"""The port's CLIP attention block and tower against the JAX package.

The port's ``fused_block_attention`` (plain version on the CPU) is held to
the JAX Pallas kernel ``fused_block_attention(..., interpret=True)`` on the
same weights, and the port's tower to JAX ``_run_blocks_fused(...,
interpret=True)`` and ``clip_encode``. Inputs and weights are f32 from numpy;
tolerance 1e-5 absolute on block outputs of magnitude ~1 (f32 sums in
another order), 1e-4 through the 2-block tower.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcoder_tpu.config import VCoderConfig as JConfig
from vcoder_tpu.models import clip as jclip
from vcoder_tpu.ops import vit_attention as jvit
from vcoder_tpu_torch.config import VCoderConfig as TConfig
from vcoder_tpu_torch.models import clip as tclip
from vcoder_tpu_torch.ops import vit_attention as tvit

torch.set_num_threads(1)


def _block_weights(rng, Dm, scale=0.2):
    w = {n: (rng.randn(Dm, Dm) * scale).astype(np.float32)
         for n in ("q_proj", "k_proj", "v_proj", "out_proj")}
    w.update({n: (rng.randn(Dm) * scale).astype(np.float32)
              for n in ("q_bias", "k_bias", "v_bias")})
    return w


@pytest.mark.parametrize("B,T,H,dh", [(2, 13, 4, 8), (1, 29, 2, 16)])
def test_block_matches_jax_kernel(B, T, H, dh):
    rng = np.random.RandomState(0)
    Dm = H * dh
    w = _block_weights(rng, Dm)
    x = rng.randn(B, T, Dm).astype(np.float32)

    hb = jvit.pick_head_block(H)
    wqkv, bqkv, wo = jvit.repack_stacked(
        {k: jnp.asarray(v)[None] for k, v in w.items()}, H, hb, dh
    )
    Tp = -(-T // 8) * 8
    ref = jvit.fused_block_attention(
        jnp.asarray(np.pad(x, ((0, 0), (0, Tp - T), (0, 0)))),
        wqkv[0], bqkv[0], wo[0], t_valid=T, n_heads=H, hb=hb, interpret=True,
    )[:, :T]

    tw = tvit.repack_block({k: torch.from_numpy(v) for k, v in w.items()}, H)
    assert tw[0].shape == (Dm, 3 * Dm) and tw[2].shape == (Dm, Dm)  # [in, out], no transpose
    out = tvit.fused_block_attention(torch.from_numpy(x), *tw, n_heads=H)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def _tower_inputs():
    jcfg = JConfig.tiny("vcoder_ds_llava").vision
    tcfg = TConfig.tiny("vcoder_ds_llava").vision
    params = jclip.init_clip_params(jax.random.PRNGKey(0), jcfg)
    # Non-trivial norms and biases so every parameter matters.
    rng = np.random.RandomState(1)
    params = jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(np.float32)),
        params,
    )
    pnp = jax.tree.map(np.asarray, params)
    tparams = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), pnp)
    px = rng.randn(3, jcfg.image_size, jcfg.image_size, 3).astype(np.float32)
    return jcfg, tcfg, params, tparams, px


def test_tower_fused_blocks_match_jax_kernel():
    jcfg, tcfg, params, tparams, px = _tower_inputs()
    rng = np.random.RandomState(2)
    x = rng.randn(3, jcfg.num_positions, jcfg.hidden_size).astype(np.float32)
    n_blocks = jclip._num_blocks(jcfg)
    ref = jclip._run_blocks_fused(params, jcfg, jnp.asarray(x), n_blocks, interpret=True)
    out = tclip._run_blocks_fused(tparams, tcfg, torch.from_numpy(x), n_blocks)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("attn_impl", ["auto", "xla"])
def test_clip_encode_matches_jax(attn_impl):
    jcfg, tcfg, params, tparams, px = _tower_inputs()
    ref = jclip.clip_encode(params, jcfg, jnp.asarray(px), attn_impl="xla")
    out = tclip.clip_encode(tparams, tcfg, torch.from_numpy(px), attn_impl=attn_impl)
    assert out.shape == (3, jcfg.num_patches, jcfg.hidden_size)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
