"""The port's fused ViT MLP half-block (K9) against the JAX package.

The port's ``fused_block_mlp`` (its plain version on the CPU) is held to the
JAX Pallas kernel ``fused_block_mlp(..., interpret=True)`` on the same
weights, as tests/test_vit_attention.py:115 holds the JAX kernel to its
oracle, at a T that is not a multiple of 8 (the kernel's rows are
independent; the TPU pad was a sublane rule). f32: 1e-5 absolute on outputs
of magnitude ~1 (f32 sums in another order). bf16: both round at the same
places (the normalized row, the GELU output, the result), so outputs may
differ by one bf16 rounding of the result (2**-8 relative), where an f32
sum lands near a rounding boundary. The port's tower with
``fuse_mlp=True`` is held to JAX ``_run_blocks_fused(..., fuse_mlp=True,
interpret=True)``, and ``clip_encode`` takes the MLP route at call time when
``FUSE_MLP_DEFAULT`` is set.
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
from vcoder_tpu_torch.ops import _kernels
from vcoder_tpu_torch.ops import vit_attention as tvit

torch.set_num_threads(1)


def _mlp_inputs(seed, B, T, Dm, I):
    rng = np.random.RandomState(seed)
    f = lambda *s, sc=1.0: (rng.randn(*s) * sc).astype(np.float32)  # noqa: E731
    return dict(x=f(B, T, Dm), ln_scale=1.0 + f(Dm, sc=0.1), ln_bias=f(Dm, sc=0.1),
                fc1=f(Dm, I, sc=0.2), fc1_bias=f(I, sc=0.2), fc2=f(I, Dm, sc=0.2),
                fc2_bias=f(Dm, sc=0.2))


@pytest.mark.parametrize("B,T,Dm,I,ib,dtype", [
    (2, 13, 32, 256, 128, "float32"),
    (1, 24, 64, 128, 128, "float32"),
    (3, 29, 64, 256, 128, "bfloat16"),
])
def test_plain_mlp_matches_jax_kernel(B, T, Dm, I, ib, dtype):
    w = _mlp_inputs(B + T, B, T, Dm, I)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jw = {k: jnp.asarray(v, jdt) for k, v in w.items()}
    ref = np.asarray(jvit.fused_block_mlp(
        jw["x"], jw["ln_scale"], jw["ln_bias"], jw["fc1"], jw["fc1_bias"], jw["fc2"],
        jw["fc2_bias"], eps=1e-5, i_block=ib, interpret=True).astype(jnp.float32))
    tw = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(getattr(torch, dtype))
          for k, v in jw.items()}
    tvit.launches_mlp = 0
    out = tvit.fused_block_mlp(tw["x"], tw["ln_scale"], tw["ln_bias"], tw["fc1"], tw["fc1_bias"],
                               tw["fc2"], tw["fc2_bias"], eps=1e-5, i_block=ib)
    assert out.dtype == getattr(torch, dtype) and out.shape == (B, T, Dm)
    assert tvit.launches_mlp == 0 and "vit_mlp" not in _kernels._LIBS
    out = out.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(out, ref, atol=2.0**-8 * np.abs(ref).max(), rtol=0)
        assert (out == ref).mean() > 0.95  # mostly bit-equal: the same roundings


def test_plain_mlp_keeps_the_kernel_roundings_not_the_unfused_mlp():
    """The unfused ``_mlp`` rounds after fc1; K9 rounds after the GELU: in
    bf16 the two differ, and the plain K9 is the one that equals JAX's
    kernel (test above)."""
    w = _mlp_inputs(7, 2, 21, 64, 256)
    t = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in w.items()}
    fused = tvit.fused_block_mlp_ref(t["x"], t["ln_scale"], t["ln_bias"], t["fc1"], t["fc1_bias"],
                                     t["fc2"], t["fc2_bias"], eps=1e-5, i_block=128)
    unfused = tclip._mlp(t["x"], {"ln2_scale": t["ln_scale"], "ln2_bias": t["ln_bias"],
                                  "fc1": t["fc1"], "fc1_bias": t["fc1_bias"], "fc2": t["fc2"],
                                  "fc2_bias": t["fc2_bias"]}, 1e-5)
    assert not torch.equal(fused, unfused)
    np.testing.assert_allclose(fused.float().numpy(), unfused.float().numpy(), atol=0.1)


def test_pick_i_block_matches_jax():
    for n in (4096, 256, 128, 96, 32):
        assert tvit.pick_i_block(n) == jvit.pick_i_block(n)
    with pytest.raises(ValueError, match="does not divide"):
        w = {k: torch.from_numpy(v) for k, v in _mlp_inputs(0, 1, 3, 8, 96).items()}
        tvit.fused_block_mlp(*w.values(), eps=1e-5, i_block=64)


def _tower():
    jcfg = JConfig.tiny("vcoder_ds_llava").vision
    tcfg = TConfig.tiny("vcoder_ds_llava").vision
    params = jclip.init_clip_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.RandomState(3)
    params = jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(np.float32)),
        params)
    tparams = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)
    return jcfg, tcfg, params, tparams, rng


def test_tower_fused_mlp_blocks_match_jax_kernels():
    jcfg, tcfg, params, tparams, rng = _tower()
    x = rng.randn(3, jcfg.num_positions, jcfg.hidden_size).astype(np.float32)  # T = 5
    n_blocks = jclip._num_blocks(jcfg)
    ref = jclip._run_blocks_fused(params, jcfg, jnp.asarray(x), n_blocks, interpret=True,
                                  fuse_mlp=True)
    out = tclip._run_blocks_fused(tparams, tcfg, torch.from_numpy(x), n_blocks, fuse_mlp=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def test_clip_encode_reads_the_flag_at_call_time(monkeypatch):
    jcfg, tcfg, params, tparams, rng = _tower()
    px = rng.randn(2, jcfg.image_size, jcfg.image_size, 3).astype(np.float32)
    calls = []
    real = tvit.fused_block_mlp
    monkeypatch.setattr(tclip, "fused_block_mlp", lambda *a, **k: calls.append(1) or real(*a, **k))
    off = tclip.clip_encode(tparams, tcfg, torch.from_numpy(px))
    assert not calls
    monkeypatch.setattr(tclip, "FUSE_MLP_DEFAULT", True)
    on = tclip.clip_encode(tparams, tcfg, torch.from_numpy(px))
    assert len(calls) == jclip._num_blocks(jcfg)
    np.testing.assert_allclose(on.numpy(), off.numpy(), atol=1e-5, rtol=0)  # f32: same function
    # The MLP route takes plain fc1/fc2 only; a quantized tower stays unfused.
    from vcoder_tpu_torch.ops.quant import quantize

    qp = dict(tparams, layers=dict(tparams["layers"], fc1=quantize(tparams["layers"]["fc1"])))
    calls.clear()
    tclip.clip_encode(qp, tcfg, torch.from_numpy(px))
    assert not calls
