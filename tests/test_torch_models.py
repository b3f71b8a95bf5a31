"""The port's models against the JAX package, on the CPU in f32.

Weights come from ``vcoder_tpu.models.vcoder.init_vcoder_params`` on
``VCoderConfig.tiny("vcoder_ds_llava")`` (GQA 4q/2kv), perturbed so norms,
biases and the ``vcoder_lm_emb`` table all differ from their init values,
and reach the port through ``checkpoint.from_jax_params``. The port's
attention takes its flash route (the kernel's plain version on the CPU), the
JAX side its jnp route. Tolerances: 2e-5 absolute on hidden states and
features of magnitude ~1, 1e-4 relative on logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from vcoder_tpu.config import VCoderConfig as JConfig
from vcoder_tpu.models import llama as jllama
from vcoder_tpu.models import vcoder as jvcoder
from vcoder_tpu.models.projectors import apply_projector as j_apply_projector
from vcoder_tpu_torch.checkpoint import from_jax_params
from vcoder_tpu_torch.config import VCoderConfig as TConfig
from vcoder_tpu_torch.models import llama as tllama
from vcoder_tpu_torch.models import vcoder as tvcoder
from vcoder_tpu_torch.models.projectors import apply_projector as t_apply_projector

torch.set_num_threads(1)

ATOL = 2e-5


@pytest.fixture(scope="module")
def models():
    jcfg = JConfig.tiny("vcoder_ds_llava")
    tcfg = TConfig.tiny("vcoder_ds_llava")
    jp = jvcoder.init_vcoder_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.RandomState(0)
    jp = jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(np.float32)), jp
    )
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _t(a):
    return torch.from_numpy(np.array(a))


def _ragged(B, T, lens):
    mask = np.zeros((B, T), bool)
    pos = np.zeros((B, T), np.int32)
    for b, n in enumerate(lens):
        mask[b, :n] = True
        pos[b, :n] = np.arange(n)
    return mask, pos


def test_llama_forward_without_cache(models):
    jcfg, tcfg, jp, tp = models
    B, T, D = 2, 24, jcfg.text.hidden_size
    x = np.random.RandomState(1).randn(B, T, D).astype(np.float32)
    mask, pos = _ragged(B, T, [24, 17])
    ref, _ = jllama.llama_forward(
        jp["lm"], jcfg.text, jnp.asarray(x), attn_mask=jnp.asarray(mask),
        position_ids=jnp.asarray(pos), attn_impl="xla",
    )
    out, cache = tllama.llama_forward(
        tp["lm"], tcfg.text, _t(x), attn_mask=_t(mask), position_ids=_t(pos)
    )
    assert cache is None
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_llama_forward_with_cache_then_decode(models):
    jcfg, tcfg, jp, tp = models
    B, T, D = 2, 24, jcfg.text.hidden_size
    S = T + 4
    rng = np.random.RandomState(2)
    x = rng.randn(B, T, D).astype(np.float32)
    mask, pos = _ragged(B, T, [24, 17])
    jc = jllama.KVCache.create(jcfg.text, B, S)
    tc = tllama.KVCache.create(tcfg.text, B, S)
    zeros = np.zeros((B,), np.int32)
    jh, jc = jllama.llama_forward(
        jp["lm"], jcfg.text, jnp.asarray(x), attn_mask=jnp.asarray(mask),
        position_ids=jnp.asarray(pos), cache=jc, write_offset=jnp.asarray(zeros),
        attn_impl="xla",
    )
    th, tc = tllama.llama_forward(
        tp["lm"], tcfg.text, _t(x), attn_mask=_t(mask), position_ids=_t(pos),
        cache=tc, write_offset=_t(zeros),
    )
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(tc.kv_mask.numpy(), np.asarray(jc.kv_mask))
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    valid = np.asarray(jc.kv_mask)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            getattr(tc, name).numpy()[:, valid], np.asarray(getattr(jc, name))[:, valid],
            atol=ATOL, rtol=0,
        )
    # One decode token per row at its next position, over the pad slots.
    lens = np.asarray([24, 17], np.int32)
    x1 = rng.randn(B, 1, D).astype(np.float32)
    jh1, jc = jllama.llama_forward(
        jp["lm"], jcfg.text, jnp.asarray(x1), attn_mask=jnp.ones((B, 1), bool),
        position_ids=jnp.asarray(lens[:, None]), cache=jc,
        write_offset=jnp.asarray(lens), attn_impl="xla",
    )
    th1, tc = tllama.llama_forward(
        tp["lm"], tcfg.text, _t(x1), attn_mask=torch.ones((B, 1), dtype=torch.bool),
        position_ids=_t(lens[:, None]), cache=tc, write_offset=_t(lens),
    )
    np.testing.assert_allclose(th1.numpy(), np.asarray(jh1), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(tc.kv_mask.numpy(), np.asarray(jc.kv_mask))


def test_apply_projector(models):
    jcfg, tcfg, jp, tp = models
    x = np.random.RandomState(3).randn(2, 5, jcfg.vision.hidden_size).astype(np.float32)
    for name in ("mm_projector", "mm2_projector", "seg_projector", "depth_projector"):
        ref = j_apply_projector(jp[name], jnp.asarray(x))
        out = t_apply_projector(tp[name], _t(x))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("n_occ", [1, 2])
def test_encode_vision_three_modalities(models, n_occ):
    jcfg, tcfg, jp, tp = models
    hw = jcfg.vision.image_size
    rng = np.random.RandomState(4)
    shape = (2, hw, hw, 3) if n_occ == 1 else (2, n_occ, hw, hw, 3)
    px = [rng.randn(*shape).astype(np.float32) for _ in range(3)]
    ref = jvcoder.encode_vision(jp, jcfg, *(jnp.asarray(p) for p in px), attn_impl="xla")
    out = tvcoder.encode_vision(tp, tcfg, *(_t(p) for p in px))
    assert out.shape == (2, 3 * n_occ * jcfg.vision.num_patches, jcfg.text.hidden_size)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def _assert_logits_close(out, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_prefill_and_decode_on_example_batch(models):
    """The flagship DS batch of ``__graft_entry__._example_batch``
    at the tiny config: last-token logits of prefill, then one decode step."""
    jcfg, tcfg, jp, tp = models
    batch = __graft_entry__._example_batch(jcfg, 2)
    px = {k: np.asarray(batch[k]).astype(np.float32) for k in ("images", "segs", "depths")}
    B, T = batch["safe_ids"].shape
    S = T + 4
    jc = jllama.KVCache.create(jcfg.text, B, S)
    ref, jc = jvcoder.prefill(
        jp, jcfg, batch, batch["images"], batch["segs"], batch["depths"], cache=jc,
        use_vcoder_emb=True, attn_impl="xla",
    )
    arrays = {
        k: _t(batch[k]).long()
        for k in ("safe_ids", "vis_idx", "position_ids", "seq_lens")
    }
    arrays.update({k: _t(batch[k]) for k in ("is_text", "attn_mask")})
    tc = tllama.KVCache.create(tcfg.text, B, S)
    out, tc = tvcoder.prefill(
        tp, tcfg, arrays, _t(px["images"]), _t(px["segs"]), _t(px["depths"]), cache=tc,
        use_vcoder_emb=True,
    )
    assert out.shape == (B, jcfg.text.vocab_size)
    _assert_logits_close(out.numpy(), ref)

    tok = np.asarray(jnp.argmax(ref, axis=-1)).astype(np.int32)
    positions = np.asarray(batch["seq_lens"]).astype(np.int32)
    ref1, _ = jvcoder.decode_step(jp, jcfg, jnp.asarray(tok), jnp.asarray(positions), jc,
                                  attn_impl="xla")
    out1, _ = tvcoder.decode_step(tp, tcfg, _t(tok).long(), _t(positions).long(), tc)
    _assert_logits_close(out1.numpy(), ref1)


def _golden(prefix):
    import os

    g = np.load(os.path.join(os.path.dirname(__file__), "golden", "hf_golden.npz"))
    state = {k[len(prefix):]: _t(g[k]) for k in g.files if k.startswith(prefix)}
    return g, state


def test_golden_vectors_anchor_llama():
    """The port's importer and decoder against the committed HF Llama
    activations, at the JAX test's tolerance (test_llama_parity.py:184)."""
    from vcoder_tpu_torch.checkpoint import import_llama
    from vcoder_tpu_torch.config import TextConfig

    g, state = _golden("llama.state.")
    cfg = TextConfig(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2,
                     num_heads=4, num_kv_heads=2, max_position_embeddings=128)
    params = import_llama(state, cfg)
    ids = _t(g["llama.input_ids"]).long()
    B, T = ids.shape
    hidden, _ = tllama.llama_forward(
        params, cfg, tllama.embed_tokens(params, ids),
        attn_mask=torch.ones((B, T), dtype=torch.bool),
        position_ids=torch.arange(T).expand(B, T),
    )
    got = tllama.lm_head(params, hidden).numpy()
    np.testing.assert_allclose(got, g["llama.logits"], atol=2e-4, rtol=2e-3)


def test_golden_vectors_anchor_clip():
    """The port's importer and tower (fused-block route) against the
    committed HF CLIP activations (test_clip_parity.py:96)."""
    from vcoder_tpu_torch.checkpoint import import_clip
    from vcoder_tpu_torch.config import VisionConfig
    from vcoder_tpu_torch.models.clip import clip_encode

    g, state = _golden("clip.state.")
    cfg = VisionConfig(image_size=28, patch_size=14, hidden_size=32, intermediate_size=64,
                       num_layers=3, num_heads=4)
    params = import_clip(state, cfg, prefix="vision_model.")
    got = clip_encode(params, cfg, _t(g["clip.pixel_values"].transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(got.numpy(), g["clip.hidden_m2"][:, 1:, :], atol=2e-4, rtol=2e-3)
