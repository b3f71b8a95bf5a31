"""The port's int8 dense KV cache against the JAX package's (CPU, f32).

Mirrors tests/test_kv_quant.py: ``_kv_quantize`` gives JAX's bytes and
scales; ``xla_attention`` with the scales folded in agrees with JAX's and
with attention over the dequantized K/V; a prefill and decode steps into a
quantized cache agree with JAX's quantized cache (the int8 values and
scales written, the logits) and stay close to the unquantized cache;
``trim_cache`` carries the scales; the ``kv_quant`` slot engine emits the
JAX ``kv_quant`` engine's tokens. Tolerances: f32 on both sides, so logits
agree to 2e-5 relative to their largest magnitude; an int8 value may round
the other way where ``x / scale`` sits within float error of a .5 (counted,
and bounded at one level).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcoder_tpu.config import VCoderConfig as JConfig
from vcoder_tpu.constants import IMAGE_TOKEN_INDEX, SEG_TOKEN_INDEX
from vcoder_tpu.models import llama as jllama
from vcoder_tpu.models import vcoder as jvcoder
from vcoder_tpu.multimodal import build_splice_plan as jplan
from vcoder_tpu.ops import attention as jattn
from vcoder_tpu.serve.engine import ServingEngine as JEngine
from vcoder_tpu_torch.checkpoint import from_jax_params
from vcoder_tpu_torch.config import VCoderConfig as TConfig
from vcoder_tpu_torch.models import llama as tllama
from vcoder_tpu_torch.models import vcoder as tvcoder
from vcoder_tpu_torch.multimodal import build_splice_plan as tplan
from vcoder_tpu_torch.ops import attention as tattn
from vcoder_tpu_torch.serve.engine import ServingEngine as TEngine
from vcoder_tpu_torch.speculative import trim_cache

torch.set_num_threads(1)

IDS = [1, 5, IMAGE_TOKEN_INDEX, SEG_TOKEN_INDEX, 7, 8, 9]


def test_kv_quantize_matches_jax():
    x = np.random.RandomState(0).randn(2, 8, 4, 32).astype(np.float32)
    qj, sj = jllama._kv_quantize(jnp.asarray(x))
    qt, st = tllama._kv_quantize(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and st.shape == (2, 8, 4, 1)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    x_hat = qt.float() * st
    rel = (x_hat - torch.from_numpy(x)).abs().max() / np.abs(x).max()
    assert rel < 0.02


@pytest.mark.parametrize("t,kh", [(1, 4), (4, 2)])
def test_scale_folded_attention_matches_jax(t, kh):
    """int8 K/V with their scales: the folded plain route equals JAX's, and
    attention over the dequantized K/V; ``multi_head_attention`` takes the
    plain route whenever scales are given, whatever ``impl`` says."""
    rng = np.random.RandomState(t)
    b, s, h, d = 2, 24, 4, 16
    q = rng.randn(b, t, h, d).astype(np.float32)
    k, ks = tllama._kv_quantize(torch.from_numpy(rng.randn(b, s, kh, d).astype(np.float32)))
    v, vs = tllama._kv_quantize(torch.from_numpy(rng.randn(b, s, kh, d).astype(np.float32)))
    pos = np.stack([np.arange(t) + 20, np.arange(t) + 9]).astype(np.int32)
    mask = np.ones((b, s), bool)
    mask[1, 12:] = False
    mask[0, 3] = False
    ref = jattn.xla_attention(
        jnp.asarray(q), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()), causal=True,
        q_positions=jnp.asarray(pos), kv_mask=jnp.asarray(mask),
        k_scale=jnp.asarray(ks[..., 0].numpy()), v_scale=jnp.asarray(vs[..., 0].numpy()))
    kw = dict(causal=True, q_positions=torch.from_numpy(pos).long(),
              kv_mask=torch.from_numpy(mask), k_scale=ks[..., 0], v_scale=vs[..., 0])
    got = tattn.xla_attention(torch.from_numpy(q), k, v, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    deq = tattn.xla_attention(torch.from_numpy(q), k.float() * ks, v.float() * vs,
                              causal=True, q_positions=kw["q_positions"],
                              kv_mask=kw["kv_mask"])
    np.testing.assert_allclose(got.numpy(), deq.numpy(), rtol=1e-5, atol=1e-5)
    routed = tattn.multi_head_attention(torch.from_numpy(q), k, v, impl="auto", **kw)
    assert torch.equal(routed, got)


def _setup(pad_to):
    jcfg = JConfig.tiny("vcoder_llava")
    tcfg = TConfig.tiny("vcoder_llava")
    jp = jvcoder.init_vcoder_params(jax.random.PRNGKey(0), jcfg)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    kw = dict(num_patches=jcfg.vision.num_patches, has_seg=True, pad_to=pad_to)
    jarr = jvcoder.plan_to_arrays(jplan([IDS], **kw))
    plan = tplan([IDS], **kw)
    tarr = tvcoder.plan_to_arrays(plan, "cpu")
    hw = jcfg.vision.image_size
    px = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (1, hw, hw, 3)))
    return jcfg, tcfg, jp, tp, jarr, tarr, px, plan


@pytest.fixture(scope="module", params=[16, 48], ids=["prefill-folded", "prefill-dequantized"])
def tiny(request):
    return _setup(request.param)


def _jax_run(jcfg, jp, jarr, px, plan, quantized):
    T = plan.seq_len
    cache = jllama.KVCache.create(jcfg.text, 1, T + 8, dtype=jnp.float32, quantized=quantized)
    logits, cache = jvcoder.prefill(jp, jcfg, jarr, jnp.asarray(px), jnp.asarray(px),
                                    cache=cache, use_vcoder_emb=True, attn_impl="xla")
    rows, toks = [np.asarray(logits)], [int(jnp.argmax(logits))]
    tok = jnp.asarray([toks[0]], jnp.int32)
    for i in range(4):
        pos = jnp.asarray(plan.seq_lens) + i
        logits, cache = jvcoder.decode_step(jp, jcfg, tok, pos, cache, attn_impl="xla")
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        rows.append(np.asarray(logits))
        toks.append(int(tok[0]))
    return toks, rows, cache


def _torch_run(tcfg, tp, tarr, px, plan, quantized):
    T = plan.seq_len
    cache = tllama.KVCache.create(tcfg.text, 1, T + 8, quantized=quantized)
    x = torch.as_tensor(px)
    with torch.no_grad():
        logits, cache = tvcoder.prefill(tp, tcfg, tarr, x, x, cache=cache, use_vcoder_emb=True,
                                        attn_impl="xla")
        rows, toks = [logits.numpy()], [int(logits.argmax())]
        tok = torch.tensor([toks[0]])
        for i in range(4):
            pos = tarr["seq_lens"] + i
            logits, cache = tvcoder.decode_step(tp, tcfg, tok, pos, cache, attn_impl="xla")
            tok = logits.argmax(-1)
            rows.append(logits.numpy())
            toks.append(int(tok[0]))
    return toks, rows, cache


def test_quantized_cache_prefill_decode_matches_jax(tiny):
    """A prefill (of 16 tokens: the scales folded in; of 48, past
    ``QUANT_FOLD_T_MAX``: attention over the dequantized layer) and 4
    decode steps (folded) into an int8 cache: the logits, tokens, int8
    values and scales equal JAX's quantized cache's, and the tokens equal
    the unquantized cache's (the JAX test's expectation)."""
    jcfg, tcfg, jp, tp, jarr, tarr, px, plan = tiny
    toks_j, rows_j, cj = _jax_run(jcfg, jp, jarr, px, plan, True)
    toks_t, rows_t, ct = _torch_run(tcfg, tp, tarr, px, plan, True)
    assert ct.quantized and ct.k.dtype == torch.int8 and ct.k_scale.dtype == torch.float32
    assert toks_t == toks_j
    for a, b in zip(rows_t, rows_j):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-5 * np.abs(b).max())
    n = int(ct.length[0])
    assert n == int(cj.length[0]) == plan.seq_lens[0] + 4
    for name in ("k", "v"):
        got = getattr(ct, name)[:, :, :n].numpy().astype(np.int32)
        ref = np.asarray(getattr(cj, name))[:, :, :n].astype(np.int32)
        assert np.abs(got - ref).max() <= 1 and (got != ref).mean() < 1e-3
        np.testing.assert_allclose(getattr(ct, f"{name}_scale")[:, :, :n].numpy(),
                                   np.asarray(getattr(cj, f"{name}_scale"))[:, :, :n],
                                   rtol=1e-5, atol=0)
    np.testing.assert_array_equal(ct.kv_mask.numpy(), np.asarray(cj.kv_mask))
    toks_f, rows_f, _ = _torch_run(tcfg, tp, tarr, px, plan, False)
    assert toks_t == toks_f
    err = np.abs(rows_t[-1] - rows_f[-1]).max() / np.abs(rows_f[-1]).max()
    assert err < 0.05, err


def test_trim_cache_carries_the_scales():
    cfg = TConfig.tiny("vcoder_llava").text
    cache = tllama.KVCache.create(cfg, 2, 16, quantized=True)
    out = trim_cache(cache, torch.tensor([3, 7]))
    assert out.k_scale is cache.k_scale and out.v_scale is cache.v_scale and out.quantized
    assert out.kv_mask.sum(1).tolist() == [3, 7] and out.length.tolist() == [3, 7]
    plain = trim_cache(tllama.KVCache.create(cfg, 2, 16), torch.tensor([1, 2]))
    assert not plain.quantized and plain.k_scale is None


def test_engine_with_kv_quant_matches_jax(tiny):
    """The int8-cache slot engine's tokens equal the JAX int8-cache engine's
    and the bf16-layout engine's (as the JAX test expects), with a verify
    window of 4 too; its cache really is int8."""
    jcfg, tcfg, jp, tp, _, _, px, _ = tiny
    outs = {}
    for label, kw in (("plain", {}), ("q8", {"kv_quant": True}),
                      ("q8 spec", {"kv_quant": True, "speculative": 4})):
        for side, eng in (("jax", JEngine(jcfg, jp, max_batch=2, max_len=768, attn_impl="xla",
                                          **kw)),
                          ("torch", TEngine(tcfg, tp, max_batch=2, max_len=768, attn_impl="xla",
                                            device="cpu", **kw))):
            rid = eng.add_request(IDS, images=px, segs=px, max_new_tokens=5)
            outs[label, side] = eng.run()[rid]
    assert outs["q8", "torch"] == outs["q8", "jax"] == outs["plain", "torch"]
    assert outs["q8 spec", "torch"] == outs["q8 spec", "jax"]
    eng = TEngine(tcfg, tp, max_batch=1, max_len=768, kv_quant=True, attn_impl="xla",
                  device="cpu")
    assert eng.cache.k.dtype == torch.int8 and eng.cache.quantized
    assert eng.cache.k_scale.shape == eng.cache.k.shape[:-1] + (1,)
