"""The fused append + attend (K7) of the port against the JAX package.

* The port's plain K7 (``carry_paged_attention_fused`` on CPU tensors)
  against JAX's ``carry_paged_attention_fused(interpret=True)`` and against
  JAX's scatter oracle (the append writers, then the unfused kernel), as
  tests/test_paged_engine.py:800-896 holds the JAX kernel: bf16-layout
  pools (held in f32) and int8 pools with scales, windows 1 and 4, GQA
  (8 query heads over 4 KV heads), row 0's window straddling a page
  boundary, inactive rows parked on the scratch page. Pools byte-equal;
  outputs within 2e-5 on active rows (an inactive row's output is
  discarded by both engines).
* ``llama_paged_decode`` / ``llama_paged_verify`` with ``FUSED_APPEND`` on in
  both packages (each flag patched for the test only; a call counter shows
  that both took the fused kernel).
* Paged-engine greedy tokens with ``FUSED_APPEND`` on in both packages. JAX
  reads its flag while tracing a step, so its jit caches are cleared before
  and after, and a counter shows the JAX engine traced the fused kernel (a
  cached unfused trace would pass silently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcoder_tpu.config import VCoderConfig as JConfig
from vcoder_tpu.models import llama as jllama
from vcoder_tpu.models import vcoder as jvcoder
from vcoder_tpu.ops import paged_attention as jpa
from vcoder_tpu.serve import paged_engine as jpe
from vcoder_tpu_torch.checkpoint import from_jax_params
from vcoder_tpu_torch.config import VCoderConfig as TConfig
from vcoder_tpu_torch.models import llama as tllama
from vcoder_tpu_torch.ops import paged_attention as tpa
from vcoder_tpu_torch.serve import paged_engine as tpe

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------------------
# The kernel's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantized,window,active", [
    (False, 1, [True, True, True]),
    (False, 4, [True, True, True]),
    (True, 1, [True, True, True]),
    (True, 4, [True, True, True]),
    (False, 1, [True, False, True]),
    (True, 4, [False, True, True]),
], ids=["bf16_w1", "bf16_w4", "int8_w1", "int8_w4", "bf16_w1_inactive", "int8_w4_inactive"])
def test_plain_fused_matches_jax_kernel_and_scatter_oracle(quantized, window, active):
    L, n_pages, KH, page, D, B, H = 2, 12, 4, 8, 16, 3, 8
    k = window
    rng = np.random.default_rng(21 + window + 10 * quantized)
    kp_f = rng.standard_normal((L, n_pages, KH, page, D)).astype(np.float32)
    vp_f = rng.standard_normal((L, n_pages, KH, page, D)).astype(np.float32)
    lengths0 = np.asarray([page - 1, 2 * page + 3, 5], np.int32)  # row 0 straddles
    act = np.asarray(active)
    table = np.zeros((B, 4), np.int32)
    for b in range(B):
        table[b] = 1 + b * 3 + np.minimum(np.arange(4), 2)
    q = rng.standard_normal((B, k, H, D)).astype(np.float32)
    new_k = rng.standard_normal((B, k, KH, D)).astype(np.float32)
    new_v = rng.standard_normal((B, k, KH, D)).astype(np.float32)
    attn_lengths = lengths0 + k * act.astype(np.int32)
    pos2d = lengths0[:, None] + np.arange(k, dtype=np.int32)[None]
    l = 1
    J = jnp.asarray
    if quantized:
        kq, ks = (np.asarray(a) for a in jllama._kv_quantize(J(kp_f)))
        vq, vs = (np.asarray(a) for a in jllama._kv_quantize(J(vp_f)))
        nkq, nks = (np.asarray(a) for a in jllama._kv_quantize(J(new_k)))
        nvq, nvs = (np.asarray(a) for a in jllama._kv_quantize(J(new_v)))
        pools = [kq, vq, ks[..., 0], vs[..., 0]]
        news = dict(new_k=nkq, new_v=nvq, new_ks=nks[..., 0], new_vs=nvs[..., 0])
    else:
        pools = [kp_f, vp_f]
        news = dict(new_k=new_k, new_v=new_v)

    # JAX: the fused kernel in interpret mode, and the scatter oracle.
    jkw = {}
    if quantized:
        jkw = dict(k_scale=J(pools[2]), v_scale=J(pools[3]), new_ks=J(news["new_ks"]),
                   new_vs=J(news["new_vs"]))
    jres = jpa.carry_paged_attention_fused(
        J(q), J(news["new_k"]), J(news["new_v"]), J(pools[0]), J(pools[1]), J(table),
        J(attn_lengths), J(lengths0), J(act), jnp.int32(l), window=k, interpret=True, **jkw)
    if quantized:
        oracle = [jpa.append_tokens_layer(J(pools[0]), l, J(nkq), J(pos2d), J(table), J(act)),
                  jpa.append_tokens_layer(J(pools[1]), l, J(nvq), J(pos2d), J(table), J(act)),
                  jpa.append_token_scales_layer(J(pools[2]), l, J(news["new_ks"]), J(pos2d),
                                                J(table), J(act)),
                  jpa.append_token_scales_layer(J(pools[3]), l, J(news["new_vs"]), J(pos2d),
                                                J(table), J(act))]
        out_oracle = jpa.carry_paged_attention_multi_q8(
            J(q), *oracle, J(table), J(attn_lengths), l, window=k, interpret=True)[0]
    else:
        oracle = [jpa.append_tokens_layer(J(pools[0]), l, J(new_k), J(pos2d), J(table), J(act)),
                  jpa.append_tokens_layer(J(pools[1]), l, J(new_v), J(pos2d), J(table), J(act))]
        out_oracle = jpa.carry_paged_attention_multi(
            J(q), *oracle, J(table), J(attn_lengths), l, window=k, interpret=True)[0]

    # The port's plain version, pools written in place.
    tpools = [_t(p) for p in pools]
    tkw = {}
    if quantized:
        tkw = dict(k_scale=tpools[2], v_scale=tpools[3], new_ks=_t(news["new_ks"]),
                   new_vs=_t(news["new_vs"]))
    tpa.reset_launches()
    out = tpa.carry_paged_attention_fused(
        _t(q), _t(news["new_k"]), _t(news["new_v"]), tpools[0], tpools[1], _t(table),
        _t(attn_lengths), _t(lengths0), _t(act), l, window=k, **tkw)
    assert tpa.launches_fused == 0  # CPU tensors: the plain version, no launch

    for got, want, ora in zip(tpools, jres[1:], oracle):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ora))
    for ref in (jres[0], out_oracle):
        np.testing.assert_allclose(out.numpy()[act], np.asarray(ref)[act], atol=2e-5, rtol=2e-5)
    if not act.all():
        # The inactive row's window landed on the scratch page, at its offsets.
        b = int(np.nonzero(~act)[0][0])
        for t in range(k):
            off = (lengths0[b] + t) % page
            np.testing.assert_array_equal(tpools[0][l, n_pages - 1, :, off].numpy(),
                                          news["new_k"][b, t])


def test_fused_wrapper_refuses_a_bf16_pool_with_scales():
    z = torch.zeros((1, 2, 1, 8, 16))
    with pytest.raises(TypeError, match="int8 pools"):
        tpa.carry_paged_attention_fused(
            torch.zeros(1, 1, 1, 16), torch.zeros(1, 1, 1, 16), torch.zeros(1, 1, 1, 16), z, z,
            torch.zeros((1, 1), dtype=torch.int32), torch.ones(1, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), torch.ones(1, dtype=torch.bool), 0, window=1,
            k_scale=z[..., 0], v_scale=z[..., 0])


# ---------------------------------------------------------------------------
# The decoder's fused branches
# ---------------------------------------------------------------------------


@pytest.fixture
def fused_on(monkeypatch):
    """FUSED_APPEND on in both packages; counts each package's fused calls."""
    calls = {"jax": 0, "torch": 0}
    jreal, treal = jpa.carry_paged_attention_fused, tpa.carry_paged_attention_fused

    def jcount(*a, **k):
        calls["jax"] += 1
        return jreal(*a, **k)

    def tcount(*a, **k):
        calls["torch"] += 1
        return treal(*a, **k)

    jax.clear_caches()
    monkeypatch.setattr(jpa, "FUSED_APPEND", True)
    monkeypatch.setattr(jpa, "carry_paged_attention_fused", jcount)
    monkeypatch.setattr(tpa, "FUSED_APPEND", True)
    monkeypatch.setattr(tpa, "carry_paged_attention_fused", tcount)
    yield calls
    jax.clear_caches()  # no fused trace outlives the test


@pytest.fixture(scope="module")
def lm():
    jcfg = JConfig.tiny("vcoder_ds_llava").text
    tcfg = TConfig.tiny("vcoder_ds_llava").text
    jp = jllama.init_llama_params(jax.random.PRNGKey(5), jcfg)
    rng = np.random.RandomState(1)
    jp = jax.tree.map(lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.randn(*a.shape)
                                            .astype(np.float32)), jp)
    tp = jax.tree.map(lambda a: _t(np.asarray(a)), jp)
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("quant", [False, True], ids=["bf16_layout", "int8"])
@pytest.mark.parametrize("kind", ["decode", "verify4", "verify16"])
def test_paged_decoder_fused_matches_jax(lm, fused_on, kind, quant):
    """Decode at window 1, a 4-token verify window across a page boundary,
    and a 16-token page-aligned window (the largest the fused branch takes;
    page_aligned must not route it to the page writer)."""
    jcfg, tcfg, jp, tp = lm
    page, B, n_pages, P_max = 8, 3, 12, 5
    rng = np.random.default_rng(40 + quant)
    L, KH, HD = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim
    shape = (L, n_pages, KH, page, HD)
    if quant:
        pools = [rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2)]
        pools += [rng.uniform(0.005, 0.02, shape[:-1]).astype(np.float32) for _ in range(2)]
    else:
        pools = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    table = np.zeros((B, P_max), np.int32)
    table[0, :3] = [3, 7, 1]
    table[1, :4] = [2, 9, 5, 4]
    table[2, :2] = [6, 8]
    active = np.asarray([True, True, False])
    k = {"decode": 1, "verify4": 4, "verify16": 16}[kind]
    lengths = {"decode": [17, 31, 9], "verify4": [6, 14, 3], "verify16": [8, 16, 0]}[kind]
    lengths = np.asarray(lengths, np.int32)
    x = rng.standard_normal((B, k, jcfg.hidden_size)).astype(np.float32)
    tpools = [_t(p) for p in pools]
    jkw, tkw = {}, {}
    if quant:
        jkw = dict(k_scale=jnp.asarray(pools[2]), v_scale=jnp.asarray(pools[3]))
        tkw = dict(k_scale=tpools[2], v_scale=tpools[3])
    J = jnp.asarray
    if kind == "decode":
        out_j = jllama.llama_paged_decode(
            jp, jcfg, J(x), J(lengths), J(pools[0]), J(pools[1]), J(table), J(lengths),
            J(active), interpret=True, **jkw)
        hid = tllama.llama_paged_decode(
            tp, tcfg, _t(x), _t(lengths), tpools[0], tpools[1], _t(table), _t(lengths),
            _t(active), **tkw)
    else:
        positions = lengths[:, None] + np.arange(k, dtype=np.int32)[None, :]
        aligned = kind == "verify16"
        out_j = jllama.llama_paged_verify(
            jp, jcfg, J(x), J(positions), J(pools[0]), J(pools[1]), J(table), J(lengths),
            J(active), interpret=True, page_aligned=aligned, **jkw)
        hid = tllama.llama_paged_verify(
            tp, tcfg, _t(x), _t(positions), tpools[0], tpools[1], _t(table), _t(lengths),
            _t(active), page_aligned=aligned, **tkw)
    # JAX traces its layer scan once; the port calls the kernel per layer.
    assert fused_on == {"jax": 1, "torch": L}
    hj = np.asarray(out_j[0])
    np.testing.assert_allclose(hid.numpy(), hj, rtol=1e-4, atol=1e-4 * np.abs(hj).max())
    for pj, pt in zip(out_j[1:], tpools):
        if pt.dtype == torch.int8:
            np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
        else:
            np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# The paged engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engine_setup():
    jcfg = JConfig.tiny("vcoder_ds_llava")
    tcfg = TConfig.tiny("vcoder_ds_llava")
    jp = jvcoder.init_vcoder_params(jax.random.PRNGKey(0), jcfg)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("kw", [{}, {"kv_quant": True}, {"speculative": 4, "kv_quant": True}],
                         ids=["bf16_layout", "int8_pools", "speculative4_int8"])
def test_paged_engine_fused_append_matches_jax(engine_setup, fused_on, kw):
    jcfg, tcfg, jp, tp = engine_setup
    prompts = [[1] + [20 + ((i * 7 + j) % 50) for j in range(25 + 3 * i)] for i in range(3)]
    kw = {"max_batch": 2, "max_len": 256, "page_size": 8, "attn_impl": "xla", **kw}
    outs = []
    for eng in (jpe.PagedServingEngine(jcfg, jp, **kw),
                tpe.PagedServingEngine(tcfg, tp, device="cpu", **kw)):
        rids = [eng.add_request(p, max_new_tokens=7) for p in prompts]
        res = eng.run()
        outs.append([res[r] for r in rids])
    assert outs[1] == outs[0] and all(len(o) == 7 for o in outs[1])
    # Both engines went through the fused kernel (JAX: while tracing).
    assert fused_on["jax"] > 0 and fused_on["torch"] > 0
