"""Paged attention and the page writers: the port against the JAX package.

The port's plain versions (what its wrappers run on CPU tensors) against the
JAX Pallas kernels in interpret mode on identical pools, tables and lengths;
the page writers against their JAX twins on equal arrays; ``_kv_quantize``
bit for bit. f32 on the CPU; tolerance 1e-5 absolute (f32 summation order of
the page-by-page online softmax), writers and quantization exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcoder_tpu.models import llama as jllama
from vcoder_tpu.ops import paged_attention as jpa
from vcoder_tpu_torch.models import llama as tllama
from vcoder_tpu_torch.ops import paged_attention as tpa

torch.set_num_threads(1)

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _pools(rng, L, n_pages, KH, page, D, quant):
    kp = rng.standard_normal((L, n_pages, KH, page, D)).astype(np.float32)
    vp = rng.standard_normal((L, n_pages, KH, page, D)).astype(np.float32)
    if not quant:
        return kp, vp, None, None
    kq, ks = jllama._kv_quantize(jnp.asarray(kp))
    vq, vs = jllama._kv_quantize(jnp.asarray(vp))
    return (np.asarray(kq), np.asarray(vq), np.asarray(ks)[..., 0], np.asarray(vs)[..., 0])


def _case(window, H, KH, seed, *, L=3, page=8, D=16):
    """Rows: a length-0 row, a row whose window straddles a page boundary, a
    row of a few pages; table entries past each row's live pages hold
    garbage (out-of-range ids included), never read."""
    rng = np.random.default_rng(seed)
    B, P_max = 3, 5
    n_pages = 14
    lengths = np.asarray([0, page + window // 2 + 1, 3 * page + 5], np.int32)
    lengths[1] = max(lengths[1], window)
    table = rng.integers(-7, 10**6, (B, P_max)).astype(np.int32)
    ids = rng.permutation(np.arange(1, n_pages - 1))
    o = 0
    for b in range(B):
        n_live = -(-int(lengths[b]) // page)
        table[b, :n_live] = ids[o : o + n_live]
        o += n_live
    q = rng.standard_normal((B, window, H, D)).astype(np.float32)
    return rng, q, table, lengths, (L, n_pages, KH, page, D)


@pytest.mark.parametrize("window", [1, 4, 16])
@pytest.mark.parametrize("H,KH", [(4, 4), (8, 4)])
def test_carry_multi_matches_jax(window, H, KH):
    rng, q, table, lengths, shape = _case(window, H, KH, seed=window * 10 + KH)
    kp, vp, _, _ = _pools(rng, *shape, quant=False)
    for layer in (0, 2):
        ref, _, _ = jpa.carry_paged_attention_multi(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
            jnp.asarray(lengths), jnp.int32(layer), window=window, interpret=True,
        )
        out = tpa.carry_paged_attention_multi(
            _t(q), _t(kp), _t(vp), _t(table), _t(lengths), layer, window=window
        )
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    assert not out[0].any()  # the length-0 row gives zeros


@pytest.mark.parametrize("window", [1, 4])
@pytest.mark.parametrize("H,KH", [(4, 4), (8, 4)])
def test_carry_multi_q8_matches_jax(window, H, KH):
    rng, q, table, lengths, shape = _case(window, H, KH, seed=100 + window + KH)
    kq, vq, ks, vs = _pools(rng, *shape, quant=True)
    ref, *_ = jpa.carry_paged_attention_multi_q8(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(ks), jnp.asarray(vs),
        jnp.asarray(table), jnp.asarray(lengths), jnp.int32(1), window=window, interpret=True,
    )
    out = tpa.carry_paged_attention_multi_q8(
        _t(q), _t(kq), _t(vq), _t(ks), _t(vs), _t(table), _t(lengths), 1, window=window
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    if window == 1:
        ref1, *_ = jpa.carry_paged_attention_q8(
            jnp.asarray(q[:, 0]), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(ks),
            jnp.asarray(vs), jnp.asarray(table), jnp.asarray(lengths), jnp.int32(1),
            interpret=True,
        )
        out1 = tpa.carry_paged_attention_q8(
            _t(q[:, 0]), _t(kq), _t(vq), _t(ks), _t(vs), _t(table), _t(lengths), 1
        )
        np.testing.assert_allclose(out1.numpy(), np.asarray(ref1), atol=ATOL, rtol=0)


@pytest.mark.parametrize("H,KH", [(4, 4), (8, 4)])
def test_decode_wrappers_match_jax(H, KH):
    """Window-1 decode over a stacked pool and over an unstacked one."""
    rng, q, table, lengths, shape = _case(1, H, KH, seed=7 + KH)
    kp, vp, _, _ = _pools(rng, *shape, quant=False)
    ref, _, _ = jpa.carry_paged_attention(
        jnp.asarray(q[:, 0]), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lengths), jnp.int32(2), interpret=True,
    )
    out = tpa.carry_paged_attention(_t(q[:, 0]), _t(kp), _t(vp), _t(table), _t(lengths), 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    ref = jpa.paged_attention(
        jnp.asarray(q[:, 0]), jnp.asarray(kp[1]), jnp.asarray(vp[1]),
        jnp.asarray(np.clip(table, 0, shape[1] - 1)), jnp.asarray(lengths), interpret=True,
    )
    out = tpa.paged_attention(_t(q[:, 0]), _t(kp[1]), _t(vp[1]), _t(table), _t(lengths))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


# ---- page writers ----------------------------------------------------------


def _pool(rng, shape, quant):
    if quant:
        return rng.integers(-100, 100, shape).astype(np.int8)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("quant", [False, True])
def test_append_token_layer_matches_jax(quant):
    rng = np.random.default_rng(4 + quant)
    L, n_pages, KH, page, D, B = 2, 6, 4, 8, 16, 3
    pool = _pool(rng, (L, n_pages, KH, page, D), quant)
    tok = _pool(rng, (B, KH, D), quant)
    page_ids = np.asarray([1, 3, 2], np.int32)
    offsets = np.asarray([2, 7, 0], np.int32)
    active = np.asarray([True, False, True])
    ref = jpa.append_token_layer(jnp.asarray(pool), jnp.int32(1), jnp.asarray(tok),
                                 jnp.asarray(page_ids), jnp.asarray(offsets), jnp.asarray(active))
    out = tpa.append_token_layer(_t(pool), 1, _t(tok), _t(page_ids), _t(offsets), _t(active))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    sc = rng.standard_normal((L, n_pages, KH, page)).astype(np.float32)
    s = rng.standard_normal((B, KH, 1)).astype(np.float32)
    ref = jpa.append_scale_layer(jnp.asarray(sc), jnp.int32(0), jnp.asarray(s),
                                 jnp.asarray(page_ids), jnp.asarray(offsets), jnp.asarray(active))
    out = tpa.append_scale_layer(_t(sc), 0, _t(s), _t(page_ids), _t(offsets), _t(active))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("quant", [False, True])
def test_append_tokens_layer_matches_jax(quant):
    """A window straddling a page boundary, an inactive row (scratch page),
    and a window crossing the table's end (JAX's fill wraps to page 0)."""
    rng = np.random.default_rng(13 + quant)
    L, n_pages, KH, page, D, B, k = 2, 7, 4, 8, 16, 3, 4
    pool = _pool(rng, (L, n_pages, KH, page, D), quant)
    toks = _pool(rng, (B, k, KH, D), quant)
    positions = np.asarray([[6, 7, 8, 9], [0, 1, 2, 3], [22, 23, 24, 25]], np.int32)
    table = np.asarray([[1, 2, 0], [3, 0, 0], [4, 5, 3]], np.int32)  # P_max * page = 24
    active = np.asarray([True, False, True])
    for l in range(L):
        ref = jpa.append_tokens_layer(jnp.asarray(pool), jnp.int32(l), jnp.asarray(toks),
                                      jnp.asarray(positions), jnp.asarray(table),
                                      jnp.asarray(active))
        out = tpa.append_tokens_layer(_t(pool), l, _t(toks), _t(positions), _t(table), _t(active))
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert (np.asarray(ref)[1, 0] != pool[1, 0]).any()  # page 0 took the overflow
    sc = rng.standard_normal((L, n_pages, KH, page)).astype(np.float32)
    s = rng.standard_normal((B, k, KH, 1)).astype(np.float32)
    ref = jpa.append_token_scales_layer(jnp.asarray(sc), jnp.int32(1), jnp.asarray(s),
                                        jnp.asarray(positions), jnp.asarray(table),
                                        jnp.asarray(active))
    out = tpa.append_token_scales_layer(_t(sc), 1, _t(s), _t(positions), _t(table), _t(active))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("quant", [False, True])
def test_append_pages_layer_matches_jax(quant):
    """A page-aligned chunk: mid-table, with overhang onto sentinel entries,
    an inactive row, and one crossing the table's end. JAX drops that last
    block; the port parks it on the scratch page, so every page but the
    scratch page must match (module note of ops/paged_attention.py)."""
    rng = np.random.default_rng(11 + quant)
    L, n_pages, KH, page, D = 2, 10, 4, 8, 16
    B, k = 4, 16
    pool = _pool(rng, (L, n_pages, KH, page, D), quant)
    kv = _pool(rng, (B, k, KH, D), quant)
    # One writer per page outside the scratch page (9): row 1's overhang is
    # the only block landing on the sentinel (page 0).
    table = np.asarray([[1, 2, 0], [0, 3, 0], [4, 5, 0], [6, 7, 8]], np.int32)
    starts = np.asarray([0, 8, 0, 16], np.int32)
    positions = starts[:, None] + np.arange(k, dtype=np.int32)[None, :]
    active = np.asarray([True, True, False, True])
    for l in range(L):
        ref = np.asarray(jpa.append_pages_layer(
            jnp.asarray(pool), jnp.int32(l), jnp.asarray(kv), jnp.asarray(positions),
            jnp.asarray(table), jnp.asarray(active)))
        out = tpa.append_pages_layer(_t(pool), l, _t(kv), _t(positions), _t(table),
                                     _t(active)).numpy()
        np.testing.assert_array_equal(out[:, :-1], ref[:, :-1])
        # ... and the page-granular write equals the token write there.
        tok = tpa.append_tokens_layer(_t(pool), l, _t(kv), _t(positions), _t(table), _t(active))
        np.testing.assert_array_equal(out[:, 1:-1], tok.numpy()[:, 1:-1])
    sc = rng.standard_normal((L, n_pages, KH, page)).astype(np.float32)
    s = rng.standard_normal((B, k, KH)).astype(np.float32)
    ref = np.asarray(jpa.append_page_scales_layer(
        jnp.asarray(sc), jnp.int32(1), jnp.asarray(s), jnp.asarray(positions),
        jnp.asarray(table), jnp.asarray(active)))
    out = tpa.append_page_scales_layer(_t(sc), 1, _t(s), _t(positions), _t(table),
                                       _t(active)).numpy()
    np.testing.assert_array_equal(out[:, :-1], ref[:, :-1])


def test_write_prompt_pages_matches_jax():
    rng = np.random.default_rng(5)
    n_pages, KH, page, D, T = 7, 2, 8, 16, 24
    pages = rng.standard_normal((n_pages, KH, page, D)).astype(np.float32)
    kv = rng.standard_normal((T, KH, D)).astype(np.float32)
    ids = np.asarray([4, 1, 5], np.int32)
    ref = jpa.write_prompt_pages(jnp.asarray(pages), jnp.asarray(kv), jnp.asarray(ids))
    out = tpa.write_prompt_pages(_t(pages), _t(kv), _t(ids))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quantize_bit_exact(dtype):
    """Random vectors, an all-zero vector (the 1e-8 floor) and exact
    half-integer quotients (round half to even)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5, 2, 16)).astype(np.float32) * 3.0
    x[0, 0, 0] = 0.0
    x[0, 1, 0] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5] + [0.0] * 8
    xj = jnp.asarray(x).astype(dtype)
    xt = _t(x).to(getattr(torch, dtype))
    qj, sj = jllama._kv_quantize(xj)
    qt, st = tllama._kv_quantize(xt)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert list(qt[0, 1, 0, :8]) == [127, 0, 2, 2, 0, -2, -2, 4]
