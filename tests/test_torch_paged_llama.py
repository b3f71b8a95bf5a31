"""The paged decoder forwards: ``llama_paged_decode`` and ``llama_paged_verify``
of the port against the JAX package on the same params and pools.

Tiny GQA text config in f32 (the bf16 pool layout held in f32) and int8
pools with scales; the verify window straddles a page boundary, and
``page_aligned`` takes the page-granular append on a page-aligned chunk. One
row is inactive (it writes the scratch page). Hidden states agree to 1e-4
relative (f32 matmuls in another order); the updated f32 pools and scale
pools to 1e-5 (a scale is the absmax of K/V computed in that order); the
int8 pools exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcoder_tpu.config import VCoderConfig as JConfig
from vcoder_tpu.models import llama as jllama
from vcoder_tpu_torch.config import VCoderConfig as TConfig
from vcoder_tpu_torch.models import llama as tllama

torch.set_num_threads(1)

PAGE = 8


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.fixture(scope="module")
def lm():
    jcfg = JConfig.tiny("vcoder_ds_llava").text
    tcfg = TConfig.tiny("vcoder_ds_llava").text
    assert jcfg.num_kv_heads < jcfg.num_heads
    jp = jllama.init_llama_params(jax.random.PRNGKey(5), jcfg)
    rng = np.random.RandomState(1)
    jp = jax.tree.map(lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.randn(*a.shape)
                                            .astype(np.float32)), jp)
    tp = jax.tree.map(lambda a: _t(np.asarray(a)), jp)
    return jcfg, tcfg, jp, tp


def _setup(cfg, quant, seed, B=3, n_pages=12, P_max=5):
    rng = np.random.default_rng(seed)
    L, KH, HD = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    shape = (L, n_pages, KH, PAGE, HD)
    if quant:
        pools = [rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2)]
        pools += [rng.uniform(0.005, 0.02, shape[:-1]).astype(np.float32) for _ in range(2)]
    else:
        pools = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    table = np.zeros((B, P_max), np.int32)
    table[0, :3] = [3, 7, 1]
    table[1, :4] = [2, 9, 5, 4]
    table[2, :2] = [6, 8]
    return rng, pools, table


def _run(fn_j, fn_t, pools, quant):
    kw_j, kw_t = {}, {}
    tpools = [_t(p) for p in pools]
    if quant:
        kw_j = dict(k_scale=jnp.asarray(pools[2]), v_scale=jnp.asarray(pools[3]))
        kw_t = dict(k_scale=tpools[2], v_scale=tpools[3])
    out_j = fn_j(jnp.asarray(pools[0]), jnp.asarray(pools[1]), kw_j)
    hidden_t = fn_t(tpools[0], tpools[1], kw_t)
    return out_j, hidden_t, tpools


def _compare(out_j, hidden_t, tpools):
    hj = np.asarray(out_j[0])
    np.testing.assert_allclose(hidden_t.numpy(), hj, rtol=1e-4, atol=1e-4 * np.abs(hj).max())
    for pj, pt in zip(out_j[1:], tpools):
        if pt.dtype == torch.int8:
            np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
        else:
            np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("quant", [False, True])
def test_paged_decode_matches_jax(lm, quant):
    jcfg, tcfg, jp, tp = lm
    rng, pools, table = _setup(jcfg, quant, seed=10 + quant)
    lengths = np.asarray([17, 31, 9], np.int32)  # row 1 writes the last slot of a page
    active = np.asarray([True, True, False])
    x = rng.standard_normal((3, 1, jcfg.hidden_size)).astype(np.float32)
    out_j, hid, tpools = _run(
        lambda k, v, kw: jllama.llama_paged_decode(
            jp, jcfg, jnp.asarray(x), jnp.asarray(lengths), k, v, jnp.asarray(table),
            jnp.asarray(lengths), jnp.asarray(active), interpret=True, **kw),
        lambda k, v, kw: tllama.llama_paged_decode(
            tp, tcfg, _t(x), _t(lengths), k, v, _t(table), _t(lengths), _t(active), **kw),
        pools, quant,
    )
    _compare(out_j, hid, tpools)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("page_aligned", [False, True])
def test_paged_verify_matches_jax(lm, quant, page_aligned):
    """page_aligned=False: a 4-token window straddling a page boundary;
    page_aligned=True: a 16-token chunk starting on a page boundary, row 2's
    overhanging onto a sentinel table entry."""
    jcfg, tcfg, jp, tp = lm
    rng, pools, table = _setup(jcfg, quant, seed=20 + 2 * quant + page_aligned)
    if page_aligned:
        k, lengths = 16, np.asarray([8, 16, 0], np.int32)
        table[2, 1] = 0  # row 2's second page is the sentinel: an overhang
    else:
        k, lengths = 4, np.asarray([6, 14, 3], np.int32)
    positions = lengths[:, None] + np.arange(k, dtype=np.int32)[None, :]
    active = np.asarray([True, True, page_aligned])
    if page_aligned:
        active[1] = False  # an inactive row parks on the scratch page
    x = rng.standard_normal((3, k, jcfg.hidden_size)).astype(np.float32)
    out_j, hid, tpools = _run(
        lambda kp, vp, kw: jllama.llama_paged_verify(
            jp, jcfg, jnp.asarray(x), jnp.asarray(positions), kp, vp, jnp.asarray(table),
            jnp.asarray(lengths), jnp.asarray(active), interpret=True,
            page_aligned=page_aligned, **kw),
        lambda kp, vp, kw: tllama.llama_paged_verify(
            tp, tcfg, _t(x), _t(positions), kp, vp, _t(table), _t(lengths), _t(active),
            page_aligned=page_aligned, **kw),
        pools, quant,
    )
    _compare(out_j, hid, tpools)
