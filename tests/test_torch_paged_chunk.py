"""The TILE body of the paged kernel (``csrc/paged_attn.cu``: every call with
C = group x window > 16 query columns -- chunk windows, fused GQA windows)
on the CPU.

* Routing: ``split_of`` sends every call with C <= 16 to the SPLIT body and
  every call with C > 16 to the TILE body, decided from the shapes alone
  (the card is asked only for the SPLIT body's cluster capacity).
* A test-local plain emulation of the TILE body's arithmetic order: each
  row's pool tokens in 64-token tiles from token 0 (each key's page looked
  up in the table and clipped to the pool), then, fused, the window's
  tokens in 64-token tiles from the operands; each tile one online-softmax
  step of the plain version (``_key_step``: the k-scale on the score, p
  summed into l before the v-scale, then multiplied by it and rounded to
  bf16 against the running maximum after the tile; V rows and V-scales of
  keys no column sees selected away). It is held against the JAX kernels
  in interpret mode (``carry_paged_attention_multi``, ``_multi_q8`` and
  ``_fused``) at D = 32, GQA 4/2, windows 24 and 32, pages 8, 16 and 64,
  with a length-0 row, a row shorter than the window and live page ids past
  either end of the pool, at the card's gates (max-abs 2e-2, each head's
  relative L2 8e-3); each case prints the gaps it measured.
* At 64-token pages a tile is a page: the emulation equals the plain
  version bit for bit. At other page sizes p is rounded at each 64-token
  tile instead of each page (ROADMAP, deliberate divergences).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcoder_tpu.models import llama as jllama
from vcoder_tpu.ops import paged_attention as jpa
from vcoder_tpu_torch.ops import paged_attention as tpa

torch.set_num_threads(1)

TOL = 2e-2  # the card's gates (chip_smoke.PAGED_MAX_ABS, PAGED_REL_L2)
REL_TOL = 8e-3
BK = 64  # keys of a TILE body tile

# One wave of the SPLIT body on an H100 80GB HBM3 at 2 to 8 columns
# (test_torch_paged_split.py), for split_of's SPLIT routes.
H100_CAPACITY_C4 = (264, 264, 237, 248, 235, 234, 224, 240)


@pytest.fixture
def no_card(monkeypatch):
    """``split_of`` on CPU tensors: the SPLIT body's capacity and the
    current device answered as on one H100, nothing cached."""
    monkeypatch.setattr(tpa, "_SPLIT", {})
    monkeypatch.setattr(tpa, "_capacity", lambda idx, quant, fused, C: H100_CAPACITY_C4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)


@pytest.mark.parametrize("B,k,H,KH,quant,fused,body", [
    (8, 1, 32, 32, False, False, tpa.BODY_SPLIT),    # bf16 decode (K8, K3)
    (8, 4, 32, 32, False, False, tpa.BODY_SPLIT),    # bf16 verify window 4 (K3)
    (2, 128, 32, 32, True, False, tpa.BODY_TILE),    # int8 chunk window (K4's function)
    (4, 128, 32, 32, False, False, tpa.BODY_TILE),   # bf16 chunk window (K3)
    (4, 8, 32, 8, False, True, tpa.BODY_TILE),       # fused GQA window of 8: C = 32
    (4, 4, 32, 8, True, True, tpa.BODY_SPLIT),       # fused GQA window of 4: C = 16
    (8, 1, 40, 40, False, False, tpa.BODY_SPLIT),    # 13B decode
    (8, 4, 40, 40, True, False, tpa.BODY_SPLIT),     # 13B int8 verify
    (4, 128, 40, 40, False, False, tpa.BODY_TILE),   # 13B chunk window
    (2, 17, 32, 32, False, False, tpa.BODY_TILE),    # the first window past 16 columns
], ids=["bf16_decode", "bf16_verify", "int8_chunk", "bf16_chunk", "fused_gqa_c32",
        "fused_gqa_c16", "13b_decode", "13b_int8_verify", "13b_chunk", "c17"])
def test_split_of_routes_by_column_count(no_card, B, k, H, KH, quant, fused, body):
    """SPLIT at C <= 16 with the cluster of ``_split_plan``, TILE past 16
    with a cluster of 1, whatever the pool type or the fused flag."""
    q = torch.zeros(B, k, H, 128, dtype=torch.bfloat16)
    got_body, cluster = tpa.split_of(q, KH, 20, quant=quant, fused=fused)
    assert got_body == body == tpa.body_of((H // KH) * k)
    if body == tpa.BODY_TILE:
        assert cluster == 1
    else:
        assert cluster == tpa._split_plan(B, KH, (H // KH) * k, 20, H100_CAPACITY_C4)


# ---------------------------------------------------------------------------
# The emulation
# ---------------------------------------------------------------------------


def tile_emulation(q, kp, vp, table, lengths, *, window, ks=None, vs=None, fused=None):
    """The TILE body's arithmetic order. q [B, k, H, D] bf16; kp/vp ONE
    layer [n_pages, KH, page, D] (bf16, or int8 with ks/vs [n_pages, KH,
    page] f32); fused: (new_k, new_v, new_ks, new_vs, active) or None (the
    pool is not written here). Returns out [B, k, H, D] bf16."""
    B, k, H, D = q.shape
    n_pages, KH, page, _ = kp.shape
    P_max = table.shape[1]
    dt = q.dtype
    qt = tpa._columns(q, KH).float()
    C = qt.shape[2]
    lengths, table = lengths.long(), table.long()
    t_col = (torch.arange(C) % window)[None].expand(B, C)
    if fused is None:
        act = torch.ones(B, dtype=torch.bool)
        old = lengths
        lim = (lengths - window)[:, None] + t_col
    else:
        nk, nv, nks, nvs, act = fused
        act = torch.as_tensor(act)
        old = lengths - window * act.long()
        lim = torch.where(act[:, None], old[:, None] + t_col, (old - 1)[:, None].expand(B, C))
    # The pool's tokens in 64-token tiles; keys past a row's pool end are
    # masked (and their V rows selected away).
    pool_end = old.clamp(0, P_max * page)
    lim_pool = torch.minimum(lim, (pool_end - 1)[:, None])
    carry = tpa._init_carry(B, KH, C, D, q.device)
    for j in range(-(-int(pool_end.max()) // BK)):
        x = j * BK + torch.arange(BK)
        pi = (x // page).clamp(max=P_max - 1)[None].expand(B, BK)
        pg = table.gather(1, pi).clamp(0, n_pages - 1)  # [B, BK]
        off = (x % page)[None].expand(B, BK)
        kb = kp[pg, :, off].permute(0, 2, 1, 3).contiguous()  # [B, KH, BK, D]
        vb = vp[pg, :, off].permute(0, 2, 1, 3).contiguous()
        ksb = vsb = None
        if ks is not None:
            ksb = ks[pg, :, off].permute(0, 2, 1).contiguous()
            vsb = vs[pg, :, off].permute(0, 2, 1).contiguous()
        carry = tpa._key_step(qt, kb, vb, ksb, vsb, x, lim_pool, carry, dt=dt, scale=D**-0.5)
    if fused is not None:
        # The window's tokens in 64-token tiles (rows past it zeros), causal
        # within the window; an inactive row sees none.
        limw = torch.where(act[:, None], t_col, torch.full((B, C), -1))
        for w in range(-(-window // BK)):
            t = w * BK + torch.arange(BK)
            have, sel = t < window, t.clamp(max=window - 1)

            def tile(x, have=have, sel=sel):
                x = x[:, sel]  # [B, BK, KH, ...]
                x = torch.where(have.view(1, BK, *([1] * (x.ndim - 2))), x, torch.zeros_like(x))
                return x.transpose(1, 2).contiguous()

            carry = tpa._key_step(qt, tile(nk), tile(nv), None if nks is None else tile(nks),
                                  None if nvs is None else tile(nvs), t, limw, carry, dt=dt,
                                  scale=D**-0.5)
    return tpa._finish(carry, dt, k)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _inputs(window, quant, page, seed, *, H=4, KH=2, D=32, L=2):
    """bf16-valued queries; pools of L layers (bf16 values, or int8 with f32
    scales). Rows: length 0, shorter than the window, two tiles, three
    tiles; table entries past the live pages are garbage, and two live page
    ids lie past either end of the pool (clipped)."""
    rng = np.random.default_rng(seed)
    lengths = np.asarray([0, window - 5, 70 + window // 2, 150], np.int32)
    B = len(lengths)
    n_live = -(-lengths // page)
    P_max = int(n_live.max()) + 1
    n_pages = int(n_live.sum()) + 2
    table = rng.integers(-3, 10**6, (B, P_max)).astype(np.int32)
    ids = rng.permutation(np.arange(1, n_pages - 1))
    o = 0
    for b in range(B):
        table[b, :n_live[b]] = ids[o:o + n_live[b]]
        o += n_live[b]
    table[3, 1], table[2, 0] = n_pages + 3, -2
    q = np.asarray(_bf16(torch.from_numpy(rng.standard_normal((B, window, H, D))
                                          .astype(np.float32))))
    kf = rng.standard_normal((L, n_pages, KH, page, D)).astype(np.float32)
    vf = rng.standard_normal((L, n_pages, KH, page, D)).astype(np.float32)
    if quant:
        kq, ksc = (np.asarray(a) for a in jllama._kv_quantize(jnp.asarray(kf)))
        vq, vsc = (np.asarray(a) for a in jllama._kv_quantize(jnp.asarray(vf)))
        pools = (kq, vq, ksc[..., 0], vsc[..., 0])
    else:
        pools = (np.asarray(_bf16(torch.from_numpy(kf))), np.asarray(_bf16(torch.from_numpy(vf))),
                 None, None)
    return rng, q, table, lengths, pools


def _gaps(out, ref):
    """(max-abs, worst relative L2 of an output vector over its last dim);
    a vector with ``ref`` 0 must be 0 (as ``chip_smoke.attn_gaps``)."""
    d = out - ref
    num, den = np.linalg.norm(d, axis=-1), np.linalg.norm(ref, axis=-1)
    rel = np.where(den > 0, num / np.maximum(den, 1e-30), np.where(num > 0, np.inf, 0.0))
    return float(np.abs(d).max()), float(rel.max())


def _t(a, dtype=None):
    x = torch.from_numpy(np.array(a, copy=True))
    return x if dtype is None else x.to(dtype)


def _torch_pools(pools, layer):
    """One layer of the pools as the kernel takes them: bf16, or int8 with
    f32 scales."""
    kp, vp, ks, vs = pools
    if ks is None:
        return dict(kp=_t(kp[layer], torch.bfloat16), vp=_t(vp[layer], torch.bfloat16))
    return dict(kp=_t(kp[layer]), vp=_t(vp[layer]), ks=_t(ks[layer]), vs=_t(vs[layer]))


def _emulate(q, table, lengths, pools, layer, window, fused=None):
    a = _torch_pools(pools, layer)
    return tile_emulation(_t(q, torch.bfloat16), a["kp"], a["vp"], _t(table), _t(lengths),
                          window=window, ks=a.get("ks"), vs=a.get("vs"), fused=fused)


@pytest.mark.parametrize("page", [8, 16, 64])
@pytest.mark.parametrize("window", [24, 32])
def test_tile_emulation_matches_jax_bf16(window, page):
    """K3's chunk windows: the TILE body's order against
    ``carry_paged_attention_multi`` in interpret mode."""
    _, q, table, lengths, pools = _inputs(window, False, page, seed=window + page)
    layer = 1
    ref, *_ = jpa.carry_paged_attention_multi(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(pools[0], jnp.bfloat16),
        jnp.asarray(pools[1], jnp.bfloat16), jnp.asarray(table), jnp.asarray(lengths),
        jnp.int32(layer), window=window, interpret=True)
    out = _emulate(q, table, lengths, pools, layer, window).float().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    gap, rel = _gaps(out, ref)
    print(f"TILE body emulation vs JAX bf16, window {window}, page {page}: max-abs {gap:.3e}, "
          f"worst rel L2 of a head {rel:.3e}")
    assert gap <= TOL and rel <= REL_TOL
    assert not out[0].any()  # the length-0 row gives zeros


@pytest.mark.parametrize("page", [8, 64])
@pytest.mark.parametrize("window", [24, 32])
def test_tile_emulation_matches_jax_q8(window, page):
    """int8 chunk windows (K4's function past 16 columns) against
    ``carry_paged_attention_multi_q8`` in interpret mode."""
    _, q, table, lengths, pools = _inputs(window, True, page, seed=100 + window + page)
    layer = 1
    ref, *_ = jpa.carry_paged_attention_multi_q8(
        jnp.asarray(q, jnp.bfloat16), *(jnp.asarray(p) for p in pools), jnp.asarray(table),
        jnp.asarray(lengths), jnp.int32(layer), window=window, interpret=True)
    out = _emulate(q, table, lengths, pools, layer, window).float().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    gap, rel = _gaps(out, ref)
    print(f"TILE body emulation vs JAX int8, window {window}, page {page}: max-abs {gap:.3e}, "
          f"worst rel L2 of a head {rel:.3e}")
    assert gap <= TOL and rel <= REL_TOL
    assert not out[0].any()


@pytest.mark.parametrize("window,page", [(24, 16), (32, 8)])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_tile_emulation_matches_jax_fused(quant, window, page):
    """Fused GQA windows past 16 columns (the window's tokens as one more
    tile from the operands) against ``carry_paged_attention_fused`` in
    interpret mode, with an inactive row, on the active rows' outputs."""
    rng, q, table, lengths0, pools = _inputs(window, quant, page, seed=200 + window + quant)
    B, k, H, D = q.shape
    KH = pools[0].shape[2]
    lengths0 = np.maximum(lengths0, 1)  # the fused window follows at least one token
    act = np.asarray([True, True, False, True])
    nkf = rng.standard_normal((B, k, KH, D)).astype(np.float32)
    nvf = rng.standard_normal((B, k, KH, D)).astype(np.float32)
    if quant:
        nk, nks = (np.asarray(x) for x in jllama._kv_quantize(jnp.asarray(nkf)))
        nv, nvs = (np.asarray(x) for x in jllama._kv_quantize(jnp.asarray(nvf)))
        nks, nvs = nks[..., 0], nvs[..., 0]
    else:
        nk, nv = (np.asarray(_bf16(torch.from_numpy(x))) for x in (nkf, nvf))
        nks = nvs = None
    attn_lengths = lengths0 + k * act.astype(np.int32)
    layer = 1
    J = jnp.asarray
    dt = jnp.int8 if quant else jnp.bfloat16
    jkw = {}
    if quant:
        jkw = dict(k_scale=J(pools[2]), v_scale=J(pools[3]), new_ks=J(nks), new_vs=J(nvs))
    res = jpa.carry_paged_attention_fused(
        J(q, jnp.bfloat16), J(nk, dt), J(nv, dt), J(pools[0], dt), J(pools[1], dt), J(table),
        J(attn_lengths), J(lengths0), J(act), jnp.int32(layer), window=k, interpret=True, **jkw)
    ref = np.asarray(res[0].astype(jnp.float32))
    tdt = torch.int8 if quant else torch.bfloat16
    fused = (_t(nk, tdt), _t(nv, tdt), None if nks is None else _t(nks),
             None if nvs is None else _t(nvs), torch.from_numpy(act))
    out = _emulate(q, table, attn_lengths, pools, layer, k, fused=fused).float().numpy()
    gap, rel = _gaps(out[act], ref[act])
    print(f"TILE body emulation vs JAX fused {'int8' if quant else 'bf16'}, window {k}, "
          f"page {page}: max-abs {gap:.3e}, worst rel L2 of a head {rel:.3e} on the active rows")
    assert gap <= TOL and rel <= REL_TOL


@pytest.mark.parametrize("window", [24, 32])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_tile_emulation_equals_the_plain_version_at_page_64(quant, window):
    """At 64-token pages the TILE body's tiles are the plain version's pages:
    the same steps on the same keys, bit for bit."""
    _, q, table, lengths, pools = _inputs(window, quant, 64, seed=300 + window + quant)
    layer = 1
    a = _torch_pools(pools, layer)
    qt = _t(q, torch.bfloat16)
    plain = tpa.paged_attention_multi_ref(qt, a["kp"], a["vp"], _t(table), _t(lengths),
                                          window=window, k_scale=a.get("ks"),
                                          v_scale=a.get("vs"))
    out = _emulate(q, table, lengths, pools, layer, window)
    assert out.dtype == plain.dtype == torch.bfloat16
    assert torch.equal(out, plain)
