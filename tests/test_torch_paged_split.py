"""The SPLIT body of the paged kernel (``csrc/paged_attn.cu``: every call with
C <= 16 query columns; K3, K4, K7 and K8 at decode and verify) on the CPU.

* ``_split_plan``, the cluster size of the launch, pinned at the 7B (KH=32)
  and 13B (KH=40) decode and verify shapes under the H100's one-wave
  capacities, as ``test_torch_int4_matmul.py::test_split_count`` pins K5's.
* A test-local plain emulation of the body's arithmetic order: a row's live
  pages split over S ranks, each rank's tiles' 8-key groups dealt to its
  warps, each warp an online softmax over chunks of its keys (p rounded to
  bf16 against the warp's running maximum), the warps merged in the block,
  then the ranks in rank order, a split that saw no key skipped. It is held
  against the JAX kernels in interpret mode (``carry_paged_attention_multi``,
  ``_multi_q8`` and ``carry_paged_attention_fused``) on bf16 queries and bf16 or int8
  pools, at the card's gates (max-abs 2e-2, and the relative L2 of each
  head's output vector); each case prints the gaps it measured. This pins the rounding divergence of the SPLIT body
  (ROADMAP, deliberate divergences).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcoder_tpu.models import llama as jllama
from vcoder_tpu.ops import paged_attention as jpa
from vcoder_tpu_torch.ops import paged_attention as tpa

torch.set_num_threads(1)

NEG = -1e30
TOL = 2e-2  # the card's gates (chip_smoke.PAGED_MAX_ABS, PAGED_REL_L2)
REL_TOL = 8e-3

# One wave of the SPLIT body on an H100 80GB HBM3: the blocks resident at
# once with clusters of 1 .. 8 blocks, as paged_attn_capacity reports them
# (scripts/paged_attn_ab.py): at one column (3 blocks an SM) and at 2 to 8
# columns (2 blocks an SM, by registers).
H100_CAPACITY_C1 = (396, 396, 372, 368, 345, 372, 329, 360)
H100_CAPACITY_C4 = (264, 264, 237, 248, 235, 234, 224, 240)


@pytest.mark.parametrize("B,KH,C,p_max,cap,want", [
    (8, 32, 1, 32, H100_CAPACITY_C1, 1),   # 7B decode, the engines' B=8 step
    (1, 32, 1, 32, H100_CAPACITY_C1, 8),   # 7B decode at B=1
    (2, 32, 1, 32, H100_CAPACITY_C1, 5),   # 7B decode at B=2
    (8, 40, 1, 32, H100_CAPACITY_C1, 1),   # 13B decode
    (1, 40, 1, 32, H100_CAPACITY_C1, 8),   # 13B decode at B=1
    (2, 40, 1, 32, H100_CAPACITY_C1, 4),   # 13B decode at B=2
    (8, 32, 4, 32, H100_CAPACITY_C4, 1),   # 7B verify, window 4
    (8, 40, 4, 32, H100_CAPACITY_C4, 1),   # 13B verify: no wave holds it; 1
    (1, 40, 4, 32, H100_CAPACITY_C4, 5),   # 13B verify at B=1
], ids=["7b_b8", "7b_b1", "7b_b2", "13b_b8", "13b_b1", "13b_b2", "7b_verify", "13b_verify",
        "13b_verify_b1"])
def test_split_plan(B, KH, C, p_max, cap, want):
    """The largest split whose grid fits one wave; B * KH clusters of it
    fit, one more block a cluster would not (or the split is at 8)."""
    s = tpa._split_plan(B, KH, C, p_max, cap)
    assert s == want
    assert s == 1 or B * KH * s <= cap[s - 1]
    assert all(B * KH * t > cap[t - 1] for t in range(s + 1, 9))


def test_split_plan_stays_within_the_table():
    """No more splits than the table has pages (a rank past them would only
    carry an empty split), and a plan for a table without pages (a batch of
    length-0 rows) is one block."""
    for p_max in range(0, 9):
        s = tpa._split_plan(1, 32, 1, p_max, H100_CAPACITY_C1)
        assert 1 <= s <= max(1, p_max)
        assert s == max(1, p_max)


def test_split_body_takes_int8_and_fused_calls_up_to_16_columns():
    """Every call of C <= 16 columns takes the SPLIT body, int8 or bf16,
    fused or not; every call past 16 the TILE body."""
    for quant, fused, C in ((True, False, 1), (True, False, 16), (False, True, 4),
                            (True, True, 16), (False, False, 1), (False, False, 16)):
        assert tpa.body_of(C) == tpa.BODY_SPLIT, (quant, fused, C)
    for quant, fused, C in ((True, False, 128), (False, True, 64), (False, False, 128),
                            (False, False, 17)):
        assert tpa.body_of(C) == tpa.BODY_TILE, (quant, fused, C)
    assert tpa.SPLIT_MAX_COLUMNS == 16
    assert [tpa._nc(c) for c in (1, 2, 3, 4, 5, 8, 9, 16)] == [1, 2, 4, 4, 8, 8, 16, 16]


def test_split_of_sends_page_body_calls_to_split_0(monkeypatch):
    """``split_of`` is the one place that routes: the calls the earlier PAGE body
    took now go to the TILE body past 16 columns (cluster 1, decided before
    the card is asked anything) and to the SPLIT body at decode (the bf16
    K3 / K8 calls, with the cluster of ``_split_plan``)."""
    chunk = torch.zeros(2, 128, 32, 128, dtype=torch.bfloat16)
    assert tpa.split_of(chunk, 32, 20, quant=True, fused=False) == (tpa.BODY_TILE, 1)  # int8 chunk
    assert tpa.split_of(chunk, 32, 20, quant=False, fused=False) == (tpa.BODY_TILE, 1)  # bf16 chunk
    gqa = torch.zeros(2, 8, 32, 128, dtype=torch.bfloat16)
    assert tpa.split_of(gqa, 8, 20, quant=False, fused=True) == (tpa.BODY_TILE, 1)  # fused, C = 32
    monkeypatch.setattr(tpa, "_SPLIT", {})
    monkeypatch.setattr(tpa, "_capacity", lambda idx, quant, fused, C: H100_CAPACITY_C1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    q = torch.zeros(8, 1, 32, 128, dtype=torch.bfloat16)
    assert tpa.split_of(q, 32, 20, quant=False, fused=False) == (tpa.BODY_SPLIT, 1)  # K3 / K8 decode
    q1 = torch.zeros(1, 1, 32, 128, dtype=torch.bfloat16)
    assert tpa.split_of(q1, 32, 20, quant=False, fused=False) == (tpa.BODY_SPLIT, 8)  # B=1


# ---------------------------------------------------------------------------
# The emulation
# ---------------------------------------------------------------------------


def _bf16(x):
    return x.to(torch.bfloat16).float()


class _State:
    """One warp's online softmax over its keys: m, l per column, acc."""

    def __init__(self, C, D):
        self.m = torch.full((C,), NEG)
        self.l = torch.zeros(C)
        self.acc = torch.zeros(C, D)

    def chunk(self, qc, K, V, ksc, vsc, toks, exists, lim, lim_max, scale):
        s = (qc @ K.T) * scale  # [C, n]
        if ksc is not None:
            s = s * ksc[None]
        seen = exists[None] & (toks[None] <= lim[:, None])
        s = torch.where(seen, s, torch.full_like(s, NEG))
        m_new = torch.maximum(self.m, s.max(dim=1).values)
        alpha = torch.exp(self.m - m_new)
        p = torch.where(seen, torch.exp(s - m_new[:, None]), torch.zeros_like(s))
        self.l = alpha * self.l + p.sum(dim=1)
        pv = p if vsc is None else torch.where(seen, p * vsc[None], torch.zeros_like(p))
        pv = _bf16(pv)
        use = exists & (toks <= lim_max)  # V rows no column sees are never read
        self.acc = self.acc * alpha[:, None] + pv[:, use] @ V[use]
        self.m = m_new


def _merge(parts):
    """(m, l, acc) of several splits merged in order; a split that saw no
    key (m = -1e30) is skipped."""
    M = torch.stack([p[0] for p in parts]).max(dim=0).values
    l = torch.zeros_like(M)
    acc = torch.zeros_like(parts[0][2])
    for m_s, l_s, a_s in parts:
        live = m_s != NEG
        f = torch.where(live, torch.exp(m_s - M), torch.zeros_like(M))
        l = l + torch.where(live, f * l_s, torch.zeros_like(l))
        acc = acc + torch.where(live[:, None], f[:, None] * a_s, torch.zeros_like(acc))
    return M, l, acc


def split_emulation(q, kp, vp, table, lengths, *, window, S, ks=None, vs=None, fused=None):
    """The SPLIT body's arithmetic order in f32. q [B, k, H, D]; kp/vp ONE
    layer [n_pages, KH, page, D] (values of the pool's type); ks/vs [n_pages,
    KH, page] for int8; fused: (new_k, new_v, new_ks, new_vs, active) or
    None (the pool is not written here). Returns out [B, k, H, D], bf16
    values."""
    B, k, H, D = q.shape
    n_pages, KH, page, _ = kp.shape
    P_max = table.shape[1]
    quant = ks is not None
    group, C = H // KH, (H // KH) * window
    NC = tpa._nc(C)
    W = 8 if NC <= 4 else 4
    KC = 8 if NC <= 4 else 32 // NC
    TILE = 64 if quant else 32
    GROUPS = TILE // 8
    scale = D ** -0.5
    out = torch.zeros(B, k, H, D)
    cols = [(c // window, c % window) for c in range(C)]
    for b in range(B):
        length = int(lengths[b])
        act = bool(fused[4][b]) if fused is not None else True
        old = length - (window if (fused is not None and act) else 0)
        n_live = min(-(-old // page), P_max) if old > 0 else 0
        lim_max = old - 1
        for kh in range(KH):
            qc = torch.stack([q[b, t, kh * group + g] for g, t in cols])
            if fused is not None:
                lim = torch.full((C,), old - 1)
            else:
                lim = torch.tensor([length - window + t for _, t in cols])
            ranks = []
            for r in range(S):
                p0, p1 = r * n_live // S, (r + 1) * n_live // S
                warps = [_State(C, D) for _ in range(W)]
                if fused is not None and r == S - 1:
                    nk, nv, nks, nvs, _ = fused
                    limw = torch.tensor([t if act else -1 for _, t in cols])
                    wmax = window - 1 if act else -1
                    for g in range(0, wmax + 1, 8):
                        for h in range(0, 8, KC):
                            i = g + h
                            if i > wmax:
                                break
                            idx = torch.arange(i, i + KC)
                            exists = idx < window
                            sel = idx.clamp(max=window - 1)
                            warps[(g // 8) % W].chunk(
                                qc, nk[b, sel, kh], nv[b, sel, kh],
                                nks[b, sel, kh] if quant else None,
                                nvs[b, sel, kh] if quant else None,
                                idx, exists, limw, wmax, scale)
                tpp = -(-page // TILE)
                n_tiles = 0
                if p1 > p0:
                    last = min(page, lim_max + 1 - (p1 - 1) * page)
                    n_tiles = (p1 - p0 - 1) * tpp + -(-last // TILE)
                for it in range(n_tiles):
                    j, sub = p0 + it // tpp, it % tpp
                    tok0 = j * page + sub * TILE
                    n = min(TILE, page - sub * TILE)
                    pg = min(max(int(table[b, j]), 0), n_pages - 1)
                    for gi in range(-(-n // 8)):
                        if tok0 + 8 * gi > lim_max:
                            break
                        w = (it * GROUPS + gi) % W
                        for h in range(0, 8, KC):
                            i = sub * TILE + 8 * gi + h  # key within the page
                            keys = slice(i, i + KC)
                            toks = tok0 - sub * TILE + torch.arange(i, i + KC)
                            warps[w].chunk(
                                qc, kp[pg, kh, keys], vp[pg, kh, keys],
                                ks[pg, kh, keys] if quant else None,
                                vs[pg, kh, keys] if quant else None,
                                toks, torch.ones(KC, dtype=torch.bool), lim, lim_max, scale)
                ranks.append(_merge([(s.m, s.l, s.acc) for s in warps]))
            _, l, acc = _merge(ranks)
            o = _bf16(acc / torch.where(l == 0, torch.ones_like(l), l)[:, None])
            for c, (g, t) in enumerate(cols):
                out[b, t, kh * group + g] = o[c]
    return out


def _inputs(window, quant, seed, *, H=8, KH=4, page=8, D=32, L=2):
    """bf16-valued queries; pools of L layers (bf16 values, or int8 with
    f32 scales); rows: a length-0 row (or one whose window is its only
    tokens), a window across a page boundary, a row of several pages."""
    rng = np.random.default_rng(seed)
    B, P_max, n_pages = 3, 6, 20
    lengths = np.asarray([0, page + window // 2 + 1, 4 * page + 5], np.int32)
    lengths[1] = max(lengths[1], window)
    table = rng.integers(-3, 10**6, (B, P_max)).astype(np.int32)  # garbage past the live pages
    ids = rng.permutation(np.arange(1, n_pages - 1))
    o = 0
    for b in range(B):
        n_live = -(-int(lengths[b]) // page)
        table[b, :n_live] = ids[o:o + n_live]
        o += n_live
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


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _pool_args(pools, layer):
    kp, vp, ks, vs = pools
    return dict(kp=_t(kp[layer]).float(), vp=_t(vp[layer]).float(),
                ks=None if ks is None else _t(ks[layer]), vs=None if vs is None else _t(vs[layer]))


@pytest.mark.parametrize("window", [1, 4])
@pytest.mark.parametrize("S", [1, 3])
def test_split_emulation_matches_jax_q8(window, S):
    """K4's SPLIT body against ``carry_paged_attention_multi_q8`` in
    interpret mode: int8 pools, GQA (8 query heads over 4), a length-0 row."""
    _, q, table, lengths, pools = _inputs(window, True, seed=10 * window + S)
    layer = 1
    ref, *_ = jpa.carry_paged_attention_multi_q8(
        jnp.asarray(q, jnp.bfloat16), *(jnp.asarray(p) for p in pools), jnp.asarray(table),
        jnp.asarray(lengths), jnp.int32(layer), window=window, interpret=True)
    a = _pool_args(pools, layer)
    out = split_emulation(_t(q), a["kp"], a["vp"], _t(table), _t(lengths), window=window, S=S,
                          ks=a["ks"], vs=a["vs"])
    ref = np.asarray(ref.astype(jnp.float32))
    gap, rel = _gaps(out.numpy(), ref)
    print(f"SPLIT body emulation vs JAX int8, window {window}, S={S}: max-abs {gap:.3e}, "
          f"worst rel L2 of a head {rel:.3e}")
    assert gap <= TOL and rel <= REL_TOL
    assert not out[0].any()  # the length-0 row gives zeros


@pytest.mark.parametrize("window", [1, 4])
@pytest.mark.parametrize("S", [1, 3])
def test_split_emulation_matches_jax_bf16(window, S):
    """K3 and K8's SPLIT body (bf16 pools, unfused) against
    ``carry_paged_attention_multi`` in interpret mode: GQA (8 query heads
    over 4), a length-0 row."""
    _, q, table, lengths, pools = _inputs(window, False, seed=20 * window + S)
    layer = 1
    ref, *_ = jpa.carry_paged_attention_multi(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(pools[0], jnp.bfloat16),
        jnp.asarray(pools[1], jnp.bfloat16), jnp.asarray(table), jnp.asarray(lengths),
        jnp.int32(layer), window=window, interpret=True)
    a = _pool_args(pools, layer)
    out = split_emulation(_t(q), a["kp"], a["vp"], _t(table), _t(lengths), window=window, S=S)
    ref = np.asarray(ref.astype(jnp.float32))
    gap, rel = _gaps(out.numpy(), ref)
    print(f"SPLIT body emulation vs JAX bf16, window {window}, S={S}: max-abs {gap:.3e}, "
          f"worst rel L2 of a head {rel:.3e}")
    assert gap <= TOL and rel <= REL_TOL
    assert not out[0].any()  # the length-0 row gives zeros


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("window", [1, 4])
@pytest.mark.parametrize("S", [1, 3])
def test_split_emulation_matches_jax_fused(quant, window, S):
    """K7's SPLIT body (the window's keys in the last rank) against
    ``carry_paged_attention_fused`` in interpret mode, with an inactive
    row, on the active rows' outputs."""
    rng, q, table, lengths0, pools = _inputs(window, quant, seed=100 + 10 * window + S + quant)
    B, k, H, D = q.shape
    KH = pools[0].shape[2]
    lengths0 = np.maximum(lengths0, 1)  # the fused window follows at least one token
    act = np.asarray([True, False, True])
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
    a = _pool_args(pools, layer)
    fused = (_t(nk).float(), _t(nv).float(), None if nks is None else _t(nks),
             None if nvs is None else _t(nvs), act)
    out = split_emulation(_t(q), a["kp"], a["vp"], _t(table), _t(attn_lengths), window=k, S=S,
                          ks=a["ks"], vs=a["vs"], fused=fused).numpy()
    gap, rel = _gaps(out[act], ref[act])
    print(f"SPLIT body emulation vs JAX fused {'int8' if quant else 'bf16'}, window {k}, "
          f"S={S}: max-abs {gap:.3e}, worst rel L2 of a head {rel:.3e} on the active rows")
    assert gap <= TOL and rel <= REL_TOL
