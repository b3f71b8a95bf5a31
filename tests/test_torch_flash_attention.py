"""The port's flash-attention forward (plain version, on the CPU) against the
JAX package's Pallas kernel in interpret mode and its jnp oracle.

Same f32 inputs, made with numpy, go to both packages. The port's kernel
wrapper takes its plain version for CPU tensors, so these tests pin the
plain version's arithmetic, which ``chip_smoke.py`` then holds the CUDA
kernel to on the card. Tolerance: 1e-5 absolute (f32) on outputs and LSE.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcoder_tpu.ops import attention as jattn
from vcoder_tpu.ops import flash_attention as jfa
from vcoder_tpu_torch.ops import attention as tattn
from vcoder_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

ATOL = 1e-5


def _jax_flash_with_lse(q, k, v, pos, mask, causal, diag):
    """Output and LSE of the JAX forward kernel, prepared as the public
    wrapper prepares them (flash_attention.py:756-799)."""
    B, T, H, D = q.shape
    S = k.shape[1]
    bq, bk = jfa._pick_block(T, 512), jfa._pick_block(S, 512)
    Tp, Sp = -(-T // bq) * bq, -(-S // bk) * bk
    qp = np.pad(q, ((0, 0), (0, Tp - T), (0, 0), (0, 0)))
    posp = np.pad(pos, ((0, 0), (0, Tp - T)))
    kp = np.pad(k, ((0, 0), (0, Sp - S), (0, 0), (0, 0)))
    vp = np.pad(v, ((0, 0), (0, Sp - S), (0, 0), (0, 0)))
    maskp = np.pad(mask, ((0, 0), (0, Sp - S)))
    out, lse = jfa._flash_fwd(
        jnp.asarray(qp.transpose(0, 2, 1, 3)),
        jnp.asarray(kp.transpose(0, 2, 1, 3)),
        jnp.asarray(vp.transpose(0, 2, 1, 3)),
        jnp.asarray(posp[:, None, :].astype(np.int32)),
        jnp.asarray(maskp[:, None, :].astype(np.int32)),
        causal, bq, bk, True, (T, S) if diag else None,
    )
    return np.asarray(out).transpose(0, 2, 1, 3)[:, :T], np.asarray(lse)[:, :, :T, 0]


def _case(B, T, S, H, KH, D, *, seed, n_valid=None, holes=False, dead_row=False,
          positions="cache"):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, T, H, D).astype(np.float32)
    k = rng.randn(B, S, KH, D).astype(np.float32)
    v = rng.randn(B, S, KH, D).astype(np.float32)
    if positions == "cache":
        # Prefill into a cache: positions from 0, ragged rows, pad rows at 0.
        n_valid = n_valid or [T] * B
        pos = np.zeros((B, T), np.int32)
        mask = np.zeros((B, S), np.int32)
        for b, n in enumerate(n_valid):
            pos[b, :n] = np.arange(n)
            mask[b, :n] = 1
    elif positions == "non_monotone":
        # Row 0 left-padded (pad keys hidden, pad queries at position 0);
        # the other rows with the positions of rows 8..23 permuted.
        pos = np.broadcast_to(np.arange(T, dtype=np.int32) + (S - T), (B, T)).copy()
        mask = np.ones((B, S), np.int32)
        pos[0, :7], mask[0, :7] = 0, 0
        pos[1:, 8:24] = pos[1:, 8:24][:, rng.permutation(16)]
    else:
        pos = np.broadcast_to(np.arange(T, dtype=np.int32) + (S - T), (B, T)).copy()
        mask = np.ones((B, S), np.int32)
    if holes:
        mask[:, rng.rand(S) < 0.25] = 0
    if dead_row:
        mask[B - 1, : pos[B - 1, 0] + 1] = 0
    return q, k, v, pos, mask


CASES = {
    # causal prefill into a cache: S > T, positions from 0, ragged rows
    "cache_s_gt_t": (dict(B=2, T=40, S=56, H=4, KH=4, D=16, seed=0, n_valid=[40, 29]), True, True),
    # bounded (right-aligned) default positions
    "bounded_positions": (dict(B=1, T=48, S=48, H=2, KH=2, D=16, seed=1, positions="aligned"), True, True),
    # kv_mask holes
    "kv_mask_holes": (dict(B=2, T=24, S=37, H=2, KH=2, D=8, seed=2, positions="aligned", holes=True), True, True),
    # a row whose every visible key is masked
    "fully_masked_row": (dict(B=2, T=20, S=30, H=2, KH=2, D=8, seed=3, positions="aligned", dead_row=True), True, True),
    # grouped-query attention, 4 query heads per KV pair
    "gqa": (dict(B=2, T=33, S=45, H=4, KH=2, D=16, seed=4, n_valid=[33, 17]), True, True),
    # positions that are not monotone: a left-padded row, a permuted run
    "non_monotone": (dict(B=2, T=40, S=40, H=4, KH=2, D=16, seed=7, positions="non_monotone"), True, False),
    # bidirectional with key holes
    "non_causal": (dict(B=2, T=19, S=27, H=4, KH=2, D=8, seed=5, positions="aligned", holes=True), False, False),
}


@pytest.mark.parametrize("name", list(CASES))
def test_flash_plain_matches_jax_kernel(name):
    kw, causal, diag = CASES[name]
    q, k, v, pos, mask = _case(**kw)
    j_out, j_lse = _jax_flash_with_lse(q, k, v, pos, mask, causal, diag)
    t_out, t_lse = tfa.flash_fwd(
        *(torch.from_numpy(a) for a in (q, k, v, pos, mask)), causal=causal
    )
    np.testing.assert_allclose(t_out.numpy(), j_out, atol=ATOL, rtol=0)
    np.testing.assert_allclose(t_lse.numpy(), j_lse, atol=ATOL, rtol=1e-6)
    # The public wrapper agrees with the kernel entry point.
    pub = jfa.flash_attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=causal,
        q_positions=jnp.asarray(pos), kv_mask=jnp.asarray(mask),
        interpret=True, bounded_positions=diag,
    )
    t_pub = tfa.flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        q_positions=torch.from_numpy(pos), kv_mask=torch.from_numpy(mask),
    )
    np.testing.assert_allclose(t_pub.numpy(), np.asarray(pub), atol=ATOL, rtol=0)
    # Against the jnp oracle, on every row that sees at least one key (the
    # oracle averages v uniformly over a fully-masked row; flash gives 0).
    ref = np.asarray(jattn.xla_attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=causal,
        q_positions=jnp.asarray(pos), kv_mask=jnp.asarray(mask),
    ))
    vis = np.broadcast_to(mask[:, None, :].astype(bool), (q.shape[0], q.shape[1], k.shape[1]))
    if causal:
        vis = vis & (np.arange(k.shape[1])[None, None, :] <= pos[:, :, None])
    live = vis.any(-1)
    np.testing.assert_allclose(t_out.numpy()[live], ref[live], atol=ATOL, rtol=0)
    if name == "fully_masked_row":
        assert not live.all()
        assert np.all(t_out.numpy()[~live] == 0.0)


@pytest.mark.parametrize("T", [1, 9, 40])
def test_dispatch_matches_jax_xla_attention(T):
    """multi_head_attention: decode-sized T takes the plain route, long T
    the flash route; both equal the JAX oracle on live rows."""
    q, k, v, pos, mask = _case(B=2, T=T, S=48, H=4, KH=2, D=16, seed=6, positions="aligned")
    ref = jattn.xla_attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=True,
        q_positions=jnp.asarray(pos), kv_mask=jnp.asarray(mask),
    )
    out = tattn.multi_head_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=True,
        q_positions=torch.from_numpy(pos), kv_mask=torch.from_numpy(mask),
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_sdpa_causal_yardstick_only_for_prefix_rows():
    """``chip_smoke.py`` times SDPA's causal form beside K1 only where it
    computes the same function: every row's first n queries at positions
    0..n-1 over exactly the first n keys, the rest padding."""
    import chip_smoke

    T, S, n = 48, 56, 40
    pos = np.zeros((2, T), np.int32)
    pos[:, :n] = np.arange(n)
    mask = np.zeros((2, S), np.int32)
    mask[:, :n] = 1
    case = dict(causal=True, np_pos=pos, np_mask=mask)
    assert chip_smoke._causal_prefix(case) == n
    assert chip_smoke._causal_prefix(dict(case, causal=False)) == 0
    for edit in (lambda p, m: m.__setitem__((1, 3), 0),          # a key hole
                 lambda p, m: m.__setitem__((1, n), 1),          # one more key in row 1
                 lambda p, m: p.__setitem__((0, slice(8, 10)), [9, 8])):  # swapped positions
        p, m = pos.copy(), mask.copy()
        edit(p, m)
        assert chip_smoke._causal_prefix(dict(case, np_pos=p, np_mask=m)) == 0


def test_k6_flash_yardstick_takes_the_longest_right_padded_row():
    """``chip_smoke.py`` times SDPA's causal backward beside K6 over the
    first L_max rows and keys of every sequence only where each row is a
    right-padded prefix (queries 0..n-1 at positions 0..n-1 over exactly keys
    0..n-1, n per row), L_max the longest such row."""
    import chip_smoke

    T, lens = 64, [50, 57, 41]
    pos = np.zeros((3, T), np.int32)
    mask = np.zeros((3, T), np.int32)
    for b, n in enumerate(lens):
        pos[b, :n] = np.arange(n)
        mask[b, :n] = 1
    case = dict(causal=True, np_pos=pos, np_mask=mask)
    assert chip_smoke._causal_prefix_max(case) == 57
    assert chip_smoke._causal_prefix_max(dict(case, causal=False)) == 0
    # More keys than queries, the extra ones hidden: the same prefixes.
    wide = np.concatenate([mask, np.zeros((3, 8), np.int32)], axis=1)
    assert chip_smoke._causal_prefix_max(dict(case, np_mask=wide)) == 57
    # Rows of different lengths are not K1's (one length) yardstick.
    assert chip_smoke._causal_prefix(case) == 0
    for edit in (lambda p, m: m.__setitem__((1, 3), 0),          # a key hole
                 lambda p, m: m.__setitem__((2, 45), 1),         # a key past row 2's prefix
                 lambda p, m: p.__setitem__((0, slice(8, 10)), [9, 8]),  # swapped positions
                 lambda p, m: (m.__setitem__((0, slice(0, 5)), 0),   # a left-padded row
                               m.__setitem__((0, slice(50, 55)), 1))):
        p, m = pos.copy(), mask.copy()
        edit(p, m)
        assert chip_smoke._causal_prefix_max(dict(case, np_pos=p, np_mask=m)) == 0
