"""The port's flash-attention backward (``FlashAttention``, whose CPU
backward is ``flash_bwd_ref``, the plain version of ``csrc/flash_bwd.cu``)
against the JAX package on the CPU.

Identical numpy inputs go through ``jax.grad`` of the Pallas
``flash_attention`` in interpret mode (blocks of 128, as
``tests/test_flash_attention.py`` runs it), ``jax.grad`` of ``xla_attention``
and ``torch.autograd`` through the port's ``flash_attention``; the loss is
``sum(sin(out))``. Tolerances (f32): 3e-4 absolute + 1e-3 relative, those of
the JAX package's own backward tests; bf16 inputs: 2e-2 of the gradient's
largest magnitude (one bf16 step of P or dS on a rounding boundary, summed
over the keys).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcoder_tpu.ops.attention import xla_attention as j_xla_attention
from vcoder_tpu.ops.flash_attention import flash_attention as j_flash_attention
from vcoder_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

ATOL, RTOL = 3e-4, 1e-3


def _inputs(seed, B, T, S, H, KH, D, *, lens=None, holes=False, dead_row=False,
            offset=None, shuffle_pos=False):
    """q/k/v and the output gradient as numpy, plus int32 positions [B, T]
    and a bool key mask [B, S] (None when every key is valid)."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, T, H, D).astype(np.float32)
    k = rng.randn(B, S, KH, D).astype(np.float32)
    v = rng.randn(B, S, KH, D).astype(np.float32)
    g = rng.randn(B, T, H, D).astype(np.float32)
    base = (S - T) if offset is None else offset
    pos = np.broadcast_to(np.arange(T, dtype=np.int32) + base, (B, T)).copy()
    if shuffle_pos:
        pos = np.stack([rng.permutation(pos[b]) for b in range(B)]).astype(np.int32)
    mask = None
    if lens is not None or holes or dead_row:
        mask = np.ones((B, S), bool)
        if lens is not None:
            mask = np.arange(S)[None, :] < np.asarray(lens)[:, None]
        if holes:
            mask &= rng.rand(B, S) > 0.2
        if dead_row:
            mask[B - 1, : pos[B - 1, 0] + 1] = False  # row (B-1, 0) sees no key
    return q, k, v, g, pos, mask


def _jax_grads(fn, q, k, v, g, pos, mask, causal, dtype):
    def loss(q, k, v):
        o = fn(q, k, v, causal=causal, q_positions=jnp.asarray(pos),
               kv_mask=None if mask is None else jnp.asarray(mask))
        return jnp.sum(jnp.sin(o.astype(jnp.float32)) * g)

    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    return [np.asarray(x, np.float32) for x in jax.grad(loss, argnums=(0, 1, 2))(*args)]


def _pallas(q, k, v, *, causal, q_positions, kv_mask):
    return j_flash_attention(q, k, v, causal=causal, q_positions=q_positions, kv_mask=kv_mask,
                             block_q=128, block_k=128, interpret=True)


def _port_grads(q, k, v, g, pos, mask, causal, dtype):
    tq, tk, tv = (torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=causal, q_positions=torch.from_numpy(pos),
                             kv_mask=None if mask is None else torch.from_numpy(mask))
    loss = (torch.sin(out.float()) * torch.from_numpy(g)).sum()
    return [x.float().numpy() for x in torch.autograd.grad(loss, (tq, tk, tv))]


CASES = {
    "causal": dict(seed=0, B=2, T=160, S=160, H=2, KH=2, D=32),
    "bidirectional_unaligned": dict(seed=1, B=1, T=130, S=130, H=2, KH=2, D=64, causal=False),
    "gqa_h4_kh2": dict(seed=2, B=2, T=140, S=140, H=4, KH=2, D=32),
    "ragged_kv_mask": dict(seed=3, B=2, T=150, S=150, H=2, KH=2, D=32, lens=[110, 150]),
    "t_lt_s_explicit_positions": dict(seed=4, B=2, T=70, S=200, H=4, KH=2, D=32,
                                      lens=[150, 200], offset=60, shuffle_pos=True),
    "gqa_ragged_bidirectional": dict(seed=5, B=2, T=100, S=100, H=6, KH=3, D=32,
                                     lens=[70, 100], holes=True, causal=False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_grads_match_pallas_interpret_and_xla(name):
    kw = dict(CASES[name])
    causal = kw.pop("causal", True)
    q, k, v, g, pos, mask = _inputs(**kw)
    port = _port_grads(q, k, v, g, pos, mask, causal, torch.float32)
    pallas = _jax_grads(_pallas, q, k, v, g, pos, mask, causal, jnp.float32)
    xla = _jax_grads(j_xla_attention, q, k, v, g, pos, mask, causal, jnp.float32)
    for a, b, c, nm in zip(port, pallas, xla, "qkv"):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL, err_msg=f"d{nm} vs Pallas")
        np.testing.assert_allclose(a, c, atol=ATOL, rtol=RTOL, err_msg=f"d{nm} vs xla")


def test_fully_masked_row_has_zero_gradients():
    """A query row that sees no key: 0 out, 0 gradient, never NaN, as the
    Pallas backward gives (xla_attention averages such a row uniformly,
    so it is no oracle here)."""
    q, k, v, g, pos, mask = _inputs(6, 2, 96, 128, 4, 2, 32, holes=True, dead_row=True)
    port = _port_grads(q, k, v, g, pos, mask, True, torch.float32)
    pallas = _jax_grads(_pallas, q, k, v, g, pos, mask, True, jnp.float32)
    for a, b, nm in zip(port, pallas, "qkv"):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL, err_msg=f"d{nm}")
    assert np.abs(port[0][1, 0]).max() == 0.0  # dq of the dead row


def test_bf16_inputs():
    q, k, v, g, pos, mask = _inputs(7, 1, 192, 192, 4, 2, 64, lens=[170])
    port = _port_grads(q, k, v, g, pos, mask, True, torch.bfloat16)
    pallas = _jax_grads(_pallas, q, k, v, g, pos, mask, True, jnp.bfloat16)
    for a, b, nm in zip(port, pallas, "qkv"):
        tol = 2e-2 * max(1.0, np.abs(b).max())
        assert np.abs(a - b).max() <= tol, (nm, np.abs(a - b).max(), tol)


def test_wrapper_takes_the_plain_version_on_cpu():
    """On CPU tensors ``flash_bwd`` is ``flash_bwd_ref`` (nothing launched,
    the counter stays 0); a dout with any strides is accepted."""
    q, k, v, g, pos, mask = _inputs(8, 2, 40, 56, 4, 2, 16, lens=[50, 56])
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    tpos, tmask = torch.from_numpy(pos), torch.from_numpy(mask)
    out, lse = fa.flash_fwd(tq, tk, tv, tpos, tmask, causal=True)
    fa.bwd_launches = 0
    dout = tg.transpose(1, 2).contiguous().transpose(1, 2)  # same values, other strides
    got = fa.flash_bwd(tq, tk, tv, out, lse, dout, tpos, tmask, causal=True)
    ref = fa.flash_bwd_ref(tq, tk, tv, out, lse, tg, tpos, tmask, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert fa.bwd_launches == 0
    assert [x.shape for x in got] == [tq.shape, tk.shape, tv.shape]


def test_function_gives_no_gradient_to_positions_or_mask():
    q, k, v, g, pos, mask = _inputs(9, 1, 24, 24, 2, 2, 16, lens=[20])
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fa.FlashAttention.apply(tq, tk, tv, torch.from_numpy(pos), torch.from_numpy(mask), True)
    assert out.grad_fn is not None and out.grad_fn.name().endswith("FlashAttentionBackward")
    out.sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (tq, tk, tv))


def test_chip_k6_gates_on_plain_gradients():
    """``chip_smoke.flash_bwd_agreement`` (the card's K6 check) passes the
    plain gradients against themselves and with a one-ulp bf16 rounding
    flip, and fails a key tile left out of dk and a value written into a
    pad row of dq."""
    import chip_smoke

    q, k, v, g, pos, mask = _inputs(7, 2, 130, 130, 4, 2, 128, lens=[130, 100])
    g = g * mask[:, :, None, None]  # dO is 0 on pad rows, as in training
    pos[1, 100:] = 0  # pads sit at position 0
    t = [torch.from_numpy(x) for x in (q, k, v, g, pos, mask)]
    out, lse = fa.flash_attention_ref(*t[:3], t[4], t[5], causal=True)
    ref = fa.flash_bwd_ref(*t[:3], out, lse, t[3], t[4], t[5], causal=True)
    assert chip_smoke.flash_bwd_agreement(ref, ref)["ok"]
    flip = ref[0].clone()
    flip[0, 5, 1, 3] = flip[0, 5, 1, 3] * (1 + 2.0**-7)
    assert chip_smoke.flash_bwd_agreement((flip, ref[1], ref[2]), ref)["ok"]
    dk = ref[1].clone()
    dk[0, 64:128] = 0
    agree = chip_smoke.flash_bwd_agreement((ref[0], dk, ref[2]), ref)
    assert not agree["ok"] and agree["dq"]["ok"] and not agree["dk"]["ok"]
    dq = ref[0].clone()
    dq[1, 110, 0, 0] = 1e-2
    agree = chip_smoke.flash_bwd_agreement((dq, ref[1], ref[2]), ref)
    assert not agree["dq"]["ok"] and agree["dq"]["zero_row_max"] == pytest.approx(1e-2)


def test_chip_k6_faults_change_one_line_each():
    """Every fault ``chip_smoke.py --faults`` plants names a line that occurs
    exactly once in ``csrc/flash_bwd.cu`` and changes it."""
    import chip_smoke
    from vcoder_tpu_torch.ops import _kernels

    src = (_kernels.SRC_DIR / "flash_bwd.cu").read_text()
    for old, new in chip_smoke.K6_FAULTS.values():
        assert src.count(old) == 1 and new != old
