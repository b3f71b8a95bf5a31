"""Weight quantization and ``qmatmul``: the port against ``vcoder_tpu.ops.quant``.

Mirrors tests/test_w8a8.py case by case on the same numpy inputs: the
quantized bytes and scales, the nibble packing, the W8A8 branch and its
threshold, the upcast and nibble-split paths below it, the stacked 3-D leaf
(its ``[L, 1, out]`` scale, T == L included), the W8A8 switch and the
straight-through gradient. Tolerances: bit-equal where both packages do the
same f32 operations in the same order (quantization, the W8A8 epilogue in
f32); one bf16 ulp for the W8A8 product in bf16; 1e-5 (f32) and 2e-2 (bf16)
where the two frameworks sum a float matmul in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcoder_tpu.ops import quant as jq
from vcoder_tpu_torch.ops import quant as tq

torch.set_num_threads(1)

_DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _weights(shape, seed=0):
    return (np.random.RandomState(seed).randn(*shape) * 0.05).astype(np.float32)


_jquantize = jax.jit(jq.quantize, static_argnames=("bits",))


def _both(w_np, bits):
    """The same float weight quantized by each package (JAX's ``quantize``
    under jit, as its ``quantize_params`` runs it)."""
    return _jquantize(jnp.asarray(w_np), bits=bits), tq.quantize(torch.from_numpy(w_np), bits=bits)


def _tokens(n, dtype, k=64, seed=1):
    x = np.random.RandomState(seed).randn(n, k).astype(np.float32)
    jd, td = _DT[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(64, 96), (2, 64, 96)])
def test_quantize_bytes_and_scales_match_jax(bits, shape):
    w = _weights(shape)
    w[..., 3, :] = 0.0  # a zero row changes no absmax; a zero column needs the floor
    w[..., :, 5] = 0.0
    jw, tw = _both(w, bits)
    assert tw.bits == jw.bits == bits
    assert tuple(tw.shape) == tuple(jw.shape) == shape and tw.ndim == jw.ndim
    np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw.q))
    np.testing.assert_array_equal(tw.scale.numpy(), np.asarray(jw.scale))
    np.testing.assert_array_equal(tq.dequantize(tw).numpy(), np.asarray(jq.dequantize(jw)))
    # Eager JAX divides by qmax where jit multiplies by its f32 reciprocal:
    # the scales agree to one f32 ulp.
    eager = jq.quantize(jnp.asarray(w), bits=bits)
    np.testing.assert_allclose(tw.scale.numpy(), np.asarray(eager.scale), rtol=1.2e-7, atol=0)
    assert tq.base_weight_dtype(tw) == ("int4" if bits == 4 else torch.int8)
    assert tq.base_weight_dtype(torch.zeros(2)) == torch.float32


def test_pack_unpack_match_jax_and_round_trip():
    vals = np.random.RandomState(3).randint(-8, 8, (2, 64, 96)).astype(np.int8)
    packed = tq.pack_int4(torch.from_numpy(vals))
    assert packed.shape == (2, 32, 96) and packed.dtype == torch.int8
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jq.pack_int4(jnp.asarray(vals))))
    np.testing.assert_array_equal(tq.unpack_int4(packed).numpy(), vals)
    every_byte = np.arange(-128, 128, dtype=np.int8)[:, None]
    np.testing.assert_array_equal(
        tq.unpack_int4(torch.from_numpy(every_byte)).numpy(),
        np.asarray(jq.unpack_int4(jnp.asarray(every_byte))),
    )
    with pytest.raises(ValueError, match="even"):
        tq.quantize(torch.zeros(63, 8), bits=4)


def test_quantized_tensor_indexing_and_device():
    _, tw = _both(_weights((3, 64, 96)), 4)
    layer = tw[1]
    assert tuple(layer.shape) == (64, 96) and layer.q.shape == (32, 96)
    assert layer.scale.shape == (1, 96) and layer.bits == 4
    assert torch.equal(layer.q, tw.q[1]) and torch.equal(layer.scale, tw.scale[1])
    moved = tw.to("cpu")
    assert moved.q.device.type == moved.scale.device.type == "cpu"
    assert torch.equal(moved.q, tw.q) and moved.bits == 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_w8a8_engages_at_threshold_and_matches_jax(dtype, bits):
    """At W8A8_MIN_TOKENS both packages take the integer path (int4 after
    unpacking); bit-equal in f32, within one bf16 ulp in bf16."""
    jw, tw = _both(_weights((64, 96)), bits)
    jx, tx = _tokens(tq.W8A8_MIN_TOKENS, dtype)
    got = tq.qmatmul(tx, tw)
    jqv = jq.unpack_int4(jw.q) if bits == 4 else jw.q
    want = np.asarray(jq._w8a8_matmul(jx, jqv, jw.scale).astype(jnp.float32))
    np.testing.assert_array_equal(np.asarray(jq.qmatmul(jx, jw).astype(jnp.float32)), want)
    assert got.dtype == tx.dtype and got.shape == (tq.W8A8_MIN_TOKENS, 96)
    if dtype == "float32":
        np.testing.assert_array_equal(_np(got), want)
    else:
        assert np.all(np.abs(_np(got) - want) <= 2.0 ** -7 * np.abs(want))
    # The integer path is not the upcast path.
    upcast = tq.qmatmul(tx[:-1], tw)
    assert not np.allclose(_np(got)[:-1], _np(upcast), rtol=0, atol=0)


def test_w8a8_exact_when_activations_representable():
    """Rows built as (int8 grid) * row scale round-trip the activation
    quantizer exactly: the W8A8 product equals the integer oracle."""
    _, tw = _both(_weights((64, 96)), 8)
    rng = np.random.RandomState(2)
    M = tq.W8A8_MIN_TOKENS
    xq = rng.randint(-127, 128, size=(M, 64)).astype(np.float32)
    xq[:, 0] = 127.0
    row_scale = (rng.rand(M, 1).astype(np.float32) + 0.5) / 64.0
    got = tq.qmatmul(torch.from_numpy(xq * row_scale), tw).double().numpy()
    acc = xq.astype(np.int64) @ tw.q.numpy().astype(np.int64)
    want = acc * row_scale.astype(np.float64) * tw.scale.numpy().astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_below_threshold_matches_jax(dtype, bits):
    """Below the threshold: the int8 upcast path and the int4 nibble-split
    path (the port's CPU route), against JAX and the unpacked oracle."""
    jw, tw = _both(_weights((64, 96)), bits)
    jx, tx = _tokens(tq.W8A8_MIN_TOKENS - 1, dtype)
    got = _np(tq.qmatmul(tx, tw))
    tol = _TOL[dtype]
    np.testing.assert_allclose(got, _np(jq.qmatmul(jx, jw)), rtol=tol, atol=tol)
    q = tq.unpack_int4(tw.q) if bits == 4 else tw.q
    oracle = _np((tx @ q.to(tx.dtype)) * tw.scale.to(tx.dtype))
    np.testing.assert_allclose(got, oracle, rtol=tol, atol=tol)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("T", [tq.W8A8_MIN_TOKENS // 2, 2])
def test_stacked_3d_leaf_stays_on_upcast_path(bits, T):
    """A stacked [L, in, out] leaf fed directly never takes the W8A8 branch,
    and its [L, 1, out] scale broadcasts per layer, also when T == L."""
    jw, tw = _both(_weights((2, 64, 96), seed=4), bits)
    x = np.random.RandomState(5).randn(2, T, 64).astype(np.float32)
    got = tq.qmatmul(torch.from_numpy(x), tw).numpy()
    np.testing.assert_allclose(got, np.asarray(jq.qmatmul(jnp.asarray(x), jw)), rtol=1e-5,
                               atol=1e-5)
    want = np.einsum("lti,lio->lto", x, tq.dequantize(tw).numpy())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_set_w8a8_false_takes_the_upcast_path(monkeypatch):
    jw, tw = _both(_weights((64, 96)), 8)
    jx, tx = _tokens(tq.W8A8_MIN_TOKENS, "float32")
    assert tq.w8a8_enabled()
    monkeypatch.setattr(jq, "_W8A8_ENABLED", False)
    tq.set_w8a8(False)
    try:
        assert not tq.w8a8_enabled()
        got = tq.qmatmul(tx, tw).numpy()
    finally:
        tq.set_w8a8(True)
    np.testing.assert_allclose(got, np.asarray(jq.qmatmul(jx, jw)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, ((tx @ tw.q.float()) * tw.scale).numpy(), rtol=1e-6,
                               atol=1e-6)


def test_threshold_is_read_at_call_time(monkeypatch):
    _, tw = _both(_weights((64, 96)), 8)
    _, tx = _tokens(16, "float32")
    below = tq.qmatmul(tx, tw)
    monkeypatch.setattr(tq, "W8A8_MIN_TOKENS", 16)
    at = tq.qmatmul(tx, tw)
    want = tq._W8A8Matmul.apply(tx, tw.q, tw.scale)
    assert torch.equal(at, want) and not torch.equal(at, below)


def test_w8a8_gradient_is_straight_through():
    """dx through the W8A8 product equals JAX's custom_vjp (rel 5e-3, the
    bf16 noise floor of the backward product) and the dequantized weight's
    gradient."""
    jw, tw = _both(_weights((64, 96)), 8)
    M = tq.W8A8_MIN_TOKENS
    x = np.random.RandomState(4).randn(M, 64).astype(np.float32)
    g = np.random.RandomState(5).randn(M, 96).astype(np.float32)
    tx = torch.from_numpy(x).requires_grad_(True)
    (tq.qmatmul(tx, tw) * torch.from_numpy(g)).sum().backward()
    dx = tx.grad.double().numpy()
    dx_jax = np.asarray(jax.grad(lambda xx: (jq.qmatmul(xx, jw) * g).sum())(jnp.asarray(x)),
                        np.float64)
    dx_ref = g.astype(np.float64) @ tq.dequantize(tw).double().numpy().T
    for ref in (dx_jax, dx_ref):
        assert np.linalg.norm(dx - ref) / np.linalg.norm(ref) < 5e-3
    assert np.abs(dx).sum() > 0  # not the dx == 0 trap


def test_plain_weights_promote_and_lora_raises():
    x = torch.ones(2, 4, dtype=torch.float32)
    w = torch.ones(4, 3, dtype=torch.bfloat16)
    assert tq.qmatmul(x, w).dtype == torch.float32

    class LoraWeight:
        pass

    with pytest.raises(NotImplementedError, match="LoRA"):
        tq.qmatmul(x, LoraWeight())
