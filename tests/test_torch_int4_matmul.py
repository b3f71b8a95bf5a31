"""The int4 decode matmul: the port's plain version against the JAX Pallas
kernel ``vcoder_tpu.ops.int4_matmul`` in interpret mode.

The shapes are those of tests/test_w8a8.py (B < 8 exercises the kernel's
sublane padding) plus an odd B of 33. Both sides round the activations to
bf16, accumulate exact bf16 x int4 products in f32 in different orders, and
round the bf16 output once: they agree to one bf16 ulp (rtol 2**-7).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcoder_tpu.ops import quant as jq
from vcoder_tpu.ops.int4_matmul import int4_matmul as jax_int4_matmul
from vcoder_tpu_torch.ops import int4_matmul as i4
from vcoder_tpu_torch.ops import quant as tq

torch.set_num_threads(1)


def _case(B, K, N, seed):
    rng = np.random.RandomState(seed)
    vals = rng.randint(-8, 8, (K, N)).astype(np.int8)
    x = rng.randn(B, K).astype(np.float32)
    return vals, np.array(jq.pack_int4(jnp.asarray(vals))), x


@pytest.mark.parametrize("B,K,N", [(1, 128, 256), (4, 256, 384), (7, 128, 128), (33, 128, 256)])
def test_plain_version_matches_pallas_kernel(B, K, N):
    vals, packed, x = _case(B, K, N, B)
    want = np.asarray(
        jax_int4_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(packed), interpret=True),
        np.float32,
    )
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = i4.int4_matmul_ref(xt, torch.from_numpy(packed))
    assert got.dtype == torch.bfloat16 and got.shape == (B, N)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7, atol=1e-6)
    # The unpacked oracle, and the CPU wrapper, which takes the plain version.
    oracle = xt.float() @ torch.from_numpy(vals).float()
    np.testing.assert_allclose(got.float().numpy(), oracle.numpy(), rtol=2.0 ** -7, atol=1e-6)
    assert torch.equal(i4.int4_matmul(xt, torch.from_numpy(packed)), got)


def test_f32_activations_round_to_bf16_as_the_kernel_does():
    """f32 x: the kernel casts the activations to bf16 and returns f32."""
    _, packed, x = _case(3, 128, 256, 9)
    want = np.asarray(jax_int4_matmul(jnp.asarray(x), jnp.asarray(packed), interpret=True))
    got = i4.int4_matmul_ref(torch.from_numpy(x), torch.from_numpy(packed))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_scaled_kernel_route_equals_the_nibble_split_path():
    """What qmatmul computes on the card (kernel, then the scale) against the
    nibble-split form it takes on the CPU, on one quantized weight."""
    rng = np.random.RandomState(1)
    w = tq.quantize(torch.from_numpy((rng.randn(256, 384) * 0.05).astype(np.float32)), bits=4)
    x = torch.from_numpy(rng.randn(5, 256).astype(np.float32))
    split = tq.qmatmul(x, w)
    kernel_route = i4.int4_matmul_ref(x, w.q) * w.scale
    # The kernel route rounds the activations to bf16 (2**-9 relative each,
    # over 256 inputs); the split form runs in f32.
    np.testing.assert_allclose(kernel_route.numpy(), split.numpy(), rtol=2e-2, atol=1e-2)


# One wave of the kernel on an H100 80GB HBM3: the blocks resident at once
# with clusters of 1 .. 8 blocks (the card's cluster occupancy, as
# int4_matmul_capacity reports it; clusters of 3 and more lose SMs to the
# GPC layout).
H100_CAPACITY = (264, 264, 237, 248, 235, 234, 224, 240)


@pytest.mark.parametrize("k_half,n,want", [(64, 256, 1), (2048, 4096, 7), (2048, 11008, 2),
                                           (5504, 4096, 7), (2048, 32000, 1)])
def test_split_count(k_half, n, want):
    """The blocks of a cluster splitting K fill the card at the 7B shapes
    in one wave (32 column tiles x 7, 86 x 2, 250 x 1); small K never
    splits."""
    assert i4._cluster_size(k_half, n, 1, H100_CAPACITY) == want
    assert want * -(-n // i4._COLS) <= H100_CAPACITY[want - 1]
    # Rows of x past 8 take more blocks, so the split shrinks.
    assert i4._cluster_size(k_half, n, 9, H100_CAPACITY) <= want


def _exact_case(B, K, N, seed):
    """Activations that are multiples of 1/4 in [-2, 2]: every product and
    every partial sum is exact in f32, so any summation order gives the same
    accumulator and the comparison isolates the roundings around it."""
    rng = np.random.RandomState(seed)
    vals = rng.randint(-8, 8, (K, N)).astype(np.int8)
    x = (rng.randint(-8, 9, (B, K)) / 4.0).astype(np.float32)
    scale = (rng.rand(1, N) * 1e-2 + 1e-3).astype(np.float32)
    return np.array(jq.pack_int4(jnp.asarray(vals))), x, scale


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_scaled_plain_version_is_bit_equal_to_the_jax_route(dtype):
    """With a scale, the plain version computes JAX's int4 route,
    ``int4_matmul(x, q) * scale.astype(x.dtype)`` (vcoder_tpu/ops/quant.py),
    bit for bit: the product rounded to x's type, times the rounded scale,
    rounded again."""
    packed, x, scale = _exact_case(5, 256, 384, 3)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = np.asarray(
        (jax_int4_matmul(jx, jnp.asarray(packed), interpret=True)
         * jnp.asarray(scale).astype(jx.dtype)).astype(jnp.float32))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    for s in (torch.from_numpy(scale), torch.from_numpy(scale).reshape(-1)):
        got = i4.int4_matmul_ref(xt, torch.from_numpy(packed), s)
        assert got.dtype == xt.dtype and got.shape == (5, 384)
        np.testing.assert_array_equal(got.float().numpy(), want)
        # The CPU wrapper takes the plain version, scale and all.
        assert torch.equal(i4.int4_matmul(xt, torch.from_numpy(packed), s), got)
    # And the scaled form is the unscaled one times the scale in x's type.
    plain = i4.int4_matmul_ref(xt, torch.from_numpy(packed))
    assert torch.equal(i4.int4_matmul_ref(xt, torch.from_numpy(packed), torch.from_numpy(scale)),
                       plain * torch.from_numpy(scale).to(xt.dtype))


@pytest.mark.parametrize("bad,err,match", [
    (torch.ones(1, 7), ValueError, "scale must be"),
    (torch.ones(2, 6), ValueError, "scale must be"),
    (torch.ones(1, 6, dtype=torch.bfloat16), TypeError, "float32"),
    (torch.ones(1, 6, device="meta"), ValueError, "scale is on"),
    (np.ones((1, 6), np.float32), TypeError, "must be a tensor"),
])
def test_wrapper_rejects_a_bad_scale(bad, err, match):
    """A scale of the wrong shape, type or device raises in the wrapper,
    before either version runs, and in the launcher before any kernel."""
    x = torch.zeros(2, 8)
    qp = torch.zeros(4, 6, dtype=torch.int8)
    with pytest.raises(err, match=match):
        i4.int4_matmul(x, qp, bad)
    with pytest.raises(err, match=match):
        i4.launch_int4_matmul(x, qp, bad)


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: it takes ``qmatmul`` down
    its kernel branch."""

    @property
    def device(self):
        return torch.device("cuda")


def test_qmatmul_cuda_route_is_one_product_with_the_scale(monkeypatch):
    """On the card, ``qmatmul`` hands a 2-D int4 weight and its scale to
    the kernel wrapper once and adds no torch work after it."""
    rng = np.random.RandomState(4)
    w = tq.quantize(torch.from_numpy((rng.randn(64, 24) * 0.05).astype(np.float32)), bits=4)
    x = torch.from_numpy(rng.randn(3, 64).astype(np.float32)).to(torch.bfloat16)
    calls = []

    def kernel(xk, qp, scale=None):
        calls.append((tuple(xk.shape), qp, scale))
        return i4.int4_matmul_ref(xk.as_subclass(torch.Tensor), qp, scale)

    monkeypatch.setattr(tq._int4, "int4_matmul", kernel)
    y = tq.qmatmul(x.as_subclass(_OnCuda), w)
    assert len(calls) == 1 and calls[0][0] == (3, 64) and calls[0][1] is w.q
    assert torch.equal(calls[0][2], w.scale)
    want = i4.int4_matmul_ref(x, w.q) * w.scale.to(x.dtype)
    assert torch.equal(y.as_subclass(torch.Tensor), want)
