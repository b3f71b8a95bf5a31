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


@pytest.mark.parametrize("k_half,n,want", [(64, 256, 1), (2048, 4096, 8), (2048, 11008, 4),
                                           (5504, 4096, 9), (2048, 32000, 2)])
def test_split_count(k_half, n, want):
    """Splits along K fill the card at the 7B shapes; small K never splits."""
    assert i4._splits(k_half, n) == want
