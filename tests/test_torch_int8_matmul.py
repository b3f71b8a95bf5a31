"""The int8 GEMM in both forms: the port's plain versions against the Pallas
kernels of ``scripts/bench_int8_matmul.py`` in interpret mode.

The script is loaded by path (it is not a package) and run under
``force_tpu_interpret_mode`` at small blocks (bm=32, bn=128, bk=128; M=64,
K=N=256). The s32 product must be bit-equal. The scaled form differs in one
place: the TPU kernel multiplies ``acc * (sa * sb)``, the port ``(acc * sa)
* sb`` (the W8A8 order of ``ops/quant.py``), so the two may differ by one
bf16 rounding.
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vcoder_tpu_torch.ops import int8_matmul as i8

torch.set_num_threads(1)

_SCRIPT = pathlib.Path(__file__).resolve().parent.parent / "scripts" / "bench_int8_matmul.py"


@pytest.fixture(scope="module")
def bench():
    spec = importlib.util.spec_from_file_location("bench_int8_matmul", _SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _operands(M, K, N, seed=0):
    rng = np.random.RandomState(seed)
    a = rng.randint(-127, 128, (M, K)).astype(np.int8)
    b = rng.randint(-127, 128, (K, N)).astype(np.int8)
    sa = (rng.rand(M, 1) * 0.02 + 1e-3).astype(np.float32)
    sb = (rng.rand(1, N) * 0.002 + 1e-4).astype(np.float32)
    return a, b, sa, sb


def test_s32_form_bit_equal_to_pallas_kernel(bench):
    a, b, _, _ = _operands(64, 256, 256)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(bench.pallas_int8_mm(jnp.asarray(a), jnp.asarray(b), bm=32, bn=128,
                                               bk=128))
    got = i8.int8_mm_ref(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64))
    assert torch.equal(i8.int8_mm(torch.from_numpy(a), torch.from_numpy(b)), got)


def test_scaled_form_within_one_bf16_rounding_of_pallas_kernel(bench):
    a, b, sa, sb = _operands(64, 256, 256, seed=1)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(bench.pallas_int8_mm(
            jnp.asarray(a), jnp.asarray(b), bm=32, bn=128, bk=128, scaled=True,
            sa=jnp.asarray(sa), sb=jnp.asarray(sb)), np.float32)
    args = [torch.from_numpy(t) for t in (a, b, sa, sb)]
    got = i8.int8_mm_scaled_ref(*args)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want))
    assert torch.equal(i8.int8_mm_scaled(*args).float(), torch.from_numpy(got))


@pytest.mark.parametrize("M,K,N", [(33, 70, 19), (1, 16, 8), (130, 48, 257)])
def test_ragged_shapes_exact(M, K, N):
    """Shapes no tile divides: the s32 product against numpy int64, and the
    f32 epilogue in the W8A8 order."""
    a, b, sa, sb = _operands(M, K, N, seed=M)
    acc = a.astype(np.int64) @ b.astype(np.int64)
    got = i8.int8_mm(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), acc)
    y = i8.int8_mm_scaled(*(torch.from_numpy(t) for t in (a, b, sa, sb)),
                          out_dtype=torch.float32)
    want = (acc.astype(np.float32) * sa) * sb
    np.testing.assert_array_equal(y.numpy(), want)


@pytest.mark.parametrize("M,K,N", [(64, 40, 256), (64, 256, 200), (1, 8, 16)])
def test_launch_refuses_shapes_tma_cannot_read(M, K, N):
    """The kernel reads both operands through TMA (16-byte row strides): a K
    or N that is not a multiple of 16 raises before anything is built or
    launched, naming the shapes."""
    a, b, sa, sb = (torch.from_numpy(t) for t in _operands(M, K, N))
    with pytest.raises(ValueError, match=rf"a\({M}, {K}\) b\({K}, {N}\)"):
        i8.launch_int8_mm(a, b)
    with pytest.raises(ValueError, match="multiples of 16"):
        i8.launch_int8_mm_scaled(a, b, sa, sb)


def test_launch_refuses_misaligned_views():
    """A contiguous view that starts off a 16-byte boundary raises too (TMA
    needs 16-byte-aligned bases); the plain version takes it."""
    M, K, N = 32, 64, 48
    a, b, sa, sb = (torch.from_numpy(t) for t in _operands(M, K, N, seed=3))
    buf = torch.zeros(K * N + 16, dtype=torch.int8)
    b_off = buf[1:1 + K * N].view(K, N)
    b_off.copy_(b)
    assert b_off.is_contiguous() and b_off.data_ptr() % 16 != 0
    with pytest.raises(ValueError, match=rf"16-byte-aligned .*b\({K}, {N}\) at offset 1"):
        i8.launch_int8_mm(a, b_off)
    a_off = torch.zeros(M * K + 16, dtype=torch.int8)[8:8 + M * K].view(M, K)
    a_off.copy_(a)
    with pytest.raises(ValueError, match=rf"a\({M}, {K}\) at offset 8"):
        i8.launch_int8_mm_scaled(a_off, b, sa, sb)
    np.testing.assert_array_equal(i8.int8_mm(a_off, b_off).numpy(),
                                  a.numpy().astype(np.int64) @ b.numpy().astype(np.int64))
