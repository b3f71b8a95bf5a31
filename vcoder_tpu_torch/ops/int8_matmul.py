"""int8 GEMM: the CUDA kernel ``csrc/int8_mm.cu`` in its two forms and their
plain PyTorch versions.

Port of ``scripts/bench_int8_matmul.py`` (``pallas_int8_mm:109`` over
``_mm_kernel:76`` and ``_mm_scaled_kernel:92``):

* :func:`int8_mm` -- ``a [M, K] s8 @ b [K, N] s8 -> [M, N] s32``, exact;
* :func:`int8_mm_scaled` -- the same product with the row x column scale
  epilogue ``(acc * sa [M, 1]) * sb [1, N]`` in f32, rounded once to the
  output dtype (bf16 by default). This is the W8A8 prefill product of
  ``ops/quant.py``; it multiplies in that path's order (the TPU kernel forms
  ``sa * sb`` first), so on the CPU the plain version equals the JAX
  package's ``_w8a8_matmul`` bit for bit.

The plain versions compute the integer product exactly in float64 (every
partial sum is an integer below 2**53; CUDA has no integer matmul, and an
f32 product is not exact at K = 4096). The wrappers take the plain versions
for tensors on the CPU and launch the kernel for tensors on CUDA; there is no
fallback from one to the other. ``launches`` and ``launches_scaled`` count
kernel launches.
"""

from __future__ import annotations

import torch

from vcoder_tpu_torch.ops import _kernels

launches = 0
launches_scaled = 0

_OUT_KIND = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


def reset_launches() -> None:
    global launches, launches_scaled
    launches = launches_scaled = 0


def int8_mm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: the exact s32 product."""
    return (a.double() @ b.double()).to(torch.int32)


def int8_mm_scaled_ref(a, b, sa, sb, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of the scaled form: ``((acc * sa) * sb)`` in f32."""
    acc = int8_mm_ref(a, b).float()
    return (acc * sa.float() * sb.float()).to(out_dtype)


def _launch(a, b, sa, sb, out_dtype):
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"int8_mm: bad shapes a{tuple(a.shape)} b{tuple(b.shape)}")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_mm: operands must be int8, got {a.dtype} and {b.dtype}")
    if b.device != a.device:
        raise ValueError(f"int8_mm: b is on {b.device}, a on {a.device}")
    M, K = a.shape
    N = b.shape[1]
    a, b = a.contiguous(), b.contiguous()
    scaled = sa is not None
    if scaled:
        if out_dtype not in _OUT_KIND:
            raise TypeError(f"int8_mm_scaled: unsupported output dtype {out_dtype}")
        sa = sa.to(device=a.device, dtype=torch.float32).reshape(M).contiguous()
        sb = sb.to(device=a.device, dtype=torch.float32).reshape(N).contiguous()
        out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    else:
        out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    fn = _kernels.lib("int8_mm").int8_mm
    err = fn(
        a.data_ptr(), b.data_ptr(), sa.data_ptr() if scaled else None,
        sb.data_ptr() if scaled else None, out.data_ptr(), M, N, K, int(scaled),
        _OUT_KIND.get(out_dtype, 0), _kernels.stream_handle(a.device),
    )
    _kernels.check(err, "int8_mm")
    return out


def launch_int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the s32 form on CUDA tensors (no counting)."""
    return _launch(a, b, None, None, torch.int32)


def launch_int8_mm_scaled(a, b, sa, sb, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Launch the scaled form on CUDA tensors (no counting)."""
    return _launch(a, b, sa, sb, out_dtype)


def _check_device(name: str, a: torch.Tensor) -> bool:
    """True for the CPU (plain version), False for CUDA (kernel)."""
    if a.device.type == "cpu":
        return True
    if a.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {a.device}")
    return False


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [M, K] s8 @ b [K, N] s8 -> [M, N] s32``: the kernel on CUDA, the
    plain version on the CPU."""
    global launches
    if _check_device("int8_mm", a):
        return int8_mm_ref(a, b)
    out = launch_int8_mm(a, b)
    launches += 1
    return out


def int8_mm_scaled(a, b, sa, sb, out_dtype=torch.bfloat16) -> torch.Tensor:
    """``out_dtype((a @ b) * sa * sb)`` with ``sa [M, 1]``, ``sb [1, N]`` f32:
    the kernel on CUDA, the plain version on the CPU."""
    global launches_scaled
    if _check_device("int8_mm_scaled", a):
        return int8_mm_scaled_ref(a, b, sa, sb, out_dtype)
    out = launch_int8_mm_scaled(a, b, sa, sb, out_dtype)
    launches_scaled += 1
    return out
