"""int4 decode matmul: the CUDA kernel ``csrc/int4_matmul.cu`` and its plain
PyTorch version.

Port of ``vcoder_tpu/ops/int4_matmul.py`` (``int4_matmul:63`` over
``_kernel:47``): ``x [B, K] @ unpack(qp [K/2, N])`` with f32 accumulation,
returned in ``x.dtype``; the activations enter the product rounded to bf16,
as the TPU kernel casts them. Packed row i holds weight row 2i in its low
nibble and row 2i+1 in its high nibble (``ops/quant.py``). The per-column
scale is the caller's.

The kernel takes every even K, every N and any B (``qmatmul`` sends it fewer
than ``W8A8_MIN_TOKENS`` rows); the TPU tiling gate
``int4_matmul_supported`` has no counterpart. The wrapper takes the plain
version for a tensor on the CPU and launches the kernel for a tensor on
CUDA; there is no fallback from one to the other. ``launches`` counts kernel
launches made by :func:`int4_matmul`.
"""

from __future__ import annotations

import torch

from vcoder_tpu_torch.ops import _kernels

launches = 0

# Column tile of the kernel (csrc/int4_matmul.cu: COLS) and the number of
# blocks it aims to keep in flight (two per SM of an H100).
_COLS = 128
_TARGET_BLOCKS = 264


def nibbles(qp: torch.Tensor):
    """Packed int8 bytes -> (low, high) signed nibbles as int8: the left
    shift drops the high nibble and the arithmetic right shifts sign-extend."""
    return (qp << 4) >> 4, qp >> 4


def int4_matmul_ref(x: torch.Tensor, qp: torch.Tensor) -> torch.Tensor:
    """Plain version: ``x_even @ lo + x_odd @ hi`` in f32 over bf16-rounded
    activations, cast to ``x.dtype``."""
    lo, hi = nibbles(qp)
    xb = x.to(torch.bfloat16).float()
    acc = xb[:, 0::2] @ lo.float() + xb[:, 1::2] @ hi.float()
    return acc.to(x.dtype)


def _splits(k_half: int, n: int) -> int:
    """Blocks along the packed rows: enough column blocks x splits to fill
    the card, each split at least 256 packed rows."""
    n_blocks = -(-n // _COLS)
    return max(1, min(-(-_TARGET_BLOCKS // n_blocks), k_half // 256))


def launch_int4_matmul(x: torch.Tensor, qp: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors (no counting; see
    :func:`int4_matmul`)."""
    if x.ndim != 2 or qp.ndim != 2 or x.shape[1] != 2 * qp.shape[0]:
        raise ValueError(f"int4_matmul: bad shapes x{tuple(x.shape)} qp{tuple(qp.shape)}")
    if qp.dtype != torch.int8:
        raise TypeError(f"int4_matmul: qp must be int8, got {qp.dtype}")
    if not x.is_floating_point():
        raise TypeError(f"int4_matmul: x must be floating point, got {x.dtype}")
    if qp.device != x.device:
        raise ValueError(f"int4_matmul: qp is on {qp.device}, x on {x.device}")
    B, K = x.shape
    k_half, N = qp.shape
    xb = x.to(torch.bfloat16)
    if xb.stride(1) != 1:
        xb = xb.contiguous()
    qp = qp.contiguous()
    out_f32 = x.dtype != torch.bfloat16
    out = torch.empty((B, N), dtype=torch.float32 if out_f32 else torch.bfloat16,
                      device=x.device)
    splits = _splits(k_half, N)
    rows = -(-k_half // splits)
    part = (torch.empty((splits, B, N), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    fn = _kernels.lib("int4_matmul").int4_matmul
    err = fn(
        xb.data_ptr(), qp.data_ptr(), None if part is None else part.data_ptr(),
        out.data_ptr(), B, k_half, N, xb.stride(0), splits, rows, int(out_f32),
        _kernels.stream_handle(x.device),
    )
    _kernels.check(err, "int4_matmul")
    return out.to(x.dtype)


def int4_matmul(x: torch.Tensor, qp: torch.Tensor) -> torch.Tensor:
    """``x [B, K] @ unpack(qp [K/2, N])`` -> [B, N] in ``x.dtype``: the kernel
    on CUDA, the plain version on the CPU."""
    global launches
    if x.device.type == "cpu":
        return int4_matmul_ref(x, qp)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul: unsupported device {x.device}")
    _kernels.forbid_grad("int4_matmul", x, qp)
    out = launch_int4_matmul(x, qp)
    launches += 1
    return out
