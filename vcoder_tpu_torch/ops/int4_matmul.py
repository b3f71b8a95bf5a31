"""int4 decode matmul: the CUDA kernel ``csrc/int4_matmul.cu`` and its plain
PyTorch version.

Port of ``vcoder_tpu/ops/int4_matmul.py`` (``int4_matmul:63`` over
``_kernel:47``): ``x [B, K] @ unpack(qp [K/2, N])`` with f32 accumulation,
returned in ``x.dtype``; the activations enter the product rounded to bf16,
as the TPU kernel casts them. Packed row i holds weight row 2i in its low
nibble and row 2i+1 in its high nibble (``ops/quant.py``).

With ``scale`` (``[N]`` or ``[1, N]`` f32, a quantized weight's per-column
scale) both versions also compute the caller's epilogue,
``int4_matmul(x, qp) * scale.to(x.dtype)``, which the JAX package leaves to
XLA to fuse (``vcoder_tpu/ops/quant.py:241-242``): the product rounded to
``x.dtype``, times the scale rounded to ``x.dtype``, rounded again. The
kernel runs it in its epilogue, so ``qmatmul``'s int4 product is one launch.

The kernel takes every even K, every N and any B (``qmatmul`` sends it fewer
than ``W8A8_MIN_TOKENS`` rows); the TPU tiling gate
``int4_matmul_supported`` has no counterpart. The wrapper takes the plain
version for a tensor on the CPU and launches the kernel for a tensor on
CUDA; there is no fallback from one to the other. ``launches`` counts kernel
launches made by :func:`int4_matmul`.
"""

from __future__ import annotations

import ctypes

import torch

from vcoder_tpu_torch.ops import _kernels

launches = 0

# Tiling of the kernel (csrc/int4_matmul.cu): COLS output columns and ROWS
# rows of x a block, WARPS slices of K a block (one per warp), at most
# MAX_CLUSTER blocks of a cluster splitting K. Every warp gets at least
# _MIN_STEPS k-steps of 16 k.
_COLS = 128
_ROWS = 8
_WARPS = 8
_MAX_CLUSTER = 8
_MIN_STEPS = 2

# Per device: the blocks one wave of the kernel holds with clusters of 1 ..
# _MAX_CLUSTER blocks, as the card's occupancy calculator gives them; and
# the cluster size chosen per (device, K/2, N, B).
_CAPACITY: dict = {}
_CLUSTER: dict = {}

# Output types the kernel writes (its out_kind).
_OUT_KIND = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}


def nibbles(qp: torch.Tensor):
    """Packed int8 bytes -> (low, high) signed nibbles as int8: the left
    shift drops the high nibble and the arithmetic right shifts sign-extend."""
    return (qp << 4) >> 4, qp >> 4


def int4_matmul_ref(x: torch.Tensor, qp: torch.Tensor, scale=None) -> torch.Tensor:
    """Plain version: ``x_even @ lo + x_odd @ hi`` in f32 over bf16-rounded
    activations, cast to ``x.dtype``; with ``scale``, times the scale cast
    to ``x.dtype``."""
    lo, hi = nibbles(qp)
    xb = x.to(torch.bfloat16).float()
    acc = xb[:, 0::2] @ lo.float() + xb[:, 1::2] @ hi.float()
    y = acc.to(x.dtype)
    if scale is not None:
        y = y * scale.reshape(1, -1).to(x.dtype)
    return y


def _cluster_size(k_half: int, n: int, b: int, capacity) -> int:
    """Blocks of a cluster splitting K for one column tile: the most (up to
    ``_MAX_CLUSTER``) whose grid still fits one wave, ``capacity[c - 1]``
    blocks for clusters of ``c``, with every warp keeping ``_MIN_STEPS``
    k-steps. A second wave would double the time of its blocks."""
    k_steps = -(-k_half // 8)
    blocks = -(-n // _COLS) * -(-b // _ROWS)
    best = 1
    for c in range(2, _MAX_CLUSTER + 1):
        if c * _WARPS * _MIN_STEPS <= k_steps and blocks * c <= capacity[c - 1]:
            best = c
    return best


def _capacity(idx: int) -> tuple:
    """The kernel's one-wave capacity on CUDA device ``idx`` for clusters of
    1 .. ``_MAX_CLUSTER`` blocks, asked of the card once."""
    if idx not in _CAPACITY:
        blocks = (ctypes.c_int * _MAX_CLUSTER)()
        with torch.cuda.device(idx):
            err = _kernels.lib("int4_matmul").int4_matmul_capacity(ctypes.addressof(blocks))
        _kernels.check(err, "int4_matmul_capacity")
        _CAPACITY[idx] = tuple(blocks)
    return _CAPACITY[idx]


def _check_scale(scale, n: int, device) -> torch.Tensor:
    """The scale as the kernel reads it: ``[N]`` f32, contiguous, on x's
    device; raises on anything else."""
    if not isinstance(scale, torch.Tensor):
        raise TypeError(f"int4_matmul: scale must be a tensor, got {type(scale).__name__}")
    if scale.dtype != torch.float32:
        raise TypeError(f"int4_matmul: scale must be float32, got {scale.dtype}")
    if tuple(scale.shape) not in ((n,), (1, n)):
        raise ValueError(f"int4_matmul: scale must be [{n}] or [1, {n}], got "
                         f"{tuple(scale.shape)}")
    if scale.device != device:
        raise ValueError(f"int4_matmul: scale is on {scale.device}, x on {device}")
    return scale.reshape(n).contiguous()


def launch_int4_matmul(x: torch.Tensor, qp: torch.Tensor, scale=None) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors (no counting; see
    :func:`int4_matmul`)."""
    if x.ndim != 2 or qp.ndim != 2 or x.shape[1] != 2 * qp.shape[0]:
        raise ValueError(f"int4_matmul: bad shapes x{tuple(x.shape)} qp{tuple(qp.shape)}")
    if qp.dtype != torch.int8:
        raise TypeError(f"int4_matmul: qp must be int8, got {qp.dtype}")
    if x.dtype not in _OUT_KIND:
        raise TypeError(f"int4_matmul: x must be bfloat16, float16 or float32, got {x.dtype}")
    if qp.device != x.device:
        raise ValueError(f"int4_matmul: qp is on {qp.device}, x on {x.device}")
    B, K = x.shape
    k_half, N = qp.shape
    if scale is not None:
        scale = _check_scale(scale, N, x.device)
    out = torch.empty((B, N), dtype=x.dtype, device=x.device)
    if B == 0 or N == 0:
        return out
    xb = x.to(torch.bfloat16)
    if xb.stride(1) != 1:
        xb = xb.contiguous()
    qp = qp.contiguous()
    idx = x.device.index if x.device.index is not None else torch.cuda.current_device()
    key = (idx, k_half, N, B)
    cluster = _CLUSTER.get(key)
    if cluster is None:
        cluster = _CLUSTER[key] = _cluster_size(k_half, N, B, _capacity(idx))
    fn = _kernels.lib("int4_matmul").int4_matmul
    err = fn(
        xb.data_ptr(), qp.data_ptr(), None if scale is None else scale.data_ptr(),
        out.data_ptr(), B, k_half, N, xb.stride(0), cluster, _OUT_KIND[x.dtype],
        _kernels.stream_handle(x.device),
    )
    _kernels.check(err, "int4_matmul")
    return out


def int4_matmul(x: torch.Tensor, qp: torch.Tensor, scale=None) -> torch.Tensor:
    """``x [B, K] @ unpack(qp [K/2, N])`` -> [B, N] in ``x.dtype``, times
    ``scale`` when given: the kernel on CUDA, the plain version on the CPU."""
    global launches
    if x.device.type == "cpu":
        if scale is not None:
            scale = _check_scale(scale, qp.shape[-1], x.device)
        return int4_matmul_ref(x, qp, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul: unsupported device {x.device}")
    _kernels.forbid_grad("int4_matmul", x, qp, scale)
    out = launch_int4_matmul(x, qp, scale)
    if out.numel():
        launches += 1
    return out
