"""Weight-only int8/int4 quantization and ``qmatmul`` (port of
``vcoder_tpu/ops/quant.py``).

Symmetric per-output-channel scales: ``W ~= q * scale`` with the scale
factored out of the product, ``x @ W == (x @ q) * scale``. int4 is stored
nibble-packed in int8 bytes (row 2i in the low nibble, row 2i+1 in the
high), the layout of the JAX package, so packed bytes carry across unchanged.

``qmatmul`` dispatches as ``quant.py:206-260`` does:

1. W8A8 (``bits`` 8 or 4, a 2-D weight, at least ``W8A8_MIN_TOKENS``
   tokens): per-row dynamic int8 activations, an exact integer product and
   the f32 epilogue ``acc * xs * scale`` -- on CUDA through the kernel
   ``ops/int8_matmul.int8_mm_scaled``; int4 is unpacked first, in plain torch.
2. int4 below that: a 2-D weight on CUDA goes to the kernel
   ``ops/int4_matmul.int4_matmul``; on the CPU, or for a stacked 3-D leaf,
   the nibble-split form ``x_even @ lo + x_odd @ hi``.
3. int8 below that: the upcast ``x @ q * scale``, plain torch (it was plain
   XLA in JAX). The scale keeps its ``[..., 1, out]`` axis: squeezed, a
   stacked ``[L, out]`` scale would right-align against the token axis.

There is no ``VCODER_INT4_KERNEL`` switch and no shape gate on the int4
kernel: on the card it is the only route for a 2-D int4 weight below the
threshold. Nor is there a ``VCODER_W8A8_PREFILL`` switch: ``set_w8a8`` is the
only toggle of the W8A8 path. LoRA-wrapped weights raise ``NotImplementedError`` (a later
slice). Mixed float dtypes promote as in JAX (f32 @ bf16 -> f32), where
PyTorch's ``@`` would refuse them.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from vcoder_tpu_torch.ops import int4_matmul as _int4
from vcoder_tpu_torch.ops import int8_matmul as _int8


@dataclasses.dataclass
class QuantizedTensor:
    """q: ``[..., in, out]`` int8, or for ``bits == 4`` packed
    ``[..., in//2, out]`` int8 bytes; scale: ``[..., 1, out]`` f32.

    Indexing slices the leading (layer) axis of ``q`` and ``scale`` together,
    so ``{k: v[l] for k, v in layers.items()}`` gives a layer's weights."""

    q: torch.Tensor
    scale: torch.Tensor
    bits: int = 8

    @property
    def shape(self):
        """LOGICAL ``[..., in, out]`` shape (unpacked for int4)."""
        if self.bits == 4:
            return (*self.q.shape[:-2], self.q.shape[-2] * 2, self.q.shape[-1])
        return tuple(self.q.shape)

    @property
    def ndim(self) -> int:
        return self.q.ndim

    def __getitem__(self, idx) -> "QuantizedTensor":
        return QuantizedTensor(self.q[idx], self.scale[idx], self.bits)

    def to(self, device) -> "QuantizedTensor":
        return QuantizedTensor(self.q.to(device), self.scale.to(device), self.bits)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """``[..., in, out]`` int8 nibble values in [-8, 7] -> ``[..., in//2, out]``
    packed bytes (row 2i -> low nibble, row 2i+1 -> high nibble)."""
    lo = q[..., 0::2, :].to(torch.int32)
    hi = q[..., 1::2, :].to(torch.int32)
    return ((lo & 0x0F) | (hi << 4)).to(torch.int8)


def unpack_int4(qp: torch.Tensor) -> torch.Tensor:
    """Packed ``[..., in//2, out]`` bytes -> ``[..., in, out]`` int8 values."""
    w = torch.stack(_int4.nibbles(qp), dim=-2)  # [..., in//2, 2, out]
    return w.reshape(*qp.shape[:-2], qp.shape[-2] * 2, qp.shape[-1])


def quantize(w: torch.Tensor, bits: int = 8) -> QuantizedTensor:
    """Symmetric per-output-channel quantization over the input axis:
    ``absmax / qmax`` with a 1e-8 floor, round half to even.

    The scale is formed as ``absmax * f32(1 / qmax)``: the JAX package runs
    ``quantize`` under ``jit`` (``quantize_params``), where XLA compiles the
    division by the constant to that product, so these are the bytes and
    scales its quantized models hold (eager JAX divides, one f32 ulp apart
    on some channels)."""
    if bits == 8:
        qmax = 127.0
    elif bits == 4:
        qmax = 7.0
    else:
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    w32 = w.float()
    absmax = w32.abs().amax(dim=-2, keepdim=True).clamp_min(1e-8)
    scale = absmax * (1.0 / qmax)
    q = torch.round(w32 / scale).clamp(-qmax, qmax).to(torch.int8)
    if bits == 4:
        if w.shape[-2] % 2:
            raise ValueError(f"int4 packing needs an even input dim, got {tuple(w.shape)}")
        return QuantizedTensor(q=pack_int4(q), scale=scale, bits=4)
    return QuantizedTensor(q=q, scale=scale)


def dequantize(w: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    q = unpack_int4(w.q) if w.bits == 4 else w.q
    return (q.float() * w.scale).to(dtype)


def base_weight_dtype(w):
    """Storage dtype of a weight leaf: ``torch.int8`` for int8 weights, the
    string ``"int4"`` for packed int4 (torch has no int4 dtype), else the
    tensor's dtype."""
    if isinstance(w, QuantizedTensor):
        return "int4" if w.bits == 4 else w.q.dtype
    return w.dtype


#: Minimum token count (product of the leading dims) for the W8A8 path;
#: read at call time, so tests may lower it.
W8A8_MIN_TOKENS = 256

_W8A8_ENABLED = True


def w8a8_enabled() -> bool:
    return _W8A8_ENABLED


def set_w8a8(enabled: bool) -> None:
    """Toggle the W8A8 prefill path."""
    global _W8A8_ENABLED
    _W8A8_ENABLED = bool(enabled)


class _W8A8Matmul(torch.autograd.Function):
    """``x @ dequant(q, scale)`` as an s8 x s8 -> s32 product (``:162-203``).

    x: [M, K] float; q: [K, N] int8; scale: [1, N] f32. The activations are
    quantized per row (dynamic symmetric int8, plain torch). The backward is
    straight-through, ``g @ (q * scale)^T`` in bf16 with f32 accumulation:
    the round() of the activation quantization has no gradient, so without
    it an adapter trained over an int8 base would get dx == 0."""

    @staticmethod
    def forward(ctx, x, q, scale):
        x32 = x.float()
        xs = x32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
        xq = torch.round(x32 / xs).clamp(-127, 127).to(torch.int8)
        ctx.save_for_backward(q, scale)
        ctx.x_dtype = x.dtype
        return _int8.int8_mm_scaled(xq, q, xs, scale, out_dtype=x.dtype)

    @staticmethod
    def backward(ctx, g):
        q, scale = ctx.saved_tensors
        gs = (g.float() * scale).to(torch.bfloat16)
        dx = gs.float() @ q.to(torch.bfloat16).float().t()
        return dx.to(ctx.x_dtype), None, None


def qmatmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for plain or quantized weights, with JAX's dtype promotion
    for plain ones."""
    if isinstance(w, QuantizedTensor):
        if (
            _W8A8_ENABLED
            and w.q.ndim == 2
            and x.ndim >= 2
            and math.prod(x.shape[:-1]) >= W8A8_MIN_TOKENS
        ):
            q = unpack_int4(w.q) if w.bits == 4 else w.q
            y = _W8A8Matmul.apply(x.reshape(-1, x.shape[-1]), q, w.scale)
            return y.reshape(*x.shape[:-1], q.shape[-1])
        if w.bits == 4:
            if w.q.ndim == 2 and x.device.type == "cuda":
                N = w.q.shape[-1]
                y = _int4.int4_matmul(x.reshape(-1, x.shape[-1]), w.q)
                return y.reshape(*x.shape[:-1], N) * w.scale.to(x.dtype)
            # Split by nibble instead of unpacking: with row 2i in the low
            # nibble and row 2i+1 in the high,
            #   x @ W == x[..., 0::2] @ lo(q) + x[..., 1::2] @ hi(q).
            lo, hi = _int4.nibbles(w.q)
            y = x[..., 0::2] @ lo.to(x.dtype) + x[..., 1::2] @ hi.to(x.dtype)
            return y * w.scale.to(x.dtype)
        return (x @ w.q.to(x.dtype)) * w.scale.to(x.dtype)
    if type(w).__name__ in ("LoraWeight", "MultiLoraWeight"):
        raise NotImplementedError("LoRA-wrapped weights are not ported yet")
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w
