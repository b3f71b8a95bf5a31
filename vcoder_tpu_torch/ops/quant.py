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
   In a row-parallel product (:func:`w8a8_matmul` with ``group``, the
   contraction split over the group's ranks) the row absmax is all-reduced
   (max) before the activations are quantized, as GSPMD reduces JAX's
   ``jnp.max(|x|, axis=-1)`` over a split axis (``:170``), and the s32
   products (the kernel's s32 form) are summed over the group before the
   epilogue: every rank gets the whole product, equal to one device's.
2. int4 below that: a 2-D weight on CUDA goes to the kernel
   ``ops/int4_matmul.int4_matmul``, one launch with the scale in its
   epilogue (bit-equal to the kernel's product times ``scale.to(x.dtype)``,
   JAX's ``int4_matmul(x, q) * scale.astype(x.dtype)``); on the CPU, or for
   a stacked 3-D leaf, the nibble-split form ``x_even @ lo + x_odd @ hi``.
3. int8 below that: the upcast ``x @ q * scale``, plain torch (it was plain
   XLA in JAX). The scale keeps its ``[..., 1, out]`` axis: squeezed, a
   stacked ``[L, out]`` scale would right-align against the token axis.

There is no ``VCODER_INT4_KERNEL`` switch and no shape gate on the int4
kernel: on the card it is the only route for a 2-D int4 weight below the
threshold. Nor is there a ``VCODER_W8A8_PREFILL`` switch: ``set_w8a8`` is the
only toggle of the W8A8 path. LoRA-wrapped weights (``lora.py``) dispatch to
``lora_qmatmul`` / ``multilora_qmatmul``, which call ``qmatmul`` on their
base, so an adapter rides a plain, int8 or int4 base (``:261-268``); any
other non-tensor weight raises ``TypeError``. Mixed float dtypes promote as
in JAX (f32 @ bf16 -> f32), where PyTorch's ``@`` would refuse them.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

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
    """Storage dtype of a weight leaf, LoRA wrappers unwrapped:
    ``torch.int8`` for int8 weights, the string ``"int4"`` for packed int4
    (torch has no int4 dtype), else the tensor's dtype."""
    while type(w).__name__ in ("LoraWeight", "MultiLoraWeight"):
        w = w.base
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


def w8a8_epilogue(acc: torch.Tensor, xs: torch.Tensor, scale: torch.Tensor,
                  dtype) -> torch.Tensor:
    """``(acc * xs) * scale`` in f32, rounded once to ``dtype``: the scaled
    kernel's epilogue, in its plain version's order."""
    return (acc.float() * xs.float() * scale.float()).to(dtype)


def quantize_rows(x: torch.Tensor, amax: torch.Tensor):
    """Per-row dynamic symmetric int8 activations from the row absmax
    ``amax`` (over the whole contraction): ``(xq int8, xs [M, 1] f32)``."""
    xs = amax.clamp_min(1e-8) / 127.0
    return torch.round(x.float() / xs).clamp(-127, 127).to(torch.int8), xs


class _W8A8Matmul(torch.autograd.Function):
    """``x @ dequant(q, scale)`` as an s8 x s8 -> s32 product (``:162-203``).

    x: [M, K] float; q: [K, N] int8; scale: [1, N] f32. The activations are
    quantized per row (dynamic symmetric int8, plain torch). The backward is
    straight-through, ``g @ (q * scale)^T`` in bf16 with f32 accumulation:
    the round() of the activation quantization has no gradient, so without
    it an adapter trained over an int8 base would get dx == 0.

    With ``group``, x and q are one rank's input columns and weight rows
    of a product whose contraction the group splits: the row absmax and
    the s32 products are reduced over the group, and the backward gives
    each rank the ``dx`` of its own input columns."""

    @staticmethod
    def forward(ctx, x, q, scale, group=None):
        amax = x.float().abs().amax(dim=-1, keepdim=True)
        if group is not None:
            dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        xq, xs = quantize_rows(x, amax)
        ctx.save_for_backward(q, scale)
        ctx.x_dtype = x.dtype
        if group is None:
            return _int8.int8_mm_scaled(xq, q, xs, scale, out_dtype=x.dtype)
        acc = _int8.int8_mm(xq, q)
        dist.all_reduce(acc, group=group)
        return w8a8_epilogue(acc, xs, scale, x.dtype)

    @staticmethod
    def backward(ctx, g):
        q, scale = ctx.saved_tensors
        gs = (g.float() * scale).to(torch.bfloat16)
        dx = gs.float() @ q.to(torch.bfloat16).float().t()
        return dx.to(ctx.x_dtype), None, None, None


def uses_w8a8(x: torch.Tensor, w) -> bool:
    """Whether ``qmatmul(x, w)`` takes the W8A8 product."""
    return (isinstance(w, QuantizedTensor) and _W8A8_ENABLED and w.q.ndim == 2
            and x.ndim >= 2 and math.prod(x.shape[:-1]) >= W8A8_MIN_TOKENS)


def w8a8_matmul(x: torch.Tensor, w: QuantizedTensor, group=None) -> torch.Tensor:
    """The W8A8 product ``x @ w`` (int4 unpacked first); with ``group`` a
    row-parallel one, whose output is whole on every rank (the module
    docstring)."""
    q = unpack_int4(w.q) if w.bits == 4 else w.q
    y = _W8A8Matmul.apply(x.reshape(-1, x.shape[-1]), q, w.scale, group)
    return y.reshape(*x.shape[:-1], q.shape[-1])


def qmatmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for plain, quantized or LoRA-wrapped weights, with JAX's
    dtype promotion for plain ones."""
    if isinstance(w, QuantizedTensor):
        if uses_w8a8(x, w):
            return w8a8_matmul(x, w)
        if w.bits == 4:
            if w.q.ndim == 2 and x.device.type == "cuda":
                # One launch: the scale is the kernel's epilogue.
                y = _int4.int4_matmul(x.reshape(-1, x.shape[-1]), w.q, w.scale.float())
                return y.reshape(*x.shape[:-1], w.q.shape[-1])
            # Split by nibble instead of unpacking: with row 2i in the low
            # nibble and row 2i+1 in the high,
            #   x @ W == x[..., 0::2] @ lo(q) + x[..., 1::2] @ hi(q).
            lo, hi = _int4.nibbles(w.q)
            y = x[..., 0::2] @ lo.to(x.dtype) + x[..., 1::2] @ hi.to(x.dtype)
            return y * w.scale.to(x.dtype)
        return (x @ w.q.to(x.dtype)) * w.scale.to(x.dtype)
    if not isinstance(w, torch.Tensor):
        from vcoder_tpu_torch import lora  # lora.py imports this module

        if isinstance(w, lora.LoraWeight):
            return lora.lora_qmatmul(x, w)
        if isinstance(w, lora.MultiLoraWeight):
            return lora.multilora_qmatmul(x, w)
        raise TypeError(f"qmatmul: unsupported weight type {type(w).__name__}")
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w
