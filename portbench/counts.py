"""The yardstick: the chip's published peaks and the operations and bytes of
the work, counted from shapes and the harness's own lengths.

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W limit: 989 TFLOP/s
bf16, 1,979 TOP/s int8, 3.35 TB/s HBM. A kernel's bound is
``max(ops / peak, bytes / bandwidth)`` for one call, each input byte read
once and each output byte written once (the arithmetic of the port's kernel
table in ``PERF.md``).

A model's FLOPs count 2 per multiply-add of the products the model needs:
the decoder's projections, causal attention, the head where logits are
read, the tower and the projectors. A backward pass counts the activation
gradients and the gradients of the trainable leaves, not recompute.
"""

from __future__ import annotations

PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
HBM_BYTES_S = 3.35e12
BF16 = 2


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16, nbytes / HBM_BYTES_S)


def layer_params(d: dict) -> int:
    """Multiply-adds a token makes in one decoder layer's projections."""
    D, I, H, KH, HD = d["D"], d["I"], d["H"], d["KH"], d["HD"]
    return D * H * HD + 2 * D * KH * HD + H * HD * D + 3 * D * I


def causal_pairs(n: int) -> int:
    """(query, key) pairs of causal attention over ``n`` positions."""
    return n * (n + 1) // 2


def tower_flops(d: dict, pictures: int) -> float:
    """The tower's forward over ``pictures`` 336-pixel pictures."""
    T = d["n_patches"] + 1
    Dv, Iv = d["Dv"], d["Iv"]
    per_block = 2 * T * (4 * Dv * Dv + 2 * Dv * Iv) + 4 * T * T * Dv
    embed = 2 * d["n_patches"] * (3 * d["patch"] ** 2) * Dv
    return pictures * (embed + d["tower_blocks"] * per_block)


def projector_flops(d: dict, tokens: int) -> float:
    return 2 * tokens * (d["Dv"] * d["D"] + d["D"] * d["D"])


def prefill_flops(d: dict, n: int) -> float:
    """One request's admission: the tower over its three pictures, the
    projectors, the decoder over its ``n`` positions and the head at the
    last."""
    P = d["n_patches"]
    return (tower_flops(d, 3) + projector_flops(d, 3 * P)
            + d["L"] * (2 * layer_params(d) * n + 4 * d["HD"] * d["H"] * causal_pairs(n))
            + 2 * d["D"] * d["V"])


def decode_flops(d: dict, context: int) -> float:
    """One decoded token whose attention spans ``context`` positions."""
    return (d["L"] * (2 * layer_params(d) + 4 * d["H"] * d["HD"] * context)
            + 2 * d["D"] * d["V"])


def train_row_flops(d: dict, n: int, labelled: int) -> float:
    """One stage-3 row of ``n`` positions, ``labelled`` of them scored:
    forward, the activation gradients through the decoder and the head, the
    trainable seg projector's gradients over the seg block, and the tower's
    forward over the three pictures (frozen, no backward)."""
    P, D = d["n_patches"], d["D"]
    attn = 4 * d["H"] * d["HD"] * causal_pairs(n)
    dec = d["L"] * (2 * layer_params(d) * n + attn)
    head = 2 * D * d["V"] * labelled
    fwd = tower_flops(d, 3) + projector_flops(d, 3 * P) + dec + head
    bwd = dec + d["L"] * attn + head  # input gradients; attention's are twice its forward
    seg = projector_flops(d, P) + 2 * P * D * D  # weight gradients, and between the layers
    return fwd + bwd + seg


def flash_fwd_call(d: dict, lengths) -> tuple:
    """(flops, bytes) of one causal flash forward over rows of ``lengths``
    valid positions: q, k, v read, o and the log-sum-exp written."""
    H, KH, HD = d["H"], d["KH"], d["HD"]
    flops = sum(4 * H * HD * causal_pairs(n) for n in lengths)
    nbytes = sum(n * (2 * H * HD + 2 * KH * HD) * BF16 + n * H * 4 for n in lengths)
    return flops, nbytes


def flash_bwd_call(d: dict, lengths) -> tuple:
    """(flops, bytes) of one causal flash backward: the scores again, then
    dP, dV, dQ and dK; q, k, v, o, dO and the log-sum-exp read, dq, dk, dv
    written."""
    H, KH, HD = d["H"], d["KH"], d["HD"]
    flops = sum(10 * H * HD * causal_pairs(n) for n in lengths)
    nbytes = sum(n * (3 * H * HD + 2 * KH * HD) * BF16 + n * H * 4
                 + n * (H * HD + 2 * KH * HD) * BF16 for n in lengths)
    return flops, nbytes


def paged_decode_call(d: dict, contexts) -> tuple:
    """(flops, bytes) of one layer's decode attention over rows whose
    attention spans ``contexts`` positions: the keys and values read, q
    read and the output written."""
    H, KH, HD = d["H"], d["KH"], d["HD"]
    flops = sum(4 * H * HD * c for c in contexts)
    nbytes = sum(2 * c * KH * HD * BF16 + 2 * H * HD * BF16 for c in contexts)
    return flops, nbytes
