"""``qmatmul`` for plain weights (port of ``vcoder_tpu/ops/quant.py:206``).

Only the plain-weight branch is ported; quantized and LoRA weights wait for
a later slice. Mixed float dtypes promote as in JAX (f32 @ bf16 -> f32),
where PyTorch's ``@`` would refuse them.
"""

from __future__ import annotations

import torch


def qmatmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with JAX's dtype promotion."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w
