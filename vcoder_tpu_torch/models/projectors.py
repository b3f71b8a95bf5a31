"""Vision-to-LM projector heads (port of ``vcoder_tpu/models/projectors.py``).

``mlpNx_gelu`` / ``linear`` / ``identity``: Linear(in, out) then
[GELU, Linear(out, out)] * (N - 1). One parameterized form covers
mm_projector, mm2_projector, seg_projector and depth_projector.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vcoder_tpu_torch.config import projector_depth
from vcoder_tpu_torch.ops.quant import qmatmul as qm


def init_projector_params(
    generator: torch.Generator,
    projector_type: str,
    in_dim: int,
    out_dim: int,
    *,
    dtype=torch.float32,
    device="cpu",
) -> dict:
    """Random-normal (0.02) weights ``[in, out]`` and zero biases, sampled
    directly in ``dtype`` on ``device``."""
    ws, bs = [], []
    for i in range(projector_depth(projector_type)):
        d_in = in_dim if i == 0 else out_dim
        w = torch.randn((d_in, out_dim), generator=generator, dtype=dtype, device=device)
        ws.append(w.mul_(0.02))
        bs.append(torch.zeros((out_dim,), dtype=dtype, device=device))
    return {"w": ws, "b": bs}


def apply_projector(params: dict, x: torch.Tensor) -> torch.Tensor:
    """GELU between layers is the exact erf form (``projectors.py:51``),
    which is ``F.gelu``'s default."""
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        if i > 0:
            x = F.gelu(x)
        x = qm(x, w) + b
    return x
