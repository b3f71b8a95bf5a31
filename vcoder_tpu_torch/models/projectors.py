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
from vcoder_tpu_torch.parallel import spmd


def init_projector_params(
    generator: torch.Generator,
    projector_type: str,
    in_dim: int,
    out_dim: int,
    *,
    dtype=torch.float32,
    device="cpu",
    place=None,
) -> dict:
    """Random-normal (0.02) weights ``[in, out]`` and zero biases, sampled
    directly in ``dtype`` on ``device``; ``place(path, leaf)``, when given,
    takes each leaf as it is made."""
    put = place or (lambda _path, t: t)
    ws, bs = [], []
    for i in range(projector_depth(projector_type)):
        d_in = in_dim if i == 0 else out_dim
        w = torch.randn((d_in, out_dim), generator=generator, dtype=dtype, device=device)
        ws.append(put(f"w/{i}", w.mul_(0.02)))
        bs.append(put(f"b/{i}", torch.zeros((out_dim,), dtype=dtype, device=device)))
    return {"w": ws, "b": bs}


def apply_projector(params: dict, x: torch.Tensor) -> torch.Tensor:
    """GELU between layers is the exact erf form (``projectors.py:51``),
    which is ``F.gelu``'s default. Over a distributed mesh each matrix is
    gathered over ``fsdp`` at use (``parallel/spmd.py``)."""
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        if i > 0:
            x = F.gelu(x)
        x = qm(x, spmd.weight(w)) + spmd.weight(b)
    return x
