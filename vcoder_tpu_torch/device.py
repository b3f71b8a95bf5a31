"""Device selection for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU. When CUDA is
absent and the caller did not ask for ``device="cpu"``, they raise; they never
carry on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return ``torch.device(device)``; raise if it is CUDA and there is none.

    On CUDA this also turns TF32 off for matmuls and cuDNN, so a float32
    product is a float32 product, as on the CPU and in the JAX reference.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev
