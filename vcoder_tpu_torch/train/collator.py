"""Batch collation: per-sample dicts -> a static-shape training batch.

A copy of ``vcoder_tpu/train/collator.py`` (``collate_batch``) for the
PyTorch port, which imports nothing of ``vcoder_tpu``; keep the two in step.
It builds the splice plan with the port's ``multimodal.build_splice_plan``
and hands its arrays, the labels and the pixel stacks to the train step as
tensors on ``device`` (the JAX version's ``as_jnp``). Samples lacking a
modality get zero pixels (the reference does the same,
vcoder_train.py:456-460); their rows splice as pure text.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from vcoder_tpu_torch.device import resolve_device
from vcoder_tpu_torch.models.vcoder import plan_to_arrays
from vcoder_tpu_torch.multimodal import build_splice_plan, validate_features


def collate_batch(
    samples: List[dict],
    *,
    num_patches: int,
    ds_mode: bool = False,
    it_mode: bool = False,
    use_seg: bool = False,
    use_depth: bool = False,
    image_size: int = 336,
    pad_to: Optional[int] = None,
    pad_multiple: int = 128,
    device="cuda",
) -> Dict[str, torch.Tensor]:
    """samples: dicts with input_ids, labels, and optional image/seg/depth
    pixel arrays [H, W, 3]. Returns the plan tensors (``labels`` included)
    and the f32 pixel stacks ``images``/``segs``/``depths`` on ``device``
    (CUDA unless the caller asks for the CPU)."""
    device = resolve_device(device)
    input_ids = [s["input_ids"] for s in samples]
    labels = [s["labels"] for s in samples]
    has_image = any("image" in s for s in samples)
    has_seg = use_seg and has_image
    has_depth = use_depth and has_image

    zeros = np.zeros((image_size, image_size, 3), np.float32)

    def px(s, key):
        arr = s.get(key)
        return np.asarray(arr, np.float32) if arr is not None else zeros

    plan = build_splice_plan(
        input_ids,
        num_patches=num_patches,
        has_image=has_image,
        has_seg=has_seg,
        has_depth=has_depth,
        ds_mode=ds_mode,
        it_mode=it_mode,
        # Zero-pixel placeholders feed the reference's all-black skips
        # (vcoder_ds_llava_arch.py:160-171; vcoder_it_llava_arch.py:148).
        is_depth_zero=[("depth" not in s) for s in samples] if has_depth else None,
        is_seg_zero=[("seg" not in s) for s in samples] if (has_seg and it_mode) else None,
        labels=labels,
        pad_to=pad_to,
        pad_multiple=pad_multiple,
    )
    batch = plan_to_arrays(plan, device, include_labels=True)

    def pixels(key):
        return torch.from_numpy(np.stack([px(s, key) for s in samples])).to(device)

    if has_image:
        # Training streams carry one pixel stack per modality per sample;
        # fail loudly if a conversation smuggled in extra sentinels.
        validate_features(
            plan,
            zeros[None],
            zeros[None] if has_seg else None,
            zeros[None] if has_depth else None,
        )
        batch["images"] = pixels("image")
    if has_seg:
        batch["segs"] = pixels("seg")
    if has_depth:
        batch["depths"] = pixels("depth")
    return batch
