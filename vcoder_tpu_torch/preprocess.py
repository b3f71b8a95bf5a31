"""Image preprocessing: pad-to-square -> bicubic resize -> CLIP normalize.

Port of ``vcoder_tpu/preprocess.py`` (``expand2square:37``,
``resize_normalize:61``, ``process_images:189``). The pad runs on the host in
numpy; the resize and normalize run as tensor ops on ``device``. Output is
channel-last ``[B, size, size, 3]``, as the tower's patchify reads it.

The resize reproduces ``jax.image.resize(..., "bicubic", antialias=True)``:
Keys' cubic kernel with a = -0.5, its support widened by the downscale
factor, weights normalized per output pixel. ``F.interpolate(mode="bicubic")``
uses a = -0.75 and no antialiasing, so the separable weight matrices are
built here and applied as two matmuls; the result is rounded and clipped to
[0, 255] as PIL's uint8 output is (``preprocess.py:75``). The native C++
pad/resize route of the JAX package is not ported.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np
import torch

from vcoder_tpu_torch.device import resolve_device

CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)

# int(mean*255) background, as the reference computes it (mm_utils.py:33).
BACKGROUND_COLOR = tuple(int(x * 255) for x in CLIP_IMAGE_MEAN)


def expand2square(
    img: np.ndarray, background_color: Sequence[int] = BACKGROUND_COLOR
) -> np.ndarray:
    """Pad an [H, W, 3] uint8 image to a centered square (PIL paste at
    offset (max - min) // 2)."""
    h, w = img.shape[:2]
    if h == w:
        return img
    side = max(h, w)
    out = np.empty((side, side, 3), dtype=img.dtype)
    out[:, :] = np.asarray(background_color, dtype=img.dtype)
    if w > h:
        top = (side - h) // 2
        out[top : top + h, :, :] = img
    else:
        left = (side - w) // 2
        out[:, left : left + w, :] = img
    return out


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] f32 weights of jax.image's antialiased bicubic
    resize along one axis (``compute_weight_mat`` with translation 0)."""
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = (np.arange(out_size, dtype=np.float32) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = _keys_cubic(x.astype(np.float32))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        w / np.where(total != 0, total, 1),
        0,
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def resize_normalize(images: torch.Tensor, *, size: int = 336, dtype=torch.float32) -> torch.Tensor:
    """[B, S, S, 3] uint8 (square) -> [B, size, size, 3] CLIP-normalized, on
    the device of ``images``."""
    x = images.float()
    s = x.shape[1]
    if s != size or x.shape[2] != size:
        w = torch.as_tensor(resize_weights(s, size), device=x.device)
        x = torch.einsum("bhwc,hH->bHwc", x, w)
        x = torch.einsum("bhwc,wW->bhWc", x, w)
    x = torch.clamp(torch.round(x), 0.0, 255.0) / 255.0
    mean = torch.tensor(CLIP_IMAGE_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(CLIP_IMAGE_STD, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).to(dtype)


def _to_numpy_rgb(image) -> np.ndarray:
    """Accept a PIL image or a numpy [H, W, 3] / [H, W] array; return uint8 RGB."""
    if hasattr(image, "convert"):
        image = np.asarray(image.convert("RGB"))
    image = np.asarray(image)
    if image.ndim == 2:
        image = np.stack([image] * 3, axis=-1)
    if image.dtype != np.uint8:
        image = np.clip(image, 0, 255).astype(np.uint8)
    return image


def process_images(
    images: Union[Sequence, np.ndarray],
    *,
    image_aspect_ratio: str = "pad",
    size: int = 336,
    dtype=torch.float32,
    background_color: Sequence[int] = BACKGROUND_COLOR,
    device="cuda",
) -> torch.Tensor:
    """Batch preprocess (reference mm_utils.py:28-40): pad to square when
    ``image_aspect_ratio == 'pad'`` (else center-crop), resize, normalize.
    Returns [B, size, size, 3] in ``dtype`` on ``device``."""
    dev = resolve_device(device)
    if isinstance(images, np.ndarray) and images.ndim == 3:
        images = [images]
    outs: List[torch.Tensor] = []
    for im in images:
        arr = _to_numpy_rgb(im)
        if image_aspect_ratio == "pad":
            arr = expand2square(arr, background_color)
        else:
            side = min(arr.shape[:2])
            top = (arr.shape[0] - side) // 2
            left = (arr.shape[1] - side) // 2
            arr = arr[top : top + side, left : left + side]
        u8 = torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
        outs.append(resize_normalize(u8[None], size=size, dtype=dtype)[0])
    return torch.stack(outs, dim=0)
