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
[0, 255] as PIL's uint8 output is (``preprocess.py:75``).

:func:`load_images_preprocessed` (``preprocess.py:110``), the eval loaders'
file reader, runs as the JAX package's native route does: decode, pad and
resize across threads in C++ (``native_io.py``), then one
:func:`resize_normalize` at the identity size on the device. The native
pad/resize is not used by :func:`process_images`, which keeps the resize
above.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
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


# How files read by decode_file and load_images_preprocessed were decoded:
# "native" (the library's own route), "png" (png.decode_png where the library
# decodes no PNG) and "PIL" (a file the library rejects).
file_routes = {"native": 0, "png": 0, "PIL": 0}


def _read_fallback(path: str, why: str) -> np.ndarray:
    """A file the native library rejects: PIL where it is installed (as the
    JAX package does), else a ``ValueError`` that names the file."""
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(
            f"{path}: {why}; reading it needs PIL, which is not installed"
        ) from None
    return np.array(_to_numpy_rgb(Image.open(path).convert("RGB")))


def _decode(path: str):
    """(``[H, W, 3] uint8`` RGB, its route): see :func:`decode_file`."""
    from vcoder_tpu_torch import native_io, png

    with open(path, "rb") as f:
        data = f.read()
    rgb = native_io.decode_image(data)
    if rgb is not None:
        return rgb, "native"
    if data.startswith(png.SIGNATURE) and not native_io.decodes_png():
        try:
            return png.decode_png(data), "png"
        except png.UnsupportedPNG as e:
            return _read_fallback(path, str(e)), "PIL"
    return _read_fallback(
        path, f"the native library ({native_io.route()}) does not decode it"), "PIL"


def decode_file(path: str) -> np.ndarray:
    """An image file -> ``[H, W, 3] uint8`` RGB: through the native library,
    a PNG through ``png.decode_png`` where the library decodes no PNG (the
    nvJPEG route), and a file those reject through PIL where it is
    installed, else a ``ValueError`` that names it."""
    rgb, route = _decode(path)
    file_routes[route] += 1
    return rgb


def load_images_preprocessed(
    paths: Sequence[str],
    *,
    size: int = 336,
    image_aspect_ratio: str = "pad",
    dtype=torch.float32,
    n_threads: int = 8,
    device="cuda",
) -> torch.Tensor:
    """Decode + pad + resize + CLIP-normalize a batch of image FILES
    (``preprocess.py:110``): in ``pad`` mode the files decode, pad and resize
    across ``n_threads`` C++ workers with the GIL released, then one
    :func:`resize_normalize` on ``device`` normalizes the batch. A PNG the
    library does not decode (its nvJPEG route) is read by ``png.decode_png``
    and padded and resized natively; a file the library rejects goes
    through PIL where it is installed (``preprocess.py:152-160``), else
    raises a ``ValueError`` that names it. Other aspect modes decode
    through :func:`decode_file`, then run :func:`process_images`. Missing
    files raise."""
    from vcoder_tpu_torch import native_io

    dev = resolve_device(device)
    if image_aspect_ratio != "pad":
        return process_images(
            [decode_file(p) for p in paths], image_aspect_ratio=image_aspect_ratio,
            size=size, dtype=dtype, device=dev,
        )
    u8 = np.empty((len(paths), size, size, 3), np.uint8)
    failed = []
    pipe = native_io.PrefetchPipeline(min(n_threads, max(1, len(paths))), size=size, pad=True)
    try:
        for i, p in enumerate(paths):
            pipe.submit(i, p)
        for _ in paths:
            jid, status, px = pipe.next_status()
            if status == 0:
                u8[jid] = px
                file_routes["native"] += 1
            else:
                failed.append((jid, status))
    finally:
        pipe.close()
    # PNGs the library does not decode (its nvJPEG route): png.decode_png and
    # the native pad + resize across threads (zlib and the C calls release
    # the GIL).
    def own_route(jid):
        rgb, route = _decode(paths[jid])
        return native_io.pad_resize(rgb, size=size, pad=True), route

    own = [jid for jid, status in failed if status == native_io.NOT_DECODED]
    if own:
        with ThreadPoolExecutor(min(n_threads, len(own))) as ex:
            for jid, (px, route) in zip(own, ex.map(own_route, own)):
                u8[jid] = px
                file_routes[route] += 1
    for jid, status in failed:
        if status == native_io.NOT_DECODED:
            continue
        if not os.path.exists(paths[jid]):
            raise FileNotFoundError(paths[jid])
        else:
            # PIL's own pad + BICUBIC resize, as the JAX package's per-file route.
            sq = expand2square(_read_fallback(paths[jid], "the native library rejects it"))
            file_routes["PIL"] += 1
            from PIL import Image

            u8[jid] = np.asarray(Image.fromarray(sq).resize((size, size), Image.BICUBIC))
    return resize_normalize(torch.from_numpy(u8).to(dev), size=size, dtype=dtype)
