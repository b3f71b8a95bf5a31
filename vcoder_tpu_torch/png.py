"""A PNG decoder and encoder on ``zlib``, numpy and a C row loop.

The serving wire format carries images as base64 PNG, and the card machine
has no PIL, so the port decodes PNG itself: :func:`decode_png` reads 8-bit,
non-interlaced PNGs of colour types 0 (grey), 2 (RGB), 3 (palette), 4
(grey + alpha) and 6 (RGBA), undoes all five scanline filters, and returns
``[H, W, 3] uint8`` RGB as PIL's ``Image.open(...).convert("RGB")`` does:
alpha is dropped, grey is repeated over the three channels and a palette
is expanded. Any other PNG (16-bit, fewer than 8 bits, interlaced) raises
:class:`UnsupportedPNG`, a ``ValueError``. The row filters are undone in C
(``csrc/png_unfilter.c``, built with ``cc`` at first use), since Average
and Paeth rows, which encoders pick for most rows of a photo, run byte by
byte. :func:`encode_png` writes the same colour types, with one filter
type for every row.

:func:`load_image_bytes` is the one route the serving loaders take: PNG
bytes through :func:`decode_png` and JPEG bytes through the native library
(``native_io.py``) on every machine, anything else (and a file those
refuse) through PIL, and a ``ValueError`` naming PIL where PIL is missing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import zlib
from io import BytesIO
from pathlib import Path
from typing import Optional

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# A JPEG file's first marker (start of image).
JPEG_SOI = b"\xff\xd8"
# Samples per pixel of each colour type.
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Larger images are refused before anything is inflated (PIL's own
# decompression-bomb limit is twice its default MAX_IMAGE_PIXELS).
MAX_PIXELS = 2 * 89_478_485

_SRC = Path(__file__).resolve().parent / "csrc" / "png_unfilter.c"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()


class UnsupportedPNG(ValueError):
    """A well-formed PNG this decoder does not read (bit depth other than
    8, or interlaced)."""


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        crc = struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])[0]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG ends without IEND")


def unfilter_library() -> ctypes.CDLL:
    """The loaded ``csrc/png_unfilter.c``, compiled with ``cc`` on first use
    into ``_build/libpng_unfilter-<hash of the source>.so`` (a stale
    library is never loaded; the rename makes a build by another process
    safe to race)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            out = _BUILD_DIR / f"libpng_unfilter-{hashlib.sha1(_SRC.read_bytes()).hexdigest()[:12]}.so"
            if not out.exists():
                cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")
                if cc is None:
                    raise RuntimeError("no C compiler (cc): the PNG row filters cannot be built")
                _BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                proc = subprocess.run([cc, "-O2", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)],
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"cc failed for {_SRC.name}:\n{proc.stdout}{proc.stderr}")
                os.replace(tmp, out)
            lib = ctypes.CDLL(str(out))
            lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3
            lib.png_unfilter.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters: ``raw`` holds ``height`` rows of one filter
    byte and ``stride`` filtered bytes. Returns [height, stride] uint8."""
    if len(raw) < height * (stride + 1):
        raise ValueError("PNG image data is shorter than its header says")
    rows = np.frombuffer(raw, np.uint8, height * (stride + 1))
    out = np.empty((height, stride), np.uint8)
    bad = unfilter_library().png_unfilter(rows.ctypes.data, out.ctypes.data, height, stride, bpp)
    if bad:
        y = bad - 1
        raise ValueError(f"PNG row {y} has unknown filter type {rows[y * (stride + 1)]}")
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> ``[H, W, 3] uint8`` RGB, as PIL's ``convert("RGB")``."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG (bad signature)")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, ctype, _, _, interlace = header
    if ctype not in CHANNELS:
        raise ValueError(f"PNG colour type {ctype} is not a valid type")
    if depth != 8:
        raise UnsupportedPNG(f"PNG bit depth {depth} is not read here (8 only)")
    if interlace:
        raise UnsupportedPNG("interlaced PNG is not read here")
    if width * height > MAX_PIXELS:
        raise ValueError(f"PNG of {width}x{height} pixels is larger than {MAX_PIXELS}")
    ch = CHANNELS[ctype]
    # Inflate no more than the header's rows need.
    raw = zlib.decompressobj().decompress(b"".join(idat), height * (width * ch + 1))
    px = _unfilter(raw, height, width * ch, ch)
    px = px.reshape(height, width, ch)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        idx = px[..., 0]
        if int(idx.max(initial=0)) >= len(palette):
            raise ValueError("PNG palette index past the palette")
        return palette[idx]
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def _filter(px: np.ndarray, ftype: int, bpp: int) -> np.ndarray:
    """Filter every row of [H, stride] uint8 with ``ftype`` (from the
    unfiltered bytes, as the PNG specification defines each filter)."""
    x = px.astype(np.int16)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    if ftype == 0:
        pred = np.zeros_like(x)
    elif ftype == 1:
        pred = left
    elif ftype == 2:
        pred = up
    elif ftype == 3:
        pred = (left + up) >> 1
    elif ftype == 4:
        upleft = np.zeros_like(x)
        upleft[1:, bpp:] = x[:-1, :-bpp]
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    else:
        raise ValueError(f"unknown PNG filter type {ftype}")
    return ((x - pred) & 0xFF).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(arr: np.ndarray, *, palette: Optional[np.ndarray] = None,
               filter_type: int = 0) -> bytes:
    """``uint8`` pixels -> PNG bytes. ``[H, W]`` is grey, ``[H, W, 2]`` grey
    + alpha, ``[H, W, 3]`` RGB, ``[H, W, 4]`` RGBA; ``[H, W]`` indices with a
    ``palette`` ([N, 3] uint8) is a palette image. Every row takes
    ``filter_type`` (0 none, 1 sub, 2 up, 3 average, 4 Paeth)."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8 pixels, got {arr.dtype}")
    if palette is not None:
        if arr.ndim != 2:
            raise ValueError("a palette image is [H, W] indices")
        ctype = 3
    else:
        ctype = 0 if arr.ndim == 2 else None
        if arr.ndim == 3:
            ctype = {1: 0, 2: 4, 3: 2, 4: 6}.get(arr.shape[-1])
        if ctype is None:
            raise ValueError(f"no PNG colour type for pixels of shape {arr.shape}")
    h, w = arr.shape[:2]
    ch = CHANNELS[ctype]
    rows = _filter(arr.reshape(h, w * ch), filter_type, ch)
    raw = np.concatenate([np.full((h, 1), filter_type, np.uint8), rows], axis=1)
    out = [SIGNATURE, _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))]
    if ctype == 3:
        out.append(_chunk(b"PLTE", np.asarray(palette, np.uint8).reshape(-1, 3).tobytes()))
    out.append(_chunk(b"IDAT", zlib.compress(raw.tobytes())))
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)


def load_image_bytes(data: bytes) -> np.ndarray:
    """Image file bytes -> ``[H, W, 3] uint8`` RGB. PNG goes through
    :func:`decode_png`, JPEG through the native library
    (:func:`vcoder_tpu_torch.native_io.decode_image`: libjpeg or nvJPEG, one
    route per machine); any other format, a PNG :func:`decode_png` does not
    read and a JPEG the library rejects go through PIL, and without PIL that
    raises a ``ValueError`` that says so."""
    if data.startswith(SIGNATURE):
        try:
            return decode_png(data)
        except UnsupportedPNG as e:
            why = f"{e}; "
    elif data.startswith(JPEG_SOI):
        from vcoder_tpu_torch import native_io

        rgb = native_io.decode_image(data)
        if rgb is not None:
            return rgb
        why = f"the native library ({native_io.route()}) does not decode this JPEG; "
    else:
        why = "the image is neither PNG nor JPEG; "
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(why + "reading it needs PIL, which is not installed") from None
    return np.asarray(Image.open(BytesIO(data)).convert("RGB"))
