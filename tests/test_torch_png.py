"""The stdlib PNG decoder and encoder (``vcoder_tpu_torch/png.py``) against
PIL's ``Image.open(...).convert("RGB")``: colour types 0, 2, 3, 4 and 6 as PIL
writes them, each of the five filter types as the port's encoder writes them,
odd widths; the round trip; and the PNGs it refuses (16-bit, interlaced),
which the loader hands to PIL."""

import base64
import io
import struct
import zlib

import numpy as np
import pytest

from vcoder_tpu_torch import png

Image = pytest.importorskip("PIL.Image")


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _pil_png(img, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG", **kw)
    return buf.getvalue()


SHAPES = {"L": (), "LA": (2,), "RGB": (3,), "RGBA": (4,)}


@pytest.mark.parametrize("mode", ["L", "RGB", "P", "LA", "RGBA"])
@pytest.mark.parametrize("hw", [(17, 23), (5, 1), (32, 40)])
def test_pil_written_pngs_decode_as_pil(mode, hw):
    rng = np.random.RandomState(hw[0] * 100 + hw[1] + len(mode))
    if mode == "P":
        img = Image.fromarray(rng.randint(0, 256, hw + (3,)).astype(np.uint8)).quantize(200)
        data = _pil_png(img, bits=8)  # else PIL packs a small palette into fewer bits
    else:
        img = Image.fromarray(rng.randint(0, 256, hw + SHAPES[mode]).astype(np.uint8), mode)
        data = _pil_png(img)
    ctype = data[25]  # IHDR colour type
    assert ctype == {"L": 0, "RGB": 2, "P": 3, "LA": 4, "RGBA": 6}[mode] and data[24] == 8
    np.testing.assert_array_equal(png.decode_png(data), _pil_rgb(data))


@pytest.mark.parametrize("filter_type", range(5), ids=["none", "sub", "up", "average", "paeth"])
@pytest.mark.parametrize("channels", [1, 2, 3, 4, "palette"])
def test_each_filter_type_decodes_as_pil(filter_type, channels):
    rng = np.random.RandomState(filter_type * 10 + (5 if channels == "palette" else channels))
    # Smooth ramps plus noise, so Sub/Up/Average/Paeth predict and wrap.
    h, w = 19, 27
    ramp = (np.arange(h)[:, None] * 7 + np.arange(w)[None, :] * 13) % 256
    if channels == "palette":
        arr = (ramp % 50).astype(np.uint8)
        data = png.encode_png(arr, palette=rng.randint(0, 256, (50, 3)).astype(np.uint8),
                              filter_type=filter_type)
    else:
        shape = (h, w) if channels == 1 else (h, w, channels)
        noise = rng.randint(0, 40, shape)
        base = ramp if channels == 1 else ramp[:, :, None]
        arr = ((base + noise) % 256).astype(np.uint8)
        data = png.encode_png(arr, filter_type=filter_type)
    np.testing.assert_array_equal(png.decode_png(data), _pil_rgb(data))


@pytest.mark.parametrize("shape", [(1, 1, 3), (7, 13, 3), (64, 33, 3)])
def test_round_trip(shape):
    x = np.random.RandomState(shape[1]).randint(0, 256, shape).astype(np.uint8)
    for f in range(5):
        np.testing.assert_array_equal(png.decode_png(png.encode_png(x, filter_type=f)), x)


def test_rows_of_mixed_filter_types_decode_as_pil():
    """Rows whose filters differ, as an encoder's adaptive choice leaves them
    (each type after two others, on a photo-like picture: smooth shading
    plus noise), decode as PIL decodes them."""
    rng = np.random.RandomState(3)
    h, w = 27, 61
    yy, xx = np.mgrid[:h, :w]
    shade = 120 + 60 * np.sin(yy / 7.0)[..., None] * np.cos(xx / 9.0)[..., None]
    arr = np.clip(shade + [0, 30, -30] + rng.normal(0, 4, (h, w, 3)), 0, 255).astype(np.uint8)
    types = np.array([(y + y // 5) % 5 for y in range(h)], np.uint8)
    px = arr.reshape(h, w * 3)
    rows = np.stack([png._filter(px, f, 3) for f in range(5)])[types, np.arange(h)]
    data = png.encode_png(arr)
    body = zlib.compress(np.concatenate([types[:, None], rows], axis=1).tobytes())
    idat = struct.pack(">I", len(body)) + b"IDAT" + body + struct.pack(
        ">I", zlib.crc32(b"IDAT" + body) & 0xFFFFFFFF)
    data = data[:33] + idat + data[-12:]
    np.testing.assert_array_equal(png.decode_png(data), _pil_rgb(data))
    np.testing.assert_array_equal(png.decode_png(data), arr)


def test_unknown_filter_type_raises():
    data = png.encode_png(np.zeros((3, 2, 3), np.uint8), filter_type=0)
    raw = bytearray(zlib.decompress(b"".join(b for k, b in png._chunks(data) if k == b"IDAT")))
    raw[1 * (1 + 2 * 3)] = 5  # row 1's filter byte
    body = zlib.compress(bytes(raw))
    idat = struct.pack(">I", len(body)) + b"IDAT" + body + struct.pack(
        ">I", zlib.crc32(b"IDAT" + body) & 0xFFFFFFFF)
    bad = data[:33] + idat + data[-12:]
    with pytest.raises(ValueError, match="row 1 has unknown filter type 5"):
        png.decode_png(bad)


def _with_ihdr(data: bytes, **fields) -> bytes:
    """``data`` with IHDR fields replaced (CRC recomputed)."""
    names = ("width", "height", "depth", "ctype", "compression", "filter", "interlace")
    vals = dict(zip(names, struct.unpack(">IIBBBBB", data[16:29])))
    vals.update(fields)
    body = struct.pack(">IIBBBBB", *(vals[n] for n in names))
    crc = struct.pack(">I", zlib.crc32(b"IHDR" + body) & 0xFFFFFFFF)
    return data[:16] + body + crc + data[33:]


def test_sixteen_bit_interlaced_and_malformed_pngs_raise():
    sixteen = _pil_png(Image.fromarray(np.arange(12, dtype=np.uint16).reshape(3, 4) * 999))
    assert sixteen[24] == 16
    with pytest.raises(png.UnsupportedPNG, match="bit depth 16"):
        png.decode_png(sixteen)
    interlaced = _with_ihdr(png.encode_png(np.zeros((4, 4, 3), np.uint8)), interlace=1)
    with pytest.raises(png.UnsupportedPNG, match="interlaced"):
        png.decode_png(interlaced)
    with pytest.raises(ValueError, match="signature"):
        png.decode_png(b"GIF89a")
    with pytest.raises(ValueError, match="larger than"):
        png.decode_png(_with_ihdr(png.encode_png(np.zeros((4, 4, 3), np.uint8)),
                                  width=20000, height=20000))
    with pytest.raises(ValueError, match="shorter than"):
        png.decode_png(_with_ihdr(png.encode_png(np.zeros((4, 4, 3), np.uint8)), height=5))
    with pytest.raises(ValueError, match="no PNG colour type"):
        png.encode_png(np.zeros((2, 2, 5), np.uint8))
    bad_crc = bytearray(png.encode_png(np.zeros((2, 2, 3), np.uint8)))
    bad_crc[30] ^= 1
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(bytes(bad_crc))


def test_loader_routes_by_format(monkeypatch):
    """PNG through the port's decoder, JPEG through the native library (equal
    to PIL's decode on this machine's libjpeg route), a 16-bit PNG through
    PIL; without PIL the PNG and the JPEG still decode, while the 16-bit PNG
    and a JPEG the library rejects raise a ValueError that names PIL."""
    from vcoder_tpu_torch.serve.chat import load_image_from_base64

    rgb = np.random.RandomState(0).randint(0, 256, (9, 11, 3)).astype(np.uint8)
    b64 = base64.b64encode(png.encode_png(rgb)).decode()
    np.testing.assert_array_equal(load_image_from_base64(b64), rgb)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="JPEG")
    jpeg = buf.getvalue()
    np.testing.assert_array_equal(png.load_image_bytes(jpeg), _pil_rgb(jpeg))
    sixteen = _pil_png(Image.fromarray(np.arange(12, dtype=np.uint16).reshape(3, 4) * 999))
    np.testing.assert_array_equal(png.load_image_bytes(sixteen), _pil_rgb(sixteen))

    import builtins

    real_import = builtins.__import__

    def no_pil(name, *args, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    np.testing.assert_array_equal(load_image_from_base64(b64), rgb)  # no PIL needed
    np.testing.assert_array_equal(png.load_image_bytes(jpeg), _pil_rgb(jpeg))  # native
    for data in (sixteen, jpeg[:40]):
        with pytest.raises(ValueError, match="needs PIL"):
            png.load_image_bytes(data)
