"""The port's native image library and file loader against the JAX package's.

``vcoder_tpu_torch.native_io`` builds ``csrc/vcoder_io.cpp`` (a copy of
``native/vcoder_io.cpp``) on this machine's route (here libjpeg + libpng)
into ``_build/``; JAX's ``native/io.py`` builds the original into its cache.
On the same files:

* ``load_images_preprocessed`` gives uint8 pixels equal to JAX's native
  route, and normalised output within 1e-6 of it, on JPEG and PNG files;
* the in-memory decode (``decode_image``, behind ``png.load_image_bytes``)
  equals JAX's library and PIL's decode;
* a BMP, which the library rejects, goes through PIL as in JAX; without PIL
  it raises a ``ValueError`` naming the file (PIL's import monkeypatched
  away);
* a PNG the library does not decode (the nvJPEG route's PNGs, emulated by
  patching the route) is read by ``png.decode_png`` with the same pixels;
* ``chip_smoke.py`` phase 11's JPEG references are current and this
  machine's decode meets its gates.

Tiny images, f32; the whole file runs in a few seconds.
"""

import builtins
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vcoder_tpu.native import io as jio
from vcoder_tpu.preprocess import load_images_preprocessed as jax_load
from vcoder_tpu_torch import native_io, png
from vcoder_tpu_torch import preprocess as tpp

PIL = pytest.importorskip("PIL.Image")

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(not jio.is_available(),
                                reason="the JAX package's native library does not build here")


def _rand_img(seed, h, w):
    rng = np.random.RandomState(seed)
    low = rng.randint(0, 256, (12, 12, 3), np.uint8)
    return np.asarray(PIL.fromarray(low).resize((w, h), PIL.BILINEAR))


def _files(tmp_path, fmt, n=5):
    paths = []
    for i in range(n):
        p = str(tmp_path / f"b{i}.{fmt.lower()}")
        PIL.fromarray(_rand_img(20 + i, 90 + 7 * i, 130 - 9 * i)).save(p, format=fmt)
        paths.append(p)
    return paths


def _jax_u8(paths, size):
    """The uint8 pixels of JAX's native route (its pipeline, as its
    load_images_preprocessed runs it)."""
    pipe = jio.PrefetchPipeline(2, size=size)
    for i, p in enumerate(paths):
        pipe.submit(i, p)
    out = {}
    for _ in paths:
        jid, px = pipe.next()
        out[jid] = px
    pipe.close()
    return np.stack([out[i] for i in range(len(paths))])


def test_route_is_libjpeg_where_its_headers_are():
    assert native_io.route() == "libjpeg" and native_io.decodes_png()
    assert "-ljpeg" in native_io.build_command("libjpeg", native_io._BUILD_DIR / "x.so")
    cmd = native_io.build_command("nvjpeg", native_io._BUILD_DIR / "x.so")
    assert "-DVIO_NVJPEG" in cmd and "-lnvjpeg" in cmd


@pytest.mark.parametrize("fmt", ["JPEG", "PNG"])
@pytest.mark.parametrize("size", [64, 336])
def test_load_images_preprocessed_matches_jax_native_route(tmp_path, fmt, size):
    paths = _files(tmp_path, fmt)
    want_u8 = _jax_u8(paths, size)
    for i, p in enumerate(paths):
        np.testing.assert_array_equal(native_io.load_preprocessed(p, size=size), want_u8[i])
    got = tpp.load_images_preprocessed(paths, size=size, device="cpu")
    want = np.asarray(jax_load(paths, size=size))
    assert got.shape == want.shape == (len(paths), size, size, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # The uint8 pixels behind the normalised output are JAX's exactly.
    np.testing.assert_array_equal(tpp.resize_normalize(torch.from_numpy(want_u8), size=size),
                                  got)


def test_pad_resize_and_pipeline_match_jax():
    img = _rand_img(0, 200, 317)
    np.testing.assert_array_equal(native_io.pad_resize(img, size=336),
                                  jio.pad_resize(img, size=336))
    sq = _rand_img(1, 336, 336)
    np.testing.assert_array_equal(native_io.pad_resize(sq, size=336), sq)


def test_decode_image_matches_jax_library_and_pil(tmp_path):
    import ctypes

    lib = jio._load()
    for fmt in ("JPEG", "PNG"):
        (p,) = _files(tmp_path, fmt, n=1)
        data = open(p, "rb").read()
        got = native_io.decode_image(data)
        out, w, h = ctypes.POINTER(ctypes.c_uint8)(), ctypes.c_int(), ctypes.c_int()
        assert lib.vio_decode(data, len(data), ctypes.byref(out), ctypes.byref(w),
                              ctypes.byref(h)) == 0
        want = np.ctypeslib.as_array(out, shape=(h.value, w.value, 3)).copy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.asarray(PIL.open(p).convert("RGB")))
        np.testing.assert_array_equal(png.load_image_bytes(data), got)
    assert native_io.decode_image(b"not an image") is None


def _no_pil(monkeypatch):
    real_import = builtins.__import__

    def no_pil(name, *args, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)


def test_rejected_file_goes_through_pil_or_raises_without_it(tmp_path, monkeypatch):
    good = _rand_img(30, 70, 70)
    p_good, p_bmp = str(tmp_path / "good.png"), str(tmp_path / "odd.bmp")
    PIL.fromarray(good).save(p_good)
    PIL.fromarray(good).save(p_bmp)
    want = np.asarray(jax_load([p_good, p_bmp], size=48))
    tpp.file_routes.update(native=0, png=0, PIL=0)
    got = tpp.load_images_preprocessed([p_good, p_bmp], size=48, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert tpp.file_routes == {"native": 1, "png": 0, "PIL": 1}
    # Other aspect modes decode through decode_file, as JAX's PIL route.
    np.testing.assert_allclose(
        tpp.load_images_preprocessed([p_good, p_bmp], size=48, image_aspect_ratio="square",
                                     device="cpu").numpy(),
        np.asarray(jax_load([p_good, p_bmp], size=48, image_aspect_ratio="square")),
        rtol=0, atol=1e-6)
    p_bad = str(tmp_path / "bad.png")
    with open(p_bad, "wb") as f:
        f.write(b"garbage")
    with pytest.raises(Exception):
        tpp.load_images_preprocessed([p_good, p_bad], size=48, device="cpu")
    with pytest.raises(FileNotFoundError):
        tpp.load_images_preprocessed([str(tmp_path / "missing.jpg")], size=48, device="cpu")

    _no_pil(monkeypatch)
    np.testing.assert_allclose(  # JPEG and PNG need no PIL
        tpp.load_images_preprocessed([p_good], size=48, device="cpu").numpy(), want[:1],
        rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="odd.bmp.*needs PIL"):
        tpp.load_images_preprocessed([p_good, p_bmp], size=48, device="cpu")
    with pytest.raises(ValueError, match="odd.bmp.*needs PIL"):
        tpp.decode_file(p_bmp)


def test_png_route_where_the_library_decodes_no_png(tmp_path, monkeypatch):
    """The nvJPEG route's PNGs: the library answers NOT_DECODED and the
    loader reads them with png.decode_png (pixels equal to libpng's)."""
    paths = _files(tmp_path, "PNG", n=3) + _files(tmp_path, "JPEG", n=1)
    want = tpp.load_images_preprocessed(paths, size=64, device="cpu")
    real_decode = native_io.decode_image
    monkeypatch.setattr(native_io, "decodes_png", lambda: False)
    monkeypatch.setattr(native_io, "decode_image", lambda data: None
                        if data.startswith(png.SIGNATURE) else real_decode(data))

    class NoPngPipeline(native_io.PrefetchPipeline):
        def next_status(self):
            jid, status, px = super().next_status()
            return (jid, native_io.NOT_DECODED, px) if jid < 3 else (jid, status, px)

    monkeypatch.setattr(native_io, "PrefetchPipeline", NoPngPipeline)
    tpp.file_routes.update(native=0, png=0, PIL=0)
    got = tpp.load_images_preprocessed(paths, size=64, device="cpu")
    assert tpp.file_routes == {"native": 1, "png": 3, "PIL": 0}
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_load_images_preprocessed_refuses_cuda_without_a_card(tmp_path):
    (p,) = _files(tmp_path, "PNG", n=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpp.load_images_preprocessed([p], size=32)


def test_phase11_jpeg_references_are_current_and_met():
    proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "jpeg_refs.py"),
                           "--check"], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    got = chip_smoke.check_jpeg_decode()
    assert got["route"] == "libjpeg" and got["mean"] == 0 and got["thumb"] == 0
