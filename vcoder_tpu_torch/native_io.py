"""ctypes bindings and on-demand build of the native image library.

A port of ``vcoder_tpu/native/io.py`` (``load_preprocessed``, ``pad_resize``,
``PrefetchPipeline``) over ``csrc/vcoder_io.cpp``, a copy of the JAX
package's ``native/vcoder_io.cpp``: decode, pad to square and bicubic resize
in C++, across threads with the GIL released. :func:`decode_image` also
exposes the library's in-memory decode.

The library is host code, built at first use into
``_build/libvcoder_io-<route>-<hash of the source>.so``. It has one decode
route per machine, chosen by the headers the machine has:

* ``"libjpeg"``: ``jpeglib.h`` and ``png.h`` are found; ``g++`` links
  ``-ljpeg -lpng`` (the JAX package's build);
* ``"nvjpeg"``: they are not, and the CUDA toolkit has ``nvjpeg.h``;
  ``nvcc`` builds with ``-DVIO_NVJPEG`` and JPEG is decoded on the card by
  nvJPEG. That build decodes no PNG: its callers read PNG with
  :func:`vcoder_tpu_torch.png.decode_png`.

There is no switch and no quiet fallback: a build that fails raises with the
compiler's output, and a machine with neither route raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from vcoder_tpu_torch.preprocess import BACKGROUND_COLOR

_SRC = Path(__file__).resolve().parent / "csrc" / "vcoder_io.cpp"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"

# vio_load_file's status for a file this build does not decode (a PNG in the
# nvJPEG build); csrc/vcoder_io.cpp's VIO_NOT_DECODED.
NOT_DECODED = -3

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_route: Optional[str] = None

_U8P = ctypes.POINTER(ctypes.c_uint8)


def _cuda_home() -> str:
    return os.environ.get("CUDA_HOME", "/usr/local/cuda")


def _has_libjpeg_headers() -> bool:
    """True when the C++ compiler finds ``jpeglib.h`` and ``png.h``."""
    probe = subprocess.run(
        ["g++", "-E", "-x", "c++", "-", "-o", os.devnull],
        input="#include <cstdio>\n#include <jpeglib.h>\n#include <png.h>\n",
        capture_output=True, text=True,
    )
    return probe.returncode == 0


def choose_route() -> str:
    """``"libjpeg"`` where libjpeg's and libpng's headers are installed,
    else ``"nvjpeg"`` where the CUDA toolkit has nvJPEG; raises otherwise."""
    if shutil.which("g++") is None:
        raise RuntimeError("no C++ compiler (g++): the native image library cannot be built")
    if _has_libjpeg_headers():
        return "libjpeg"
    if (Path(_cuda_home()) / "include" / "nvjpeg.h").exists():
        return "nvjpeg"
    raise RuntimeError(
        "neither libjpeg + libpng headers (jpeglib.h, png.h) nor nvJPEG "
        f"({_cuda_home()}/include/nvjpeg.h) are installed: the native image "
        "library cannot be built"
    )


def build_command(route: str, out: Path) -> list:
    """The compiler command that builds ``csrc/vcoder_io.cpp`` for
    ``route`` into ``out``."""
    if route == "libjpeg":
        return ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC),
                "-o", str(out), "-ljpeg", "-lpng", "-lpthread"]
    cuda = Path(_cuda_home())
    nvcc = cuda / "bin" / "nvcc"
    return [str(nvcc if nvcc.exists() else "nvcc"), "-O3", "-std=c++17", "-shared",
            "-Xcompiler", "-fPIC", "-Wno-deprecated-gpu-targets", "-DVIO_NVJPEG",
            "-I", str(cuda / "include"), str(_SRC), "-o", str(out),
            "-L", str(cuda / "lib64"), "-lnvjpeg",
            "-Xlinker", "-rpath", "-Xlinker", str(cuda / "lib64")]


def _build() -> Tuple[ctypes.CDLL, str]:
    route = choose_route()
    digest = hashlib.sha1(_SRC.read_bytes()).hexdigest()[:12]
    out = _BUILD_DIR / f"libvcoder_io-{route}-{digest}.so"
    if not out.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(build_command(route, tmp), capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {_SRC.name} ({route}) failed:\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.vio_decode.restype = ctypes.c_int
    lib.vio_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(_U8P),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.vio_free.restype = None
    lib.vio_free.argtypes = [_U8P]
    lib.vio_load_file.restype = ctypes.c_int
    lib.vio_load_file.argtypes = [ctypes.c_char_p, _U8P, ctypes.c_int, ctypes.c_int, _U8P]
    lib.vio_pad_resize.restype = None
    lib.vio_pad_resize.argtypes = [
        _U8P, ctypes.c_int, ctypes.c_int, _U8P, ctypes.c_int, ctypes.c_int, _U8P,
    ]
    lib.vio_pipeline_new.restype = ctypes.c_void_p
    lib.vio_pipeline_new.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint8, ctypes.c_uint8, ctypes.c_uint8,
    ]
    lib.vio_pipeline_submit.restype = None
    lib.vio_pipeline_submit.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_char_p]
    lib.vio_pipeline_next.restype = ctypes.c_long
    lib.vio_pipeline_next.argtypes = [ctypes.c_void_p, _U8P, ctypes.POINTER(ctypes.c_int)]
    lib.vio_pipeline_free.restype = None
    lib.vio_pipeline_free.argtypes = [ctypes.c_void_p]
    return lib, route


def library() -> ctypes.CDLL:
    """The loaded library, built on first use (raises if it cannot be)."""
    global _lib, _route
    with _lock:
        if _lib is None:
            _lib, _route = _build()
    return _lib


def route() -> str:
    """This machine's decode route, ``"libjpeg"`` or ``"nvjpeg"``."""
    library()
    return _route


def decodes_png() -> bool:
    """Whether the library decodes PNG itself (the libjpeg route)."""
    return route() == "libjpeg"


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(_U8P)


def _bg_array(background_color) -> np.ndarray:
    return np.asarray(background_color, dtype=np.uint8)


def decode_image(data: bytes) -> Optional[np.ndarray]:
    """JPEG or PNG bytes -> ``[H, W, 3] uint8`` RGB through the library, or
    None when it does not decode them (another format, a corrupt file, or a
    PNG on the nvJPEG route)."""
    lib = library()
    out = _U8P()
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    if lib.vio_decode(data, len(data), ctypes.byref(out), ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    try:
        return np.ctypeslib.as_array(out, shape=(h.value, w.value, 3)).copy()
    finally:
        lib.vio_free(out)


def load_preprocessed(
    path: str, *, size: int = 336, pad: bool = True, background_color=BACKGROUND_COLOR
) -> np.ndarray:
    """Decode + pad-to-square + bicubic-resize one file natively.
    Returns uint8 [size, size, 3]."""
    dst = np.empty((size, size, 3), np.uint8)
    rc = library().vio_load_file(
        path.encode(), _u8(_bg_array(background_color)), size, int(pad), _u8(dst)
    )
    if rc != 0:
        raise IOError(f"native decode failed ({rc}): {path}")
    return dst


def pad_resize(
    img: np.ndarray, *, size: int = 336, pad: bool = True, background_color=BACKGROUND_COLOR
) -> np.ndarray:
    """Native pad+resize of an in-memory uint8 [H, W, 3] image."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    dst = np.empty((size, size, 3), np.uint8)
    library().vio_pad_resize(
        _u8(img), h, w, _u8(_bg_array(background_color)), size, int(pad), _u8(dst)
    )
    return dst


class PrefetchPipeline:
    """Multithreaded file -> preprocessed-uint8 pipeline.

    Submit paths with ids; iterate results in completion order. Workers live
    in C++; the GIL is released for the entire decode+resize.
    """

    def __init__(
        self, n_threads: int = 4, *, size: int = 336, pad: bool = True,
        background_color=BACKGROUND_COLOR,
    ):
        self._lib = library()
        self.size = size
        bg = _bg_array(background_color)
        self._handle = self._lib.vio_pipeline_new(
            n_threads, size, int(pad), int(bg[0]), int(bg[1]), int(bg[2])
        )
        self._outstanding = 0

    def submit(self, job_id: int, path: str) -> None:
        self._lib.vio_pipeline_submit(self._handle, job_id, path.encode())
        self._outstanding += 1

    def next_status(self) -> Tuple[int, int, np.ndarray]:
        """Block for the next finished job: (id, status, pixels). Status 0
        is success, :data:`NOT_DECODED` a file this build does not decode,
        anything else a failure to read or decode."""
        if self._outstanding == 0:
            raise RuntimeError("no outstanding jobs")
        dst = np.empty((self.size, self.size, 3), np.uint8)
        status = ctypes.c_int(0)
        jid = self._lib.vio_pipeline_next(self._handle, _u8(dst), ctypes.byref(status))
        self._outstanding -= 1
        return int(jid), status.value, dst

    def close(self) -> None:
        if self._handle:
            self._lib.vio_pipeline_free(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
