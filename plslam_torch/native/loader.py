"""ctypes wrapper of the native prefetching TUM loader and PNG decoder
(``dataset_loader.cc``, ``png_decode.cc``), the port of the JAX package's
``native/loader.py``.

The library is built with ``g++`` at first use, never at import, into
``plslam_torch/_build/`` (listed in ``.gitignore``) under a hash of the
sources and the flags, as ``ops/cuda_build.py`` builds the kernels. It
needs no libpng: PNG is decoded by the repository's own decoder. JPEG goes
through libjpeg only where ``jpeglib.h`` exists at build time; a build
without it refuses an association that lists other files than PNGs. A
failed build raises with the compiler's output. The functions are bound
with ``ctypes.CDLL``, which releases the interpreter lock during each call,
so the decode threads run beside the tracker and the mapper threads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_build"
SOURCES = ("dataset_loader.cc", "png_decode.cc", "png_decode.h")
# a private C++ runtime, nothing but the C ABI exported: in a process that
# has loaded the CUDA libraries, the loader crashed in loader_create when it
# bound to the process's C++ runtime symbols (chip_smoke.py, phase loader)
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-ffp-contract=off",
         "-fvisibility=hidden", "-static-libstdc++", "-static-libgcc",
         "-Wl,--exclude-libs,ALL"]

_lib = None
_has_jpeg = None
_lock = threading.Lock()


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def has_jpeg() -> bool:
    """Whether libjpeg's header is there to build against (checked once)."""
    global _has_jpeg
    if _has_jpeg is None:
        r = subprocess.run([_cxx(), "-E", "-x", "c++", "-"], input="#include <cstdio>\n"
                           "#include <jpeglib.h>\n", capture_output=True, text=True)
        _has_jpeg = r.returncode == 0
    return _has_jpeg


def _jpeg_flags() -> list[str]:
    return ["-ljpeg"] if has_jpeg() else ["-DPLSLAM_NO_JPEG"]


def lib_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((_DIR / name).read_bytes())
    h.update(" ".join(FLAGS + _jpeg_flags()).encode())
    return BUILD_DIR / f"libplslam_io-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is missing; raises with the compiler's
    output when the build fails."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    srcs = [str(_DIR / n) for n in SOURCES if n.endswith(".cc")]
    r = subprocess.run([_cxx(), *FLAGS, "-o", str(tmp), *srcs, *_jpeg_flags()],
                       capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {out.name} failed:\n{r.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        c_int, c_void_p = ctypes.c_int, ctypes.c_void_p
        lib.loader_create.restype = c_void_p
        lib.loader_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_double,
                                      c_int, c_int]
        lib.loader_size.restype = c_int
        lib.loader_size.argtypes = [c_void_p]
        lib.loader_set_size.restype = None
        lib.loader_set_size.argtypes = [c_void_p, c_int, c_int]
        lib.loader_next.restype = c_int
        lib.loader_next.argtypes = [
            c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(c_int), ctypes.POINTER(c_int)]
        lib.loader_destroy.restype = None
        lib.loader_destroy.argtypes = [c_void_p]
        lib.plslam_png_decode.restype = c_int
        lib.plslam_png_decode.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint16), ctypes.c_longlong,
            *[ctypes.POINTER(c_int)] * 4]
        _lib = lib
        return lib


def native_available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def read_png(path: str) -> np.ndarray:
    """One PNG file as (h, w, channels) samples: uint8, or uint16 for a
    16-bit file; palette images come out RGB, gray below 8 bits scaled to
    8 bits, a tRNS chunk as an alpha channel (what the loader reads)."""
    lib = _load()
    w, h, c, bd = (ctypes.c_int() for _ in range(4))

    def decode(buf):
        return lib.plslam_png_decode(os.fsencode(path),
                                     buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                                     buf.size, ctypes.byref(w), ctypes.byref(h),
                                     ctypes.byref(c), ctypes.byref(bd))

    # the first call reports the size (-1), the second fills the buffer
    if decode(np.empty(0, np.uint16)) != -1:
        raise ValueError(f"{path}: not a PNG this decoder reads, or damaged")
    buf = np.empty(h.value * w.value * c.value, np.uint16)
    if decode(buf) != 1:
        raise ValueError(f"{path}: changed while it was read")
    img = buf.reshape(h.value, w.value, c.value)
    return img.astype(np.uint8) if bd.value == 8 else img


def _association_paths(assoc_path: str) -> list[str]:
    """The color image of every line, parsed as loader_create parses it."""
    out = []
    with open(assoc_path) as f:
        for line in f:
            if not line.strip() or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) >= 4:
                out.append(parts[1])
    return out


class TumLoader:
    """Iterates (gray, depth, timestamp) with native decode-ahead: gray is
    0.299 R + 0.587 G + 0.114 B in float32, depth the 16-bit value over
    ``depth_factor``; a frame that fails to decode is skipped, the others
    come in order."""

    def __init__(self, assoc_path: str, root: str | None = None,
                 depth_factor: float = 5000.0, width: int = 640,
                 height: int = 480, n_threads: int = 4, prefetch: int = 8):
        lib = _load()
        if not os.path.exists(assoc_path):
            raise FileNotFoundError(assoc_path)
        if not has_jpeg():
            other = [p for p in _association_paths(assoc_path)
                     if not p.endswith((".png", ".PNG"))]
            if other:
                raise RuntimeError(
                    f"{assoc_path} lists {len(other)} color images that are not PNG "
                    f"({other[0]}, ...): they are read with libjpeg, which this build "
                    "lacks (no jpeglib.h when the native loader was built)")
        root = root or os.path.dirname(os.path.abspath(assoc_path))
        self._lib = lib
        self._h = lib.loader_create(os.fsencode(assoc_path), os.fsencode(root),
                                    depth_factor, n_threads, prefetch)
        if not self._h:
            raise FileNotFoundError(assoc_path)
        lib.loader_set_size(self._h, width, height)
        self.size = lib.loader_size(self._h)
        self._gray = np.empty(height * width, np.float32)
        self._depth = np.empty(height * width, np.float32)
        self._wh = (width, height)

    def __len__(self):
        return self.size

    def __iter__(self):
        ts = ctypes.c_double()
        w = ctypes.c_int()
        h = ctypes.c_int()
        fptr = ctypes.POINTER(ctypes.c_float)
        while True:
            r = self._lib.loader_next(self._h, self._gray.ctypes.data_as(fptr),
                                      self._depth.ctypes.data_as(fptr), ctypes.byref(ts),
                                      ctypes.byref(w), ctypes.byref(h))
            if r == 0:
                return
            if r == -1:
                continue
            if r == -2:
                raise ValueError(f"frame at {ts.value:.6f} is {w.value}x{h.value}, not "
                                 f"{self._wh[0]}x{self._wh[1]}")
            shape = (h.value, w.value)
            n = shape[0] * shape[1]
            yield (self._gray[:n].reshape(shape).copy(),
                   self._depth[:n].reshape(shape).copy(), ts.value)

    def close(self):
        if self._h:
            self._lib.loader_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
