"""Build and load the package's CUDA kernels (``plslam_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes``. Libraries are cached in
``plslam_torch/_build/`` (listed in ``.gitignore``) under a hash of the
source and the flags, so the first use in a fresh checkout builds them and
later uses load them. Nothing is built at import time. Loading is
serialised by a lock: the tracker and the local mapper's worker thread may
both reach a kernel first.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("fast_score_nms", "hamming_top2")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC"]

_loaded: dict[str, ctypes.CDLL] = {}
_functions: dict[tuple[str, str], ctypes._CFuncPtr] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = os.environ.get("NVCC") or shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def lib_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{h}.so"


def build(names=KERNELS, verbose: bool = False) -> float:
    """Compile every missing library, one ``nvcc`` per source, all started
    together. Returns the seconds taken; raises on a failed build."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(exist_ok=True)
    procs = []
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        if verbose and log:
            print(log, end="", flush=True)
        os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = lib_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib


def function(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of kernel ``name``'s library, returning an
    int, with its argument types set once."""
    fn = _functions.get((name, symbol))
    if fn is None:
        lib = load(name)
        with _lock:
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _functions[(name, symbol)] = fn
    return fn
