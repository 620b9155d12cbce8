"""Build and load the port's CUDA kernels: plain `nvcc` into one shared
library with a C interface, loaded with ctypes.

One `nvcc -shared` of the `csrc/*.cu` sources makes
`_build/libyondx_torch_kernels.so`. The build runs on first use and again
only when the sources (or flags) change: a hash of them is stored beside
the library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_NAME = "libyondx_torch_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib = None


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); "
                       "the port's CUDA kernels are built with plain nvcc")


def _sources():
    return sorted(SRC_DIR.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + CFLAGS).encode())
    for src in _sources() + sorted(SRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def build(force: bool = False, verbose: bool = False) -> Path:
    """Compile the kernels if the stored hash differs; returns the
    library path. Raises with nvcc's output when a compile fails."""
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = source_hash()
    if not force and lib.exists() and stamp.exists() \
            and stamp.read_text().strip() == digest:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [find_nvcc(), *ARCH_FLAGS, *CFLAGS, "-shared",
           *(["-Xptxas", "-v"] if verbose else []),
           *map(str, _sources()), "-o", str(lib)]
    res = subprocess.run(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{res.stdout}")
    stamp.write_text(digest + "\n")
    if verbose:
        print(res.stdout, flush=True)
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.yondx_nle_moments.argtypes = [p, p, p, p, i, i, i, i,
                                      ll, ll, ll, ll, i, i, i, i, p]
    lib.yondx_nle_moments.restype = ctypes.c_int
    return lib


def load_library() -> ctypes.CDLL:
    """Build if needed, then load and bind the kernel library once."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib
