"""The host BM3D (port of yondx/native/__init__.py's `bm3d`).

`csrc/bm3d_host.cpp`, the port's own copy of the JAX package's two BM3D
stages, is compiled on first use with the host C++ compiler into
`_build/` under a name carrying the hash of the source and the flags
(written atomically, so concurrent processes may build at once), with the
JAX package's flags, so that the two builds on one machine agree to the
bit. A missing compiler or a failed build raises. The calls run on the
host on float32 numpy planes; ctypes releases the GIL for each, so the
callers may run planes on several threads.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

from .cuda_build import BUILD_DIR, SRC_DIR

_SRC = SRC_DIR / "bm3d_host.cpp"
_CXXFLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        src = _SRC.read_bytes()
        tag = hashlib.sha256(src + " ".join(_CXXFLAGS).encode()).hexdigest()
        path = BUILD_DIR / f"libyondx_torch_bm3d-{tag[:16]}.so"
        if not path.exists():
            cxx = os.environ.get("CXX") or shutil.which("g++") \
                or shutil.which("c++")
            if cxx is None:
                raise RuntimeError("no host C++ compiler (g++, c++) to build "
                                   f"{_SRC.name}")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            res = subprocess.run([cxx, *_CXXFLAGS, "-o", str(tmp), str(_SRC),
                                  "-lpthread"], stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"{cxx} failed on {_SRC.name}:\n"
                                   f"{res.stdout}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.bm3d_ht_f32.argtypes = [p, p, i, i, f, f]
        lib.bm3d_wiener_f32.argtypes = [p, p, p, i, i, f]
        lib.bm3d_ht_f32.restype = lib.bm3d_wiener_f32.restype = None
        _lib = lib
        return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def bm3d(img: np.ndarray, sigma: float, lambda3d: float = 2.7,
         stage: str = "full") -> np.ndarray:
    """Two-stage BM3D of a float [H, W] image (or [H, W, C], channel by
    channel) with noise std `sigma`: stage='full' runs the hard-threshold
    pilot and the empirical-Wiener stage on it, stage='ht' the pilot
    only. Returns float32 of img's shape."""
    lib = _library()
    if img.ndim == 3:
        return np.stack([bm3d(img[..., c], sigma, lambda3d, stage)
                         for c in range(img.shape[-1])], axis=-1)
    x = np.ascontiguousarray(img, np.float32)
    H, W = x.shape
    pilot = np.empty_like(x)
    lib.bm3d_ht_f32(_ptr(x), _ptr(pilot), H, W, float(sigma),
                    float(lambda3d))
    if stage == "ht":
        return pilot
    out = np.empty_like(x)
    lib.bm3d_wiener_f32(_ptr(x), _ptr(pilot), _ptr(out), H, W, float(sigma))
    return out
