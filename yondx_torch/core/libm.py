"""The C library's float32 sinf, atan2f and powf over contiguous arrays.

XLA's CPU backend evaluates `sin`, `atan2` and `pow` by calling libm, so
these are the functions that made the JAX package's held-out scenes (see
data/unprocess.py). `csrc/host_libm.c` is compiled on first use with the
host C compiler into `_build/` (a name carrying the source's hash, written
atomically, so concurrent processes may build at once) and bound with
ctypes. No extension flags: each element is one libm call.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

from ..cuda_build import BUILD_DIR, SRC_DIR

_SRC = SRC_DIR / "host_libm.c"
_CFLAGS = ["-O2", "-fno-builtin", "-fPIC", "-shared"]
_lock = threading.Lock()
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        src = _SRC.read_bytes()
        tag = hashlib.sha256(src + " ".join(_CFLAGS).encode()).hexdigest()
        path = BUILD_DIR / f"libyondx_torch_libm-{tag[:16]}.so"
        if not path.exists():
            cc = os.environ.get("CC") or shutil.which("cc") \
                or shutil.which("gcc")
            if cc is None:
                raise RuntimeError("no host C compiler (cc, gcc) to build "
                                   f"{_SRC.name}")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            res = subprocess.run([cc, *_CFLAGS, str(_SRC), "-o", str(tmp),
                                  "-lm"], stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"{cc} failed on {_SRC.name}:\n"
                                   f"{res.stdout}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        p, n = ctypes.c_void_p, ctypes.c_long
        lib.yx_sinf.argtypes = [p, p, n]
        lib.yx_atan2f.argtypes = [p, p, p, n]
        lib.yx_powf.argtypes = [p, ctypes.c_float, p, n]
        for fn in (lib.yx_sinf, lib.yx_atan2f, lib.yx_powf):
            fn.restype = None
        _lib = lib
        return lib


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def sinf(x) -> np.ndarray:
    x = _f32(x)
    y = np.empty_like(x)
    _library().yx_sinf(_ptr(x), _ptr(y), x.size)
    return y


def atan2f(a, b) -> np.ndarray:
    a, b = np.broadcast_arrays(_f32(a), _f32(b))
    a, b = _f32(a), _f32(b)
    y = np.empty_like(a)
    _library().yx_atan2f(_ptr(a), _ptr(b), _ptr(y), a.size)
    return y


def powf(x, e: float) -> np.ndarray:
    x = _f32(x)
    y = np.empty_like(x)
    _library().yx_powf(_ptr(x), ctypes.c_float(e), _ptr(y), x.size)
    return y
