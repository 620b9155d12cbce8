"""Host C++ of the port: the BM3D (port of yondx/native/__init__.py's
`bm3d`), the host filters `box_mean`, `local_moments` and
`bilateral_row` (its other three), and the checkpoint codecs
`zstd_decompress` and `crc32c` (`csrc/zstd_host.cpp`, the port's own
RFC 8878 decoder, which `io/ocdbt.py` reads orbax checkpoints with).

Each source under `csrc/` (`bm3d_host.cpp`, `host_filters.cpp`, the
port's own copies of the JAX package's C++) is compiled on first use
with the host C++ compiler into `_build/` under a name carrying the hash
of the source and the flags (written atomically, so concurrent processes
may build at once), with the JAX package's flags, so that the two builds
on one machine agree to the bit. A missing compiler or a failed build
raises. The calls run on the host on float32 numpy planes; ctypes
releases the GIL for each, so the callers may run planes on several
threads.
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

_CXXFLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]
_lock = threading.Lock()
_libs = {}


def _build(name: str) -> ctypes.CDLL:
    """Load `csrc/<name>.cpp`'s library, building it where it is missing
    (under the lock)."""
    src_path = SRC_DIR / f"{name}.cpp"
    src = src_path.read_bytes()
    tag = hashlib.sha256(src + " ".join(_CXXFLAGS).encode()).hexdigest()
    path = BUILD_DIR / f"libyondx_torch_{name.split('_')[0]}-{tag[:16]}.so"
    if not path.exists():
        cxx = os.environ.get("CXX") or shutil.which("g++") \
            or shutil.which("c++")
        if cxx is None:
            raise RuntimeError("no host C++ compiler (g++, c++) to build "
                               f"{src_path.name}")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        res = subprocess.run([cxx, *_CXXFLAGS, "-o", str(tmp), str(src_path),
                              "-lpthread"], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{cxx} failed on {src_path.name}:\n"
                               f"{res.stdout}")
        os.replace(tmp, path)
    return ctypes.CDLL(str(path))


def _library() -> ctypes.CDLL:
    """The BM3D library (csrc/bm3d_host.cpp), bound."""
    with _lock:
        if "bm3d" not in _libs:
            lib = _build("bm3d_host")
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.bm3d_ht_f32.argtypes = [p, p, i, i, f, f]
            lib.bm3d_wiener_f32.argtypes = [p, p, p, i, i, f]
            lib.bm3d_ht_f32.restype = lib.bm3d_wiener_f32.restype = None
            _libs["bm3d"] = lib
        return _libs["bm3d"]


def _filters() -> ctypes.CDLL:
    """The host filters' library (csrc/host_filters.cpp), bound."""
    with _lock:
        if "filters" not in _libs:
            lib = _build("host_filters")
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.box_mean_f32.argtypes = [p, p, i, i, i, i]
            lib.local_moments_f32.argtypes = [p, p, p, i, i, i, i]
            lib.bilateral_row_f32.argtypes = [p, p, i, i, f, f]
            for fn in (lib.box_mean_f32, lib.local_moments_f32,
                       lib.bilateral_row_f32):
                fn.restype = None
            _libs["filters"] = lib
        return _libs["filters"]


def _zstd() -> ctypes.CDLL:
    """The checkpoint codecs' library (csrc/zstd_host.cpp), bound."""
    with _lock:
        if "zstd" not in _libs:
            lib = _build("zstd_host")
            p, n = ctypes.c_void_p, ctypes.c_size_t
            lib.zstd_decompress.argtypes = [ctypes.c_char_p, n,
                                            ctypes.POINTER(p), p,
                                            ctypes.c_int]
            lib.zstd_decompress.restype = ctypes.c_longlong
            lib.zstd_free.argtypes = [p]
            lib.zstd_free.restype = None
            lib.crc32c.argtypes = [ctypes.c_char_p, n]
            lib.crc32c.restype = ctypes.c_uint32
            _libs["zstd"] = lib
        return _libs["zstd"]


def zstd_decompress(buf: bytes) -> bytes:
    """Decode one or more concatenated zstd frames (RFC 8878). A corrupt
    frame, a checksum mismatch, a dictionary or a skippable frame raises
    ValueError naming it."""
    lib = _zstd()
    src = bytes(buf)
    out = ctypes.c_void_p()
    err = ctypes.create_string_buffer(512)
    n = lib.zstd_decompress(src, len(src), ctypes.byref(out), err, 512)
    if n < 0:
        raise ValueError(f"zstd: {err.value.decode()}")
    try:
        return ctypes.string_at(out, n)
    finally:
        lib.zstd_free(out)


def crc32c(buf: bytes) -> int:
    """CRC-32C (Castagnoli) of `buf`, as OCDBT's manifests and nodes end."""
    src = bytes(buf)
    return int(_zstd().crc32c(src, len(src)))


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


def _planes(img: np.ndarray):
    """[H, W] or [H, W, C] -> contiguous float32 [C, H, W] planes."""
    squeeze = img.ndim == 2
    x = np.ascontiguousarray(
        (img[..., None] if squeeze else img).transpose(2, 0, 1), np.float32)
    return x, squeeze


def _unplanes(x: np.ndarray, squeeze: bool) -> np.ndarray:
    x = x.transpose(1, 2, 0)
    return x[..., 0] if squeeze else x


def box_mean(img: np.ndarray, k: int) -> np.ndarray:
    """Reflect-101 k x k box mean of a float32 [H, W] or [H, W, C]
    image, by running sums on the host."""
    x, squeeze = _planes(img)
    out = np.empty_like(x)
    C, H, W = x.shape
    _filters().box_mean_f32(_ptr(x), _ptr(out), C, H, W, k)
    return _unplanes(out, squeeze)


def local_moments(img: np.ndarray, k: int):
    """(mean, max(E[x^2] - mean^2, 0)) k x k maps of a float32 [H, W] or
    [H, W, C] image."""
    x, squeeze = _planes(img)
    mean, var = np.empty_like(x), np.empty_like(x)
    C, H, W = x.shape
    _filters().local_moments_f32(_ptr(x), _ptr(mean), _ptr(var), C, H, W, k)
    return _unplanes(mean, squeeze), _unplanes(var, squeeze)


def bilateral_row(signal: np.ndarray, d: int = 25,
                  sigma_color: float = 10.0,
                  sigma_space: float = 1.0) -> np.ndarray:
    """1-D bilateral of a [N] float32 signal (cv2's weights, radius
    d // 2, replicated ends)."""
    x = np.ascontiguousarray(signal, np.float32)
    out = np.empty_like(x)
    _filters().bilateral_row_f32(_ptr(x), _ptr(out), x.shape[0], d,
                                 sigma_color, sigma_space)
    return out
