"""Multi-format frame loader (port of yondx/core/io.py).

Formats: .npy, .mat (scipy.io; MATLAB v7.3 files, which are HDF5,
through the port's own reader `io/hdf5.py`, key 'x' or the first key in
name order), .png (the port's own reader, core/png.py, in the
channel order the JAX package's cv2.imread + BGR -> RGB gives),
.jpg/.bmp (BGR -> RGB through cv2), .raw (fixed
1440x2560 uint16). Camera raws (.ARW/.DNG/.NEF/.CR2) need rawpy. cv2
and rawpy are optional: a format whose package is absent raises
ImportError.
"""
from __future__ import annotations

import os

import numpy as np

from .png import read_png

RAW_EXTS = {".arw", ".dng", ".nef", ".cr2"}


def _need(module: str, ext: str):
    try:
        return __import__(module)
    except ImportError as e:
        raise ImportError(f"loading {ext} files requires {module}, which "
                          "is not installed") from e


def dataload(path: str):
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        return np.load(path)
    if ext == ".mat":
        import scipy.io as sio
        try:
            mat = sio.loadmat(path)
        except NotImplementedError:  # MATLAB v7.3 -> HDF5
            from ..io import hdf5
            with hdf5.File(path) as f:
                key = "x" if "x" in f else f.keys()[0]
                return f[key][()].T
        keys = [k for k in mat if not k.startswith("__")]
        return mat["x"] if "x" in mat else mat[keys[0]]
    if ext == ".png":
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        img = read_png(path)
        if img.ndim == 3 and img.shape[2] == 2:     # gray + alpha
            img = img[:, :, (0, 0, 0, 1)]
        # cv2.imread's BGR(A) reversed, as the JAX package returns it:
        # RGB, and A R G B for four channels
        return img[:, :, (3, 0, 1, 2)] if img.ndim == 3 \
            and img.shape[2] == 4 else img
    if ext in (".jpg", ".jpeg", ".bmp"):
        cv2 = _need("cv2", ext)
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise FileNotFoundError(path)
        return img[:, :, ::-1] if img.ndim == 3 else img   # BGR -> RGB
    if ext == ".raw":
        return np.fromfile(path, np.uint16).reshape(1440, 2560)
    if ext in RAW_EXTS:
        rawpy = _need("rawpy", ext)
        with rawpy.imread(path) as raw:
            return raw.raw_image_visible.copy()
    raise ValueError(f"unsupported format: {path}")
