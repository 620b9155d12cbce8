"""NLE box moments: the wrapper of kernel K1 (csrc/nle_moments.cu).

K1 replaces the Pallas TPU kernel yondx/nle/pallas_ops.py::_moments_kernel
(launched by _pallas_moments_planes, entry fused_moments). A CUDA tensor
launches K1 (or raises); a CPU tensor takes the plain PyTorch version in
boxfilter.py. There is no fallback between the two.

Bound on an H100 SXM at the main path's shape (bands of a 3072x4096 Bayer
frame: [2, 256, 2048, 4] fp32 = 8 planes of 256x2048): one read and three
writes of 16.8 MB = 67 MB of device memory, ~20 us at 3.35 TB/s. The
function needs ~36 fp32 operations per output with sliding box sums
(0.15 GFLOP, ~2 us at 67 TFLOP/s), so bytes bound it. K1's direct window
sums do ~10k + 2*inner = 328 per output: that is its design choice (no
drift along a row), not a limit of the card. Its time is reported beside
this bound in PERF.md.
"""
from __future__ import annotations

import torch

from . import boxfilter

# launches of K1 since the last reset (one per kernel launch, nowhere else)
LAUNCHES = {"nle_moments": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def halo(k: int, inner: int, texture: bool) -> int:
    """Rows/columns of context one output needs: k//2 (+ inner//2)."""
    return k // 2 + (inner // 2 if texture else 0)


def nle_moments_plain(x, k: int, inner: int, texture: bool = True,
                      mean: bool = True):
    """The plain PyTorch version (any device): (mean, var, tex) with
    skipped maps returned as None."""
    if texture:
        m, v, t = boxfilter.nle_moments(x, k, inner)
    else:
        m, v = boxfilter.mean_varfilt(x, k)
        t = None
    return (m if mean else None), v, t


def _launch_k1(x, k: int, inner: int, texture: bool, mean: bool):
    from ..cuda_build import load_library
    if x.dtype != torch.float32:
        raise TypeError(f"K1 takes float32, got {x.dtype}")
    shape = x.shape
    h, w, C = shape[-3:]
    x4 = x.reshape((-1, h, w, C))
    L = x4.shape[0]
    plane_mean = torch.mean(x4, dim=(1, 2)).contiguous()
    out_m = torch.empty((L, h, w, C), device=x.device) if mean else None
    out_v = torch.empty((L, h, w, C), device=x.device)
    out_t = torch.empty((L, h, w, C), device=x.device) if texture else None
    sl, sy, sx, sc = x4.stride()
    lib = load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.yondx_nle_moments(
        x4.data_ptr(), plane_mean.data_ptr(),
        out_m.data_ptr() if mean else None, out_v.data_ptr(),
        out_t.data_ptr() if texture else None,
        L, h, w, C, sl, sy, sx, sc, k, inner, int(mean), int(texture),
        stream)
    if err != 0:
        raise RuntimeError(f"K1 (nle_moments) launch failed: cudaError {err}")
    LAUNCHES["nle_moments"] += 1
    return tuple(None if t is None else t.reshape(shape)
                 for t in (out_m, out_v, out_t))


def nle_moments(x, k: int, inner: int, texture: bool = True,
                mean: bool = True):
    """(mean_k, var_k, texture) of a channels-last stack [..., h, w, C]:
      mean = box_k(x), var = max(box_k(x^2) - mean^2, 0),
      tex  = stdfilt_k(box_inner(x)),
    reflect-101 borders, per-plane centered. `texture=False` / `mean=False`
    skip those maps (returned as None), as the collab fits need.
    CUDA tensors run K1; CPU tensors run the plain version."""
    h, w = x.shape[-3], x.shape[-2]
    if min(h, w) <= halo(k, inner, True):
        raise ValueError(f"NLE moment planes must exceed {halo(k, inner, True)}"
                         f" rows and columns, got {h}x{w}")
    if x.device.type == "cuda":
        return _launch_k1(x, k, inner, texture, mean)
    if x.device.type != "cpu":
        raise RuntimeError(f"nle_moments: no path for device {x.device}")
    return nle_moments_plain(x, k, inner, texture, mean)
