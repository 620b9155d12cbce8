"""NLE box moments: the wrapper of kernel K1 (csrc/nle_moments.cu).

K1 replaces the Pallas TPU kernel yondx/nle/pallas_ops.py::_moments_kernel
(launched by _pallas_moments_planes, entry fused_moments). A CUDA tensor
launches K1 (or raises); a CPU tensor takes the plain PyTorch version in
boxfilter.py. There is no fallback between the two.

Bound on an H100 SXM at the main path's shape (bands of a 3072x4096 Bayer
frame: [2, 256, 2048, 4] fp32 = 8 planes of 256x2048): bytes. One read
of 16.8 MB and one write of 16.8 MB per map: 67.1 MB for the self fit's
three maps, 0.0200 ms at 3.35 TB/s (collab fits: 50.3 MB / 0.0150 ms for
mean and var, 33.5 MB / 0.0100 ms for var). The function needs ~36 fp32
operations per output with sliding box sums (0.15 GFLOP, ~2 us at
67 TFLOP/s). K1 stages a halo'd tile per block and channel, centered on
one of its own samples (so nothing runs before it), and slides every box
sum in registers over runs of at most 32 outputs. Its time is reported
beside this bound in PERF.md.
"""
from __future__ import annotations

import torch

from . import boxfilter

# launches of K1 since the last reset (one per kernel launch, nowhere else)
LAUNCHES = {"nle_moments": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


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
    out_m = torch.empty((L, h, w, C), device=x.device) if mean else None
    out_v = torch.empty((L, h, w, C), device=x.device)
    out_t = torch.empty((L, h, w, C), device=x.device) if texture else None
    sl, sy, sx, sc = x4.stride()
    lib = load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.yondx_nle_moments(
        x4.data_ptr(), out_m.data_ptr() if mean else None, out_v.data_ptr(),
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
    reflect-101 borders, centered (per plane in the plain version, per
    tile in K1). `texture=False` / `mean=False`
    skip those maps (returned as None), as the collab fits need.
    Any plane of at least 1x1 is taken: borders reflect periodically
    when a window is wider than the plane, as jnp.pad(mode='reflect').
    CUDA tensors run K1; CPU tensors run the plain version."""
    if x.device.type == "cuda":
        return _launch_k1(x, k, inner, texture, mean)
    if x.device.type != "cpu":
        raise RuntimeError(f"nle_moments: no path for device {x.device}")
    return nle_moments_plain(x, k, inner, texture, mean)
