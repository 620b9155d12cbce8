"""Separable box-filter statistics, reflect-101 borders (cv2.blur
semantics); the plain PyTorch version of the NLE moments (port of
yondx/nle/boxfilter.py), and `np_box_mean`, a numpy box mean of the
port's own in place of the JAX package's cv2.blur.

Prefix sums run on per-plane centered data, so fp32 cancellation stays
~1e-6 on 2k-pixel rows. Layout: [..., H, W, C] (or [H, W] for box_mean).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tiling import reflect_pad


def _box1d_cumsum(x, k: int, axis: int):
    """Sliding-window mean along `axis` by prefix sums, reflect-101."""
    pad = k // 2
    axis = axis % x.ndim
    xp = reflect_pad(x, axis, pad, pad)
    cs = torch.cumsum(xp.float(), dim=axis)
    zshape = list(cs.shape)
    zshape[axis] = 1
    cs = torch.cat([cs.new_zeros(zshape), cs], dim=axis)
    n = x.shape[axis]
    hi = cs.narrow(axis, k, n)
    lo = cs.narrow(axis, 0, n)
    return (hi - lo) * (1.0 / k)


def _box2d(x, k: int):
    """[..., H, W, C] separable box mean of per-plane centered data."""
    c = torch.mean(x, dim=(-3, -2), keepdim=True)
    y = _box1d_cumsum(x - c, k, x.ndim - 3)
    y = _box1d_cumsum(y, k, x.ndim - 2)
    return y + c


def box_mean(x, k: int):
    """cv2.blur(x, (k, k)); [H, W] is one plane, ndim >= 3 is
    [..., H, W, C]. The JAX package computes the same mean two ways, by
    prefix sums (its box_mean) and by two k-tap convolutions (its
    _sep_blur); this one serves for both."""
    if x.ndim == 2:
        return _box2d(x[..., None], k)[..., 0]
    return _box2d(x, k)


def varfilt(x, k: int):
    """Local variance E[x^2] - E[x]^2 on per-plane centered data."""
    squeeze = x.ndim == 2
    if squeeze:
        x = x[..., None]
    c = torch.mean(x, dim=(-3, -2), keepdim=True)
    xc = x - c
    both = _box2d(torch.cat([xc, xc * xc], dim=-1), k)
    n = x.shape[-1]
    m, m2 = both[..., :n], both[..., n:]
    out = m2 - m * m
    return out[..., 0] if squeeze else out


def stdfilt(x, k: int):
    """Local std sqrt(max(var_k, 0))."""
    return torch.sqrt(torch.clamp(varfilt(x, k), min=0.0))


def mean_varfilt(x, k: int):
    """(mean_k, max(var_k, 0)) of [..., h, w, C] in one stacked pass."""
    c = torch.mean(x, dim=(-3, -2), keepdim=True)
    xc = x - c
    n = x.shape[-1]
    both = _box2d(torch.cat([xc, xc * xc], dim=-1), k)
    m, m2 = both[..., :n], both[..., n:]
    return m + c, torch.clamp(m2 - m * m, min=0.0)


def nle_moments(x, k: int, inner: int):
    """(mean_k, var_k, texture) of [..., h, w, C]:
      mean    = blur_k(x)
      var     = max(blur_k(x^2) - mean^2, 0)      (centered)
      texture = stdfilt_k(blur_inner(x))"""
    mean, var = mean_varfilt(x, k)
    c = torch.mean(x, dim=(-3, -2), keepdim=True)
    t1 = _box2d(x - c, inner)
    n = x.shape[-1]
    tb = _box2d(torch.cat([t1, t1 * t1], dim=-1), k)
    tm, tm2 = tb[..., :n], tb[..., n:]
    tex = torch.sqrt(torch.clamp(tm2 - tm * tm, min=0.0))
    return mean, var, tex


def var_corr(x, k: int):
    """Mean^2 / mean-of-squares ratio map box_k(x)^2 / box_k(x^2) (the
    reference's var_corr): the content-vs-noise correction factor of
    variance fits on textured regions."""
    m = box_mean(x, k)
    m2 = box_mean(x * x, k)
    return (m * m) / torch.clamp(m2, min=1e-20)


def np_box_mean(x: np.ndarray, k: int) -> np.ndarray:
    """cv2.blur(x, (k, k)) in numpy: the k x k mean of the first two axes
    of x ([H, W] or [H, W, C]) with reflect-101 borders, summed in float64
    and returned in x's dtype (integers rounded half to even and clipped
    to their range, as cv2 saturates)."""
    x = np.asarray(x)
    pad = k // 2
    cfg = [(pad, pad), (pad, pad)] + [(0, 0)] * (x.ndim - 2)
    y = np.pad(x.astype(np.float64), cfg, mode="reflect")
    for axis, n in ((0, x.shape[0]), (1, x.shape[1])):
        cs = np.cumsum(y, axis=axis)
        zero = np.zeros_like(np.take(cs, [0], axis=axis))
        cs = np.concatenate([zero, cs], axis=axis)
        y = np.take(cs, np.arange(k, k + n), axis=axis) \
            - np.take(cs, np.arange(n), axis=axis)
    y = y / (k * k)
    if np.issubdtype(x.dtype, np.integer):
        info = np.iinfo(x.dtype)
        y = np.clip(np.rint(y), info.min, info.max)
    return y.astype(x.dtype)
