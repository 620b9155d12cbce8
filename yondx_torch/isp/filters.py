"""Spatial filters: guided filter, row-noise removal, log-domain 1-D blur
(port of yondx/isp/filters.py), on tensors of any device.

- `guided_filter` / `fast_guided_filter`: He et al.'s guided filter from
  box means (nle/boxfilter.box_mean, reflect-101 borders as in JAX); the
  fast variant forms the coefficients at half resolution;
- `row_denoise`: per Bayer-row-plane row means, smoothed by a 1-D
  bilateral (d = 25, sigma_color = 10, sigma_space = 1 + iso / 200), and
  the residual subtracted;
- `blur1d_log`: 3-tap smoothing in the log2 domain, endpoints kept.
"""
from __future__ import annotations

import numpy as np
import torch

from ..nle.boxfilter import box_mean
from .bayer import bayer2rows, rows2bayer


def guided_filter(p, I, d: int = 7, eps: float = 1.0):
    """He et al.'s guided filter of target p by guide I (the same shape,
    [H, W] or [H, W, C]), box window d, regularizer eps."""
    mu_p, mu_I = box_mean(p, d), box_mean(I, d)
    var = box_mean(I * I, d) - mu_I * mu_I
    cov = box_mean(I * p, d) - mu_I * mu_p
    a = cov / (var + eps)
    b = mu_p - a * mu_I
    return box_mean(a, d) * I + box_mean(b, d)


def _down2(x):
    return 0.25 * (x[0::2, 0::2] + x[1::2, 0::2] + x[0::2, 1::2]
                   + x[1::2, 1::2])


def _up2(x, H, W):
    return x.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)[:H, :W]


def fast_guided_filter(p, I, d: int = 7, eps: float = 1.0):
    """The guided filter with its coefficients formed at half resolution
    and repeated back up."""
    H, W = I.shape[:2]
    p_lr, I_lr = _down2(p), _down2(I)
    mu_p, mu_I = box_mean(p_lr, d), box_mean(I_lr, d)
    var = box_mean(I_lr * I_lr, d) - mu_I * mu_I
    cov = box_mean(I_lr * p_lr, d) - mu_I * mu_p
    a = cov / (var + eps)
    b = mu_p - a * mu_I
    return _up2(box_mean(a, d), H, W) * I + _up2(box_mean(b, d), H, W)


def bilateral_1d(signal, d: int = 25, sigma_color: float = 10.0,
                 sigma_space: float = 1.0):
    """1-D bilateral filter of a [N] signal (cv2.bilateralFilter's
    weights; radius d // 2, replicated ends)."""
    r = d // 2
    n = signal.shape[0]
    offs = np.arange(-r, r + 1)
    space_w = torch.as_tensor(np.exp(-(offs ** 2) / (2.0 * sigma_space ** 2)),
                              dtype=signal.dtype, device=signal.device)
    idx = torch.as_tensor(np.clip(np.arange(n)[:, None] + offs[None, :], 0,
                                  n - 1), device=signal.device)
    win = signal[idx]
    color_w = torch.exp(-((win - signal[:, None]) ** 2)
                        / (2.0 * sigma_color ** 2))
    w = color_w * space_w[None, :]
    return torch.sum(w * win, dim=1) / torch.sum(w, dim=1)


def row_denoise(bayer, iso: float):
    """Row-noise removal of a bayer frame [H, W]: in each of its two row
    planes, each row less (its mean - the bilateral-smoothed mean)."""
    rows = bayer2rows(bayer)
    out = []
    for i in range(2):
        means = torch.mean(rows[i], dim=1)
        smooth = bilateral_1d(means, 25, sigma_color=10.0,
                              sigma_space=1.0 + iso / 200.0)
        out.append(rows[i] - (means - smooth)[:, None])
    return rows2bayer(torch.stack(out))


def blur1d_log(data, c: float = 0.5, log: bool = True):
    """3-tap smoothing along the first axis, x[i] * c + (x[i-1] + x[i+1])
    * (1 - c) / 2, of log2(data) (of data with log=False), the endpoints
    kept."""
    x = torch.log2(data) if log else data
    if x.shape[0] > 2:
        mid = x[1:-1] * c + (x[:-2] + x[2:]) * (1 - c) / 2
        x = torch.cat([x[:1], mid, x[-1:]])
    return 2.0 ** x if log else x
