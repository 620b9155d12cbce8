"""Line fits var ~ beta1 * mean + beta2 (port of yondx/nle/fit.py): the
masked least-squares fit by weighted centered normal equations, the
saturation filter of its weights, and the reference's host RANSAC fit."""
from __future__ import annotations

import numpy as np
import torch


def masked_linefit(x, y, w):
    """Weighted line fit -> (beta1, beta2); degenerate masks give (0, 0)."""
    x = x.reshape(-1).float()
    y = y.reshape(-1).float()
    w = w.reshape(-1).float()
    n = torch.sum(w)
    safe_n = torch.clamp(n, min=1.0)
    xbar = torch.sum(w * x) / safe_n
    ybar = torch.sum(w * y) / safe_n
    dx = x - xbar
    dy = y - ybar
    sxx = torch.sum(w * dx * dx)
    sxy = torch.sum(w * dx * dy)
    zero = torch.zeros_like(sxx)
    beta1 = torch.where(sxx > 0, sxy / torch.clamp(sxx, min=1e-30), zero)
    beta2 = ybar - beta1 * xbar
    ok = n > 0
    return torch.where(ok, beta1, zero), torch.where(ok, beta2, zero)


def nonsat_weights(x, w):
    """Keep 1e-4 < x < 0.8 if that retains > 1% of the masked points."""
    nonsat = (x > 1e-4) & (x < 0.8)
    w2 = w * nonsat
    keep = torch.sum(w2) > 0.01 * torch.sum(w)
    return torch.where(keep, w2, w)


def ransac_linefit(x, y, mask=None, min_samples: int | None = None,
                   n_trials: int = 64, seed: int = 2024):
    """Host RANSAC line fit (the reference's ransac=True branch, seeded
    2024 as there): n_trials least-squares fits of min_samples points
    (default sqrt(n)) drawn without replacement by
    numpy.random.default_rng(seed); the model with the most inliers
    (|residual| under the median absolute deviation of y) is refit on its
    inliers. Returns (beta1, beta2); fewer than 2 points give (0, 0)."""
    x = np.asarray(x, np.float64).reshape(-1)
    y = np.asarray(y, np.float64).reshape(-1)
    if mask is not None:
        keep = np.asarray(mask).reshape(-1) > 0
        x, y = x[keep], y[keep]
    n = len(x)
    if n < 2:
        return 0.0, 0.0
    rng = np.random.default_rng(seed)
    m = min_samples or max(int(np.sqrt(n)), 2)
    resid_scale = max(np.median(np.abs(y - np.median(y))), 1e-12)
    best_inl, best = -1, (0.0, 0.0)
    for _ in range(n_trials):
        idx = rng.choice(n, size=m, replace=False)
        A = np.vstack([x[idx], np.ones(m)]).T
        (b1, b2), *_ = np.linalg.lstsq(A, y[idx], rcond=None)
        inl = np.abs(y - (b1 * x + b2)) < resid_scale
        if inl.sum() > best_inl:
            A2 = np.vstack([x[inl], np.ones(int(inl.sum()))]).T
            best = tuple(np.linalg.lstsq(A2, y[inl], rcond=None)[0])
            best_inl = int(inl.sum())
    return float(best[0]), float(best[1])
