"""Masked least-squares line fit var ~ beta1 * mean + beta2 (port of
yondx/nle/fit.py:19-41,73-80): weighted centered normal equations."""
from __future__ import annotations

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
