"""Reflect padding to a multiple (port of yondx/core/tiling.py:30-58)."""
from __future__ import annotations

import torch


def reflect_index(n: int, before: int, after: int, device) -> torch.Tensor:
    """Source indices of a reflect-101 (numpy 'reflect') extension of a
    length-n axis by `before`/`after` samples; any pad width."""
    i = torch.arange(-before, n + after, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


def reflect_pad(x, axis: int, before: int, after: int):
    """numpy/jnp.pad(mode='reflect') along one axis."""
    if before == 0 and after == 0:
        return x
    axis = axis % x.ndim
    idx = reflect_index(x.shape[axis], before, after, x.device)
    return torch.index_select(x, axis, idx)


def _axes(ndim: int, channels_last: bool):
    return (ndim - 3, ndim - 2) if channels_last else (ndim - 2, ndim - 1)


def pad_to_multiple(x, base: int = 32, channels_last: bool = True):
    """Reflect-pad the spatial dims up to a multiple of `base`; the larger
    half goes at the bottom/right. Returns (padded, (top, bottom, left,
    right))."""
    hax, wax = _axes(x.ndim, channels_last)
    H, W = x.shape[hax], x.shape[wax]
    ph = (-H) % base
    pw = (-W) % base
    top, bottom = ph // 2, ph - ph // 2
    left, right = pw // 2, pw - pw // 2
    x = reflect_pad(x, hax, top, bottom)
    x = reflect_pad(x, wax, left, right)
    return x, (top, bottom, left, right)


def unpad(x, p2d, channels_last: bool = True):
    """Invert `pad_to_multiple`."""
    top, bottom, left, right = p2d
    hax, wax = _axes(x.ndim, channels_last)
    x = x.narrow(hax, top, x.shape[hax] - top - bottom)
    return x.narrow(wax, left, x.shape[wax] - left - right)
