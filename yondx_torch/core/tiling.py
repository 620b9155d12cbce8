"""Reflect padding to a multiple and overlap tiling (port of
yondx/core/tiling.py:30-125)."""
from __future__ import annotations

import math

import numpy as np
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


def tile_grid(H: int, W: int, tile: int, halo: int):
    """Static tiling plan of an HxW frame: tiles of `tile` interior pixels
    plus a `halo` ring on a stride-`tile` grid, the frame reflect-padded so
    every tile is full-size. Returns (ny, nx, padded_H, padded_W)."""
    ny = max(1, math.ceil(H / tile))
    nx = max(1, math.ceil(W / tile))
    return ny, nx, ny * tile + 2 * halo, nx * tile + 2 * halo


def tile_overlap(x, tile: int = 512, halo: int = 64):
    """Split an [H, W] or [H, W, C] tensor into [ny*nx, tile+2*halo,
    tile+2*halo(, C)] on its own device; returns (tiles, (ny, nx, H, W))."""
    H, W = x.shape[:2]
    ny, nx, _, _ = tile_grid(H, W, tile, halo)
    xp = reflect_pad(x, 0, halo, halo + ny * tile - H)
    xp = reflect_pad(xp, 1, halo, halo + nx * tile - W)
    ts = tile + 2 * halo
    tiles = [xp[iy * tile:iy * tile + ts, ix * tile:ix * tile + ts]
             for iy in range(ny) for ix in range(nx)]
    return torch.stack(tiles), (ny, nx, H, W)


def untile_overlap(tiles, plan, halo: int = 64):
    """Merge tiles of `tile_overlap`, cropping the halo ring."""
    ny, nx, H, W = plan
    tile = tiles.shape[1] - 2 * halo
    core = tiles[:ny * nx, halo:halo + tile, halo:halo + tile]
    core = core.reshape((ny, nx, tile, tile) + tuple(tiles.shape[3:]))
    out = core.transpose(1, 2).reshape((ny * tile, nx * tile)
                                       + tuple(tiles.shape[3:]))
    return out[:H, :W]


def np_tile_overlap(x: np.ndarray, tile: int = 512, halo: int = 64):
    """Host (numpy) twin of tile_overlap."""
    H, W = x.shape[:2]
    ny, nx, _, _ = tile_grid(H, W, tile, halo)
    pad = [(halo, halo + ny * tile - H), (halo, halo + nx * tile - W)] \
        + [(0, 0)] * (x.ndim - 2)
    xp = np.pad(x, pad, mode="reflect")
    ts = tile + 2 * halo
    out = np.empty((ny * nx, ts, ts) + x.shape[2:], x.dtype)
    for iy in range(ny):
        for ix in range(nx):
            out[iy * nx + ix] = xp[iy * tile:iy * tile + ts,
                                   ix * tile:ix * tile + ts]
    return out, (ny, nx, H, W)
