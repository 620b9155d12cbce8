"""Bayer <-> packed RGGB planes (port of yondx/isp/bayer.py:25-44).

RGGB channel order = [x[0::2,0::2], x[0::2,1::2], x[1::2,0::2], x[1::2,1::2]].
"""
from __future__ import annotations


def bayer2rggb(bayer):
    """[..., H, W] -> [..., H/2, W/2, 4] 2x2-block packing."""
    shp = tuple(bayer.shape)
    H, W = shp[-2], shp[-1]
    x = bayer.reshape(shp[:-2] + (H // 2, 2, W // 2, 2))
    x = x.movedim(-3, -2)                       # [..., H/2, W/2, 2, 2]
    return x.reshape(shp[:-2] + (H // 2, W // 2, 4))


def rggb2bayer(rggb):
    """[..., H/2, W/2, 4] -> [..., H, W], inverse of bayer2rggb."""
    shp = tuple(rggb.shape)
    h, w = shp[-3], shp[-2]
    x = rggb.reshape(shp[:-3] + (h, w, 2, 2))
    x = x.movedim(-2, -3)                       # [..., h, 2, w, 2]
    return x.reshape(shp[:-3] + (h * 2, w * 2))
