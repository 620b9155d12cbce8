"""Bayer <-> packed RGGB planes, CFA rotation and flips, row splits and
the gray blur (port of yondx/isp/bayer.py).

RGGB channel order = [x[0::2,0::2], x[0::2,1::2], x[1::2,0::2], x[1::2,1::2]].
"""
from __future__ import annotations

import torch


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


def bayer_aug(rggb, k: int = 0):
    """Rotate the underlying bayer mosaic by 90*k degrees (CFA phase):
    rggb -> bayer -> rot90(k) over the last two axes -> rggb."""
    if k % 4 == 0:
        return rggb
    bayer = torch.rot90(rggb2bayer(rggb), k % 4, dims=(-2, -1))
    return bayer2rggb(bayer)


# SIDD bayer_2by2 patterns (1=R, 2=G, 3=B) -> rot90 count to RGGB
# (yondx/isp/bayer.py:58-64)
_PATTERN_TO_K = {
    ((1, 2), (2, 3)): 0,  # RGGB
    ((2, 1), (3, 2)): 3,  # GRBG
    ((2, 3), (1, 2)): 1,  # GBRG
    ((3, 2), (2, 1)): 2,  # BGGR
}


def rot_bayer_k(bayer_2by2) -> int:
    """Pattern -> rot90 count that maps the CFA to RGGB."""
    key = tuple(tuple(int(v) for v in row) for row in bayer_2by2)
    if key not in _PATTERN_TO_K:
        raise ValueError(f"Unknown Bayer pattern: {bayer_2by2}")
    return _PATTERN_TO_K[key]


def rot_bayer(image, bayer_2by2, rev: bool = False, axes=(-2, -1)):
    """Rotate a bayer-domain tensor so its CFA reads RGGB; `rev=True`
    undoes it."""
    k = rot_bayer_k(bayer_2by2)
    if rev:
        k = (4 - k) % 4
    if k == 0:
        return image
    return torch.rot90(image, k=k, dims=axes)


def flip_bayer(image, bayer_2by2):
    """Flip-based CFA normalization to RGGB (the SIDD sRGB render's):
    flips of the last two axes, by the pattern."""
    key = tuple(tuple(int(v) for v in row) for row in bayer_2by2)
    if key == ((1, 2), (2, 3)):
        return image
    if key == ((2, 1), (3, 2)):
        return torch.flip(image, dims=(-1,))
    if key == ((2, 3), (1, 2)):
        return torch.flip(image, dims=(-2,))
    if key == ((3, 2), (2, 1)):
        return torch.flip(image, dims=(-2, -1))
    raise ValueError(f"Unknown Bayer pattern: {bayer_2by2}")


def bayer2rows(bayer):
    """[..., H, W] -> [..., 2, H/2, W]: the even rows, then the odd."""
    return torch.stack((bayer[..., 0::2, :], bayer[..., 1::2, :]), dim=-3)


def rows2bayer(rows):
    """[..., 2, H/2, W] -> [..., H, W], inverse of bayer2rows."""
    shp = tuple(rows.shape)
    out = torch.stack((rows[..., 0, :, :], rows[..., 1, :, :]), dim=-2)
    return out.reshape(shp[:-3] + (shp[-2] * 2, shp[-1]))


def bayer2gray(bayer):
    """Bayer -> gray by the separable [1, 2, 1] / 4 filter in each axis,
    symmetric borders (cv2.filter2D with BORDER_REFLECT)."""
    x = torch.cat([bayer[..., :1, :], bayer, bayer[..., -1:, :]], dim=-2)
    x = torch.cat([x[..., :1], x, x[..., -1:]], dim=-1)
    k = (0.25, 0.5, 0.25)
    x = x[..., :-2, :] * k[0] + x[..., 1:-1, :] * k[1] + x[..., 2:, :] * k[2]
    return x[..., :-2] * k[0] + x[..., 1:-1] * k[1] + x[..., 2:] * k[2]
