"""Stride-style raw packing, DN normalization and bad-pixel repair (port
of yondx/isp/raw_io.py).

- `pack_raw` / `unpack_raw`: RGBG channel order (R@00, G1@01, B@11,
  G2@10), the noise-modeling convention, against the reshape-style RGGB
  of bayer2rggb;
- `raw2bayer`: RGBG planes channel-first with (x - bl) / (wp - bl) and a
  per-channel bias; `bayer2raw`, its inverse to uint16 DN;
- `repair_bad_pixels`: the per-plane 3x3 median at listed coordinates,
  through `median3x3`, the port's own in place of cv2.medianBlur;
- `space_to_depth` / `depth_to_space` and the SIDD cameras' BGGR
  normalization (`to_bggr` / `from_bggr`).
Each takes a tensor or a numpy array and returns the same kind.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .bayer import bayer2rggb, rggb2bayer


def _in(x):
    return (x, False) if isinstance(x, torch.Tensor) else \
        (torch.from_numpy(np.ascontiguousarray(x)), True)


def _out(t, as_numpy):
    return t.numpy() if as_numpy else t


def pack_raw(bayer):
    """[H, W] -> [H/2, W/2, 4] RGBG order (R, G1, B, G2)."""
    x, np_ = _in(bayer)
    return _out(torch.stack([x[0::2, 0::2], x[0::2, 1::2], x[1::2, 1::2],
                             x[1::2, 0::2]], dim=-1), np_)


def unpack_raw(raw4ch):
    """[h, w, 4] RGBG -> [2h, 2w] bayer."""
    x, np_ = _in(raw4ch)
    h, w = x.shape[:2]
    out = torch.zeros((h * 2, w * 2), dtype=x.dtype, device=x.device)
    out[0::2, 0::2] = x[..., 0]
    out[0::2, 1::2] = x[..., 1]
    out[1::2, 1::2] = x[..., 2]
    out[1::2, 0::2] = x[..., 3]
    return _out(out, np_)


def raw2bayer(raw, wp: int = 1023, bl: int = 64, norm: bool = True,
              clip: bool = False, bias=np.zeros(4)):
    """DN bayer [H, W] -> channel-first RGBG planes [4, H/2, W/2] float32,
    (x - bl - bias) / (wp - bl - bias) in float64 when normalized."""
    x, np_ = _in(raw)
    x = x.to(torch.float32)
    out = torch.stack([x[0::2, 0::2], x[0::2, 1::2], x[1::2, 1::2],
                       x[1::2, 0::2]], dim=0)
    if norm:
        b = torch.as_tensor(np.asarray(bias) + bl,
                            device=x.device).reshape(4, 1, 1)
        out = (out - b) / (wp - b)
    if clip:
        out = torch.clamp(out, 0, 1)
    return _out(out.to(torch.float32), np_)


def bayer2raw(packed, wp: int = 16383, bl: int = 512):
    """[4, h, w] normalized RGBG -> uint16 DN bayer [2h, 2w] (truncated,
    as numpy's cast)."""
    x, np_ = _in(packed)
    x = torch.clamp(x.to(torch.float32), 0, 1) * (wp - bl) + bl
    _, h, w = x.shape
    out = torch.empty((h * 2, w * 2), dtype=torch.int32, device=x.device)
    out[0::2, 0::2] = x[0].to(torch.int32)
    out[0::2, 1::2] = x[1].to(torch.int32)
    out[1::2, 1::2] = x[2].to(torch.int32)
    out[1::2, 0::2] = x[3].to(torch.int32)
    if np_:
        return out.numpy().astype(np.uint16)
    return out.to(torch.uint16)


def median3x3(x):
    """The 3x3 median of each [..., H, W] plane with replicated borders
    (cv2.medianBlur(x, 3) on float32 planes)."""
    t, np_ = _in(x)
    lead, (H, W) = t.shape[:-2], t.shape[-2:]
    v = t if t.is_floating_point() else t.to(torch.int32)
    p = F.pad(v.reshape(-1, 1, H, W), (1, 1, 1, 1), mode="replicate")
    win = torch.stack([p[:, 0, i:i + H, j:j + W] for i in range(3)
                       for j in range(3)], dim=-1)
    med = torch.sort(win, dim=-1).values[..., 4].to(t.dtype)
    return _out(med.reshape(lead + (H, W)), np_)


def repair_bad_pixels(raw, bad_points):
    """Replace the listed (y, x) bayer coordinates by the 3x3 median of
    their RGGB plane."""
    x, np_ = _in(raw)
    # the JAX package's jnp.asarray: float64 drops to float32
    rggb = bayer2rggb(x.float() if x.dtype == torch.float64 else x)
    fixed = rggb2bayer(median3x3(rggb.movedim(-1, 0)).movedim(0, -1))
    out = x.clone()
    for (y, xx) in bad_points:
        out[y, xx] = fixed[y, xx]
    return _out(out, np_)


def space_to_depth(x, block: int = 2):
    """[H, W, C] -> [H/b, W/b, b*b*C]."""
    t, np_ = _in(x)
    H, W, C = t.shape
    y = t.reshape(H // block, block, W // block, block, C).transpose(1, 2)
    return _out(y.reshape(H // block, W // block, -1), np_)


def depth_to_space(x, block: int = 2):
    """[h, w, b*b*C] -> [h*b, w*b, C], inverse of space_to_depth."""
    t, np_ = _in(x)
    h, w, _ = t.shape
    y = t.reshape(h, w, block, block, -1).transpose(1, 2)
    return _out(y.reshape(h * block, w * block, -1), np_)


def to_bggr(patch, cam: str):
    """A SIDD camera's bayer patch turned so its CFA reads BGGR: IP
    (RGGB) by 180 degrees, S6 (GBRG) flipped left-right; GP, N6 and G4
    are BGGR already."""
    t, np_ = _in(patch)
    if cam == "IP":
        t = torch.rot90(t, 2, dims=(0, 1))
    elif cam == "S6":
        t = torch.flip(t, dims=(1,))
    return _out(t, np_)


def from_bggr(patch, cam: str):
    """Inverse of to_bggr (each of its turns is its own inverse)."""
    return to_bggr(patch, cam)
