"""The edge-aware demosaic of the port's own, in place of the JAX package's
`cv2.cvtColor(bayer_u16, cv2.COLOR_BayerBG2RGB_EA)`: integer arithmetic
on the tensor's device, bit-equal to cv2 on the CPU
(tests/test_torch_isp.py).

The mosaic has R at (even, even) and B at (odd, odd); the output is RGB.
At an interior pixel:
  - an R or B site keeps its own colour; its G is the mean of the two
    vertical neighbours where |left - right| > |up - down|, else of the
    two horizontal ones (a tie goes horizontal), each mean rounded up,
    (a + b + 1) >> 1; its opposite colour is the rounded mean of the four
    diagonals, (sum + 2) >> 2;
  - a G site in an R row takes R from its left and right neighbours and B
    from those above and below, rounded as above; in a B row the two swap.
Border: column 0 copies column 1 and the last column the one before it;
then row 0 copies row 1 and the last row the one before it.
"""
from __future__ import annotations

import numpy as np
import torch


def demosaic_ea(bayer):
    """[..., H, W] integer mosaic (uint16 values) -> [..., H, W, 3] RGB of
    the same dtype (a numpy array in, a numpy array out)."""
    as_numpy = isinstance(bayer, np.ndarray)
    x = torch.from_numpy(bayer.astype(np.int32)) if as_numpy else bayer
    dtype = x.dtype
    x = x.to(torch.int32)
    H, W = x.shape[-2:]
    out = torch.zeros(x.shape + (3,), dtype=torch.int32, device=x.device)
    if H > 2 and W > 2:
        c = x[..., 1:-1, 1:-1]
        up, down = x[..., :-2, 1:-1], x[..., 2:, 1:-1]
        left, right = x[..., 1:-1, :-2], x[..., 1:-1, 2:]
        hor = (left + right + 1) >> 1
        ver = (up + down + 1) >> 1
        diag = (x[..., :-2, :-2] + x[..., :-2, 2:] + x[..., 2:, :-2]
                + x[..., 2:, 2:] + 2) >> 2
        g_rb = torch.where((left - right).abs() > (up - down).abs(), ver, hor)
        ev_r = (torch.arange(1, H - 1, device=x.device) % 2 == 0)[:, None]
        ev_c = (torch.arange(1, W - 1, device=x.device) % 2 == 0)[None, :]
        r_site, b_site = ev_r & ev_c, ~ev_r & ~ev_c
        g_rrow, g_brow = ev_r & ~ev_c, ~ev_r & ev_c
        red = torch.where(r_site, c, torch.where(
            b_site, diag, torch.where(g_rrow, hor, ver)))
        blue = torch.where(b_site, c, torch.where(
            r_site, diag, torch.where(g_rrow, ver, hor)))
        green = torch.where(r_site | b_site, g_rb, c)
        out[..., 1:-1, 1:-1, :] = torch.stack([red, green, blue], -1)
    if W > 1:
        out[..., 1:-1, 0, :] = out[..., 1:-1, 1, :]
        out[..., 1:-1, -1, :] = out[..., 1:-1, -2, :]
    if H > 1:
        out[..., 0, :, :] = out[..., 1, :, :]
        out[..., -1, :, :] = out[..., -2, :, :]
    if as_numpy:
        return out.numpy().astype(bayer.dtype)
    return out.to(dtype)
