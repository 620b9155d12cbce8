"""Data augmentation of the AWGN trainer's RGB mode (port of
yondx/data/augment.py:30-46)."""
from __future__ import annotations

import torch


def data_aug8(imgs, modes):
    """8-way rot/flip augmentation of square crops: imgs [B, S, S, C],
    modes [B] ints; mode % 4 = rot90 count over (H, W), mode // 4 > 0 =
    then a flip of the width axis."""
    modes = [int(m) for m in torch.as_tensor(modes).tolist()]
    out = []
    for img, mode in zip(imgs, modes):
        img = torch.rot90(img, mode % 4, dims=(0, 1))
        if mode // 4 > 0:
            img = torch.flip(img, dims=(1,))
        out.append(img)
    return torch.stack(out)
