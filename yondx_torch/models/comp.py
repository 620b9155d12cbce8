"""Comparison model zoo (port of yondx/models/comp.py): `est_UNet`, the
PGE-Net noise estimator.

Channels-last [B, H, W, C] in, NCHW inside (as models/unets.py);
submodule names are the flax names, so models/convert.py maps the
committed checkpoint by path.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import UpConvT, conv1x1, conv3x3


class est_UNet(nn.Module):  # noqa: N801 (the registry's arch name)
    """Shallow add-merge UNet -> 1x1 head -> squared map -> spatial mean
    -> [K, sigma] per sample (yondx/models/comp.py:58-88). The squared
    branch is unconditional, as in the reference (its `use_type` check
    compares against a misspelt name)."""

    def __init__(self, args: Dict[str, Any]):
        super().__init__()
        depth, nf = args["depth"], args["nf"]
        self.depth = depth
        cin = args.get("in_nc", 4)
        f = nf
        for i in range(depth):
            f = nf * (2 ** i)
            setattr(self, f"down{i}_1", conv3x3(cin, f))
            setattr(self, f"down{i}_2", conv3x3(f, f))
            cin = f
        for i in range(depth - 1):
            setattr(self, f"up{i}_deconv", UpConvT(f, f // 2))
            f = f // 2
            setattr(self, f"up{i}_1", conv3x3(f, f))
            setattr(self, f"up{i}_2", conv3x3(f, f))
        self.conv_final = conv1x1(f, args["out_nc"])

    def forward(self, x):
        """x: [B, H, W, C] -> [out_nc] for B == 1, else [B, out_nc] (the
        flax model's trailing squeeze)."""
        h = x.permute(0, 3, 1, 2)
        skips = []
        for i in range(self.depth):
            h = F.relu(getattr(self, f"down{i}_1")(h))
            h = F.relu(getattr(self, f"down{i}_2")(h))
            skips.append(h)
            if i < self.depth - 1:
                h = F.max_pool2d(h, 2, 2)
        for i in range(self.depth - 1):
            h = getattr(self, f"up{i}_deconv")(h) + skips[-(i + 2)]
            h = F.relu(getattr(self, f"up{i}_1")(h))
            h = F.relu(getattr(self, f"up{i}_2")(h))
        out = self.conv_final(h) ** 2
        return torch.mean(out, dim=(2, 3)).squeeze()
