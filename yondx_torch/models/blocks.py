"""Building blocks of the SNR-Net (port of yondx/models/blocks.py).

Modules run in NCHW; submodule names match the flax names so that
`models.convert.params_to_state_dict` maps weights by path. The scalar
guidance t is a [B] vector through Linear layers (flax Dense).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def data_normalize(x):
    """Per-sample max normalization (lower bound pinned at 0)."""
    ub = torch.amax(x, dim=(1, 2, 3), keepdim=True)
    ub = torch.clamp(ub, min=1e-8)
    return x / ub, 0.0, ub


def data_inv_normalize(x, lb, ub):
    return x * (ub - lb) + lb


class GuideMLP(nn.Module):
    """t [B] -> per-channel FiLM params (tk, tb), each [B, f, 1, 1]."""

    def __init__(self, features: int):
        super().__init__()
        self.gamma_in = nn.Linear(1, features)
        self.gamma_out = nn.Linear(features, features)
        self.beta_out = nn.Linear(features, features)

    def forward(self, t):
        t = t.reshape(-1, 1)
        tk = self.gamma_out(F.silu(self.gamma_in(t)))
        tb = self.beta_out(F.silu(tk))
        return tk[:, :, None, None], tb[:, :, None, None]


def conv3x3(cin: int, cout: int) -> nn.Conv2d:
    """3x3 SAME conv (stride 1: symmetric padding 1)."""
    return nn.Conv2d(cin, cout, 3, padding=1)


def conv1x1(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 1)


class StridedDown(nn.Module):
    """Stride-2 3x3 conv with explicit (1, 1) padding (blocks.py:80-84)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class UpConvT(nn.Module):
    """2x2 stride-2 transposed conv."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.deconv = nn.ConvTranspose2d(cin, cout, 2, stride=2)

    def forward(self, x):
        return self.deconv(x)


class ShortCut(nn.Module):
    """Identity, or a 1x1 conv when the channel count changes."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = conv1x1(cin, cout) if cin != cout else None

    def forward(self, x):
        return x if self.conv is None else self.conv(x)


class GuidedResidualBlock(nn.Module):
    """FiLM residual block: shortcut, SiLU-conv, z*tk+tb, SiLU-conv, +x."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.short_cut = ShortCut(cin, features)
        self.conv1 = conv3x3(features, features)
        self.guide = GuideMLP(features)
        self.conv2 = conv3x3(features, features)

    def forward(self, x, t):
        x = self.short_cut(x)
        z = self.conv1(F.silu(x))
        tk, tb = self.guide(t)
        z = z * tk + tb
        z = self.conv2(F.silu(z))
        return z + x


class SNRBlock(nn.Module):
    """Two-scale multiplicative conditioning: shortcut, SiLU-conv, z *
    sfm1(t), SiLU-conv, z * sfm2(t), +x; each sfm is Linear-SiLU-Linear
    of the scalar t (flax names sfm{1,2}_{in,out})."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.short_cut = ShortCut(cin, features)
        self.conv1 = conv3x3(features, features)
        self.sfm1_in = nn.Linear(1, features)
        self.sfm1_out = nn.Linear(features, features)
        self.conv2 = conv3x3(features, features)
        self.sfm2_in = nn.Linear(1, features)
        self.sfm2_out = nn.Linear(features, features)

    def _sfm(self, i: int, t):
        h = getattr(self, f"sfm{i}_in")(t.reshape(-1, 1))
        return getattr(self, f"sfm{i}_out")(F.silu(h))[:, :, None, None]

    def forward(self, x, t):
        x = self.short_cut(x)
        z = self.conv1(F.silu(x)) * self._sfm(1, t)
        z = self.conv2(F.silu(z)) * self._sfm(2, t)
        return z + x


class ResidualBlockLRelu(nn.Module):
    """(conv-relu-conv)-LeakyReLU(0.2) + shortcut of the block's input."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv1 = conv3x3(cin, features)
        self.conv2 = conv3x3(features, features)
        self.short_cut = ShortCut(cin, features)

    def forward(self, x):
        z = self.conv2(F.relu(self.conv1(x)))
        return F.leaky_relu(z, 0.2) + self.short_cut(x)


class ResBlockSiLU(nn.Module):
    """shortcut, SiLU-conv, SiLU-conv, +x."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.short_cut = ShortCut(cin, features)
        self.conv1 = conv3x3(features, features)
        self.conv2 = conv3x3(features, features)

    def forward(self, x):
        x = self.short_cut(x)
        z = self.conv2(F.silu(self.conv1(F.silu(x))))
        return z + x


class ChannelAttention(nn.Module):
    """Squeeze-excite channel gate [B, C, 1, 1]: a shared bias-free
    two-layer MLP over the avg- and max-pooled descriptors, sigmoid."""

    def __init__(self, channels: int, ratio: int = 16):
        super().__init__()
        hidden = max(channels // ratio, 1)
        self.mlp_in = nn.Linear(channels, hidden, bias=False)
        self.mlp_out = nn.Linear(hidden, channels, bias=False)

    def forward(self, x):
        def mlp(v):
            return self.mlp_out(F.relu(self.mlp_in(v)))
        gate = mlp(torch.mean(x, dim=(2, 3))) + mlp(torch.amax(x, dim=(2, 3)))
        return torch.sigmoid(gate)[:, :, None, None]


class SpatialAttention(nn.Module):
    """Spatial gate [B, 1, H, W]: a bias-free conv over the channel mean
    and max, sigmoid."""

    def __init__(self, kernel_size: int = 3):
        super().__init__()
        self.conv = nn.Conv2d(2, 1, kernel_size, padding=kernel_size // 2,
                              bias=False)

    def forward(self, x):
        h = torch.cat([torch.mean(x, dim=1, keepdim=True),
                       torch.amax(x, dim=1, keepdim=True)], dim=1)
        return torch.sigmoid(self.conv(h))


class CBAM(nn.Module):
    """Convolutional block attention: the channel gate, then the spatial
    gate."""

    def __init__(self, channels: int):
        super().__init__()
        self.ca = ChannelAttention(channels)
        self.sa = SpatialAttention()

    def forward(self, x):
        x = self.ca(x) * x
        return self.sa(x) * x


def mask_mul(x, mask, scale_factor: int = 1):
    """Masked feature gating (NCHW): the mask's channel mean where the
    widths differ, average-pooled down by scale_factor, times x."""
    if mask.shape[1] != x.shape[1]:
        mask = torch.mean(mask, dim=1, keepdim=True)
    if scale_factor > 1:
        mask = F.avg_pool2d(mask, scale_factor, scale_factor)
    return x * mask


class UpsampleBlock(nn.Module):
    """conv -> upsample by up_scale -> relu. mode 'pixel_shuffle': a conv
    to cin * r^2 channels, then depth-to-space with flax's channel order
    (r, r, c) (torch's pixel_shuffle orders (c, r, r)); 'bilinear': a
    conv to `features`, then a bilinear resize (half-pixel centers)."""

    def __init__(self, cin: int, features: int, up_scale: int = 2,
                 mode: str = "bilinear"):
        super().__init__()
        if mode not in ("pixel_shuffle", "bilinear"):
            raise NotImplementedError(mode)
        self.r, self.mode = up_scale, mode
        self.conv = conv3x3(cin, cin * up_scale ** 2
                            if mode == "pixel_shuffle" else features)

    def forward(self, x):
        r = self.r
        h = self.conv(x)
        if self.mode == "pixel_shuffle":
            B, _, H, W = h.shape
            h = h.reshape(B, r, r, -1, H, W).permute(0, 3, 4, 1, 5, 2)
            h = h.reshape(B, -1, H * r, W * r)
        else:
            h = F.interpolate(h, scale_factor=r, mode="bilinear",
                              align_corners=False)
        return F.relu(h)
