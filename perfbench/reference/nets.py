"""Plain float32 forward of the two SNR-Nets the benchmark runs:
GuidedResUnet (gru32) and GuidedResUnetS2D (s2dt16), channels-last in
and out, NCHW inside. Module names follow the flax tree, so the
checkpoint's leaves map by path.

`set_fp8(net)` makes every convolution round its input and its weight to
float8 e4m3 (one scale per tensor, amax / 448) before a float32
convolution: the control's precision for a bfloat16 configuration.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .ckpt import read_params, state_dict

E4M3_MAX = 448.0


def fp8_round(x):
    s = torch.clamp(torch.amax(torch.abs(x)), min=1e-30) / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Conv(nn.Conv2d):
    fp8 = False

    def forward(self, x):
        if not self.fp8:
            return super().forward(x)
        return F.conv2d(fp8_round(x), fp8_round(self.weight), self.bias,
                        self.stride, self.padding)


class Deconv(nn.ConvTranspose2d):
    fp8 = False

    def forward(self, x):
        if not self.fp8:
            return super().forward(x)
        return F.conv_transpose2d(fp8_round(x), fp8_round(self.weight),
                                  self.bias, self.stride)


def conv3x3(cin, cout):
    return Conv(cin, cout, 3, padding=1)


def conv1x1(cin, cout):
    return Conv(cin, cout, 1)


class StridedDown(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = Conv(cin, cout, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class UpConvT(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.deconv = Deconv(cin, cout, 2, stride=2)

    def forward(self, x):
        return self.deconv(x)


class ShortCut(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = conv1x1(cin, cout) if cin != cout else None

    def forward(self, x):
        return x if self.conv is None else self.conv(x)


class GuideMLP(nn.Module):
    def __init__(self, f):
        super().__init__()
        self.gamma_in = nn.Linear(1, f)
        self.gamma_out = nn.Linear(f, f)
        self.beta_out = nn.Linear(f, f)

    def forward(self, t):
        tk = self.gamma_out(F.silu(self.gamma_in(t.reshape(-1, 1))))
        tb = self.beta_out(F.silu(tk))
        return tk[:, :, None, None], tb[:, :, None, None]


class Block(nn.Module):
    """FiLM residual block: shortcut, SiLU-conv, z*tk+tb, SiLU-conv, +x."""

    def __init__(self, cin, f):
        super().__init__()
        self.short_cut = ShortCut(cin, f)
        self.conv1 = conv3x3(f, f)
        self.guide = GuideMLP(f)
        self.conv2 = conv3x3(f, f)

    def forward(self, x, t):
        x = self.short_cut(x)
        z = self.conv1(F.silu(x))
        tk, tb = self.guide(t)
        return self.conv2(F.silu(z * tk + tb)) + x


def _normalize(x):
    ub = torch.clamp(torch.amax(x, dim=(1, 2, 3), keepdim=True), min=1e-8)
    return x / ub, ub


class _UNet(nn.Module):
    """conv_in -> [block, stride-2 conv] x4 -> block -> [deconv, concat,
    block] x4 -> 1x1 out (the body `unet` of GuidedResUnet)."""

    def __init__(self, nf, in_nc, out_nc):
        super().__init__()
        self.conv_in = conv3x3(in_nc, nf)
        feats = [nf, 2 * nf, 4 * nf, 8 * nf]
        cin = nf
        for i, f in enumerate(feats):
            setattr(self, f"conv{i + 1}", Block(cin, f))
            cin = feats[i + 1] if i < 3 else 16 * nf
            setattr(self, f"pool{i + 1}", StridedDown(f, cin))
        self.conv5 = Block(cin, 16 * nf)
        cin = 16 * nf
        for i, f in enumerate(reversed(feats)):
            setattr(self, f"upv{6 + i}", UpConvT(cin, f))
            setattr(self, f"conv{6 + i}", Block(2 * f, f))
            cin = f
        self.conv10 = conv1x1(nf, out_nc)

    def forward(self, x, t):
        h = F.leaky_relu(self.conv_in(x), 0.01)
        skips = []
        for i in range(1, 5):
            h = getattr(self, f"conv{i}")(h, t)
            skips.append(h)
            h = getattr(self, f"pool{i}")(h)
        h = self.conv5(h, t)
        for i in range(4):
            h = torch.cat([getattr(self, f"upv{6 + i}")(h), skips[-1 - i]], 1)
            h = getattr(self, f"conv{6 + i}")(h, t)
        return self.conv10(h)


class GuidedResUnet(nn.Module):
    """gru32: res and norm on, body `unet`."""

    def __init__(self, arch):
        super().__init__()
        self.unet = _UNet(arch["nf"], arch["in_nc"], arch["out_nc"])

    def forward(self, x, t):
        x = x.permute(0, 3, 1, 2)
        xn, ub = _normalize(x)
        out = self.unet(xn, t / ub.reshape(-1)) + xn[:, :4]
        return (out * ub).permute(0, 2, 3, 1)


def _s2d2(x):
    B, C, H, W = x.shape
    x = x.reshape(B, C, H // 2, 2, W // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(B, 4 * C, H // 2, W // 2)


def _d2s2(x):
    B, C, H, W = x.shape
    x = x.reshape(B, 2, 2, C // 4, H, W).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(B, C // 4, 2 * H, 2 * W)


class GuidedResUnetS2D(nn.Module):
    """s2dt16: space-to-depth, a 3-down encoder at nf, bottleneck at 8 nf,
    3x3 head, full-resolution tail; res and norm on."""

    def __init__(self, arch):
        super().__init__()
        nf, out_nc = arch["nf"], arch["out_nc"]
        self.out_nc = out_nc
        self.conv_in = conv3x3(4 * arch["in_nc"], nf)
        feats = [nf, 2 * nf, 4 * nf]
        cin = nf
        for i, f in enumerate(feats):
            setattr(self, f"conv{i + 1}", Block(cin, f))
            cin = feats[i + 1] if i < 2 else 8 * nf
            setattr(self, f"pool{i + 1}", StridedDown(f, cin))
        self.conv4 = Block(cin, 8 * nf)
        cin = 8 * nf
        for i, f in enumerate(reversed(feats)):
            setattr(self, f"upv{5 + i}", UpConvT(cin, f))
            setattr(self, f"conv{5 + i}", Block(2 * f, f))
            cin = f
        self.conv_out = (conv3x3 if arch["out_k"] == 3 else conv1x1)(
            nf, 4 * out_nc)
        self.tail_nf = arch["tail_nf"]
        self.tail_1 = conv3x3(2 * out_nc, self.tail_nf)
        self.tail_2 = conv3x3(self.tail_nf, out_nc)

    def forward(self, x, t):
        x = x.permute(0, 3, 1, 2)
        xn, ub = _normalize(x)
        t = t / ub.reshape(-1)
        h = F.leaky_relu(self.conv_in(_s2d2(xn)), 0.01)
        skips = []
        for i in range(1, 4):
            h = getattr(self, f"conv{i}")(h, t)
            skips.append(h)
            h = getattr(self, f"pool{i}")(h)
        h = self.conv4(h, t)
        for i in range(3):
            h = torch.cat([getattr(self, f"upv{5 + i}")(h), skips[-1 - i]], 1)
            h = getattr(self, f"conv{5 + i}")(h, t)
        out = _d2s2(self.conv_out(h)) + xn[:, :self.out_nc]
        th = F.leaky_relu(self.tail_1(torch.cat(
            [out, xn[:, :self.out_nc]], 1)), 0.01)
        out = out + self.tail_2(th)
        return (out * ub).permute(0, 2, 3, 1)


NETS = {"GuidedResUnet": GuidedResUnet, "GuidedResUnetS2D": GuidedResUnetS2D}


def load_net(arch, ckpt_path, device):
    """The float32 net of `arch` with the checkpoint's weights, eval mode."""
    net = NETS[arch["name"]](arch)
    net.load_state_dict(state_dict(read_params(ckpt_path)), strict=True)
    return net.to(device).eval()


def set_fp8(net, on=True):
    for m in net.modules():
        if isinstance(m, (Conv, Deconv)):
            m.fp8 = on
    return net
