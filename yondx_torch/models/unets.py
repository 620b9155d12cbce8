"""The UNet family (port of yondx/models/unets.py): GuidedResUnet, the
gru32 flagship; GuidedResUnetS2D, the s2d-packed variant; SNRnet, ResUnet
and ResUnet2 on the same encoder/decoder with other blocks;
UNetSeeInDark, the plain SID UNet (the 'unetn' denoiser); EstUnet.

All take and return channels-last [B, H, W, C] tensors like the flax
models; inside they run NCHW (a permuted view, so a channels-last input
stays channels-last in memory, which is what cuDNN wants on the GPU).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..io.ckpt import load_checkpoint
from .blocks import (GuidedResidualBlock, ResBlockSiLU, ResidualBlockLRelu,
                     SNRBlock, StridedDown, UpConvT, conv1x1, conv3x3,
                     data_inv_normalize, data_normalize)
from .convert import params_to_state_dict


class _GuidedUNetBase(nn.Module):
    """Encoder/decoder wiring of GuidedResUnet, SNRnet, ResUnet and
    ResUnet2 (yondx/models/unets.py:31-83) on NCHW tensors: conv_in ->
    [block, stride-2 conv] x4 -> bottleneck block -> [2x2 deconv, skip
    concat, block] x4 -> 1x1 out, with the residual add and per-sample
    max norm options. block_cls(cin, features) is called as block(z, t)
    when guided, else block(z)."""

    def __init__(self, args: Dict[str, Any], block_cls=GuidedResidualBlock,
                 guided: bool = True, in_lrelu_slope: float = 0.01):
        super().__init__()
        nf = args["nf"]
        self.res = args.get("res", False)
        self.norm = args.get("norm", False)
        self.guided = guided
        self.in_lrelu_slope = in_lrelu_slope
        self.conv_in = conv3x3(args.get("in_nc", 4), nf)
        feats = [nf, nf * 2, nf * 4, nf * 8]
        cin = nf
        for i, f in enumerate(feats):
            setattr(self, f"conv{i + 1}", block_cls(cin, f))
            nxt = feats[i + 1] if i + 1 < len(feats) else nf * 16
            setattr(self, f"pool{i + 1}", StridedDown(f, nxt))
            cin = nxt
        self.conv5 = block_cls(cin, nf * 16)
        cin = nf * 16
        for i, f in enumerate([nf * 8, nf * 4, nf * 2, nf]):
            setattr(self, f"upv{6 + i}", UpConvT(cin, f))
            setattr(self, f"conv{6 + i}", block_cls(2 * f, f))
            cin = f
        self.conv10 = conv1x1(nf, args["out_nc"])

    def forward(self, x, t=None):
        lb = ub = None
        if self.norm:
            x, lb, ub = data_normalize(x)
            if t is not None:
                t = t / (ub - lb).reshape(-1)
        inp = x

        def block(name, z):
            b = getattr(self, name)
            return b(z, t) if self.guided else b(z)

        h = F.leaky_relu(self.conv_in(x), self.in_lrelu_slope)
        skips = []
        for i in range(1, 5):
            h = block(f"conv{i}", h)
            skips.append(h)
            h = getattr(self, f"pool{i}")(h)
        h = block("conv5", h)
        for i in range(4):
            h = getattr(self, f"upv{6 + i}")(h)
            h = torch.cat([h, skips[-1 - i]], dim=1)
            h = block(f"conv{6 + i}", h)
        out = self.conv10(h)
        if self.res:
            out = out + inp[:, :4]
        if self.norm:
            out = data_inv_normalize(out, lb, ub)
        return out


class GuidedResUnet(nn.Module):
    """The gru32 flagship SNR-Net (nf=32: 11.17M parameters). Its body
    is the submodule `unet`, as in flax, so weights map by path."""

    block_cls = GuidedResidualBlock

    def __init__(self, args: Dict[str, Any]):
        super().__init__()
        self.unet = _GuidedUNetBase(args, self.block_cls)

    def forward(self, x, t):
        """x: [B, H, W, C] channels-last, t: [B] guidance -> [B, H, W, C]."""
        x = x.permute(0, 3, 1, 2)
        return self.unet(x, t.to(x.dtype)).permute(0, 2, 3, 1)


def _s2d2(x):
    """space_to_depth(2) in NCHW with the NHWC channel order of
    yondx's _s2d2: out channel (dy*2 + dx)*C + c."""
    B, C, H, W = x.shape
    x = x.reshape(B, C, H // 2, 2, W // 2, 2)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(B, 4 * C, H // 2, W // 2)


def _d2s2(x):
    """depth_to_space(2), inverse of _s2d2."""
    B, C, H, W = x.shape
    x = x.reshape(B, 2, 2, C // 4, H, W)
    x = x.permute(0, 3, 4, 1, 5, 2)
    return x.reshape(B, C // 4, H * 2, W * 2)


class GuidedResUnetS2D(nn.Module):
    """s2d-packed SNR-Net: 3-down encoder at nf, bottleneck at 8 nf,
    3x3 (out_k=3) or 1x1 head, optional full-resolution tail."""

    def __init__(self, args: Dict[str, Any]):
        super().__init__()
        nf = args["nf"]
        in_nc = args.get("in_nc", 4)
        out_nc = args.get("out_nc", 4)
        self.out_nc = out_nc
        self.res = args.get("res", False)
        self.norm = args.get("norm", False)
        self.conv_in = conv3x3(4 * in_nc, nf)
        feats = [nf, nf * 2, nf * 4]
        cin = nf
        for i, f in enumerate(feats):
            setattr(self, f"conv{i + 1}", GuidedResidualBlock(cin, f))
            nxt = feats[i + 1] if i + 1 < len(feats) else nf * 8
            setattr(self, f"pool{i + 1}", StridedDown(f, nxt))
            cin = nxt
        self.conv4 = GuidedResidualBlock(cin, nf * 8)
        cin = nf * 8
        for i, f in enumerate([nf * 4, nf * 2, nf]):
            setattr(self, f"upv{5 + i}", UpConvT(cin, f))
            setattr(self, f"conv{5 + i}", GuidedResidualBlock(2 * f, f))
            cin = f
        out_k = args.get("out_k", 1)
        self.conv_out = (conv3x3 if out_k == 3 else conv1x1)(nf, 4 * out_nc)
        self.tail_nf = args.get("tail_nf", 0)
        if self.tail_nf:
            self.tail_1 = conv3x3(2 * out_nc, self.tail_nf)
            self.tail_2 = conv3x3(self.tail_nf, out_nc)
            nn.init.zeros_(self.tail_2.weight)

    def forward(self, x, t):
        """x: [B, H, W, C] channels-last, t: [B] guidance -> [B, H, W, C]."""
        x = x.permute(0, 3, 1, 2)
        t = t.to(x.dtype)
        lb = ub = None
        if self.norm:
            x, lb, ub = data_normalize(x)
            t = t / (ub - lb).reshape(-1)
        inp = x
        h = F.leaky_relu(self.conv_in(_s2d2(x)), 0.01)
        skips = []
        for i in range(1, 4):
            h = getattr(self, f"conv{i}")(h, t)
            skips.append(h)
            h = getattr(self, f"pool{i}")(h)
        h = self.conv4(h, t)
        for i in range(3):
            h = getattr(self, f"upv{5 + i}")(h)
            h = torch.cat([h, skips[-1 - i]], dim=1)
            h = getattr(self, f"conv{5 + i}")(h, t)
        out = _d2s2(self.conv_out(h))
        if self.res:
            out = out + inp[:, :self.out_nc]
        if self.tail_nf:
            tin = torch.cat([out, inp[:, :self.out_nc]], dim=1)
            th = F.leaky_relu(self.tail_1(tin), 0.01)
            out = out + self.tail_2(th)
        if self.norm:
            out = data_inv_normalize(out, lb, ub)
        return out.permute(0, 2, 3, 1)


class SNRnet(GuidedResUnet):
    """SNRBlock-bodied guided UNet (yondx/models/unets.py:206)."""

    block_cls = SNRBlock


class ResUnet(nn.Module):
    """ResidualBlockLRelu-bodied unguided UNet, LeakyReLU(0.2) after
    conv_in (yondx/models/unets.py:217); body `unet`."""

    block_cls = ResidualBlockLRelu

    def __init__(self, args: Dict[str, Any]):
        super().__init__()
        self.unet = _GuidedUNetBase(args, self.block_cls, False,
                                    in_lrelu_slope=0.2)

    def forward(self, x, t=None):
        """x: [B, H, W, C] channels-last (t is ignored) -> [B, H, W, C]."""
        return self.unet(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ResUnet2(ResUnet):
    """ResBlockSiLU-bodied unguided UNet (yondx/models/unets.py:230)."""

    block_cls = ResBlockSiLU


class UNetSeeInDark(nn.Module):
    """The SID UNet (yondx/models/unets.py:242-283): double 3x3 convs with
    LeakyReLU(0.2), 2x2 max pool, 2x2 transposed-conv up, skip concat,
    1x1 head conv10_1; residual add and per-sample max norm options. Its
    module names (conv1_1 ... conv10_1, upv6 ...) sit at the top level,
    as in flax."""

    def __init__(self, args: Dict[str, Any]):
        super().__init__()
        nf = args["nf"]
        self.res = args.get("res", False)
        self.norm = args.get("norm", False)
        cin = args.get("in_nc", 4)
        for i, f in enumerate([nf, nf * 2, nf * 4, nf * 8, nf * 16]):
            setattr(self, f"conv{i + 1}_1", conv3x3(cin, f))
            setattr(self, f"conv{i + 1}_2", conv3x3(f, f))
            cin = f
        for i, f in enumerate([nf * 8, nf * 4, nf * 2, nf]):
            setattr(self, f"upv{6 + i}", UpConvT(cin, f))
            setattr(self, f"conv{6 + i}_1", conv3x3(2 * f, f))
            setattr(self, f"conv{6 + i}_2", conv3x3(f, f))
            cin = f
        self.conv10_1 = conv1x1(nf, args["out_nc"])

    def _dconv(self, h, i: int):
        h = F.leaky_relu(getattr(self, f"conv{i}_1")(h), 0.2)
        return F.leaky_relu(getattr(self, f"conv{i}_2")(h), 0.2)

    def forward(self, x, t=None):
        """x: [B, H, W, C] channels-last (t is ignored) -> [B, H, W, C]."""
        x = x.permute(0, 3, 1, 2)
        lb = ub = None
        if self.norm:
            x, lb, ub = data_normalize(x)
        inp = x
        h = x
        skips = []
        for i in range(1, 5):
            h = self._dconv(h, i)
            skips.append(h)
            h = F.max_pool2d(h, 2, 2)
        h = self._dconv(h, 5)
        for i in range(4):
            h = getattr(self, f"upv{6 + i}")(h)
            h = torch.cat([h, skips[-1 - i]], dim=1)
            h = self._dconv(h, 6 + i)
        out = self.conv10_1(h)
        if self.res:
            out = out + inp[:, :4]
        if self.norm:
            out = data_inv_normalize(out, lb, ub)
        return out.permute(0, 2, 3, 1)


class EstUnet(nn.Module):
    """Shallow estimation UNet (yondx/models/unets.py:286-328): depth-d
    double-conv encoder (relu, 2x2 max pool), add-merge decoder, 1x1
    head; emits a std map, its square when use_type != 'std', or with
    pge (the default) the map's spatial mean [B, out_nc] (squeezed as
    the flax model squeezes it). Channels-last in and out."""

    def __init__(self, args: Dict[str, Any]):
        super().__init__()
        a = dict(out_nc=4, in_nc=4, depth=3, nf=64, res=False,
                 use_type="std", pge=True)
        a.update(args or {})
        depth, nf = a["depth"], a["nf"]
        self.depth = depth
        self.squared = a["use_type"] != "std"
        self.pge = a["pge"]
        cin = a["in_nc"]
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
        self.conv_final = conv1x1(f, a["out_nc"])

    def forward(self, x):
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
        out = self.conv_final(h)
        if self.squared:
            out = out ** 2
        if self.pge:
            return torch.mean(out, dim=(2, 3)).squeeze()
        return out.permute(0, 2, 3, 1)


# bench.py's architectures (bench.py:96-117): the shipped s2dt16, the
# s2d64 net it was distilled from (no tail), and the gru32 flagship
S2DT16_ARCH = {"name": "GuidedResUnetS2D", "guided": True, "in_nc": 4,
               "out_nc": 4, "nf": 64, "nframes": 1, "res": True,
               "norm": True, "out_k": 3, "tail_nf": 16}
S2D64_ARCH = {k: v for k, v in S2DT16_ARCH.items() if k != "tail_nf"}
GRU32_ARCH = {"name": "GuidedResUnet", "guided": True, "in_nc": 4,
              "out_nc": 4, "nf": 32, "nframes": 1, "res": True,
              "norm": True}


def load_model(arch: Dict[str, Any], ckpt_path: str, device=None,
               dtype=torch.float32) -> nn.Module:
    """Build the net of a YAML `arch` dict and load a committed flax
    checkpoint into it (every parameter, strictly), in eval mode on
    `device` (default "cuda") with parameters in `dtype`."""
    from .registry import build_model     # the registry imports this module
    dev = resolve_device(device)
    net = build_model(arch)
    sd = params_to_state_dict(load_checkpoint(ckpt_path)["params"])
    net.load_state_dict(sd, strict=True)
    net = net.to(device=dev, dtype=dtype).eval()
    if dev.type == "cuda":
        net = net.to(memory_format=torch.channels_last)
    return net


def load_guided_s2d(ckpt_path: str, device=None,
                    dtype=torch.float32) -> GuidedResUnetS2D:
    """The s2dt16 net with a committed checkpoint (see load_model)."""
    return load_model(S2DT16_ARCH, ckpt_path, device=device, dtype=dtype)
