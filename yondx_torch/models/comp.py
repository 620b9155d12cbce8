"""Comparison and self-supervised model zoo (port of
yondx/models/comp.py): `DnCNN`, `est_UNet` (the PGE-Net noise
estimator), the blind-spot `FBI_Net`, `SelfSupUNet`, `SelfResUNet`,
`GuidedSelfUnet` and `N2NF_Unet`.

Channels-last [B, H, W, C] in and out, NCHW inside (as models/unets.py).
Submodule, parameter and buffer names are the flax names (a BatchNorm's
`scale`, `bias` and batch stats `mean`, `var`; a PReLU's `alpha`), so
models/convert.py maps flax weights by path. Input channel counts, which
flax infers from the input, come from the arch's `in_nc`.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .blocks import (GuideMLP, ShortCut, UpConvT, conv1x1, conv3x3,
                     data_inv_normalize, data_normalize)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class PReLU(nn.Module):
    """Per-channel PReLU with flax's parameter name `alpha` (init 0)."""

    def __init__(self, features: int, init: float = 0.0):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((features,), float(init)))

    def forward(self, x):
        return torch.where(x >= 0, x, self.alpha[None, :, None, None] * x)


class BatchNorm(nn.Module):
    """flax.linen.BatchNorm over the channels of an NCHW tensor: params
    `scale` and `bias`, batch stats `mean` and `var`. Eval normalises by
    the stats; train by the batch's own mean and (biased) variance, and
    moves the stats by `momentum` (flax's convention: new = momentum * old
    + (1 - momentum) * batch)."""

    def __init__(self, features: int, epsilon: float = 1e-4,
                 momentum: float = 0.95):
        super().__init__()
        self.epsilon, self.momentum = epsilon, momentum
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x, train: bool = False):
        if train:
            mean = torch.mean(x, dim=(0, 2, 3))
            var = torch.clamp(torch.mean(x * x, dim=(0, 2, 3)) - mean * mean,
                              min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.mul_(m).add_((1 - m) * mean)
                self.var.mul_(m).add_((1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return (x - mean[None, :, None, None]) * mul[None, :, None, None] \
            + self.bias[None, :, None, None]


class DnCNN(nn.Module):
    """Plain DnCNN (yondx/models/comp.py:23-55): conv + relu, (depth - 2)
    x bias-free conv [+ BatchNorm] + relu, a bias-free conv; then the
    residual `x - out` (res), or with in_nc 4 and out_nc 3 the raw-to-RGB
    pixel shuffle in the JAX package's channel order (whose reshape of
    out_nc channels into 2 x 2 x out_nc // 4 fails there, as here)."""

    def __init__(self, args: Dict[str, Any]):
        super().__init__()
        self.args = args
        nf, depth = args["nf"], args["depth"]
        self.depth = depth
        self.use_bn = args.get("use_bn", False)
        self.conv0 = conv3x3(args["in_nc"], nf)
        for i in range(depth - 2):
            setattr(self, f"conv{i + 1}", nn.Conv2d(nf, nf, 3, padding=1,
                                                    bias=False))
            if self.use_bn:
                setattr(self, f"bn{i + 1}", BatchNorm(nf))
        setattr(self, f"conv{depth - 1}",
                nn.Conv2d(nf, args["out_nc"], 3, padding=1, bias=False))

    def forward(self, x, train: bool = False):
        a = self.args
        h = F.relu(self.conv0(_nchw(x)))
        for i in range(self.depth - 2):
            h = getattr(self, f"conv{i + 1}")(h)
            if self.use_bn:
                h = getattr(self, f"bn{i + 1}")(h, train)
            h = F.relu(h)
        out = _nhwc(getattr(self, f"conv{self.depth - 1}")(h))
        if a["in_nc"] == 4 and a["out_nc"] == 3:
            B, H, W, C = out.shape
            out = out.reshape(B, H, W, 2, 2, C // 4)
            out = out.permute(0, 1, 3, 2, 4, 5).reshape(B, H * 2, W * 2,
                                                          C // 4)
        elif a.get("res", False):
            out = x - out
        return out


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


class _MaskedConv(nn.Module):
    """A conv whose kernel is multiplied by a fixed [kh, kw] mask at every
    call (the blind-spot receptive fields), with dilation; SAME
    padding."""

    def __init__(self, cin: int, features: int, mask: np.ndarray,
                 dilation: int = 1):
        super().__init__()
        kh, kw = mask.shape
        self.weight = nn.Parameter(torch.zeros(features, cin, kh, kw))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mask", torch.from_numpy(
            np.asarray(mask, np.float32)), persistent=False)
        self.dilation = dilation
        self.pad = (kh // 2) * dilation

    def forward(self, x):
        return F.conv2d(x, self.weight * self.mask, self.bias,
                        padding=self.pad, dilation=self.dilation)


_MASK_NEW1 = np.array([[1, 1, 1], [1, 0, 1], [1, 1, 1]], np.float32)
_MASK_NEW2 = np.array([[0, 1, 0, 1, 0], [1, 0, 0, 0, 1], [0, 0, 1, 0, 0],
                       [1, 0, 0, 0, 1], [0, 1, 0, 1, 0]], np.float32)
_MASK_NEW3 = np.array([[1, 0, 1], [0, 1, 0], [1, 0, 1]], np.float32)


class _ResidualModule(nn.Module):
    """1x1 bottleneck residual with PReLU: act2((x + conv2(act1(conv1
    x))) / 2)."""

    def __init__(self, features: int, mul: int = 1):
        super().__init__()
        self.conv1 = conv1x1(features, features * mul)
        self.act1 = PReLU(features * mul)
        self.conv2 = conv1x1(features * mul, features)
        self.act2 = PReLU(features)

    def forward(self, x):
        h = self.conv2(self.act1(self.conv1(x)))
        return self.act2((x + h) / 2.0)


class FBI_Net(nn.Module):  # noqa: N801 (the registry's arch name)
    """Blind-spot network (yondx/models/comp.py:138-188): New1 (3x3,
    centre masked) -> New2 (5x5 ring) -> (num_of_layers - 2) x New3
    (dilated X, dilation 3), each followed by PReLU and a residual
    module, summing the block outputs; then PReLU, a residual module and
    a 1x1 head. output_type 'sigmoid' maps channel 0 through
    sigmoid_value * sigmoid; res makes the output out[..., :1] * x +
    out[..., 1:]."""

    def __init__(self, args: Dict[str, Any]):
        super().__init__()
        self.args = args
        nf = args["nf"]
        self.n_layers = args.get("num_of_layers", 8)
        mul = args.get("mul", 1)
        out_nc = args.get("output_channel", args.get("out_nc", 1))
        cin = args.get("in_nc", args.get("channel", 1))
        self.new1_conv = _MaskedConv(cin, nf, _MASK_NEW1)
        self.new1_act = PReLU(nf)
        self.new1_res = _ResidualModule(nf, mul)
        self.new2_conv = _MaskedConv(nf, nf, _MASK_NEW2)
        self.new2_act = PReLU(nf)
        self.new2_act2 = PReLU(nf)
        self.new2_res = _ResidualModule(nf, mul)
        for i in range(self.n_layers - 2):
            setattr(self, f"new3_{i}_conv",
                    _MaskedConv(nf, nf, _MASK_NEW3, dilation=3))
            setattr(self, f"new3_{i}_act", PReLU(nf))
            setattr(self, f"new3_{i}_act2", PReLU(nf))
            setattr(self, f"new3_{i}_res", _ResidualModule(nf, mul))
        self.final_act = PReLU(nf)
        self.final_res = _ResidualModule(nf, mul)
        self.output_layer = conv1x1(nf, out_nc)

    def forward(self, x):
        a = self.args
        xin = _nchw(x)
        h = self.new1_act(self.new1_conv(xin))
        out_new = h
        h = self.new1_res(h)
        out_sum = h
        z = self.new2_act(self.new2_conv(out_new))
        h = self.new2_res(self.new2_act2((z + h) / 2.0))
        out_new = z
        out_sum = out_sum + h
        for i in range(self.n_layers - 2):
            z = getattr(self, f"new3_{i}_act")(
                getattr(self, f"new3_{i}_conv")(out_new))
            h = (z + h) / 2.0
            h = getattr(self, f"new3_{i}_res")(
                getattr(self, f"new3_{i}_act2")(h))
            out_new = z
            out_sum = out_sum + h
        final = self.final_res(self.final_act(out_sum / self.n_layers))
        final = _nhwc(self.output_layer(final))
        if a.get("output_type") == "sigmoid":
            sv = a.get("sigmoid_value", 1.0)
            final = torch.cat([sv * torch.sigmoid(final[..., :1]),
                               final[..., 1:]], dim=-1)
        if a.get("res", False):
            final = final[..., :1] * x + final[..., 1:]
        return final


def _nearest_up2(x):
    """Nearest-neighbour x2 upsampling of an NCHW tensor."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def _max_pool2(x):
    return F.max_pool2d(x, 2, 2)


def _check_res(out, h, name: str):
    """`out + h` of the res branches, which the JAX package adds only
    when the shapes agree (out_nc == 2 nf); elsewhere it fails."""
    if out.shape != h.shape:
        raise ValueError(
            f"{name} res=True adds the last features {tuple(h.shape)} to "
            f"the output {tuple(out.shape)}: their channels differ (out_nc "
            "!= 2 nf), where the JAX package fails too")
    return out + h


class SelfSupUNet(nn.Module):
    """Noise2Noise-style UNet (yondx/models/comp.py:199-242): two head
    convs, depth x [maxpool, conv], depth x [nearest x2, concat skip, two
    convs of 2 nf], two 1x1 convs of 2 nf and a 1x1 head; LeakyReLU(slope)
    throughout."""

    def __init__(self, args: Dict[str, Any]):
        super().__init__()
        self.args = args
        nf = args.get("nf", 48)
        self.depth = depth = args.get("depth", 5)
        slope = args.get("slope", 0.1)
        cin = args["in_nc"]
        # flax's leaves sit directly under these names: a Conv2d each
        self.head1 = nn.Conv2d(cin, nf, 3, padding=1)
        self.head2 = nn.Conv2d(nf, nf, 3, padding=1)
        skips = [cin] + [nf] * (depth - 1)
        for i in range(depth):
            setattr(self, f"down{i}", nn.Conv2d(nf, nf, 3, padding=1))
        ch = nf
        for i in range(depth):
            setattr(self, f"up{i}_1", nn.Conv2d(ch + skips[-i - 1], 2 * nf,
                                                3, padding=1))
            setattr(self, f"up{i}_2", nn.Conv2d(2 * nf, 2 * nf, 3,
                                                padding=1))
            ch = 2 * nf
        self.last1 = conv1x1(2 * nf, 2 * nf)
        self.last2 = conv1x1(2 * nf, 2 * nf)
        self.last_out = conv1x1(2 * nf, args["out_nc"])
        self.slope = slope

    def forward(self, x):
        a = self.args
        lb = ub = None
        if a.get("norm", False):
            x, lb, ub = data_normalize(x)

        def lr(h, name):
            return F.leaky_relu(getattr(self, name)(h), self.slope)

        x = _nchw(x)
        blocks = [x]
        h = lr(lr(x, "head1"), "head2")
        for i in range(self.depth):
            h = _max_pool2(h)
            if i != self.depth - 1:
                blocks.append(h)
            h = lr(h, f"down{i}")
        for i in range(self.depth):
            h = torch.cat([_nearest_up2(h), blocks[-i - 1]], dim=1)
            h = lr(lr(h, f"up{i}_1"), f"up{i}_2")
        h = lr(lr(h, "last1"), "last2")
        out = self.last_out(h)
        if a.get("res", False):
            out = _check_res(out, h, "SelfSupUNet")
        out = _nhwc(out)
        if a.get("norm", False):
            out = data_inv_normalize(out, lb, ub)
        return out


class _ResPair(nn.Module):
    """shortcut + two LeakyReLU(slope) convs, residual."""

    def __init__(self, cin: int, features: int, slope: float = 0.1,
                 ksize: int = 3):
        super().__init__()
        self.short_cut = ShortCut(cin, features)
        self.conv1 = nn.Conv2d(features, features, ksize,
                               padding=ksize // 2)
        self.conv2 = nn.Conv2d(features, features, ksize,
                               padding=ksize // 2)
        self.slope = slope

    def forward(self, x):
        x = self.short_cut(x)
        z = F.leaky_relu(self.conv1(x), self.slope)
        z = F.leaky_relu(self.conv2(z), self.slope)
        return z + x


class SelfResUNet(nn.Module):
    """Residual self-supervised UNet (yondx/models/comp.py:265-299): the
    SelfSupUNet layout with residual pairs; res adds the input."""

    def __init__(self, args: Dict[str, Any]):
        super().__init__()
        self.args = args
        nf = args.get("nf", 32)
        self.depth = depth = args.get("depth", 5)
        slope = args.get("slope", 0.1)
        cin = args["in_nc"]
        self.head = _ResPair(cin, nf, slope)
        for i in range(depth):
            setattr(self, f"down{i}", _ResPair(nf, nf, slope))
        skips = [cin] + [nf] * (depth - 1)
        ch = nf
        for i in range(depth):
            setattr(self, f"up{i}", _ResPair(ch + skips[-i - 1], 2 * nf,
                                             slope))
            ch = 2 * nf
        self.last = _ResPair(2 * nf, 2 * nf, slope, ksize=1)
        self.out = conv1x1(2 * nf, args["out_nc"])

    def forward(self, x):
        a = self.args
        lb = ub = None
        if a.get("norm", False):
            x, lb, ub = data_normalize(x)
        inp = x
        x = _nchw(x)
        blocks = [x]
        h = self.head(x)
        for i in range(self.depth):
            h = _max_pool2(h)
            if i != self.depth - 1:
                blocks.append(h)
            h = getattr(self, f"down{i}")(h)
        for i in range(self.depth):
            h = getattr(self, f"up{i}")(
                torch.cat([_nearest_up2(h), blocks[-i - 1]], dim=1))
        out = _nhwc(self.out(self.last(h)))
        if a.get("res", False):
            out = out + inp
        if a.get("norm", False):
            out = data_inv_normalize(out, lb, ub)
        return out


class _GuidedLR(nn.Module):
    """Conv, FiLM by the guidance t (z * tk + tb), LeakyReLU(slope)."""

    def __init__(self, cin: int, features: int, slope: float = 0.1,
                 ksize: int = 3):
        super().__init__()
        self.conv = nn.Conv2d(cin, features, ksize, padding=ksize // 2)
        self.guide = GuideMLP(features)
        self.slope = slope

    def forward(self, x, t):
        tk, tb = self.guide(t)
        return F.leaky_relu(self.conv(x) * tk + tb, self.slope)


class _GuidedResPair(nn.Module):
    """shortcut + LeakyReLU(0.1) conv + guided conv, residual."""

    def __init__(self, cin: int, features: int, slope: float = 0.1,
                 ksize: int = 3):
        super().__init__()
        self.short_cut = ShortCut(cin, features)
        self.conv1 = nn.Conv2d(features, features, ksize,
                               padding=ksize // 2)
        self.conv2 = _GuidedLR(features, features, slope, ksize)

    def forward(self, x, t):
        x = self.short_cut(x)
        z = F.leaky_relu(self.conv1(x), 0.1)
        return self.conv2(z, t) + x


class GuidedSelfUnet(nn.Module):
    """FiLM variant of SelfSupUNet (yondx/models/comp.py:336-370); norm
    divides t by the per-sample range too. Its res branch adds the last
    features (2 nf channels) to the output, which fails unless out_nc ==
    2 nf, in the JAX package as here."""

    def __init__(self, args: Dict[str, Any]):
        super().__init__()
        self.args = args
        nf = args.get("nf", 32)
        self.depth = depth = args.get("depth", 5)
        slope = args.get("slope", 0.1)
        cin = args["in_nc"]
        self.head = _GuidedResPair(cin, nf, slope)
        for i in range(depth):
            setattr(self, f"down{i}", _GuidedLR(nf, nf, slope))
        skips = [cin] + [nf] * (depth - 1)
        ch = nf
        for i in range(depth):
            setattr(self, f"up{i}", _GuidedResPair(ch + skips[-i - 1],
                                                   2 * nf, slope))
            ch = 2 * nf
        self.last = _GuidedResPair(2 * nf, 2 * nf, slope, ksize=1)
        self.out = conv1x1(2 * nf, args["out_nc"])

    def forward(self, x, t):
        a = self.args
        lb = ub = None
        t = t.to(x.dtype)
        if a.get("norm", False):
            x, lb, ub = data_normalize(x)
            t = t / torch.reshape(ub - lb, (-1,))
        x = _nchw(x)
        blocks = [x]
        h = self.head(x, t)
        for i in range(self.depth):
            h = _max_pool2(h)
            if i != self.depth - 1:
                blocks.append(h)
            h = getattr(self, f"down{i}")(h, t)
        for i in range(self.depth):
            h = getattr(self, f"up{i}")(
                torch.cat([_nearest_up2(h), blocks[-i - 1]], dim=1), t)
        h = self.last(h, t)
        out = self.out(h)
        if a.get("res", False):
            out = _check_res(out, h, "GuidedSelfUnet")
        out = _nhwc(out)
        if a.get("norm", False):
            out = data_inv_normalize(out, lb, ub)
        return out


class _ConvTransposeSame(nn.Module):
    """flax's ConvTranspose(features, (3, 3), strides 2, padding 'SAME',
    transpose_kernel False): the kernel slides over the input dilated by 2
    and padded (2, 1), giving twice the size. `weight` is laid out as a
    Conv2d's [out, in, 3, 3] (models/convert.py's rule for a conv
    kernel); the forward is conv_transpose2d with that kernel flipped, its
    first 2H x 2W outputs."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(features, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        H, W = x.shape[-2:]
        w = self.weight.flip(2, 3).transpose(0, 1)
        y = F.conv_transpose2d(x, w, self.bias, stride=2)
        return y[..., :2 * H, :2 * W]


class N2NF_Unet(nn.Module):  # noqa: N801 (the registry's arch name)
    """Noise2NoiseFlow-style UNet (yondx/models/comp.py:373-420): a 48-ch
    encoder with max pools, a stride-2 3x3 transposed-conv decoder with
    skip concats and 96-ch blocks, then 64 and 32 channels and a
    LeakyReLU(0.1) head; ReLU after every other conv."""

    def __init__(self, args: Dict[str, Any]):
        super().__init__()
        self.args = args
        cin = args["in_nc"]
        self.b1_1 = conv3x3(cin, 48)
        for name in ("b1_2", "b2", "b3", "b4", "b5", "b6"):
            setattr(self, name, conv3x3(48, 48))
        self.up5 = _ConvTransposeSame(48, 48)
        self.b7_1 = conv3x3(96, 96)
        self.b7_2 = conv3x3(96, 96)
        self.up4 = _ConvTransposeSame(96, 96)
        for j in (8, 9, 10):
            setattr(self, f"b{j}_1", conv3x3(144, 96))
            setattr(self, f"b{j}_2", conv3x3(96, 96))
            setattr(self, f"up{11 - j}", _ConvTransposeSame(96, 96))
        self.b11_1 = conv3x3(96 + cin, 64)
        self.b11_2 = conv3x3(64, 32)
        self.b11_3 = conv3x3(32, args["out_nc"])

    def forward(self, x):
        a = self.args
        lb = ub = None
        if a.get("norm", False):
            x, lb, ub = data_normalize(x)

        def conv(h, name):
            return F.relu(getattr(self, name)(h))

        x = _nchw(x)
        p1 = _max_pool2(conv(conv(x, "b1_1"), "b1_2"))
        p2 = _max_pool2(conv(p1, "b2"))
        p3 = _max_pool2(conv(p2, "b3"))
        p4 = _max_pool2(conv(p3, "b4"))
        p5 = _max_pool2(conv(p4, "b5"))
        h = torch.cat([self.up5(conv(p5, "b6")), p4], dim=1)
        h = torch.cat([self.up4(conv(conv(h, "b7_1"), "b7_2")), p3], dim=1)
        h = torch.cat([self.up3(conv(conv(h, "b8_1"), "b8_2")), p2], dim=1)
        h = torch.cat([self.up2(conv(conv(h, "b9_1"), "b9_2")), p1], dim=1)
        h = torch.cat([self.up1(conv(conv(h, "b10_1"), "b10_2")), x], dim=1)
        h = conv(conv(h, "b11_1"), "b11_2")
        out = _nhwc(F.leaky_relu(self.b11_3(h), 0.1))
        if a.get("norm", False):
            out = data_inv_normalize(out, lb, ub)
        return out
