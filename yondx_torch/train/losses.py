"""Losses (port of yondx/train/losses.py).

YOND trains with plain L1 (`unet_loss`); the rest of the family is here
for parity: Charbonnier, Sobel gradient, pyramid deep supervision, the
deep-supervision sums, the relativistic GAN family and the per-sample
PSNR train metric. Plain functions on channels-last [B, H, W, C]
tensors, differentiable by autograd.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred - target))


def charbonnier_loss(pred, target, eps: float = 1e-6):
    d = pred - target
    return torch.mean(torch.sqrt(d * d + eps))


_SOBEL = {"x": ((1., 0., -1.), (2., 0., -2.), (1., 0., -1.)),
          "y": ((1., 2., 1.), (0., 0., 0.), (-1., -2., -1.))}


def _sobel(x, direction: str):
    """[B, H, W, C] Sobel gradient (cross-correlation, zero SAME pad)."""
    k = torch.tensor(_SOBEL[direction], dtype=x.dtype, device=x.device) / 4
    B, H, W, C = x.shape
    y = x.permute(0, 3, 1, 2).reshape(-1, 1, H, W)
    y = F.conv2d(y, k[None, None], padding=1)
    return y.reshape(B, C, H, W).permute(0, 2, 3, 1)


def gradient_loss(pred, target):
    gx = torch.abs(_sobel(pred, "x") - _sobel(target, "x"))
    gy = torch.abs(_sobel(pred, "y") - _sobel(target, "y"))
    return torch.mean(gx + gy)


def _down2(x):
    return 0.25 * (x[:, 0::2, 0::2] + x[:, 1::2, 0::2]
                   + x[:, 0::2, 1::2] + x[:, 1::2, 1::2])


def pyramid_loss(pred, target, loss_fn=l1_loss, rate: float = 0.5,
                 max_scale: int = 8):
    """Deep supervision across average-pooled scales 1..max_scale."""
    total, weight, lam = 0.0, 0.0, 1.0
    p, t = pred, target
    s = 1
    while s <= max_scale:
        total = total + loss_fn(p, t) * lam
        weight += lam
        lam *= rate
        if s < max_scale:
            p, t = _down2(p), _down2(t)
        s *= 2
    return total / weight


def unet_loss(pred, target, charbonnier: bool = False,
              pyramid: bool = False):
    """The default training loss: L1 (or Charbonnier), optionally over
    the pyramid."""
    fn = charbonnier_loss if charbonnier else l1_loss
    if pyramid:
        return pyramid_loss(pred, target, loss_fn=fn)
    return fn(pred, target)


def unet_dpsv_loss(preds, target, charbonnier: bool = False):
    """Sum of per-scale losses over a list of decoder outputs, preds[i]
    at scale 1/2^i against the avg-pool-2 pyramid of `target`."""
    fn = charbonnier_loss if charbonnier else l1_loss
    total, t = 0.0, target
    for i, p in enumerate(preds):
        if i > 0:
            t = _down2(t)
        total = total + fn(p, t)
    return total


def unet_dpsv_loss_up(preds, target, charbonnier: bool = False):
    """As unet_dpsv_loss with two full-resolution heads first: targets
    [target, target, target/2, ...]."""
    fn = charbonnier_loss if charbonnier else l1_loss
    total, t = 0.0, target
    for i, p in enumerate(preds):
        if i > 1:
            t = _down2(t)
        total = total + fn(p, t)
    return total


def _bce_with_logits(logits, target: float):
    return torch.mean(torch.clamp(logits, min=0) - logits * target
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def gan_loss(real_logits, fake_logits, kind: str = "RaSGAN",
             for_discriminator: bool = True):
    """Relativistic GAN loss family: SGAN, RSGAN, RaSGAN, RaLSGAN."""
    if kind == "SGAN":
        if for_discriminator:
            return _bce_with_logits(real_logits, 1.0) + \
                _bce_with_logits(fake_logits, 0.0)
        return _bce_with_logits(fake_logits, 1.0)
    if kind == "RSGAN":
        d = real_logits - fake_logits if for_discriminator else \
            fake_logits - real_logits
        return _bce_with_logits(d, 1.0)
    ra_r = real_logits - torch.mean(fake_logits)
    ra_f = fake_logits - torch.mean(real_logits)
    if kind == "RaSGAN":
        if for_discriminator:
            return (_bce_with_logits(ra_r, 1.0)
                    + _bce_with_logits(ra_f, 0.0)) / 2
        return (_bce_with_logits(ra_r, 0.0)
                + _bce_with_logits(ra_f, 1.0)) / 2
    if kind == "RaLSGAN":
        if for_discriminator:
            return (torch.mean((ra_r - 1.0) ** 2)
                    + torch.mean((ra_f + 1.0) ** 2)) / 2
        return (torch.mean((ra_r + 1.0) ** 2)
                + torch.mean((ra_f - 1.0) ** 2)) / 2
    raise ValueError(kind)


def psnr_loss(pred, target):
    """Per-sample-mean PSNR in dB; inputs in [0,1]."""
    if pred.ndim <= 3:
        mse = torch.mean((pred - target) ** 2)
        return -10.0 * torch.log(torch.clamp(mse, min=1e-20)) / math.log(10)
    mse = torch.mean((pred - target) ** 2, dim=tuple(range(1, pred.ndim)))
    return torch.mean(-10.0 * torch.log(torch.clamp(mse, min=1e-20))
                      / math.log(10))
