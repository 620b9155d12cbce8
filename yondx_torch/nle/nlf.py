"""Self / collaborative noise-level fits (port of yondx/nle/nlf.py).

Fit var = beta1 * mean + beta2 over the flat regions of packed RGGB
planes [..., h, w, 4]. Every box moment goes through the K1 wrapper
(`moments.nle_moments`): one launch for the self fit, two for the collab
fit (the noisy frame's variance alone; the denoised proxy's mean and
variance).
"""
from __future__ import annotations

import torch

from .fit import masked_linefit, nonsat_weights
from .moments import nle_moments
from .threshold import score3_threshold_with_p25


def _flat_mask_and_fit(var, mean, texture, step: int):
    """Adaptive threshold (exact, subsample 1) -> flat mask, with the
    empty-mask 25th-percentile and all-ones fallbacks -> saturation
    filter -> weighted line fit."""
    th, th25 = score3_threshold_with_p25(texture, mean, step=step)
    mask = (texture < th).float()
    mask = torch.where(torch.sum(mask) == 0, (texture < th25).float(), mask)
    mask = torch.where(torch.sum(mask) == 0, torch.ones_like(mask), mask)
    w = nonsat_weights(mean, mask)
    return masked_linefit(mean, var, w)


def self_nlf(lr_rggb, k: int = 29, step: int = 5):
    """Self NLE on a noisy RGGB stack [..., h, w, 4] -> (beta1, beta2) as
    0-d tensors: local var and mean over k x k boxes, texture =
    stdfilt_k(blur_inner(x)) with inner = 2k//3 + 1."""
    mean, var, texture = nle_moments(lr_rggb.float(), k, k // 3 * 2 + 1)
    return _flat_mask_and_fit(var, mean, texture, step)


def collab_nlf(lr_rggb, dn_rggb, k: int = 29, step: int = 5):
    """Collaborative NLE with a denoised proxy [..., h, w, 4]: noise var =
    var_k(noisy) - var_k(denoised), mean = blur_k(denoised), texture =
    stdfilt_k(denoised)."""
    inner = k // 3 * 2 + 1
    _, lr_var, _ = nle_moments(lr_rggb.float(), k, inner, texture=False,
                               mean=False)
    mean, dn_var, _ = nle_moments(dn_rggb.float(), k, inner, texture=False)
    return _flat_mask_and_fit(lr_var - dn_var, mean, torch.sqrt(dn_var),
                              step)


def simple_nlf(lr_bayer, hr_bayer=None, k: int = 29, mode: str = "self"):
    """Bayer-domain dispatch: a frame [H, W] or stack [B, H, W] tensor ->
    host floats (beta1, beta2)."""
    from ..isp.bayer import bayer2rggb
    lr = bayer2rggb(lr_bayer)
    if mode == "self":
        b1, b2 = self_nlf(lr, k=k)
    elif mode == "collab":
        b1, b2 = collab_nlf(lr, bayer2rggb(hr_bayer), k=k)
    else:
        raise ValueError(mode)
    return float(b1), float(b2)
