"""Adaptive guidance scale (port of yondx/pipeline/denoiser.py:54-86).

The blind per-frame sigma_corr rule: low-noise scenes keep 1.03,
mid-noise 1.08, high-noise 1.00; heavy clipping with agreeing MAD and
fit estimates boosts to 1.25 (thresholds measured for the JAX package,
docs/sigma_corr_blind_r5.json).
"""
from __future__ import annotations

import torch

from ..nle.robust import mad_self_estimate
from ..vst.vst import vst

ADAPTIVE_CORR_NSR_LO = 0.025
ADAPTIVE_CORR_NSR_HI = 0.09
ADAPTIVE_CORR_CLIP = 0.25
ADAPTIVE_CORR_MAD_DEV = 0.04
ADAPTIVE_CORR_VALUES = (1.03, 1.08, 1.00, 1.25)   # lo, mid, hi, clip


def adaptive_sigma_corr(rggb, K, sigma, scale):
    """Guidance scale in {1.00, 1.03, 1.08, 1.25} (float32 0-d tensor).
    rggb: [..., H, W, 4] in [0, 1]; K, sigma in DN; scale = wp - bl.
    Precedence: hi-noise > clip-boost > lo-noise > mid default."""
    c_lo, c_mid, c_hi, c_clip = ADAPTIVE_CORR_VALUES
    zero = torch.zeros((), device=rggb.device)
    lower = vst(zero, sigma, gain=K)
    upper = vst(torch.ones((), device=rggb.device) * scale, sigma, gain=K)
    nsr = 1.0 / (upper - lower)
    clip_frac = torch.mean(((rggb < 0.02) | (rggb > 0.98)).float())
    mu = torch.mean(torch.clamp(rggb, 0.0, 1.0))
    v_fit = (K / scale) * mu + (sigma / scale) ** 2
    m1, m2 = mad_self_estimate(rggb)
    v_mad = m1 * mu + m2
    madr = torch.sqrt(torch.clamp(v_mad, min=0.0)
                      / torch.clamp(v_fit, min=1e-30))

    def const(v):
        return torch.full((), v, device=rggb.device)

    corr = torch.where(nsr < ADAPTIVE_CORR_NSR_LO, const(c_lo), const(c_mid))
    boost = (clip_frac > ADAPTIVE_CORR_CLIP) \
        & (torch.abs(madr - 1.0) < ADAPTIVE_CORR_MAD_DEV)
    corr = torch.where(boost, const(c_clip), corr)
    corr = torch.where(nsr > ADAPTIVE_CORR_NSR_HI, const(c_hi), corr)
    return corr.float()
