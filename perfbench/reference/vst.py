"""Plain float32 VST stage of the product path: the generalized Anscombe
transform and its asymptotic inverse, the bias curve read from the
committed 2-D bias table (and its sg-extension table) at sg = sigma / K,
its Chebyshev fit and per-pixel Clenshaw evaluation, and the adaptive
guidance scale."""
from __future__ import annotations

import math
import os

import numpy as np
import torch

_SP = 128
X_LIN_STEP = 2.0 ** -4 / _SP
X_LUT = np.concatenate((np.linspace(0, 2 ** -4, _SP, endpoint=False),
                        np.exp(np.linspace(np.log(2 ** -4), np.log(2 ** 10),
                                           14 * _SP + 1))))
SG_LUT = np.concatenate((np.linspace(0, 1, 200, endpoint=False),
                         np.linspace(1, 10, 901)))
X_EXT = np.exp(np.linspace(np.log(2 ** 10), np.log(2 ** 16), 257))[1:]
FULL_LEN = len(X_LUT) + len(X_EXT)
SG_EXT = np.exp(np.linspace(np.log(10.0), np.log(160.0), 65))
_LOG_A = math.log(2 ** -4)
_LOG_D = (math.log(2 ** 10) - _LOG_A) / (14 * _SP)
_EXT_A = math.log(2 ** 10)
_EXT_D = (math.log(2 ** 16) - _EXT_A) / 256
CHEB_M = 65

CORR_NSR_LO, CORR_NSR_HI, CORR_CLIP, CORR_MAD_DEV = 0.025, 0.09, 0.25, 0.04
CORR_VALUES = (1.03, 1.08, 1.00, 1.25)


def load_tables(root="."):
    """The committed bias tables (2-D and sg-extension), float32."""
    d = os.path.join(root, "checkpoints")
    lut = np.load(os.path.join(d, "bias_lut_2d.npy")).astype(np.float32)
    ext = np.load(os.path.join(d, "bias_lut_sgext.npy")).astype(np.float32)
    if lut.shape != (len(X_LUT), len(SG_LUT)) \
            or ext.shape != (len(X_LUT), len(SG_EXT)):
        raise ValueError("bias tables of unexpected shape")
    return lut, ext


def vst(x, sigma, gain):
    fz = gain * x + 0.375 * gain ** 2 + sigma ** 2
    return (2.0 / gain) * torch.sqrt(torch.clamp(fz, min=0.0))


def inverse_vst(z, sigma, gain):
    s = sigma / gain
    return torch.clamp((z / 2.0) ** 2 - 0.375 - s ** 2, min=0.0) * gain


def _close_form(lam, sg):
    y_hat = lam + 0.375 + sg ** 2
    m1 = (lam + sg ** 2) / y_hat ** 2
    m2 = lam / y_hat ** 3
    m3 = (lam + 3.0 * (lam + sg ** 2) ** 2) / y_hat ** 4
    return 2.0 * torch.sqrt(y_hat) * (-m1 / 8.0 + m2 / 16.0 - 5.0 * m3 / 128.0)


def bias_curve(lut, ext_lut, K, sigma):
    """The bias over the full electron grid at sg = sigma / K: a blend of
    two table columns to sg 10, of the extension table to sg 160, the
    closed form beyond and past 2^10 electrons."""
    dev = lut.device
    sg = sigma / K
    pos = torch.where(sg < 1.0, sg / 0.005, 200.0 + (sg - 1.0) / 0.01)
    pos = torch.clamp(pos, 0.0, len(SG_LUT) - 1)
    lo = torch.floor(pos).long()
    hi = torch.clamp(lo + 1, max=len(SG_LUT) - 1)
    w = pos - lo
    base = lut[:, lo] * (1.0 - w) + lut[:, hi] * w
    oor = _close_form(torch.as_tensor(X_LUT, device=dev, dtype=torch.float32),
                      sg)
    epos = (torch.log(torch.clamp(sg, min=10.0)) - float(np.log(10.0))) \
        / float(np.log(160.0) - np.log(10.0)) * (len(SG_EXT) - 1)
    epos = torch.clamp(epos, 0.0, len(SG_EXT) - 1)
    elo = torch.floor(epos).long()
    ehi = torch.clamp(elo + 1, max=len(SG_EXT) - 1)
    ew = epos - elo
    oor = torch.where(sg <= float(SG_EXT[-1]),
                      ext_lut[:, elo] * (1.0 - ew) + ext_lut[:, ehi] * ew, oor)
    base = torch.where(sg <= float(SG_LUT[-1]), base, oor)
    tail = _close_form(torch.as_tensor(X_EXT, device=dev, dtype=torch.float32),
                       sg)
    return torch.cat([base, tail]).float()


def frac_index(xe):
    """Fractional index of electron values in the full grid."""
    xe = torch.clamp(xe, min=0.0)

    def log_pos(x, a, d, base):
        j = torch.floor((torch.log(torch.clamp(x, min=1e-30)) - a) / d)
        g0 = torch.exp(a + j * d)
        g1 = torch.exp(a + (j + 1) * d)
        return base + j + (x - g0) / (g1 - g0)

    pos = torch.where(xe < 2 ** -4, xe / X_LIN_STEP,
                      torch.where(xe <= 2 ** 10,
                                  log_pos(xe, _LOG_A, _LOG_D, _SP),
                                  log_pos(xe, _EXT_A, _EXT_D,
                                          len(X_LUT) - 1)))
    return torch.clamp(pos, 0.0, FULL_LEN - 1)


def _interp(curve, pos):
    lo = torch.floor(pos).long()
    hi = torch.clamp(lo + 1, max=curve.shape[0] - 1)
    w = pos - lo
    return curve[lo] * (1.0 - w) + curve[hi] * w


def cheb_coeffs(curve):
    """Chebyshev series of the curve sampled at CHEB_M nodes."""
    k = np.arange(CHEB_M)
    s = np.cos(np.pi * (k + 0.5) / CHEB_M)
    nodes = ((s + 1.0) / 2.0 * (FULL_LEN - 1)).astype(np.float32)
    dct = (2.0 / CHEB_M) * np.cos(np.outer(np.arccos(s), k)).T
    dct[0] *= 0.5
    dev = curve.device
    return torch.as_tensor(dct.astype(np.float32), device=dev) @ _interp(
        curve, torch.as_tensor(nodes, device=dev))


def bias_at(x_dn, coeffs, K):
    """Per-pixel bias: Clenshaw evaluation at the pixel's grid position."""
    s = frac_index(x_dn / K) * (2.0 / (FULL_LEN - 1)) - 1.0
    b1 = torch.zeros_like(s)
    b2 = torch.zeros_like(s)
    for i in range(coeffs.shape[0] - 1, 0, -1):
        b1, b2 = 2.0 * s * b1 - b2 + coeffs[i], b1
    return s * b1 - b2 + coeffs[0]


def sigma_corr(x01, K, sigma, scale, mad):
    """The guidance scale in {1.00, 1.03, 1.08, 1.25}."""
    clip = torch.mean(((x01 < 0.02) | (x01 > 0.98)).float())
    mu = torch.mean(torch.clamp(x01, 0.0, 1.0))
    zero = torch.zeros((), device=mu.device)
    nsr = 1.0 / (vst(zero + scale, sigma, K) - vst(zero, sigma, K))
    v_fit = (K / scale) * mu + (sigma / scale) ** 2
    v_mad = mad[0] * mu + mad[1]
    madr = torch.sqrt(torch.clamp(v_mad, min=0.0)
                      / torch.clamp(v_fit, min=1e-30))
    lo, mid, hi, clipv = (torch.full((), v, device=mu.device)
                          for v in CORR_VALUES)
    corr = torch.where(nsr < CORR_NSR_LO, lo, mid)
    corr = torch.where((clip > CORR_CLIP)
                       & (torch.abs(madr - 1.0) < CORR_MAD_DEV), clipv, corr)
    return torch.where(nsr > CORR_NSR_HI, hi, corr).float()
