"""Robust Poisson-Gaussian NLE: per-intensity-bucket wavelet MAD (port of
yondx/nle/robust.py:42-474: what the fused product path and the
engine's robust fits call).

Finest-scale Haar diagonal detail per RGGB plane, bucketed by cell
intensity; per-bucket median |d| from a (bucket x log|d|) histogram; a
lower-envelope IRLS line fit sigma_b^2 ~ mean_b. Histograms are
scatter-adds (`index_add_`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .nlf import collab_nlf, self_nlf
from .threshold import _subsample

NB_M = 200          # intensity buckets
NB_D = 256          # log|d| histogram bins
_D_RANGE = float(np.log(1e4))   # |d| span: [dmax*1e-4, dmax]
_MAD_C = 0.6745     # median|d| = 0.6745 sigma for Gaussian d
_MAX_CELLS = 1 << 17
_BAND = 32          # rows per sampled band (even)
COLLAB_BAND = 1.8


def _haar_hh(x):
    """[..., h, w, C] -> (diagonal detail, cell mean) at half resolution;
    odd h/w are cropped to even first."""
    h, w = x.shape[-3], x.shape[-2]
    x = x[..., : h // 2 * 2, : w // 2 * 2, :]
    a = x[..., 0::2, 0::2, :]
    b = x[..., 1::2, 1::2, :]
    c = x[..., 0::2, 1::2, :]
    d = x[..., 1::2, 0::2, :]
    return (a + b - c - d) * 0.5, (a + b + c + d) * 0.25


def _count_histogram(idx, n: int, weights=None):
    """segment_sum(weights or ones, idx, n) in float32.

    On a CUDA device, weights accumulate in float64 before the cast: the
    card's atomic adds run in no fixed order, and float32 sums of the
    cell intensities made two runs of one held-out column differ by up
    to 3.1e-4 dB; the order moves a float64 sum far less than a float32
    ulp. Counts (no weights) are exact integers in any order."""
    if weights is None:
        return torch.zeros(n, device=idx.device, dtype=torch.float32
                           ).index_add_(0, idx, torch.ones(
                               idx.shape, device=idx.device,
                               dtype=torch.float32))
    acc = torch.float64 if idx.device.type == "cuda" else torch.float32
    out = torch.zeros(n, device=idx.device, dtype=acc)
    return out.index_add_(0, idx, weights.to(acc)).float()


def _first_reaching(cdf, rank):
    """argmax(cdf >= rank) along the last axis of a non-decreasing cdf."""
    n = cdf.shape[-1]
    return torch.clamp(torch.sum(cdf < rank[..., None], dim=-1), max=n - 1)


def _mad_histograms(d, m, dmax):
    """(bucket x log|d|) counts [NB_M, NB_D] + per-bucket intensity sums."""
    d = torch.abs(d.reshape(-1))
    m = m.reshape(-1)
    r = torch.clamp(d / dmax, 1e-4, 1.0)
    dbin = torch.clamp(((torch.log(r) + _D_RANGE) / _D_RANGE * NB_D)
                       .to(torch.int64), 0, NB_D - 1)
    bucket = torch.clamp((torch.clamp(m, 0.0, 1.0) * (NB_M - 1))
                         .to(torch.int64), 0, NB_M - 1)
    counts = _count_histogram(bucket * NB_D + dbin, NB_M * NB_D)
    sum_m = _count_histogram(bucket, NB_M, m)
    return counts.reshape(NB_M, NB_D), sum_m


def mad_pg_fit(detail, mean, min_count: int = 64):
    """(beta1, beta2) from per-bucket median |detail|."""
    d = torch.abs(detail.reshape(-1))
    dmax = torch.max(d) + 1e-30
    counts, sum_m = _mad_histograms(d, mean, dmax)
    return _mad_fit_from_hist(counts, sum_m, dmax, min_count)


def _mad_fit_from_hist(counts, sum_m, dmax, min_count: int = 64):
    """Per-bucket medians + lower-envelope IRLS fit (robust.py:101-184)."""
    n_b = torch.sum(counts, dim=1)
    cdf = torch.cumsum(counts, dim=1)
    rank = 0.5 * n_b
    med_bin = _first_reaching(cdf, rank)
    prev = torch.gather(cdf, 1, torch.clamp(med_bin - 1, min=0)[:, None])[:, 0]
    below = torch.where(med_bin > 0, prev, torch.zeros_like(prev))
    cnt_at = torch.gather(counts, 1, med_bin[:, None])[:, 0]
    frac = torch.clamp((rank - below) / torch.clamp(cnt_at, min=1e-30),
                       0.0, 1.0)
    log_lo = (med_bin.float() / NB_D - 1.0) * _D_RANGE
    step = _D_RANGE / NB_D
    med = dmax * torch.exp(log_lo + frac * step)
    sigma_b = med / _MAD_C
    var_b = sigma_b ** 2
    mean_b = sum_m / torch.clamp(n_b, min=1.0)
    w0 = n_b * ((mean_b > torch.clamp(2.0 * sigma_b, min=1e-4))
                & (mean_b < 0.8)
                & (n_b >= min_count)).float()

    def wfit(w):
        wsum = torch.clamp(torch.sum(w), min=1e-30)
        xbar = torch.sum(w * mean_b) / wsum
        ybar = torch.sum(w * var_b) / wsum
        dx = mean_b - xbar
        sxx = torch.sum(w * dx * dx)
        sxy = torch.sum(w * dx * (var_b - ybar))
        b1 = torch.where(sxx > 0, sxy / torch.clamp(sxx, min=1e-30),
                         torch.zeros_like(sxx))
        return b1, ybar - b1 * xbar

    se = 3.7 * var_b / torch.sqrt(torch.clamp(n_b, min=1.0))
    b1, b2 = wfit(w0)
    w = w0
    for _ in range(3):
        resid = var_b - (b1 * mean_b + b2)
        t = resid - 2.0 * se
        w = w0 * torch.where(t <= 0, torch.ones_like(t),
                             torch.exp(-t / torch.clamp(2.0 * se,
                                                        min=1e-30)))
        b1, b2 = wfit(w)
    wsum = torch.clamp(torch.sum(w), min=1e-30)
    b1_org = torch.sum(w * mean_b * var_b) / torch.clamp(
        torch.sum(w * mean_b * mean_b), min=1e-30)
    b2_flat = torch.sum(w * var_b) / wsum
    zero = torch.zeros_like(b1)
    b1, b2 = (torch.where(b2 < 0, b1_org, torch.where(b1 < 0, zero, b1)),
              torch.where(b2 < 0, zero, torch.where(b1 < 0, b2_flat, b2)))
    coverage = torch.sum(w0) / torch.clamp(torch.sum(n_b), min=1.0)
    ok = coverage > 0.05
    inf = torch.full_like(b1, float("inf"))
    return torch.where(ok, b1, inf), torch.where(ok, b2, inf)


def _maybe_subsample(d, m):
    """Joint run subsample of (detail, mean) to <= _MAX_CELLS cells."""
    d = d.reshape(-1)
    m = m.reshape(-1)
    if d.shape[0] > _MAX_CELLS:
        s = d.shape[0] // _MAX_CELLS + 1
        d = _subsample(d, s)
        m = _subsample(m, s)
    return d, m


def _band_subsample_rows(x, max_px: int):
    """Evenly-spaced contiguous _BAND-row bands totalling <= max_px px."""
    h, w = x.shape[-3], x.shape[-2]
    per_ch = int(np.prod(x.shape[:-3], dtype=np.int64)) * x.shape[-1]
    max_rows = max(_BAND, max_px // max(w * per_ch, 1))
    if h <= max_rows or h < 2 * _BAND:
        return x
    nb = h // _BAND
    keep = max(1, min(nb, max_rows // _BAND))
    stride = nb // keep
    lead = tuple(x.shape[:-3])
    xb = x[..., :nb * _BAND, :, :].reshape(lead + (nb, _BAND, w,
                                                   x.shape[-1]))
    xb = xb[..., ::stride, :, :, :][..., :keep, :, :, :]
    return xb.reshape(lead + (keep * _BAND, w, x.shape[-1]))


def mad_self_estimate(rggb):
    """Robust (beta1, beta2) of a noisy RGGB stack."""
    x = _band_subsample_rows(rggb.float(), 4 * _MAX_CELLS)
    d, m = _haar_hh(x)
    return mad_pg_fit(*_maybe_subsample(d, m))


def _flat_quantile_sigma(d, m, q: float):
    """q-quantile of |d| over mid-tone cells -> half-normal sigma."""
    d = torch.abs(d)
    valid = (m > 0.02) & (m < 0.9)
    n = torch.sum(valid)
    nbins = 512
    span = float(np.log(1e6))
    dmax = torch.max(torch.where(valid, d, torch.zeros_like(d))) + 1e-30
    r = torch.clamp(d / dmax, float(np.exp(-span)), 1.0)
    dbin = torch.clamp(((torch.log(r) + span) / span * nbins)
                       .to(torch.int64), 0, nbins - 1)
    counts = _count_histogram(dbin.reshape(-1), nbins,
                              valid.float().reshape(-1))
    cdf = torch.cumsum(counts, dim=0)
    rank = q * n
    qbin = _first_reaching(cdf, rank)
    below = torch.where(qbin > 0, cdf[torch.clamp(qbin - 1, min=0)],
                        torch.zeros_like(cdf[0]))
    frac = torch.clamp((rank - below) / torch.clamp(counts[qbin], min=1e-30),
                       0.0, 1.0)
    dq = dmax * torch.exp((qbin.float() + frac) / nbins * span - span)
    erfinv_q = torch.erfinv(torch.tensor(q, dtype=torch.float32,
                                         device=d.device))
    sigma = dq / (float(np.sqrt(2.0)) * erfinv_q)
    return torch.where(n > 16, sigma, torch.zeros_like(sigma))


def mad_noise_floor(rggb, q: float = 0.2, levels: int = 3):
    """Content-free lower bound on the noise std: max over Haar levels of
    the input-referred q-quantile sigma of mid-tone cells."""
    x = _band_subsample_rows(rggb.float(), 4 * _MAX_CELLS)
    floor = torch.zeros((), device=x.device)
    for j in range(levels):
        d, m = _haar_hh(x)
        if j == 0:
            d, m2 = _maybe_subsample(d, m)
            sig = _flat_quantile_sigma(d, m2, q)
        else:
            sig = _flat_quantile_sigma(d, m, q)
        floor = torch.maximum(floor, sig * (2.0 ** j))
        x = m
        if min(x.shape[-3], x.shape[-2]) < 8:
            break
    return floor


def flat_floor_stats(rggb, q: float = 0.2):
    """(floor_sigma, mu_mid): level-1 noise floor and the mean intensity of
    the mid-tone cells it reads."""
    x = _band_subsample_rows(rggb.float(), 4 * _MAX_CELLS)
    d, m = _haar_hh(x)
    d, m = _maybe_subsample(d, m)
    sigma = _flat_quantile_sigma(d, m, q)
    valid = (m > 0.02) & (m < 0.9)
    mu_mid = torch.sum(torch.where(valid, m, torch.zeros_like(m))) \
        / torch.clamp(torch.sum(valid), min=1)
    return sigma, mu_mid


def mad_collab_estimate(lr_rggb, dn_rggb):
    """Robust re-estimate from (noisy, denoised): Haar detail of the
    residual, intensities from the denoised proxy."""
    lr = _band_subsample_rows(lr_rggb.float(), 4 * _MAX_CELLS)
    dn = _band_subsample_rows(dn_rggb.float(), 4 * _MAX_CELLS)
    d, _ = _haar_hh(lr - dn)
    _, m = _haar_hh(dn)
    return mad_pg_fit(*_maybe_subsample(d, m))


def combine_estimates(fit, mad, ref_mean, ratio: float = 1.5,
                      band: Optional[float] = None):
    """Keep the flat-mask fit unless the MAD fit's variance at ref_mean
    disagrees (one-sided, or symmetric within `band`)."""
    b1f, b2f = fit
    b1m, b2m = mad
    v_fit = b1f * ref_mean + b2f
    v_mad = b1m * ref_mean + b2m
    hi = band if band is not None else ratio
    use_mad = v_fit > hi * torch.clamp(v_mad, min=1e-30)
    if band is not None:
        use_mad = use_mad | (v_fit * band < v_mad)
    use_mad = use_mad & torch.isfinite(v_mad)
    return (torch.where(use_mad, b1m, b1f), torch.where(use_mad, b2m, b2f))


def shape_consistent_collab(comb, fit, mad, ref_mean, self_reg,
                            b2_ratio: float = 4.0):
    """Adopt the MAD's slope/intercept split (scaled to the fit's total)
    when the band-kept fit's beta2 is above b2_ratio x both references."""
    b1c, b2c = comb
    b1f, b2f = fit
    b1m, b2m = mad
    b2s = self_reg[1]
    chose_fit = (b1c == b1f) & (b2c == b2f)
    suspect = b2f > b2_ratio * torch.clamp(torch.maximum(b2s, b2m),
                                           min=1e-9)
    v_fit = b1f * ref_mean + b2f
    v_mad = b1m * ref_mean + b2m
    s = v_fit / torch.clamp(v_mad, min=1e-30)
    fix = chose_fit & suspect & torch.isfinite(v_mad)
    return (torch.where(fix, b1m * s, b1c), torch.where(fix, b2m * s, b2c))


def self_nlf_robust(lr_rggb, k: int = 29, step: int = 5,
                    ratio: float = 1.5):
    """SelfNLF with the MAD cross-check (the 'robust_nle' path)."""
    x = lr_rggb.float()
    fit = self_nlf(x, k=k, step=step)
    mad = mad_self_estimate(x)
    ref_mean = torch.mean(torch.clamp(x, 0.0, 1.0))
    return combine_estimates(fit, mad, ref_mean, ratio)


def collab_nlf_robust(lr_rggb, dn_rggb, k: int = 29, step: int = 5,
                      band: float = COLLAB_BAND, self_reg=None):
    """CollabNLF with the symmetric MAD cross-check on the residual;
    `self_reg` (round-0 (beta1, beta2)) enables the shape-consistency
    repair."""
    lr = lr_rggb.float()
    dn = dn_rggb.float()
    fit = collab_nlf(lr, dn, k=k, step=step)
    mad = mad_collab_estimate(lr, dn)
    ref_mean = torch.mean(torch.clamp(dn, 0.0, 1.0))
    comb = combine_estimates(fit, mad, ref_mean, band=band)
    if self_reg is not None:
        reg = tuple(torch.as_tensor(r, dtype=torch.float32, device=lr.device)
                    for r in self_reg)
        comb = shape_consistent_collab(comb, fit, mad, ref_mean, reg)
    return comb
