"""Plain float32 noise-level estimation of the product path: box
moments by prefix sums (float64 accumulation on a CUDA device), the
score3 flat-region threshold by one sort, the masked line fit, and the
wavelet-MAD cross-check with its noise-floor statistics.

`q` is the precision hook of the fused reference: every map a stage
hands on passes through it (identity in float32, a bfloat16 round trip
in the control).
"""
from __future__ import annotations

import numpy as np
import torch

NBINS = 1000
NB_M = 200
NB_D = 256
D_RANGE = float(np.log(1e4))
MAD_C = 0.6745
MAX_CELLS = 1 << 17
MAD_BAND = 32
COLLAB_BAND = 1.8


def ident(x):
    return x


# ---------------------------------------------------------------- borders

def reflect_pad(x, axis, before, after):
    """numpy pad(mode='reflect') along one axis, any width."""
    if before == 0 and after == 0:
        return x
    axis = axis % x.ndim
    n = x.shape[axis]
    i = torch.arange(-before, n + after, device=x.device)
    if n == 1:
        i = torch.zeros_like(i)
    else:
        period = 2 * (n - 1)
        i = torch.remainder(i, period)
        i = torch.where(i >= n, period - i, i)
    return torch.index_select(x, axis, i)


# ---------------------------------------------------------------- moments

def _box1d(x, k, axis):
    pad = k // 2
    xp = reflect_pad(x, axis, pad, pad)
    acc = torch.float64 if xp.is_cuda or xp.dtype == torch.float64 \
        else torch.float32
    cs = torch.cumsum(xp.to(acc), dim=axis)
    zshape = list(cs.shape)
    zshape[axis] = 1
    cs = torch.cat([cs.new_zeros(zshape), cs], dim=axis)
    n = x.shape[axis]
    return ((cs.narrow(axis, k, n) - cs.narrow(axis, 0, n)) * (1.0 / k)
            ).to(x.dtype)


def box2d(x, k):
    """[..., H, W, C] box mean, reflect-101 borders, per-plane centred."""
    c = torch.mean(x, dim=(-3, -2), keepdim=True)
    y = _box1d(x - c, k, x.ndim - 3)
    return _box1d(y, k, x.ndim - 2) + c


def mean_var(x, k):
    c = torch.mean(x, dim=(-3, -2), keepdim=True)
    xc = x - c
    n = x.shape[-1]
    both = box2d(torch.cat([xc, xc * xc], dim=-1), k)
    m, m2 = both[..., :n], both[..., n:]
    return m + c, torch.clamp(m2 - m * m, min=0.0)


def moments(x, k, inner):
    """(mean_k, var_k, stdfilt_k(box_inner(x)))."""
    mean, var = mean_var(x, k)
    c = torch.mean(x, dim=(-3, -2), keepdim=True)
    t1 = box2d(x - c, inner)
    n = x.shape[-1]
    tb = box2d(torch.cat([t1, t1 * t1], dim=-1), k)
    tm, tm2 = tb[..., :n], tb[..., n:]
    return mean, var, torch.sqrt(torch.clamp(tm2 - tm * tm, min=0.0))


# ---------------------------------------------------- threshold and fit

def subsample_runs(x, s):
    """Every s-th 128-element run of the flattened array."""
    x = x.reshape(-1)
    if s <= 1:
        return x
    blk = 128 * s
    n = x.shape[0] // blk * blk
    return x[:n].reshape(-1, s, 128)[:, 0, :].reshape(-1)


def percentile_linear(data, quants):
    srt = torch.sort(data.reshape(-1)).values
    n = srt.shape[-1]
    q = (quants / 100.0) * (n - 1)
    low = torch.floor(q)
    hw = q - low
    lo_v = srt[low.long().clamp(0, n - 1)]
    hi_v = srt[torch.ceil(q).long().clamp(0, n - 1)]
    return lo_v * (1.0 - hw) + hi_v * hw


def score3_threshold(texture, mean, step, subsample):
    """(th, th25) of the score3 rule over the sorted texture percentiles."""
    data = subsample_runs(texture, subsample)
    n_q = 100 // step
    quants = torch.linspace(step, 100, n_q, device=data.device,
                            dtype=torch.float32)
    ths = percentile_linear(data, quants)
    m = subsample_runs(mean, subsample)
    buckets = (torch.clamp(m, 0.0, 1.0) * NBINS).to(torch.int64)
    min_tex = torch.full((NBINS + 1,), float("inf"), device=data.device,
                         dtype=data.dtype).scatter_reduce(0, buckets, data,
                                                          "amin")
    npeaks = torch.clamp(torch.sum(min_tex[None, :] <= ths[:, None], dim=1)
                         .to(data.dtype), min=1.0)
    score = ths / (quants * npeaks)
    th = ths[torch.argmin(score[1:]) + 1]
    if 25 % step == 0:
        return th, ths[25 // step - 1]
    q25 = torch.tensor([25.0], device=data.device)
    return th, percentile_linear(data, q25)[0]


def masked_linefit(x, y, w):
    x, y, w = (a.reshape(-1).float() for a in (x, y, w))
    n = torch.sum(w)
    safe_n = torch.clamp(n, min=1.0)
    xbar = torch.sum(w * x) / safe_n
    ybar = torch.sum(w * y) / safe_n
    dx, dy = x - xbar, y - ybar
    sxx = torch.sum(w * dx * dx)
    sxy = torch.sum(w * dx * dy)
    zero = torch.zeros_like(sxx)
    b1 = torch.where(sxx > 0, sxy / torch.clamp(sxx, min=1e-30), zero)
    b2 = ybar - b1 * xbar
    ok = n > 0
    return torch.where(ok, b1, zero), torch.where(ok, b2, zero)


def nonsat_weights(x, w):
    w2 = w * ((x > 1e-4) & (x < 0.8))
    return torch.where(torch.sum(w2) > 0.01 * torch.sum(w), w2, w)


def flat_fit(var, mean, texture, step):
    n = texture.numel()
    sub = 1 if n < 2_000_000 else (4 if n < 8_000_000 else 8)
    th, th25 = score3_threshold(texture, mean, step, sub)
    mask = (texture < th).float()
    mask = torch.where(torch.sum(mask) == 0, (texture < th25).float(), mask)
    mask = torch.where(torch.sum(mask) == 0, torch.ones_like(mask), mask)
    return masked_linefit(mean, var, nonsat_weights(mean, mask))


# ------------------------------------------------------------ row bands

def band_plan(shape, max_px, band, margin):
    """None (no banding) or (nb, keep, stride) of contiguous row bands."""
    if max_px is None:
        return None
    h, w = shape[-3], shape[-2]
    per_row = int(np.prod([s for i, s in enumerate(shape)
                           if i not in (len(shape) - 3, len(shape) - 2)],
                          dtype=np.int64)) * w
    if h * per_row <= max_px or h < 3 * band:
        return None
    nb = h // band
    keep = max(1, min(nb, max_px // max((band - 2 * margin) * per_row, 1)))
    if keep >= nb:
        return None
    return nb, keep, nb // keep


def take_bands(x, nb, keep, stride, band):
    lead = tuple(x.shape[:-3])
    w, C = x.shape[-2], x.shape[-1]
    xb = x[..., :nb * band, :, :].reshape(lead + (nb, band, w, C))
    return xb[..., ::stride, :, :, :][..., :keep, :, :, :]


def crop_rows(a, m):
    return a[..., m:-m, :, :]


# ------------------------------------------------------------ wavelet MAD

def haar_hh(x):
    h, w = x.shape[-3], x.shape[-2]
    x = x[..., :h // 2 * 2, :w // 2 * 2, :]
    a, b = x[..., 0::2, 0::2, :], x[..., 1::2, 1::2, :]
    c, d = x[..., 0::2, 1::2, :], x[..., 1::2, 0::2, :]
    return (a + b - c - d) * 0.5, (a + b + c + d) * 0.25


def count_hist(idx, n, weights=None):
    if weights is None:
        return torch.zeros(n, device=idx.device).index_add_(
            0, idx, torch.ones(idx.shape, device=idx.device))
    acc = torch.float64 if idx.is_cuda else torch.float32
    return torch.zeros(n, device=idx.device, dtype=acc).index_add_(
        0, idx, weights.to(acc)).float()


def first_reaching(cdf, rank):
    n = cdf.shape[-1]
    return torch.clamp(torch.sum(cdf < rank[..., None], dim=-1), max=n - 1)


def band_rows(x, max_px):
    h, w = x.shape[-3], x.shape[-2]
    per_ch = int(np.prod(x.shape[:-3], dtype=np.int64)) * x.shape[-1]
    max_rows = max(MAD_BAND, max_px // max(w * per_ch, 1))
    if h <= max_rows or h < 2 * MAD_BAND:
        return x
    nb = h // MAD_BAND
    keep = max(1, min(nb, max_rows // MAD_BAND))
    stride = nb // keep
    lead = tuple(x.shape[:-3])
    xb = x[..., :nb * MAD_BAND, :, :].reshape(lead + (nb, MAD_BAND, w,
                                                      x.shape[-1]))
    xb = xb[..., ::stride, :, :, :][..., :keep, :, :, :]
    return xb.reshape(lead + (keep * MAD_BAND, w, x.shape[-1]))


def cap_cells(d, m):
    d, m = d.reshape(-1), m.reshape(-1)
    if d.shape[0] > MAX_CELLS:
        s = d.shape[0] // MAX_CELLS + 1
        d, m = subsample_runs(d, s), subsample_runs(m, s)
    return d, m


def mad_fit(detail, mean, min_count=64):
    """(beta1, beta2) from per-intensity-bucket median |detail| and a
    lower-envelope IRLS line fit; inf where coverage is too thin."""
    d = torch.abs(detail.reshape(-1))
    dmax = torch.max(d) + 1e-30
    m = mean.reshape(-1)
    r = torch.clamp(d / dmax, 1e-4, 1.0)
    dbin = torch.clamp(((torch.log(r) + D_RANGE) / D_RANGE * NB_D)
                       .to(torch.int64), 0, NB_D - 1)
    bucket = torch.clamp((torch.clamp(m, 0.0, 1.0) * (NB_M - 1))
                         .to(torch.int64), 0, NB_M - 1)
    counts = count_hist(bucket * NB_D + dbin, NB_M * NB_D).reshape(NB_M,
                                                                   NB_D)
    sum_m = count_hist(bucket, NB_M, m)
    n_b = torch.sum(counts, dim=1)
    cdf = torch.cumsum(counts, dim=1)
    rank = 0.5 * n_b
    med_bin = first_reaching(cdf, rank)
    prev = torch.gather(cdf, 1, torch.clamp(med_bin - 1, min=0)[:, None])[:, 0]
    below = torch.where(med_bin > 0, prev, torch.zeros_like(prev))
    cnt_at = torch.gather(counts, 1, med_bin[:, None])[:, 0]
    frac = torch.clamp((rank - below) / torch.clamp(cnt_at, min=1e-30),
                       0.0, 1.0)
    log_lo = (med_bin.float() / NB_D - 1.0) * D_RANGE
    med = dmax * torch.exp(log_lo + frac * (D_RANGE / NB_D))
    var_b = (med / MAD_C) ** 2
    sigma_b = med / MAD_C
    mean_b = sum_m / torch.clamp(n_b, min=1.0)
    w0 = n_b * ((mean_b > torch.clamp(2.0 * sigma_b, min=1e-4))
                & (mean_b < 0.8) & (n_b >= min_count)).float()

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
        t = var_b - (b1 * mean_b + b2) - 2.0 * se
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
    ok = torch.sum(w0) / torch.clamp(torch.sum(n_b), min=1.0) > 0.05
    inf = torch.full_like(b1, float("inf"))
    return torch.where(ok, b1, inf), torch.where(ok, b2, inf)


def mad_self(x):
    d, m = haar_hh(band_rows(x, 4 * MAX_CELLS))
    return mad_fit(*cap_cells(d, m))


def mad_collab(lr, dn):
    lr = band_rows(lr, 4 * MAX_CELLS)
    dn = band_rows(dn, 4 * MAX_CELLS)
    d, _ = haar_hh(lr - dn)
    _, m = haar_hh(dn)
    return mad_fit(*cap_cells(d, m))


def flat_quantile_sigma(d, m, q):
    d = torch.abs(d)
    valid = (m > 0.02) & (m < 0.9)
    n = torch.sum(valid)
    nbins, span = 512, float(np.log(1e6))
    dmax = torch.max(torch.where(valid, d, torch.zeros_like(d))) + 1e-30
    r = torch.clamp(d / dmax, float(np.exp(-span)), 1.0)
    dbin = torch.clamp(((torch.log(r) + span) / span * nbins)
                       .to(torch.int64), 0, nbins - 1)
    counts = count_hist(dbin.reshape(-1), nbins, valid.float().reshape(-1))
    cdf = torch.cumsum(counts, dim=0)
    rank = q * n
    qbin = first_reaching(cdf, rank)
    below = torch.where(qbin > 0, cdf[torch.clamp(qbin - 1, min=0)],
                        torch.zeros_like(cdf[0]))
    frac = torch.clamp((rank - below) / torch.clamp(counts[qbin], min=1e-30),
                       0.0, 1.0)
    dq = dmax * torch.exp((qbin.float() + frac) / nbins * span - span)
    erfinv_q = torch.erfinv(torch.tensor(q, dtype=torch.float32,
                                         device=d.device))
    sigma = dq / (float(np.sqrt(2.0)) * erfinv_q)
    return torch.where(n > 16, sigma, torch.zeros_like(sigma))


def flat_floor_stats(x, q=0.2):
    """(level-1 noise floor sigma, mean of the mid-tone cells it reads)."""
    d, m = cap_cells(*haar_hh(band_rows(x, 4 * MAX_CELLS)))
    sigma = flat_quantile_sigma(d, m, q)
    valid = (m > 0.02) & (m < 0.9)
    mu = torch.sum(torch.where(valid, m, torch.zeros_like(m))) \
        / torch.clamp(torch.sum(valid), min=1)
    return sigma, mu


def combine(fit, mad, ref_mean, ratio=1.5, band=None):
    b1f, b2f = fit
    b1m, b2m = mad
    v_fit = b1f * ref_mean + b2f
    v_mad = b1m * ref_mean + b2m
    use = v_fit > (band if band is not None else ratio) \
        * torch.clamp(v_mad, min=1e-30)
    if band is not None:
        use = use | (v_fit * band < v_mad)
    use = use & torch.isfinite(v_mad)
    return torch.where(use, b1m, b1f), torch.where(use, b2m, b2f)


def shape_consistent(comb, fit, mad, ref_mean, self_b2, b2_ratio=4.0):
    b1c, b2c = comb
    b1f, b2f = fit
    b1m, b2m = mad
    chose_fit = (b1c == b1f) & (b2c == b2f)
    suspect = b2f > b2_ratio * torch.clamp(torch.maximum(self_b2, b2m),
                                           min=1e-9)
    v_mad = b1m * ref_mean + b2m
    s = (b1f * ref_mean + b2f) / torch.clamp(v_mad, min=1e-30)
    fix = chose_fit & suspect & torch.isfinite(v_mad)
    return torch.where(fix, b1m * s, b1c), torch.where(fix, b2m * s, b2c)
