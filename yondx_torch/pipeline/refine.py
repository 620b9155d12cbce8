"""Method-noise Wiener refinement (port of yondx/pipeline/refine.py:56-553).

In VST space the noise is unit variance, so the residual r = z_noisy -
z_dn measures the denoiser's local error power: sigma_d^2 = max(0,
box(r^2) - floor). The Wiener weight alpha = sigma_d^2 / (sigma_d^2 +
floor) blends back the residual, optionally a-trous-shrunk first. The
floor is the caller's noise variance ('fixed'), its per-intensity
bucket measurement ('bucket'), a windowed-min erosion of the residual
power ('local'), or a gated 10th percentile of it ('q10').
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.tiling import reflect_pad
from ..nle.boxfilter import box_mean
from ..nle.robust import _band_subsample_rows, _first_reaching, _haar_hh

# The refine's fixed settings (the defaults below, which wiener_refine
# keeps), read from here by its kernels (refine_kernels.py): the a-trous
# shrink's levels, stabiliser box and directional gate; the bucket
# floor's buckets, quantile, trust ramp, log-|detail| bins over SPAN of
# log range, and sample budget.
LEVELS, STAB_K, DIR_L, DIR_C0, DIR_C1 = 3, 3, 9, 8.0, 8.0
FLOOR_NB, FLOOR_Q, FLOOR_MIN_COUNT = 64, 0.2, 64
FLOOR_TRUST_LO, FLOOR_TRUST_HI = 0.35, 0.60
FLOOR_NBIN, FLOOR_SPAN = 128, float(np.log(1e4))
FLOOR_MAX_SAMPLES = 1 << 19


def _bucket_floor_table(z_noisy, z_dn, noise_var, nb: int = FLOOR_NB,
                        q: float = FLOOR_Q, min_count: int = FLOOR_MIN_COUNT,
                        trust_lo: float = FLOOR_TRUST_LO,
                        trust_hi: float = FLOOR_TRUST_HI):
    """The [nb] noise floor of each z_dn-intensity bucket: the q-quantile
    |Haar detail| of z_noisy there, trusted below trust_hi x the model
    variance."""
    zs = _band_subsample_rows(z_noisy, 4 * FLOOR_MAX_SAMPLES)
    ds = _band_subsample_rows(z_dn, 4 * FLOOR_MAX_SAMPLES)
    d, _ = _haar_hh(zs)
    _, mc = _haar_hh(ds)
    d = torch.abs(d).reshape(-1)
    mc = torch.clamp(mc.reshape(-1), 0.0, 1.0)
    if d.shape[0] > FLOOR_MAX_SAMPLES:
        s = d.shape[0] // FLOOR_MAX_SAMPLES + 1
        d, mc = d[::s], mc[::s]
    nd = FLOOR_NBIN
    dmax = torch.max(d) + 1e-30
    lr = torch.log(torch.clamp(d / dmax, 1e-4, 1.0))
    span = FLOOR_SPAN
    dbin = torch.clamp(((lr + span) / span * nd).to(torch.int64), 0, nd - 1)
    bucket = torch.clamp((mc * (nb - 1)).to(torch.int64), 0, nb - 1)
    counts = torch.zeros(nb * nd, device=d.device).index_add_(
        0, bucket * nd + dbin, torch.ones_like(d)).reshape(nb, nd)
    n_b = torch.sum(counts, dim=1)
    cdf = torch.cumsum(counts, dim=1)
    rank = q * n_b
    qbin = _first_reaching(cdf, rank)
    prev = torch.gather(cdf, 1, torch.clamp(qbin - 1, min=0)[:, None])[:, 0]
    below = torch.where(qbin > 0, prev, torch.zeros_like(prev))
    cnt = torch.gather(counts, 1, qbin[:, None])[:, 0]
    frac = torch.clamp((rank - below) / torch.clamp(cnt, min=1e-30), 0.0, 1.0)
    qd = dmax * torch.exp((qbin.float() + frac) / nd * span - span)
    erfinv_q = torch.erfinv(torch.tensor(q, dtype=torch.float32,
                                         device=d.device))
    sigma_b = qd / (float(np.sqrt(2.0)) * erfinv_q)
    V = torch.as_tensor(noise_var, dtype=torch.float32, device=d.device)
    q_b = sigma_b ** 2
    ratio = q_b / torch.clamp(V, min=1e-12)
    t = torch.clamp((ratio - trust_lo) / (trust_hi - trust_lo), 0.0, 1.0)
    floor_b = torch.minimum(V, q_b * (1.0 - t) + V * t)
    floor_b = torch.where(n_b >= min_count, floor_b, V.expand_as(floor_b))
    return torch.clamp(floor_b, min=1e-12)


def _bucket_noise_floor(z_noisy, z_dn, noise_var, nb: int = FLOOR_NB,
                        **kw):
    """Per-intensity content-free noise floor measured on the input
    (_bucket_floor_table, keywords as its), a per-pixel map via z_dn."""
    floor_b = _bucket_floor_table(z_noisy, z_dn, noise_var, nb, **kw)
    pix = torch.clamp((torch.clamp(z_dn, 0.0, 1.0) * (nb - 1))
                      .to(torch.int64), 0, nb - 1)
    return floor_b[pix]


def _b3_smooth_kernels(levels: int):
    h = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
    smooth = [np.array([1.0])]
    for j in range(levels):
        hk = np.zeros(4 * (2 ** j) + 1)
        hk[:: 2 ** j] = h
        smooth.append(np.convolve(smooth[-1], hk))
    return smooth


def _starlet_noise_vars(levels: int):
    """Per-band white-noise variance factors of the B3 a-trous transform."""
    smooth = _b3_smooth_kernels(levels)

    def center_pad(a, n):
        out = np.zeros(n)
        off = (n - len(a)) // 2
        out[off:off + len(a)] = a
        return out

    var_c = [float((s ** 2).sum() ** 2) for s in smooth]
    det_vars = []
    for j in range(1, levels + 1):
        n = len(smooth[j])
        a, b = center_pad(smooth[j - 1], n), smooth[j]
        cov = float((a * b).sum() ** 2)
        det_vars.append(var_c[j - 1] + var_c[j] - 2.0 * cov)
    return det_vars, var_c[levels]


def _sep_b3_blur(c, t: int):
    """Separable dilated B3-spline blur (a-trous step), reflect borders."""
    for axis in (c.ndim - 3, c.ndim - 2):
        cp = reflect_pad(c, axis, 2 * t, 2 * t)
        n = c.shape[axis]

        def sl(off):
            return cp.narrow(axis, 2 * t + off, n)

        c = (sl(-2 * t) + 4.0 * sl(-t) + 6.0 * sl(0)
             + 4.0 * sl(t) + sl(2 * t)) * (1.0 / 16.0)
    return c


def _dir_mean_noise_vars(levels: int, L: int, step_cap: int = 4):
    """White-noise variance of the L-tap directional mean of each a-trous
    band: [(nu_axis_j, nu_diag_j)]."""
    smooth = _b3_smooth_kernels(levels)

    def kern2d(a, n):
        out = np.zeros(n)
        off = (n - len(a)) // 2
        out[off:off + len(a)] = a
        return np.outer(out, out)

    m = L // 2
    vals = []
    for j in range(levels):
        t = min(2 ** j, step_cap)
        n = len(smooth[j + 1])
        D = kern2d(smooth[j], n) - kern2d(smooth[j + 1], n)
        pad = m * t
        big = n + 2 * pad
        acc_ax = np.zeros((big, big))
        acc_dg = np.zeros((big, big))
        for i in range(-m, m + 1):
            acc_ax[pad:pad + n, pad + i * t:pad + i * t + n] += D
            acc_dg[pad + i * t:pad + i * t + n,
                   pad + i * t:pad + i * t + n] += D
        vals.append((float(((acc_ax / L) ** 2).sum()),
                     float(((acc_dg / L) ** 2).sum())))
    return vals


def _dir_coherence(d, t: int, L: int):
    """Max over 4 orientations of the squared L-tap directional mean of the
    channel-averaged band plane -> (coh_axis, coh_diag), [..., h, w, 1]."""
    m = L // 2
    h, w = d.shape[-3], d.shape[-2]
    m_ax = min(m, max((min(h, w) - 1) // max(t, 1), 0))
    dm = torch.mean(d, dim=-1, keepdim=True)
    if m_ax < 1:
        z = dm * dm
        return z, z
    P = m_ax * t
    dp = reflect_pad(reflect_pad(dm, -3, P, P), -2, P, P)

    def sl(dy, dx):
        return dp[..., P + dy:P + dy + h, P + dx:P + dx + w, :]

    def line_mean(dy, dx):
        acc = sl(0, 0)
        for i in range(1, m_ax + 1):
            acc = acc + sl(i * dy * t, i * dx * t) \
                + sl(-i * dy * t, -i * dx * t)
        return acc / (2 * m_ax + 1)

    coh_ax = torch.maximum(line_mean(0, 1) ** 2, line_mean(1, 0) ** 2)
    coh_dg = torch.maximum(line_mean(1, 1) ** 2, line_mean(1, -1) ** 2)
    return coh_ax, coh_dg


def shrink_residual_atrous(r, noise_var, levels: int = LEVELS,
                           lam: float = 1.0, stab_k: int = STAB_K,
                           mode: str = "oriented", dir_L: int = DIR_L,
                           dir_c0: float = DIR_C0, dir_c1: float = DIR_C1):
    """Per-band empirical-Wiener shrink of the residual in the a-trous
    domain; mode 'oriented' adds the orientation-coherence structure
    gate, 'iso' keeps the isotropic gain alone. Returns (shrunk residual,
    coherence-gated structure part; zeros for 'iso')."""
    if mode not in ("iso", "oriented"):
        raise ValueError(f"shrink mode {mode!r} is not 'iso' or 'oriented'")
    det_vars, _ = _starlet_noise_vars(levels)
    if mode == "oriented":
        dir_vars = _dir_mean_noise_vars(levels, dir_L)
    V = noise_var
    c = r
    out = torch.zeros_like(r)
    struct = torch.zeros_like(r)
    for j in range(levels):
        cj = _sep_b3_blur(c, 2 ** j)
        d = c - cj
        e = box_mean(d * d, stab_k)
        g = torch.clamp(e - lam * det_vars[j] * V, min=0.0) \
            / torch.clamp(e, min=1e-20)
        if mode == "oriented":
            # channel mean of C independent planes: noise variance / C
            nu_ax, nu_dg = (v / r.shape[-1] for v in dir_vars[j])
            coh_ax, coh_dg = _dir_coherence(d, min(2 ** j, 4), dir_L)
            q = torch.maximum(coh_ax / (nu_ax * V + 1e-30),
                              coh_dg / (nu_dg * V + 1e-30))
            qe = torch.clamp(q - dir_c0, min=0.0)
            s = qe / (qe + dir_c1)
            g = g + (1.0 - g) * s
            struct = struct + s * d
        out = out + g * d
        c = cj
    return out + c, struct


def _window_min(x, w: int, axis: int):
    """Windowed minimum of width w (odd) along `axis` of [..., h, w, C],
    centred, over the in-bounds samples only (XLA's reduce_window with
    SAME padding and an infinite pad value)."""
    xt = x.movedim(axis, -1)
    shp = xt.shape
    y = -F.max_pool1d(-xt.reshape(-1, 1, shp[-1]), w, stride=1,
                      padding=w // 2)
    return y.reshape(shp).movedim(-1, axis)


def _local_floor(local_pow, noise_var, k: int):
    """Every region inherits the residual power of its nearest flat
    patch: a (4k+3)-wide separable erosion, debiased, capped by the
    model variance."""
    w = 4 * k + 3
    ero = _window_min(_window_min(local_pow, w, -3), w, -2)
    # min over ~(w/k)^2 independent k^2-sample chi2 means sits ~1.8
    # sampling-sigmas below the mean
    df = max(1.0 - 1.8 * float(np.sqrt(2.0)) / k, 0.5)
    V = torch.as_tensor(noise_var, dtype=torch.float32,
                        device=local_pow.device)
    return torch.minimum(V, torch.clamp(ero / df, min=1e-12))


def _q10_floor(local_pow, noise_var, x01, k: int, stride: int,
               sat_lo: float):
    """The 10th percentile of the strided residual power over mid-tone
    samples (the unmasked one where fewer than 17 are valid), debiased
    and trusted only as a gross over-estimate of the model variance."""
    s = stride
    sub = local_pow[..., ::s, ::s, :]
    if x01 is not None:
        lvl = x01[..., ::s, ::s, :]
        valid = (lvl > 0.06) & (lvl < sat_lo)
        subm = torch.where(valid, sub, torch.full_like(sub, float("inf")))
    else:
        valid = torch.ones_like(sub, dtype=torch.bool)
        subm = sub
    lead = sub.shape[0] if sub.ndim == 4 else 1
    flat = torch.sort(subm.reshape(lead, -1), dim=-1).values
    nv = torch.sum(valid.reshape(lead, -1), dim=-1)
    idx = torch.clamp((0.10 * nv.float()).to(torch.int64), 0,
                      flat.shape[-1] - 1)
    q = torch.gather(flat, 1, idx[:, None])[:, 0]
    q_all = torch.quantile(sub.reshape(lead, -1), 0.10, dim=-1)
    q = torch.where(nv > 16, q, q_all)
    q = q[:, None, None, None] if sub.ndim == 4 else q[0]
    # the 10th pct of a k^2-sample mean of squares sits ~1.28*sqrt(2)/k
    # below its mean
    q = q / max(1.0 - 1.28 * float(np.sqrt(2.0)) / k, 0.5)
    q = torch.clamp(q, min=1e-12)
    V = torch.as_tensor(noise_var, dtype=torch.float32,
                        device=local_pow.device)
    ratio = q / torch.clamp(V, min=1e-12)
    t = torch.clamp((ratio - 0.35) / 0.25, 0.0, 1.0)
    return torch.minimum(V, q * (1.0 - t) + V * t)


def wiener_refine(z_dn, z_noisy, noise_var=1.0, *, k: int = 15,
                  beta: float = 1.0, deadband: float = 2.0, x01=None,
                  sat_lo: float = 0.92, sat_hi: float = 0.98,
                  noise_floor: str = "bucket", floor_stride: int = 32,
                  residual_shrink: bool = True, shrink_lam: float = 1.0,
                  shrink_full_alpha: float = 1.0,
                  shrink_mode: str = "oriented"):
    """Refine a VST-space denoiser output against its own input
    ([..., h, w, C] normalized planes, noise variance `noise_var`), as
    yondx's wiener_refine. The defaults are the product configuration
    (bucket floor, oriented shrink at full alpha 1.0); the JAX
    function's defaults are q10 and no shrink, and its callers pass
    every setting, as the port's VSTDenoiser does.

    With residual_shrink and shrink_full_alpha >= 1: out = z_dn + alpha *
    shrunk(r) + (1 - alpha) * structure(r); with shrink_full_alpha < 1
    the shrunk residual is handed back to the raw one as alpha rises
    past it; without the shrink: out = z_dn + alpha * r.

    CUDA tensors run the refine's kernels (refine_kernels.py; float32
    [..., h, w, 4] planes, or it raises); CPU tensors run the plain
    version, wiener_refine_plain."""
    kw = dict(k=k, beta=beta, deadband=deadband, x01=x01, sat_lo=sat_lo,
              sat_hi=sat_hi, noise_floor=noise_floor,
              floor_stride=floor_stride, residual_shrink=residual_shrink,
              shrink_lam=shrink_lam, shrink_full_alpha=shrink_full_alpha,
              shrink_mode=shrink_mode)
    if z_dn.device.type == "cuda":
        from .refine_kernels import wiener_refine_cuda
        return wiener_refine_cuda(z_dn, z_noisy, noise_var, **kw)
    if z_dn.device.type != "cpu":
        raise RuntimeError(f"wiener_refine: no path for device {z_dn.device}")
    return wiener_refine_plain(z_dn, z_noisy, noise_var, **kw)


def wiener_refine_plain(z_dn, z_noisy, noise_var=1.0, *, k: int = 15,
                        beta: float = 1.0, deadband: float = 2.0, x01=None,
                        sat_lo: float = 0.92, sat_hi: float = 0.98,
                        noise_floor: str = "bucket", floor_stride: int = 32,
                        residual_shrink: bool = True, shrink_lam: float = 1.0,
                        shrink_full_alpha: float = 1.0,
                        shrink_mode: str = "oriented"):
    """The plain PyTorch version of wiener_refine (any device)."""
    r = z_noisy - z_dn
    local_pow = box_mean(r * r, k)
    if noise_floor == "bucket":
        noise_var = _bucket_noise_floor(z_noisy, z_dn, noise_var)
    elif noise_floor == "local":
        noise_var = _local_floor(local_pow, noise_var, k)
    elif noise_floor == "q10":
        noise_var = _q10_floor(local_pow, noise_var, x01, k, floor_stride,
                               sat_lo)
    elif noise_floor != "fixed":
        raise ValueError(f"noise floor {noise_floor!r} is not one of "
                         "'bucket', 'local', 'q10', 'fixed'")
    allowance = noise_var * (1.0 + deadband * float(np.sqrt(2.0) / k))
    sigma_d2 = beta * torch.clamp(local_pow - allowance, min=0.0)
    alpha = sigma_d2 / (sigma_d2 + noise_var)
    if x01 is not None:
        sat = torch.clamp((x01 - sat_lo) / (sat_hi - sat_lo), 0.0, 1.0)
        alpha = alpha * (1.0 - sat)
    if residual_shrink:
        rs, rs_struct = shrink_residual_atrous(r, noise_var, lam=shrink_lam,
                                               mode=shrink_mode)
        if shrink_full_alpha >= 1.0:
            w_struct = 1.0 - alpha
            if x01 is not None:
                w_struct = w_struct * (1.0 - sat)
            return z_dn + alpha * rs + w_struct * rs_struct
        # below full alpha the shrunk residual is used as-is; above it a
        # linear ramp hands back the raw residual (fa -> 1 clamped so the
        # ramp stays defined)
        fa = min(shrink_full_alpha, 1.0 - 1e-6)
        w = torch.clamp((alpha - fa) / (1.0 - fa), 0.0, 1.0)
        r = rs + w * (r - rs)
    return z_dn + alpha * r
