"""Plain float32 method-noise Wiener refine, as the product runs it: the
per-intensity bucket noise floor, the Wiener weight on the local
residual power, and the oriented a-trous shrink of the residual at full
alpha 1 (levels 3, stabiliser box 3, 9-tap directional means)."""
from __future__ import annotations

import numpy as np
import torch

from .nle import band_rows, box2d, first_reaching, haar_hh, reflect_pad

K_BOX, DEADBAND, SAT_LO, SAT_HI = 15, 2.0, 0.92, 0.98
LEVELS, STAB_K, DIR_L, DIR_C0, DIR_C1 = 3, 3, 9, 8.0, 8.0


def bucket_floor(z_noisy, z_dn, noise_var, nb=64, q=0.2, min_count=64,
                 trust_lo=0.35, trust_hi=0.60):
    d, _ = haar_hh(band_rows(z_noisy, 4 * (1 << 19)))
    _, mc = haar_hh(band_rows(z_dn, 4 * (1 << 19)))
    d = torch.abs(d).reshape(-1)
    mc = torch.clamp(mc.reshape(-1), 0.0, 1.0)
    if d.shape[0] > (1 << 19):
        s = d.shape[0] // (1 << 19) + 1
        d, mc = d[::s], mc[::s]
    nd, span = 128, float(np.log(1e4))
    dmax = torch.max(d) + 1e-30
    lr = torch.log(torch.clamp(d / dmax, 1e-4, 1.0))
    dbin = torch.clamp(((lr + span) / span * nd).to(torch.int64), 0, nd - 1)
    bucket = torch.clamp((mc * (nb - 1)).to(torch.int64), 0, nb - 1)
    counts = torch.zeros(nb * nd, device=d.device).index_add_(
        0, bucket * nd + dbin, torch.ones_like(d)).reshape(nb, nd)
    n_b = torch.sum(counts, dim=1)
    cdf = torch.cumsum(counts, dim=1)
    rank = q * n_b
    qbin = first_reaching(cdf, rank)
    prev = torch.gather(cdf, 1, torch.clamp(qbin - 1, min=0)[:, None])[:, 0]
    below = torch.where(qbin > 0, prev, torch.zeros_like(prev))
    cnt = torch.gather(counts, 1, qbin[:, None])[:, 0]
    frac = torch.clamp((rank - below) / torch.clamp(cnt, min=1e-30), 0.0, 1.0)
    qd = dmax * torch.exp((qbin.float() + frac) / nd * span - span)
    erfinv_q = torch.erfinv(torch.tensor(q, dtype=torch.float32,
                                         device=d.device))
    q_b = (qd / (float(np.sqrt(2.0)) * erfinv_q)) ** 2
    V = torch.as_tensor(noise_var, dtype=torch.float32, device=d.device)
    t = torch.clamp((q_b / torch.clamp(V, min=1e-12) - trust_lo)
                    / (trust_hi - trust_lo), 0.0, 1.0)
    floor_b = torch.minimum(V, q_b * (1.0 - t) + V * t)
    floor_b = torch.where(n_b >= min_count, floor_b, V.expand_as(floor_b))
    floor_b = torch.clamp(floor_b, min=1e-12)
    pix = torch.clamp((torch.clamp(z_dn, 0.0, 1.0) * (nb - 1))
                      .to(torch.int64), 0, nb - 1)
    return floor_b[pix]


def _b3_kernels(levels):
    h = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
    smooth = [np.array([1.0])]
    for j in range(levels):
        hk = np.zeros(4 * (2 ** j) + 1)
        hk[::2 ** j] = h
        smooth.append(np.convolve(smooth[-1], hk))
    return smooth


def _centre(a, n):
    out = np.zeros(n)
    off = (n - len(a)) // 2
    out[off:off + len(a)] = a
    return out


def starlet_vars(levels):
    smooth = _b3_kernels(levels)
    var_c = [float((s ** 2).sum() ** 2) for s in smooth]
    out = []
    for j in range(1, levels + 1):
        n = len(smooth[j])
        cov = float((_centre(smooth[j - 1], n) * smooth[j]).sum() ** 2)
        out.append(var_c[j - 1] + var_c[j] - 2.0 * cov)
    return out


def dir_vars(levels, L, step_cap=4):
    smooth = _b3_kernels(levels)
    m = L // 2
    vals = []
    for j in range(levels):
        t = min(2 ** j, step_cap)
        n = len(smooth[j + 1])
        D = np.outer(_centre(smooth[j], n), _centre(smooth[j], n)) \
            - np.outer(smooth[j + 1], smooth[j + 1])
        pad = m * t
        big = n + 2 * pad
        ax = np.zeros((big, big))
        dg = np.zeros((big, big))
        for i in range(-m, m + 1):
            ax[pad:pad + n, pad + i * t:pad + i * t + n] += D
            dg[pad + i * t:pad + i * t + n, pad + i * t:pad + i * t + n] += D
        vals.append((float(((ax / L) ** 2).sum()),
                     float(((dg / L) ** 2).sum())))
    return vals


def b3_blur(c, t):
    for axis in (c.ndim - 3, c.ndim - 2):
        cp = reflect_pad(c, axis, 2 * t, 2 * t)
        n = c.shape[axis]

        def sl(off):
            return cp.narrow(axis, 2 * t + off, n)

        c = (sl(-2 * t) + 4.0 * sl(-t) + 6.0 * sl(0) + 4.0 * sl(t)
             + sl(2 * t)) * (1.0 / 16.0)
    return c


def coherence(d, t, L):
    m = L // 2
    h, w = d.shape[-3], d.shape[-2]
    m_ax = min(m, max((min(h, w) - 1) // max(t, 1), 0))
    dm = torch.mean(d, dim=-1, keepdim=True)
    if m_ax < 1:
        return dm * dm, dm * dm
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

    return (torch.maximum(line_mean(0, 1) ** 2, line_mean(1, 0) ** 2),
            torch.maximum(line_mean(1, 1) ** 2, line_mean(1, -1) ** 2))


def shrink(r, V):
    det = starlet_vars(LEVELS)
    dv = dir_vars(LEVELS, DIR_L)
    c = r
    out = torch.zeros_like(r)
    struct = torch.zeros_like(r)
    for j in range(LEVELS):
        cj = b3_blur(c, 2 ** j)
        d = c - cj
        e = box2d(d * d, STAB_K)
        g = torch.clamp(e - det[j] * V, min=0.0) / torch.clamp(e, min=1e-20)
        nu_ax, nu_dg = (v / r.shape[-1] for v in dv[j])
        coh_ax, coh_dg = coherence(d, min(2 ** j, 4), DIR_L)
        qq = torch.maximum(coh_ax / (nu_ax * V + 1e-30),
                           coh_dg / (nu_dg * V + 1e-30))
        qe = torch.clamp(qq - DIR_C0, min=0.0)
        s = qe / (qe + DIR_C1)
        g = g + (1.0 - g) * s
        struct = struct + s * d
        out = out + g * d
        c = cj
    return out + c, struct


def wiener_refine(z_dn, z_noisy, noise_var):
    """z_dn + alpha * shrunk residual + (1 - alpha) * its structure part,
    with the saturation roll-off read from z_dn itself."""
    r = z_noisy - z_dn
    local_pow = box2d(r * r, K_BOX)
    V = bucket_floor(z_noisy, z_dn, noise_var)
    allowance = V * (1.0 + DEADBAND * float(np.sqrt(2.0) / K_BOX))
    sigma_d2 = torch.clamp(local_pow - allowance, min=0.0)
    sat = torch.clamp((z_dn - SAT_LO) / (SAT_HI - SAT_LO), 0.0, 1.0)
    alpha = sigma_d2 / (sigma_d2 + V) * (1.0 - sat)
    rs, rs_struct = shrink(r, V)
    return z_dn + alpha * rs + (1.0 - alpha) * (1.0 - sat) * rs_struct
