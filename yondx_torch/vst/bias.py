"""VST bias on the host (numpy + scipy; a copy of yondx/vst/bias.py):
the closed form, the reference's grid convolution and Riemann sum
(`bias_points_numeric`, a cross-check) and the exact separable evaluator
that builds the bias tables and that `bias_curve_for` calls for noise
ratios past the 2-D table:

    bias(lam, sg) = sum_k Pois(k; lam) * M(k, sg) - VST(lam),
    M(k, sg) = E_g[VST(k + g)], g ~ N(0, sg^2),

in electron units (gain 1).
"""
from __future__ import annotations

import numpy as np

# scipy is imported where it is called: importing scipy.signal takes
# seconds, and every process of a mesh imports this module


def _vst_np(x, sigma, gain=1.0):
    fz = gain * np.asarray(x, np.float64) + (3 / 8) * gain ** 2 + sigma ** 2
    return (2.0 / gain) * np.sqrt(np.maximum(fz, 0.0))


def close_form_bias(lam, sigGs=25.853043, K=24.48128):
    """High-flux Taylor-series bias (Foi TIP-13)."""
    y = np.asarray(lam, np.float64) / K
    sigma = sigGs / K
    y_hat = y + 3 / 8 + sigma ** 2
    m1 = (y + sigma ** 2) / y_hat ** 2
    m2 = y / y_hat ** 3
    m3 = (y + 3 * (y + sigma ** 2) ** 2) / y_hat ** 4
    return 2 * np.sqrt(y_hat) * (-m1 / 8 + m2 / 16 - 5 * m3 / 128)


def pg_pdf_grid(lam, K, sigGs, r=5, pho=1, clip=False):
    """Poisson(+)Gaussian density on the uniform grid linspace(-r, r, 2 pho
    r + 1): the Poisson pmf at the grid points (0 off the integers)
    convolved with the Gaussian pdf, renormalised to sum / pho == 1;
    clip folds the mass below 0 onto 0. Returns (x, pdf)."""
    from scipy.signal import convolve
    from scipy.stats import norm, poisson
    n = 2 * pho * r + 1
    x = np.linspace(-r, r, n)
    ps = poisson.pmf(x, lam / K)
    if sigGs > 0:
        gs = norm.pdf(x, loc=0, scale=sigGs / K)
        pdf = convolve(ps, gs, mode="same")
    else:
        pdf = poisson.pmf(x, lam / K)
    pdf[pdf < 0] = 0
    if clip:
        pdf[r * pho] += pdf[: r * pho].sum()
        pdf[: r * pho] = 0
    pdf = pdf / (pdf.sum() / pho)
    return x, pdf


def bias_points_numeric(lams, K, sigGs, pho_min=100, close_form=False,
                        clip=False):
    """The reference's bias pipeline: per lam a grid density
    (`pg_pdf_grid`) and a Riemann sum of the VST over it, minus the VST of
    lam; with close_form, the closed form above 50 K (K < 1) or 50 sqrt(K).
    Slow: for cross-checks."""
    lams = np.asarray(lams, np.float64)
    bias = np.zeros_like(lams)
    pho = max(int(K ** 0.5), pho_min)
    if close_form:
        th = 50 * K if K < 1 else 50 * K ** 0.5
        hi = lams > th
        bias[hi] = close_form_bias(lams[hi], sigGs, K)
    else:
        th = lams.max() + 1
    for i, lam in enumerate(lams):
        if lam > th:
            continue
        r = int(lam * (1 / K) * 2 + sigGs * 2 + lam + 10)
        x, p = pg_pdf_grid(lam, K, sigGs, r=r, pho=pho, clip=clip)
        bias[i] = np.sum(p * _vst_np(K * x, sigGs, gain=K) / pho) \
            - _vst_np(lam, sigGs, gain=K)
    return bias


def _m_table(k_max: int, sgs: np.ndarray, n_gauss: int = 4001,
             tail: float = 10.0) -> np.ndarray:
    """M[k, j] = E_g[VST_1(k + g; sg_j)] by a dense trapezoid over
    +-tail*sg; sg == 0 degenerates to VST_1(k)."""
    from scipy.stats import norm
    ks = np.arange(k_max + 1, dtype=np.float64)
    M = np.empty((k_max + 1, len(sgs)), np.float64)
    for j, sg in enumerate(np.asarray(sgs, np.float64)):
        if sg <= 0:
            M[:, j] = _vst_np(ks, 0.0, 1.0)
            continue
        g = np.linspace(-tail * sg, tail * sg, n_gauss)
        w = norm.pdf(g, scale=sg)
        w /= w.sum()
        vals = 2.0 * np.sqrt(np.maximum(ks[:, None] + g[None, :]
                                        + 3 / 8 + sg ** 2, 0.0))
        M[:, j] = vals @ w
    return M


def bias_points(lams: np.ndarray, sgs: np.ndarray,
                k_sigma: float = 12.0, k_pad: int = 32) -> np.ndarray:
    """Exact separable bias over a (lam x sg) grid, electron units:
    bias[i, j]. k_max covers lam + k_sigma*sqrt(lam) + k_pad."""
    from scipy.stats import poisson
    lams = np.asarray(lams, np.float64)
    sgs = np.asarray(sgs, np.float64)
    k_max = int(np.max(lams) + k_sigma * np.sqrt(np.max(lams) + 1) + k_pad)
    M = _m_table(k_max, sgs)
    ks = np.arange(k_max + 1, dtype=np.float64)
    P = poisson.pmf(ks[None, :], np.maximum(lams, 1e-300)[:, None])
    zero = lams <= 0
    if zero.any():
        P[zero] = 0.0
        P[zero, 0] = 1.0
    return P @ M - _vst_np(lams[:, None], sgs[None, :], 1.0)
