"""VST bias on the host: the closed form and the exact separable
evaluator (numpy + scipy; a copy of yondx/vst/bias.py:30-133 without the
numeric-integration cross-check). `BiasLUT.curve` calls `bias_points`
for noise ratios past the committed table.

    bias(lam, sg) = sum_k Pois(k; lam) * M(k, sg) - VST(lam),
    M(k, sg) = E_g[VST(k + g)], g ~ N(0, sg^2),

in electron units (gain 1).
"""
from __future__ import annotations

import numpy as np
from scipy.stats import norm, poisson


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


def _m_table(k_max: int, sgs: np.ndarray, n_gauss: int = 4001,
             tail: float = 10.0) -> np.ndarray:
    """M[k, j] = E_g[VST_1(k + g; sg_j)] by a dense trapezoid over
    +-tail*sg; sg == 0 degenerates to VST_1(k)."""
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
