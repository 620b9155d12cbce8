"""Adaptive flat-region thresholds (port of yondx/nle/threshold.py):
score2 (the PG est-net data) and score3 with the sort implementation.

score2: each percentile threshold th at quants 1..100 is scored th /
quant; the argmin over the candidates from 5 past the first positive
score wins.

Candidates are the texture percentiles at quants = step, 2 step, ..., 100;
each is scored th / (quant * npeaks) with npeaks the number of occupied
1000-bin brightness buckets among pixels with texture <= th; the argmin
over candidates [1:] wins. Bucket occupancy at th is min_texture[b] <= th.
"""
from __future__ import annotations

import numpy as np
import torch

NBINS = 1000


def _subsample(x, s: int):
    """Every s-th 128-element run of the flattened array."""
    x = x.reshape(-1)
    if s <= 1:
        return x
    blk = 128 * s
    n = x.shape[0] // blk * blk
    return x[:n].reshape(-1, s, 128)[:, 0, :].reshape(-1)


def _interp_sorted(srt, quants):
    """Linear-method percentiles at quants of each sorted row of srt
    [..., n] -> [..., len(quants)]."""
    n = srt.shape[-1]
    q = (quants / 100.0) * (n - 1)
    low = torch.floor(q)
    high = torch.ceil(q)
    high_w = q - low
    low_w = 1.0 - high_w
    lo_v = srt[..., low.long().clamp(0, n - 1)]
    hi_v = srt[..., high.long().clamp(0, n - 1)]
    return lo_v * low_w + hi_v * high_w


def percentile_linear(data, quants):
    """jnp.percentile(data, quants, method='linear') of a 1-D float32
    tensor, by one sort."""
    return _interp_sorted(torch.sort(data.reshape(-1)).values, quants)


def linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """jnp.linspace(start, stop, num) in float32 as XLA's CPU backend
    folds it: start (1 - i c) + i (stop c) with c = 1 / (num - 1) and the
    second product fused into an fma; the last entry is stop."""
    f = np.float32
    a, b = f(start), f(stop)
    if num < 2:
        return np.full((num,), a, f)
    i = np.arange(num - 1, dtype=f)
    c = f(1) / f(num - 1)
    head = (i.astype(np.float64) * np.float64(f(b * c))
            + (a * (f(1) - i * c)).astype(np.float64)).astype(f)
    return np.append(head, b).astype(f)


def score2_rows(data, step: int = 1):
    """(th [B], quant [B]) of the score2 mode of each row of data [B, N],
    from one sort of the rows."""
    n_q = 100 // step
    quants = torch.from_numpy(linspace_f32(step, 100, n_q)).to(data.device)
    ths = _interp_sorted(torch.sort(data, dim=1).values, quants)
    score = ths / quants
    start = torch.argmax((score > 0).to(torch.int32), dim=1) + 5
    idx = torch.arange(n_q, device=data.device)
    i = torch.argmin(torch.where(idx[None] >= start[:, None], score,
                                 torch.full_like(score, float("inf"))),
                     dim=1)
    return torch.gather(ths, 1, i[:, None])[:, 0], quants[i]


def adaptive_threshold_score2(texture, step: int = 1):
    """(th, quant) of the score2 mode over the flattened texture map."""
    th, quant = score2_rows(texture.reshape(1, -1), step)
    return th[0], quant[0]


def _npeaks(texture, mean, ths, subsample: int = 1):
    data = _subsample(texture, subsample)
    m = _subsample(mean, subsample)
    buckets = (torch.clamp(m, 0.0, 1.0) * NBINS).to(torch.int64)
    min_tex = torch.full((NBINS + 1,), float("inf"), device=data.device,
                         dtype=data.dtype)
    min_tex = min_tex.scatter_reduce(0, buckets, data, "amin")
    npeaks = torch.sum(min_tex[None, :] <= ths[:, None], dim=1).to(data.dtype)
    return torch.clamp(npeaks, min=1.0)


def _score3_full(texture, mean, step: int, subsample: int):
    data = _subsample(texture, subsample)
    n_q = 100 // step
    quants = torch.linspace(step, 100, n_q, device=data.device,
                            dtype=torch.float32)
    ths = percentile_linear(data, quants)
    npeaks = _npeaks(texture, mean, ths, subsample)
    score = ths / (quants * npeaks)
    i = torch.argmin(score[1:]) + 1
    return ths[i], quants[i], ths, quants


def score3_threshold_with_p25(texture, mean, step: int = 5,
                              subsample: int = 1):
    """(th, th25): the adaptive threshold and the 25th percentile from one
    sort (yondx's impl='sort')."""
    th, _, ths, _ = _score3_full(texture, mean, step, subsample)
    if 25 % step == 0:
        th25 = ths[25 // step - 1]
    else:
        q25 = torch.tensor([25.0], device=texture.device)
        th25 = percentile_linear(_subsample(texture, subsample), q25)[0]
    return th, th25
