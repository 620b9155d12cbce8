"""Adaptive flat-region threshold, score3 mode, sort implementation
(port of yondx/nle/threshold.py:47-165).

Candidates are the texture percentiles at quants = step, 2 step, ..., 100;
each is scored th / (quant * npeaks) with npeaks the number of occupied
1000-bin brightness buckets among pixels with texture <= th; the argmin
over candidates [1:] wins. Bucket occupancy at th is min_texture[b] <= th.
"""
from __future__ import annotations

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


def percentile_linear(data, quants):
    """jnp.percentile(data, quants, method='linear') of a 1-D float32
    tensor, by one sort."""
    srt = torch.sort(data.reshape(-1)).values
    n = srt.shape[0]
    q = (quants / 100.0) * (n - 1)
    low = torch.floor(q)
    high = torch.ceil(q)
    high_w = q - low
    low_w = 1.0 - high_w
    lo_v = srt[low.long().clamp(0, n - 1)]
    hi_v = srt[high.long().clamp(0, n - 1)]
    return lo_v * low_w + hi_v * high_w


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
