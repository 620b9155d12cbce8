"""Spatial sharding: one frame's rows split over the ranks of a mesh
(port of yondx/parallel/spatial.py).

Each rank holds a contiguous block of a frame's packed rows, [h, W, 4]
(rank r: rows r*h .. (r+1)*h). Windowed operations see their neighbours'
rows through a halo exchange (`dist.batch_isend_irecv` with the
immediate neighbours; reflect-101 rows at the frame's top and bottom).
Frame-wide statistics (the NLE thresholds, the line fits, the MAD
histograms) are all-reduced partial sums, maxima and minima: the same
algorithm as JAX's psum'd shard_map bodies, so the result does not depend
on the number of ranks beyond float rounding.

The NLE box moments run through K1 (`nle/moments.py`) on each rank's
halo-extended rows [1, h + 2k, W, 4]; the texture's support, k//2 +
inner//2 rows (23 at k = 29), stays inside the halo of k rows, so the
kept rows are those of the whole frame. CPU tensors take K1's plain
version, as everywhere in the port.

Every function here is called on every rank of the mesh with that
rank's rows (tensors on the rank's device) and returns that rank's rows
of a map or the frame-wide scalars (0-d tensors, equal on every rank).
`on_rows` runs one on a whole frame that every rank holds: it cuts the
rank's rows and gathers the row-sharded results, as jax.shard_map with
P(axis) in and out does.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..nle.moments import nle_moments
from ..nle.robust import (COLLAB_BAND, _BAND, _MAX_CELLS,
                          _band_subsample_rows, _haar_hh, _mad_fit_from_hist,
                          _mad_histograms, combine_estimates,
                          shape_consistent_collab)
from ..nle.threshold import _subsample
from ..vst.lut import lookup_bias_curve
from ..vst.vst import inverse_vst, vst
from .mesh import Mesh

NBINS_TH = 4096
_LOG_RANGE = float(np.log(1e7))  # the histogram spans [t_max*1e-7, t_max]


# ------------------------------------------------------------ collectives
def _all_reduce(mesh: Mesh, v, op=dist.ReduceOp.SUM):
    """v reduced over the mesh (a new tensor)."""
    v = v.clone()
    dist.all_reduce(v, op=op, group=mesh.group)
    return v


def _psum(mesh: Mesh, v):
    return _all_reduce(mesh, v, dist.ReduceOp.SUM)


def _pmax(mesh: Mesh, v):
    return _all_reduce(mesh, v, dist.ReduceOp.MAX)


def _pmin(mesh: Mesh, v):
    return _all_reduce(mesh, v, dist.ReduceOp.MIN)


def global_mean(mesh: Mesh, x):
    """The mean of a row-sharded array over the whole frame (0-d)."""
    return _psum(mesh, torch.sum(x.float())) / (x.numel() * mesh.size)


def _all_gather_rows(mesh: Mesh, x, counts):
    """The ranks' row blocks of x ([counts[rank], ...] each) concatenated
    in rank order on every rank."""
    most = max(counts)
    pad = x.new_zeros((most,) + tuple(x.shape[1:]))
    pad[:x.shape[0]] = x
    parts = [torch.empty_like(pad) for _ in range(mesh.size)]
    dist.all_gather(parts, pad.contiguous(), group=mesh.group)
    return torch.cat([p[:c] for p, c in zip(parts, counts)], 0)


def shard_rows(mesh: Mesh, frame):
    """This rank's rows of a whole frame [H, ...] (H a multiple of the
    mesh size), as a tensor on the rank's device."""
    x = torch.as_tensor(frame)
    if x.shape[0] % mesh.size:
        raise ValueError(f"{x.shape[0]} rows do not split over "
                         f"{mesh.size} ranks")
    h = x.shape[0] // mesh.size
    return x[mesh.rank * h:(mesh.rank + 1) * h].to(mesh.device)


def gather_rows(mesh: Mesh, x):
    """The whole frame from every rank's rows [h, ...], on every rank."""
    return _all_gather_rows(mesh, x.contiguous(), [x.shape[0]] * mesh.size)


def on_rows(mesh: Mesh, fn, frames, *args, lead=(), **kwargs):
    """fn(mesh, *lead, *rows_of_each_frame, *args, **kwargs) with every
    output tensor of one or more dims (a block of rows, equal in size on
    every rank) gathered in rank order; 0-d outputs (frame-wide scalars,
    equal on every rank) pass as they are."""
    local = [shard_rows(mesh, f) for f in frames]

    def gather(o):
        if isinstance(o, (tuple, list)):
            return type(o)(gather(v) for v in o)
        if isinstance(o, torch.Tensor) and o.ndim:
            return gather_rows(mesh, o)
        return o

    return gather(fn(mesh, *lead, *local, *args, **kwargs))


def frame_band_rows(mesh: Mesh, x, max_px: int = 4 * _MAX_CELLS):
    """The rows nle.robust._band_subsample_rows keeps of the WHOLE frame
    (from every rank's rows [h, W, C]), gathered on every rank in frame
    order. The robust helpers take such a stack unchanged (it is within
    their row budget), so `mad_self_estimate(frame_band_rows(...))` is the
    whole frame's estimate."""
    h, w, C = x.shape
    H = h * mesh.size
    max_rows = max(_BAND, max_px // max(w * C, 1))
    if H <= max_rows or H < 2 * _BAND:
        rows = np.arange(H)
    else:
        nb = H // _BAND
        keep = max(1, min(nb, max_rows // _BAND))
        bands = np.arange(nb)[::nb // keep][:keep]
        rows = (bands[:, None] * _BAND + np.arange(_BAND)).reshape(-1)
    counts = [int(((rows >= r * h) & (rows < (r + 1) * h)).sum())
              for r in range(mesh.size)]
    lo = mesh.rank * h
    mine = rows[(rows >= lo) & (rows < lo + h)] - lo
    part = x[torch.as_tensor(mine, device=x.device, dtype=torch.long)]
    return _all_gather_rows(mesh, part.contiguous(), counts)


# ------------------------------------------------------------ halo rows
def _halo_exchange_rows(mesh: Mesh, x, halo: int):
    """x: this rank's rows [h, W, C] (h > halo). Returns [h + 2 halo, W, C]
    with the neighbours' rows around it; the frame's top and bottom get
    reflect-101 rows. One rank exchanges nothing."""
    n, r = mesh.size, mesh.rank
    top, bot = x[:halo].contiguous(), x[-halo:].contiguous()
    from_above = torch.empty_like(bot)
    from_below = torch.empty_like(top)
    ops = []
    if r > 0:
        ops += [dist.P2POp(dist.isend, top, mesh.peer(r - 1), mesh.group),
                dist.P2POp(dist.irecv, from_above, mesh.peer(r - 1),
                           mesh.group)]
    if r < n - 1:
        ops += [dist.P2POp(dist.isend, bot, mesh.peer(r + 1), mesh.group),
                dist.P2POp(dist.irecv, from_below, mesh.peer(r + 1),
                           mesh.group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    top_pad = x[1:halo + 1].flip(0) if r == 0 else from_above
    bot_pad = x[-halo - 1:-1].flip(0) if r == n - 1 else from_below
    return torch.cat([top_pad, x, bot_pad], 0)


def sharded_box_stats(mesh: Mesh, rggb, k: int = 29):
    """(mean, var, texture) maps of this rank's rows [h, W, 4], equal to
    the whole frame's: K1 on the rows extended by a halo of k."""
    inner = k // 3 * 2 + 1
    xe = _halo_exchange_rows(mesh, rggb.float(), k)
    mean, var, tex = nle_moments(xe[None], k, inner)
    sl = slice(k, xe.shape[0] - k)
    return mean[0, sl], var[0, sl], tex[0, sl]


# ----------------------------------------------------- frame-wide fits
def log_bins(mesh: Mesh, t):
    """(bin index, t_max): the log-spaced histogram bin of each value of
    a positive field, over the frame-wide maximum."""
    t_max = _pmax(mesh, torch.max(t)) + 1e-30
    r = torch.clamp(t / t_max, 1e-7, 1.0)
    pos = (torch.log(r) + _LOG_RANGE) / _LOG_RANGE * NBINS_TH
    return torch.clamp(pos.to(torch.int64), 0, NBINS_TH - 1), t_max


def _psum_log_quantiles(mesh: Mesh, t, ranks_frac):
    """Frame-wide quantiles of a positive field from an all-reduced
    4096-bin log-spaced histogram with the rank interpolated inside its
    bin (~1e-4 relative to the exact percentile). The counts and their
    cumsum are float32, as in JAX: a bin stops counting at 2^24.

    t: this rank's values (flat); ranks_frac: [n] fractions in (0, 1].
    Returns [n] quantiles, equal on every rank."""
    bins, t_max = log_bins(mesh, t)
    counts = torch.zeros(NBINS_TH, device=t.device, dtype=torch.float32)
    counts.index_add_(0, bins, torch.ones_like(t, dtype=torch.float32))
    cdf = torch.cumsum(_psum(mesh, counts), 0)
    ranks = ranks_frac * cdf[-1]
    # the first bin that reaches each rank (bin 0 where none does, as
    # jnp.argmax of an all-false row)
    idx = torch.argmax((cdf[None, :] >= ranks[:, None]).to(torch.uint8), 1)
    below = torch.where(idx > 0, cdf[torch.clamp(idx - 1, min=0)],
                        torch.zeros_like(ranks))
    frac = torch.clamp((ranks - below)
                       / torch.clamp(cdf[idx] - below, min=1e-30), 0.0, 1.0)
    log_lo = (idx.float() / NBINS_TH - 1.0) * _LOG_RANGE
    step = _LOG_RANGE / NBINS_TH
    return t_max * torch.exp(log_lo + frac * step)


def nonsat_weights_global(mesh: Mesh, x, w):
    """Drop saturated and black pixels from the weights unless that
    leaves under 1% of the frame's weight."""
    nonsat = (x > 1e-4) & (x < 0.8)
    w2 = w * nonsat
    keep = _psum(mesh, torch.sum(w2)) > 0.01 * _psum(mesh, torch.sum(w))
    return torch.where(keep, w2, w)


def _global_linefit(mesh: Mesh, x, y, w):
    """Weighted least squares y = b1 x + b2 over the whole frame."""
    n = _psum(mesh, torch.sum(w))
    safe_n = torch.clamp(n, min=1.0)
    xbar = _psum(mesh, torch.sum(w * x)) / safe_n
    ybar = _psum(mesh, torch.sum(w * y)) / safe_n
    dx = x - xbar
    dy = y - ybar
    sxx = _psum(mesh, torch.sum(w * dx * dx))
    sxy = _psum(mesh, torch.sum(w * dx * dy))
    zero = torch.zeros_like(sxx)
    b1 = torch.where(sxx > 0, sxy / torch.clamp(sxx, min=1e-30), zero)
    b2 = ybar - b1 * xbar
    ok = n > 0
    return torch.where(ok, b1, zero), torch.where(ok, b2, zero)


def _flat_fit(mesh: Mesh, m, v, t, step: int):
    """Flat-region line fit of var against mean: thresholds from the
    frame-wide texture quantiles, the occupied-brightness-bin score over
    all-reduced bucket minima, the p25 fallback for an empty mask, the
    saturation filter and the all-reduced fit."""
    n_q = 100 // step
    quants = torch.as_tensor(
        np.linspace(step, 100, n_q, endpoint=True).astype(np.float32),
        device=t.device)
    ranks_frac = torch.cat([quants / 100.0,
                            torch.full((1,), 0.25, device=t.device)])
    qs = _psum_log_quantiles(mesh, t, ranks_frac)
    ths, th25 = qs[:-1], qs[-1]
    buckets = (torch.clamp(m, 0.0, 1.0) * 1000).to(torch.int64)
    min_tex = torch.full((1001,), float("inf"), device=t.device)
    min_tex = _pmin(mesh, min_tex.scatter_reduce(0, buckets, t, "amin"))
    npeaks = torch.sum(min_tex[None, :] <= ths[:, None], 1)
    npeaks = torch.clamp(npeaks.float(), min=1.0)
    score = ths / (quants * npeaks)
    th = ths[torch.argmin(score[1:]) + 1]
    mask = (t < th).float()
    empty = _psum(mesh, torch.sum(mask)) == 0
    mask = torch.where(empty, (t < th25).float(), mask)
    w = nonsat_weights_global(mesh, m, mask)
    return _global_linefit(mesh, m, v, w)


def sharded_self_nlf(mesh: Mesh, rggb, k: int = 29, step: int = 5):
    """Self NLE of a row-sharded frame -> (beta1, beta2) 0-d tensors, equal
    on every rank: nle.nlf.self_nlf's algorithm with the percentile
    thresholds from an all-reduced log histogram of the texture map. One
    K1 launch (mean, var, texture) on the halo-extended rows."""
    mean, var, tex = sharded_box_stats(mesh, rggb, k)
    return _flat_fit(mesh, mean.reshape(-1), var.reshape(-1),
                     tex.reshape(-1), step)


def sharded_collab_nlf(mesh: Mesh, lr_rggb, dn_rggb, k: int = 29,
                       step: int = 5):
    """Collaborative NLE of a row-sharded (noisy, denoised proxy) pair ->
    (beta1, beta2): var = var_k(noisy) - var_k(proxy), intensity and
    texture from the proxy. Two K1 launches on the halo-extended rows
    (the noisy rows' variance; the proxy's mean and variance)."""
    inner = k // 3 * 2 + 1
    lre = _halo_exchange_rows(mesh, lr_rggb.float(), k)
    dne = _halo_exchange_rows(mesh, dn_rggb.float(), k)
    _, lr_var, _ = nle_moments(lre[None], k, inner, texture=False,
                               mean=False)
    mean, dn_var, _ = nle_moments(dne[None], k, inner, texture=False)
    sl = slice(k, lre.shape[0] - k)
    m = mean[0, sl].reshape(-1)
    v = (lr_var - dn_var)[0, sl].reshape(-1)
    t = torch.sqrt(dn_var[0, sl]).reshape(-1)
    return _flat_fit(mesh, m, v, t, step)


def _sharded_mad(mesh: Mesh, d, m):
    """The MAD fit from this rank's Haar cells: each rank subsamples its
    own cells to 1/n of the budget; one all-reduce of the (bucket x
    log|d|) counts and bucket sums, binned under the frame-wide max."""
    d = torch.abs(d.reshape(-1))
    m = m.reshape(-1)
    cap = max(1, _MAX_CELLS // mesh.size)
    if d.shape[0] > cap:
        s = d.shape[0] // cap + 1
        d = _subsample(d, s)
        m = _subsample(m, s)
    dmax = _pmax(mesh, torch.max(d)) + 1e-30
    counts, sum_m = _mad_histograms(d, m, dmax)
    return _mad_fit_from_hist(_psum(mesh, counts), _psum(mesh, sum_m), dmax)


def _even_rows(x):
    if x.shape[0] % 2:
        raise ValueError("row shards must hold an even number of rows for "
                         "the 2x2 Haar cells")


def sharded_mad_self_estimate(mesh: Mesh, rggb):
    """Wavelet-MAD (beta1, beta2) of a row-sharded noisy frame (rows
    even): each rank's bands of rows at 1/n of the budget."""
    _even_rows(rggb)
    xs = _band_subsample_rows(rggb.float(), 4 * _MAX_CELLS // mesh.size)
    return _sharded_mad(mesh, *_haar_hh(xs))


def sharded_mad_collab_estimate(mesh: Mesh, lr_rggb, dn_rggb):
    """Wavelet-MAD (beta1, beta2) of the residual noisy - proxy, with the
    proxy's intensities, on a row-sharded pair (rows even)."""
    _even_rows(lr_rggb)
    budget = 4 * _MAX_CELLS // mesh.size
    lrs = _band_subsample_rows(lr_rggb.float(), budget)
    dns = _band_subsample_rows(dn_rggb.float(), budget)
    d, _ = _haar_hh(lrs - dns)
    _, m = _haar_hh(dns)
    return _sharded_mad(mesh, d, m)


def sharded_self_nlf_robust(mesh: Mesh, rggb, k: int = 29, step: int = 5,
                            ratio: float = 1.5):
    """nle.robust.self_nlf_robust on a row-sharded frame: the flat-mask
    fit cross-checked against the MAD estimate at the frame's mean."""
    fit = sharded_self_nlf(mesh, rggb, k=k, step=step)
    mad = sharded_mad_self_estimate(mesh, rggb)
    ref_mean = global_mean(mesh, torch.clamp(rggb.float(), 0.0, 1.0))
    return combine_estimates(fit, mad, ref_mean, ratio)


def sharded_collab_nlf_robust(mesh: Mesh, lr_rggb, dn_rggb, k: int = 29,
                              step: int = 5, band: Optional[float] = None,
                              self_reg=None):
    """nle.robust.collab_nlf_robust on a row-sharded pair: the collab fit
    inside the symmetric MAD trust band, and the shape-consistency repair
    when the round-0 `self_reg` is given."""
    fit = sharded_collab_nlf(mesh, lr_rggb, dn_rggb, k=k, step=step)
    mad = sharded_mad_collab_estimate(mesh, lr_rggb, dn_rggb)
    ref_mean = global_mean(mesh, torch.clamp(dn_rggb.float(), 0.0, 1.0))
    comb = combine_estimates(fit, mad, ref_mean,
                             band=band if band is not None else COLLAB_BAND)
    if self_reg is not None:
        reg = tuple(torch.as_tensor(r, dtype=torch.float32,
                                    device=ref_mean.device)
                    for r in self_reg)
        comb = shape_consistent_collab(comb, fit, mad, ref_mean, reg)
    return comb


# ------------------------------------------------------------- denoise
@torch.no_grad()
def spatial_denoise_sharded_pair(mesh: Mesh, model, rggb, curve, K, sigma,
                                 scale, halo: int = 64,
                                 bias_corr: Optional[str] = "pre",
                                 exact_inverse: bool = False,
                                 sigma_corr=1.03, guided: bool = True,
                                 refine: bool = False, refine_k: int = 15,
                                 refine_beta: float = 1.0,
                                 refine_floor: str = "local",
                                 refine_shrink: bool = True,
                                 refine_shrink_lam: float = 1.0,
                                 refine_shrink_full_alpha: float = 1.0,
                                 refine_shrink_mode: str = "oriented",
                                 compute_dtype=None):
    """Row-sharded VST denoise of this rank's rows [h, W, 4] -> (output,
    raw net output) rows, VSTDenoiser.denoise_pair's analog.

    scale -> VST -> bias subtraction by the curve's gather ('pre') ->
    normalise by [VST(0), VST(scale)] -> halo exchange -> the net on the
    clipped, extended rows [1, h + 2 halo, W, 4] (guided by nsr *
    sigma_corr) -> with refine, the Wiener refine over the extended rows
    (its windows see the neighbours' rows) -> crop -> inverse VST. The
    net is an nn.Module on the rank's device, called model(x, t) (model(x)
    unguided; in compute_dtype when given). (h + 2 halo) and W must be
    multiples of the net's scale tree (32 for the SNR-Nets)."""
    dev = rggb.device

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev)

    curve, K, sigma, scale = f32(np.asarray(curve, np.float32)), f32(K), \
        f32(sigma), f32(scale)
    xd = rggb.float() * scale
    z = vst(xd, sigma, gain=K)
    if bias_corr == "pre":
        z = z - lookup_bias_curve(torch.clamp(xd, min=0.0), curve, K)
    lower = vst(f32(0.0), sigma, gain=K)
    upper = vst(scale, sigma, gain=K)
    nsr = 1.0 / (upper - lower)
    z = (z - lower) * nsr
    ze = _halo_exchange_rows(mesh, z, halo)
    zin = torch.clamp(ze, 0.0, 1.0)[None]
    if compute_dtype is not None:
        zin = zin.to(compute_dtype)
    if guided:
        out = model(zin, (nsr * f32(sigma_corr)).reshape(1))
    else:
        out = model(zin)
    out = torch.clamp(out[0].float(), 0.0, 1.0)
    z_raw = out[halo:-halo]
    if refine:
        from ..pipeline.refine import wiener_refine
        # the residual is against the UNCLIPPED normalised input, as in
        # VSTDenoiser; the shrink's support (14 px at level 3, plus the
        # k = 3 stabiliser) sits inside the default halo of 64
        zr = wiener_refine(out, ze, noise_var=nsr ** 2, k=refine_k,
                           beta=refine_beta, x01=out,
                           noise_floor=refine_floor,
                           residual_shrink=refine_shrink,
                           shrink_lam=refine_shrink_lam,
                           shrink_full_alpha=refine_shrink_full_alpha,
                           shrink_mode=refine_shrink_mode)
        z_fin = zr[halo:-halo]
    else:
        z_fin = z_raw

    def finish(zz):
        zz = zz * (upper - lower) + lower
        xx = inverse_vst(zz, sigma, gain=K, exact=exact_inverse)
        return torch.clamp(xx / scale, 0.0, 1.0)

    return finish(z_fin), finish(z_raw)


def spatial_denoise_sharded(mesh: Mesh, model, rggb, curve, K, sigma, scale,
                            halo: int = 64,
                            bias_corr: Optional[str] = "pre",
                            exact_inverse: bool = False,
                            sigma_corr=1.03, guided: bool = True):
    """The output rows of spatial_denoise_sharded_pair without the
    refine."""
    return spatial_denoise_sharded_pair(
        mesh, model, rggb, curve, K, sigma, scale, halo=halo,
        bias_corr=bias_corr, exact_inverse=exact_inverse,
        sigma_corr=sigma_corr, guided=guided, refine=False)[0]
