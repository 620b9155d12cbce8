"""The whole iterated blind-denoise pipeline on ONE large frame, its rows
sharded over a mesh (port of yondx/parallel/product.py).

    bayer -> rggb, reflect-pad -> this rank's rows
      -> sharded robust self NLE        (all-reduced histograms, K1 once)
      -> sharded VST denoise             (halo exchange, net on the rows)
      -> sharded robust collab NLE       (K1 twice)
      -> guards, rescue gate, second pass, iteration policy
      -> all-gather, unpad, bayer

Every rank gets the same frame and returns the same result (the rounds'
outputs are all-gathered), as JAX's call returns the whole arrays. Three
statistics read the whole frame, which GSPMD gathers silently in JAX and
which are exact here too: the adaptive guidance rule's clipped fraction,
mean and MAD estimate, the rescue gate's flat floor (the MAD and the
floor read the whole frame's bands of rows, gathered on every rank:
`spatial.frame_band_rows`), and the mean of the round-0 output. Logs come
from rank 0 only. The single-card analog is
`YONDEngine.iter_denoise_tiled`.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..core.logging import log
from ..isp.bayer import bayer2rggb, rggb2bayer
from ..nle.robust import flat_floor_stats, mad_self_estimate
from ..pipeline.denoiser import adaptive_corr_from_stats
from ..pipeline.policy import (DEFAULT_FLOOR_FRAC, DEFAULT_POLICY,
                               DEFAULT_TOL, combine_rounds, reg_agreement)
from ..vst.lut import FULL_X_GRID
from .mesh import Mesh, check_mesh
from .spatial import (frame_band_rows, gather_rows, global_mean,
                      sharded_collab_nlf_robust, sharded_self_nlf_robust,
                      spatial_denoise_sharded_pair)


def _pad_rows_cols(rggb: np.ndarray, row_mult: int, col_mult: int):
    """Reflect-pad [H, W, 4] so H % row_mult == 0 and W % col_mult == 0."""
    H, W, _ = rggb.shape
    ph = (-H) % row_mult
    pw = (-W) % col_mult
    if ph or pw:
        rggb = np.pad(rggb, ((0, ph), (0, pw), (0, 0)), mode="reflect")
    return rggb, (H, W)


def _adaptive_corr(mesh: Mesh, x, K, sigma, scale):
    """pipeline/denoiser.adaptive_sigma_corr of the whole frame from this
    rank's rows."""
    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device=x.device)

    clip_frac = global_mean(mesh, ((x < 0.02) | (x > 0.98)).float())
    mu = global_mean(mesh, torch.clamp(x, 0.0, 1.0))
    mad = mad_self_estimate(frame_band_rows(mesh, x))
    return adaptive_corr_from_stats(f32(K), f32(sigma), f32(scale),
                                    clip_frac, mu, mad)


@torch.no_grad()
def iter_denoise_frame_sharded(mesh: Mesh, engine, bayer,
                               p: Dict[str, Any],
                               halo: int = 64) -> Dict[str, Any]:
    """Run the whole iterative pipeline for ONE bayer frame on the mesh;
    call it on every rank with the same frame.

    engine: a YONDEngine on the rank's device (its VSTDenoiser's net and
    settings, bias LUT, pipeline guards and iteration policy); p: {'wp',
    'bl', 'ratio', 'scale', ...} as in iter_denoise. Returns {'raw_dns':
    [numpy [H, W] per round], 'regs': [(beta1, beta2), ...]} on every
    rank. The refine runs with its shrink at the defaults of
    spatial_denoise_sharded_pair, as in JAX."""
    check_mesh(mesh)
    pipe = engine.pipe
    den = engine.denoiser
    n = mesh.size
    logfile = engine.logfile

    def say(msg):
        if mesh.is_main:
            log(msg, logfile=logfile)

    rggb = bayer2rggb(torch.as_tensor(np.asarray(bayer, np.float32))).numpy()
    # row shards must satisfy (h_shard + 2 halo) % pad_base == 0 for the
    # net's scale tree and be even for the NLE's 2x2 Haar cells; columns
    # hit pad_base too (no column sharding)
    base = max(den.pad_base, 2)
    if (2 * halo) % base:
        raise ValueError(f"2 * halo ({2 * halo}) is not a multiple of the "
                         f"net's pad base {base}")
    rggb, (H0, W0) = _pad_rows_cols(rggb, row_mult=n * base, col_mult=base)
    h_shard = rggb.shape[0] // n
    # halo rows come from the IMMEDIATE neighbour only, so the halo stays
    # under the shard height: the largest base/2 multiple that fits
    if halo >= h_shard:
        step = max(base // 2, 2)
        halo_eff = max(((h_shard - 1) // step) * step, step)
        say(f"[product] halo {halo} >= shard rows {h_shard}; clamped to "
            f"{halo_eff}")
        halo = halo_eff
    if halo >= h_shard:
        raise ValueError(f"{h_shard} rows a rank leave no room for a halo "
                         f"of {halo}: use fewer ranks")
    x = torch.from_numpy(np.ascontiguousarray(
        rggb[mesh.rank * h_shard:(mesh.rank + 1) * h_shard])).to(mesh.device)

    scale = float(p["scale"])
    dn_units = p["wp"] - p["bl"]

    # round 0: sharded robust self NLE
    b1, b2 = (float(v) for v in sharded_self_nlf_robust(mesh, x, k=pipe.k))
    reg = (b1, b2)
    K = max(b1 * dn_units, 1e-4)
    sigma = float(np.sqrt(max(b2, 0.0))) * dn_units
    say(f"Self Est (sharded x{n}): K={K:.4f}, b={sigma:.4f} "
        f"(beta1={b1:.3e}, beta2={b2:.3e})")

    def one_pass(Kv, sv):
        Kv = max(Kv, 1e-4)
        curve = engine.biaslut.curve(Kv, sv) if pipe.bias_corr \
            else np.zeros(len(FULL_X_GRID), np.float32)
        corr = den.sigma_corr
        if corr == "adaptive":
            # the blind rule reads the whole frame, at each pass's (K, sigma)
            corr = float(_adaptive_corr(mesh, x, Kv, sv, scale))
        return spatial_denoise_sharded_pair(
            mesh, den.model, x, curve, Kv, sv, scale, halo=halo,
            bias_corr=den.bias_corr, exact_inverse=den.exact_inverse,
            sigma_corr=corr, guided=den.guided, refine=den.refine,
            refine_k=den.refine_k, refine_beta=den.refine_beta,
            refine_floor=den.refine_floor, compute_dtype=den.compute_dtype)

    dn, dn_raw = one_pass(K, sigma)
    regs = [reg]
    outs = [dn]

    if pipe.iter == "iter":
        policy = pipe.extras.get("iter_policy", DEFAULT_POLICY)
        tol = float(pipe.extras.get("iter_policy_tol", DEFAULT_TOL))
        ff_tol = float(pipe.extras.get("iter_policy_floor_frac",
                                       DEFAULT_FLOOR_FRAC))
        ffrac = None
        if policy == "rescue":
            # the certified-under-estimate gate on the INPUT, the model
            # read at the floor's own mid-tone mean
            floor0, mu_mid0 = flat_floor_stats(frame_band_rows(mesh, x))
            ffrac = float(floor0) ** 2 \
                / max(b1 * float(mu_mid0) + max(b2, 0.0), 1e-30)
        for epoch in range(1, pipe.max_iter + 1):
            c1, c2 = (float(v) for v in sharded_collab_nlf_robust(
                mesh, x, dn_raw, k=pipe.k, self_reg=regs[0]))
            if c2 < 0:
                say(f"Warning!!! b={c2:.4f} is backup to {c1 ** 2:.4f}")
                c2 = c1 ** 2
            say(f"Iter {epoch} Est (sharded): K={c1 * dn_units:.4f}, "
                f"sigma={float(np.sqrt(max(c2, 0.0))) * dn_units:.4f} "
                f"(beta1={c1:.3e}, beta2={c2:.3e})")
            if c1 < 0:
                say("Warning!!! Wrong noise level! Backup to iter_0 result.")
                break
            prev, prev_raw = dn, dn_raw
            mu = float(global_mean(mesh, torch.clamp(prev_raw, 0.0, 1.0)))
            agree = float(reg_agreement(regs[-1], (c1, c2), mu))
            # the engine's dead-pass skip
            if policy != "rescue" or (agree > tol and ffrac > ff_tol):
                dn, dn_raw = one_pass(c1 * dn_units,
                                      float(np.sqrt(c2)) * dn_units)
                dn = combine_rounds(prev, dn, agree, policy=policy, tol=tol,
                                    floor_frac=ffrac, floor_frac_tol=ff_tol)
            outs.append(dn)
            regs.append((c1, c2))

    raw_dns = [rggb2bayer(gather_rows(mesh, o)[:H0, :W0]).cpu().numpy()
               for o in outs]
    return {"raw_dns": raw_dns, "regs": regs}
