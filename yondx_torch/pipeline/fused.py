"""The blind denoiser's product path (port of yondx/pipeline/fused.py).

    rggb -> self NLE (K1 moments + score3 threshold + line fit, MAD
            cross-check) -> (K, sigma)
         -> bias curve from the 2-D LUT (Chebyshev, gather-free)
         -> VST -> SNR-Net -> Wiener refine -> inverse VST
         -> collab NLE (K1 moments) -> guards -> iteration policy
         -> second denoise pass: every round, or under the 'rescue'
            policy only when its gate fires

PyTorch runs eagerly, so where the JAX graph keeps everything on the
device with selects and `lax.cond`, this port does the same arithmetic
with `torch.where`, except the rescue gate: a Python `if` on `need`, a
host sync.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..core.profiling import span
from ..nle.fit import masked_linefit, nonsat_weights
from ..nle.moments import nle_moments
from ..nle.robust import (COLLAB_BAND, combine_estimates, flat_floor_stats,
                          mad_collab_estimate, mad_self_estimate,
                          shape_consistent_collab)
from ..nle.threshold import score3_threshold_with_p25
from ..vst.lut import (SG_EXT, SG_LUT, X_EXT, X_LUT, cheb_fit_curve,
                       load_sgext_lut, lookup_bias_curve_cheb)
from ..vst.vst import inverse_vst, vst
from .denoiser import adaptive_sigma_corr, run_net
from .policy import (DEFAULT_FLOOR_FRAC, DEFAULT_POLICY, DEFAULT_TOL,
                     POLICIES, combine_rounds, reg_agreement)
from .refine import wiener_refine


_NLE_BAND = 256     # rows per NLE moment band (see _band_plan)


def _close_form_bias(lam, sg):
    """Foi TIP-13 closed-form VST bias, electron domain."""
    y_hat = lam + 3.0 / 8.0 + sg ** 2
    m1 = (lam + sg ** 2) / y_hat ** 2
    m2 = lam / y_hat ** 3
    m3 = (lam + 3.0 * (lam + sg ** 2) ** 2) / y_hat ** 4
    return 2.0 * torch.sqrt(y_hat) * (-m1 / 8.0 + m2 / 16.0 - 5.0 * m3 / 128.0)


def device_bias_curve(lut, K, sigma, lut_sgext):
    """Bias curve over FULL_X_GRID from the 2-D LUT at sg = sigma/K: sg
    column blend in [0, 10], blend of the sg-extension table in (10, 160],
    closed form beyond (and past 2^10 e- in x)."""
    dev = lut.device
    sg = sigma / K
    pos = torch.where(sg < 1.0, sg / 0.005, 200.0 + (sg - 1.0) / 0.01)
    pos = torch.clamp(pos, 0.0, len(SG_LUT) - 1)
    lo = torch.floor(pos).long()
    hi = torch.clamp(lo + 1, max=len(SG_LUT) - 1)
    w = pos - lo
    base = lut[:, lo] * (1.0 - w) + lut[:, hi] * w
    oor = _close_form_bias(torch.as_tensor(X_LUT, device=dev,
                                           dtype=torch.float32), sg)
    # log-spaced extension grid: analytic fractional index
    epos = (torch.log(torch.clamp(sg, min=10.0)) - float(np.log(10.0))) \
        / float(np.log(160.0) - np.log(10.0)) * (len(SG_EXT) - 1)
    epos = torch.clamp(epos, 0.0, len(SG_EXT) - 1)
    elo = torch.floor(epos).long()
    ehi = torch.clamp(elo + 1, max=len(SG_EXT) - 1)
    ew = epos - elo
    ext_col = lut_sgext[:, elo] * (1.0 - ew) + lut_sgext[:, ehi] * ew
    oor = torch.where(sg <= float(SG_EXT[-1]), ext_col, oor)
    base = torch.where(sg <= float(SG_LUT[-1]), base, oor)
    ext = _close_form_bias(torch.as_tensor(X_EXT, device=dev,
                                           dtype=torch.float32), sg)
    return torch.cat([base, ext]).float()


def _nlf_core(var, mean, texture, step: int = 5, th_impl: str = "sort",
              th_subsample=None):
    """Flat mask (texture < adaptive threshold, with p25 / all-ones
    fallbacks) -> non-saturated weights -> line fit. th_subsample None:
    exact threshold selection on small scenes, every 4th / 8th 128-sample
    run on multi-MP (banded) moment fields, as in the JAX package."""
    if th_subsample is None:
        n = texture.numel()
        th_subsample = 1 if n < 2_000_000 else (4 if n < 8_000_000 else 8)
    th, th25 = score3_threshold_with_p25(texture, mean, step=step,
                                         impl=th_impl,
                                         subsample=th_subsample)
    mask = (texture < th).float()
    mask = torch.where(torch.sum(mask) == 0, (texture < th25).float(), mask)
    mask = torch.where(torch.sum(mask) == 0, torch.ones_like(mask), mask)
    w = nonsat_weights(mean, mask)
    return masked_linefit(mean, var, w)


def _band_plan(shape, max_px, band: int, margin: int):
    """Static plan for contiguous-row-band NLE moment sampling:
    None (no banding) or (nb, keep, stride)."""
    if max_px is None:
        return None
    h, w = shape[-3], shape[-2]
    per_row = int(np.prod([s for i, s in enumerate(shape) if i not in
                           (len(shape) - 3, len(shape) - 2)],
                          dtype=np.int64)) * w
    if h * per_row <= max_px or h < 3 * band:
        return None
    nb = h // band
    eff = (band - 2 * margin) * per_row
    keep = max(1, min(nb, max_px // max(eff, 1)))
    if keep >= nb:
        return None
    return nb, keep, nb // keep


def _take_bands(x, nb: int, keep: int, stride: int, band: int):
    """[..., h, w, C] -> [..., keep, band, w, C] evenly-strided row bands
    (a view)."""
    lead = tuple(x.shape[:-3])
    w, C = x.shape[-2], x.shape[-1]
    xb = x[..., :nb * band, :, :].reshape(lead + (nb, band, w, C))
    return xb[..., ::stride, :, :, :][..., :keep, :, :, :]


def _crop_rows(a, m: int):
    return a[..., m:-m, :, :]


def make_fused_blind_denoiser(net, lut: np.ndarray, *, guided: bool = True,
                              k: int = 29, step: int = 5,
                              bias_corr: Optional[str] = "pre",
                              sigma_corr=1.03, max_iter: int = 1,
                              pad_base: int = 32, compute_dtype=None,
                              use_pallas_nle: bool = False,
                              th_impl: str = "sort", th_subsample=None,
                              batch_mode: str = "scene",
                              frames_sequential: bool = True,
                              refine: bool = False, refine_k: int = 15,
                              refine_beta: float = 1.0,
                              refine_floor: str = "bucket",
                              refine_shrink: bool = True,
                              refine_shrink_lam: float = 1.0,
                              refine_shrink_full_alpha: float = 1.0,
                              refine_shrink_mode: str = "oriented",
                              robust_nle: bool = True,
                              nle_max_px=1 << 22,
                              iter_policy: Optional[str] = None,
                              iter_policy_tol: Optional[float] = None,
                              device=None):
    """Build fn(rggb [B, h, w, 4], scale) -> (dn [B, h, w, 4], regs).

    The keywords and defaults of yondx.pipeline.fused's entry. `net` is
    any nn.Module called as net(x [B, H, W, 4], t [B]) (or net(x) when
    guided=False) on channels-last tensors, its input reflect-padded to a
    multiple of `pad_base`. regs[i] = (beta1, beta2) of round i: [rounds,
    2] for batch_mode='scene' (the batch is one scene), [B, rounds, 2]
    for 'frames'.
    - k: the NLE box window; the texture pre-blur is k // 3 * 2 + 1 and
      `step` the percentile step of the score3 threshold candidates.
    - bias_corr: 'pre' subtracts the bias curve of the 2-D LUT (and its
      sg-extension table) before the net and inverts with the asymptotic
      inverse; None skips the bias and inverts exactly; any other value
      skips the bias and keeps the asymptotic inverse.
    - sigma_corr: the guidance scale, a float or 'adaptive'.
    - th_impl: 'sort' or 'hist' threshold percentiles; th_subsample None
      picks 1, 4 or 8 by the size of the moment field.
    - refine and refine_*: the method-noise Wiener refine
      (pipeline/refine.py).
    - iter_policy (None: 'rescue') and iter_policy_tol (None: 0.15): how
      a collab round's output combines with the previous one
      (pipeline/policy.py). 'rescue' runs the second denoise pass only
      when its gate fires; the other policies run it every round.
    - use_pallas_nle keeps its JAX meaning, the band margins (k // 2 +
      inner // 2 for both fits when True; that self, k // 2 collab when
      False); the moments of both branches run through K1 on the GPU.
    - batch_mode='frames' runs the frames one by one whatever
      `frames_sequential` says: the JAX package's two settings differ only
      in how one dispatch holds the frames (lax.map or vmap).
    Runs on `device` ("cuda" unless the caller passes "cpu").
    `fn.stats["second_passes"]` counts the second denoise passes run.
    """
    dev = resolve_device(device)
    policy = DEFAULT_POLICY if iter_policy is None else iter_policy
    ptol = DEFAULT_TOL if iter_policy_tol is None else iter_policy_tol
    if policy not in POLICIES:
        raise ValueError(f"unknown iter policy {policy!r}; one of "
                         f"{POLICIES}")
    lut_dev = torch.as_tensor(np.asarray(lut), dtype=torch.float32,
                              device=dev)
    lut_sgext_dev = torch.as_tensor(load_sgext_lut(), dtype=torch.float32,
                                    device=dev) if bias_corr == "pre" \
        else None
    exact_inverse = bias_corr is None
    inner = k // 3 * 2 + 1
    m_self = k // 2 + inner // 2
    m_collab = m_self if use_pallas_nle else k // 2
    # second denoise passes run, read by callers
    stats = {"second_passes": 0}

    def denoise(x01, K, sigma, scale):
        with span("denoise"):
            return _denoise(x01, K, sigma, scale)

    def _denoise(x01, K, sigma, scale):
        with span("sigma_corr"):
            if sigma_corr == "adaptive":
                corr = adaptive_sigma_corr(x01, K, sigma, scale)
            else:
                corr = torch.tensor(float(sigma_corr), device=dev)
        with span("vst"):
            xd = x01 * scale
            z = vst(xd, sigma, gain=K)
        if bias_corr == "pre":
            with span("bias"):
                # gather-free bias: Chebyshev fit of the per-call curve
                curve = device_bias_curve(lut_dev, K, sigma, lut_sgext_dev)
                coeffs = cheb_fit_curve(curve)
                z = z - lookup_bias_curve_cheb(torch.clamp(xd, min=0.0),
                                               coeffs, K)
        with span("vst"):
            lower = vst(torch.zeros((), device=dev), sigma, gain=K)
            upper = vst(scale, sigma, gain=K)
            nsr = 1.0 / (upper - lower)
            z = (z - lower) * nsr
        z_noisy = z
        with span("net"):
            z = run_net(net, z, nsr * corr, guided, pad_base, compute_dtype)
        z_raw = z
        if refine:
            with span("refine"):
                z = wiener_refine(z, z_noisy, noise_var=nsr ** 2, k=refine_k,
                                  beta=refine_beta, x01=z,
                                  noise_floor=refine_floor,
                                  residual_shrink=refine_shrink,
                                  shrink_lam=refine_shrink_lam,
                                  shrink_full_alpha=refine_shrink_full_alpha,
                                  shrink_mode=refine_shrink_mode)

        def finish(zz):
            with span("inverse"):
                zz = zz * (upper - lower) + lower
                xx = inverse_vst(zz, sigma, gain=K, exact=exact_inverse)
                return torch.clamp(xx / scale, 0.0, 1.0)

        # the raw (un-refined) output feeds the next round's collab NLE
        out = finish(z)
        return out, (finish(z_raw) if refine else out)

    def self_fit(x):
        plan = _band_plan(x.shape, nle_max_px, _NLE_BAND, m_self)
        if plan is not None:
            x = _take_bands(x, *plan, _NLE_BAND)
        mean, var, tex = nle_moments(x, k, inner)
        if plan is not None:
            mean, var, tex = (_crop_rows(a, m_self) for a in (mean, var, tex))
        return _nlf_core(var, mean, tex, step, th_impl, th_subsample)

    def collab_fit(lr, dn):
        plan = _band_plan(lr.shape, nle_max_px, _NLE_BAND, m_collab)
        if plan is not None:
            lr = _take_bands(lr, *plan, _NLE_BAND)
            dn = _take_bands(dn, *plan, _NLE_BAND)
        _, var_lr, _ = nle_moments(lr, k, inner, texture=False, mean=False)
        mean_dn, var_dn, _ = nle_moments(dn, k, inner, texture=False)
        if plan is not None:
            var_lr, mean_dn, var_dn = (_crop_rows(a, m_collab)
                                       for a in (var_lr, mean_dn, var_dn))
        return _nlf_core(var_lr - var_dn, mean_dn, torch.sqrt(var_dn), step,
                         th_impl, th_subsample)

    if robust_nle:
        def self_est(x):
            fit = self_fit(x)
            mad = mad_self_estimate(x)
            return combine_estimates(fit, mad,
                                     torch.mean(torch.clamp(x, 0.0, 1.0)))

        def collab_est(lr, dn, self_reg):
            fit = collab_fit(lr, dn)
            mad = mad_collab_estimate(lr, dn)
            ref_mean = torch.mean(torch.clamp(dn, 0.0, 1.0))
            comb = combine_estimates(fit, mad, ref_mean, band=COLLAB_BAND)
            return shape_consistent_collab(comb, fit, mad, ref_mean,
                                           self_reg)
    else:
        self_est = self_fit

        def collab_est(lr, dn, self_reg):
            return collab_fit(lr, dn)

    def fused_body(rggb, scale):
        with span("nle.self"):
            b1, b2 = self_est(rggb)
            b1 = torch.maximum(b1, 1e-4 / scale)        # defensive K clamp
            K0 = b1 * scale
            sig0 = torch.sqrt(torch.clamp(b2, min=0.0)) * scale
        if policy == "rescue" and max_iter > 0:
            with span("gate.stats"):
                # certified-under-estimate gate, measured once on the input
                floor0, mu_mid0 = flat_floor_stats(rggb)
                ffrac = floor0 ** 2 / torch.clamp(
                    b1 * mu_mid0 + torch.clamp(b2, min=0.0), min=1e-30)
        dn, dn_raw = denoise(rggb, K0, sig0, scale)

        # the rounds' bookkeeping is the gate's; the collab NLE and a
        # second pass are spans of their own inside it
        with span("gate"):
            regs = [torch.stack([b1, b2])]
            for _ in range(max_iter):
                with span("nle.collab"):
                    # collab NLE sees the raw (un-refined) net output
                    c1, c2 = collab_est(rggb, dn_raw, (b1, b2))
                c2 = torch.where(c2 < 0, c1 ** 2, c2)    # beta2<0 -> beta1^2
                ok = c1 > 0                              # beta1<=0: keep
                K1 = torch.maximum(c1, 1e-4 / scale) * scale
                sig1 = torch.sqrt(c2) * scale
                mu = torch.mean(torch.clamp(dn_raw, 0.0, 1.0))
                agree = reg_agreement((regs[-1][0], regs[-1][1]), (c1, c2),
                                      mu)
                if policy == "rescue":
                    # the rescue weight is exactly 0 unless `need` holds,
                    # so the second pass is skipped otherwise; JAX decides
                    # this on the device with lax.cond, eager PyTorch
                    # needs the value on the host. This bool() is one of
                    # a product frame's 18 host syncs on an H100
                    # (perfbench/spans.py). The others are .item() reads
                    # (4 in the bias curve, its 0-d LUT column indices; 2
                    # in the gate statistics; 2 in each NLE) and blocking
                    # copies of host values (4 in the bias curve, its
                    # grids and Chebyshev tables; 1 each in the gate
                    # statistics, the refine and _prepare's scale).
                    need = ok & (agree > ptol) & (ffrac > DEFAULT_FLOOR_FRAC)
                    if bool(need):
                        stats["second_passes"] += 1
                        dn1, dn_raw = denoise(rggb, K1, sig1, scale)
                        dn = combine_rounds(dn, dn1, agree, policy=policy,
                                            tol=ptol, floor_frac=ffrac,
                                            floor_frac_tol=DEFAULT_FLOOR_FRAC)
                else:
                    # the second pass always runs; an aborted round (ok
                    # False) keeps the previous output by a select
                    stats["second_passes"] += 1
                    dn1, dn1_raw = denoise(rggb, K1, sig1, scale)
                    dn1 = combine_rounds(dn, dn1, agree, policy=policy,
                                         tol=ptol, floor_frac=None)
                    dn = torch.where(ok, dn1, dn)
                    dn_raw = torch.where(ok, dn1_raw, dn_raw)
                regs.append(torch.where(ok, torch.stack([c1, c2]), regs[-1]))
            return dn, torch.stack(regs)

    def _prepare(rggb, scale):
        with span("prepare"):
            rggb = torch.as_tensor(rggb, dtype=torch.float32, device=dev)
            scale = torch.as_tensor(scale, dtype=torch.float32, device=dev)
            return rggb, scale.reshape(())

    if batch_mode == "frames":
        @torch.no_grad()
        def fn(frames, scale):
            with span("frame"):
                frames, scale = _prepare(frames, scale)
                outs, regs = [], []
                for i in range(frames.shape[0]):
                    dn, r = fused_body(frames[i:i + 1], scale)
                    outs.append(dn[0])
                    regs.append(r)
                return torch.stack(outs), torch.stack(regs)
    elif batch_mode == "scene":
        @torch.no_grad()
        def fn(rggb, scale):
            with span("frame"):
                return fused_body(*_prepare(rggb, scale))
    else:
        raise ValueError(f"unknown batch_mode {batch_mode!r}")
    fn.stats = stats
    return fn
