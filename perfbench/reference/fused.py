"""Plain float32 copy of the blind denoiser's product path: one frame as
its own scene.

    self NLE (box moments on row bands, score3 flat mask, line fit, MAD
    cross-check) -> (K, sigma) -> rescue gate statistics
    -> VST, bias curve (Chebyshev), normalise -> SNR-Net -> Wiener
    refine -> inverse VST                                    (round 0)
    -> collab NLE on the raw net output -> guards -> the rescue gate
    -> second denoise pass and blend only when the gate fires

Settings are the product's: k 29, step 5, bias 'pre', adaptive guidance,
refine on, robust NLE, 2^22-px NLE bands of 256 rows, one collab round,
'rescue' at tol 0.15 and floor fraction 1.5.

`run` returns (dn [1, h, w, 4], regs [2, 2], fired). With `glue` set to
a rounding function, every map a stage hands on is rounded by it and the
net runs as given: that is the control.
"""
from __future__ import annotations

import torch

from . import nle, refine, vst
from .nle import ident

K, STEP, BAND, MAX_PX = 29, 5, 256, 1 << 22
TOL, FLOOR_FRAC = 0.15, 1.5
INNER = K // 3 * 2 + 1
M_SELF = K // 2 + INNER // 2
M_COLLAB = K // 2


def _pad32(z):
    H, W = z.shape[1], z.shape[2]
    ph, pw = (-H) % 32, (-W) % 32
    p = (ph // 2, ph - ph // 2, pw // 2, pw - pw // 2)
    z = nle.reflect_pad(nle.reflect_pad(z, 1, p[0], p[1]), 2, p[2], p[3])
    return z, p


def run_net(net, z, t):
    zp, (top, bottom, left, right) = _pad32(z)
    out = torch.clamp(net(torch.clamp(zp, 0.0, 1.0), t.reshape(1)).float(),
                      0.0, 1.0)
    return out[:, top:out.shape[1] - bottom, left:out.shape[2] - right]


class Reference:
    """The product path around `net` (a callable x [1, H, W, 4], t [1])."""

    def __init__(self, net, lut, ext_lut, glue=ident):
        self.net = net
        self.lut, self.ext_lut = lut, ext_lut
        self.q = glue

    def self_est(self, x):
        q = self.q
        xs = x
        plan = nle.band_plan(x.shape, MAX_PX, BAND, M_SELF)
        if plan is not None:
            xs = nle.take_bands(x, *plan, BAND)
        mean, var, tex = (q(a) for a in nle.moments(xs, K, INNER))
        if plan is not None:
            mean, var, tex = (nle.crop_rows(a, M_SELF)
                              for a in (mean, var, tex))
        fit = nle.flat_fit(var, mean, tex, STEP)
        mad = nle.mad_self(x)
        return nle.combine(fit, mad, torch.mean(torch.clamp(x, 0.0, 1.0)))

    def collab_est(self, lr, dn, self_b2):
        q = self.q
        plan = nle.band_plan(lr.shape, MAX_PX, BAND, M_COLLAB)
        lrb, dnb = lr, dn
        if plan is not None:
            lrb = nle.take_bands(lr, *plan, BAND)
            dnb = nle.take_bands(dn, *plan, BAND)
        _, var_lr = nle.mean_var(lrb, K)
        mean_dn, var_dn = nle.mean_var(dnb, K)
        var_lr, mean_dn, var_dn = q(var_lr), q(mean_dn), q(var_dn)
        if plan is not None:
            var_lr, mean_dn, var_dn = (nle.crop_rows(a, M_COLLAB)
                                       for a in (var_lr, mean_dn, var_dn))
        fit = nle.flat_fit(var_lr - var_dn, mean_dn, torch.sqrt(var_dn), STEP)
        mad = nle.mad_collab(lr, dn)
        ref_mean = torch.mean(torch.clamp(dn, 0.0, 1.0))
        comb = nle.combine(fit, mad, ref_mean, band=nle.COLLAB_BAND)
        return nle.shape_consistent(comb, fit, mad, ref_mean, self_b2)

    def denoise(self, x01, Kg, sigma, scale):
        q = self.q
        corr = vst.sigma_corr(x01, Kg, sigma, scale, nle.mad_self(x01))
        xd = x01 * scale
        coeffs = vst.cheb_coeffs(vst.bias_curve(self.lut, self.ext_lut, Kg,
                                                sigma))
        z = q(vst.vst(xd, sigma, Kg))
        z = q(z - vst.bias_at(torch.clamp(xd, min=0.0), coeffs, Kg))
        zero = torch.zeros((), device=x01.device)
        lower = vst.vst(zero, sigma, Kg)
        upper = vst.vst(zero + scale, sigma, Kg)
        nsr = 1.0 / (upper - lower)
        z = q((z - lower) * nsr)
        z_noisy = z
        z_raw = q(run_net(self.net, z, nsr * corr))
        z = q(refine.wiener_refine(z_raw, z_noisy, nsr ** 2))

        def finish(zz):
            xx = vst.inverse_vst(zz * (upper - lower) + lower, sigma, Kg)
            return q(torch.clamp(xx / scale, 0.0, 1.0))

        return finish(z), finish(z_raw)

    @torch.no_grad()
    def run(self, rggb, scale):
        """rggb [1, h, w, 4] float32 in [0, 1], scale = white - black."""
        x = self.q(rggb.float())
        scale = torch.as_tensor(scale, dtype=torch.float32,
                                device=x.device).reshape(())
        b1, b2 = self.self_est(x)
        b1 = torch.maximum(b1, 1e-4 / scale)
        K0 = b1 * scale
        sig0 = torch.sqrt(torch.clamp(b2, min=0.0)) * scale
        floor0, mu_mid0 = nle.flat_floor_stats(x)
        ffrac = floor0 ** 2 / torch.clamp(b1 * mu_mid0
                                          + torch.clamp(b2, min=0.0),
                                          min=1e-30)
        dn, dn_raw = self.denoise(x, K0, sig0, scale)
        c1, c2 = self.collab_est(x, dn_raw, b2)
        c2 = torch.where(c2 < 0, c1 ** 2, c2)
        ok = c1 > 0
        K1 = torch.maximum(c1, 1e-4 / scale) * scale
        sig1 = torch.sqrt(c2) * scale
        mu = torch.mean(torch.clamp(dn_raw, 0.0, 1.0))
        v_self = b1 * mu + b2
        agree = (c1 * mu + c2 - v_self) / torch.clamp(v_self, min=1e-30)
        fired = bool(ok & (agree > TOL) & (ffrac > FLOOR_FRAC))
        if fired:
            dn1, _ = self.denoise(x, K1, sig1, scale)
            w = torch.clamp((agree - TOL) / (2.0 * TOL), 0.0, 1.0)
            dn = (1.0 - w) * dn + w * dn1
        r0 = torch.stack([b1, b2])
        regs = torch.stack([r0, torch.where(ok, torch.stack([c1, c2]), r0)])
        return dn, regs, fired
