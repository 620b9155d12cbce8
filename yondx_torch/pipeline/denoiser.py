"""VST denoisers and the adaptive guidance scale (port of
yondx/pipeline/denoiser.py:54-310).

VSTDenoiser: scale -> VST -> bias subtraction ('pre') -> normalize by
[VST(0), VST(scale)] -> SNR-Net guided by t = nsr * sigma_corr -> optional
Wiener refine -> inverse VST -> rescale; with fbi=True the blind-spot
FBI_Net on the Bayer mosaic, normalized by the VST output's own min/max.
BM3DVSTDenoiser: the same VST around the host BM3D, normalized by the
VST output's own min/max.
SimpleDenoiser: clamp -> net -> clamp on packed planes.

The blind per-frame sigma_corr rule: low-noise scenes keep 1.03,
mid-noise 1.08, high-noise 1.00; heavy clipping with agreeing MAD and
fit estimates boosts to 1.25 (thresholds measured for the JAX package,
docs/sigma_corr_blind_r5.json).
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from .. import native, resolve_device
from ..core.tiling import pad_to_multiple, unpad
from ..isp.bayer import bayer2rggb, rggb2bayer
from ..nle.robust import mad_self_estimate
from ..vst.lut import (cheb_fit_curve, lookup_bias_curve,
                       lookup_bias_curve_cheb)
from ..vst.vst import inverse_vst, vst
from .refine import wiener_refine

ADAPTIVE_CORR_NSR_LO = 0.025
ADAPTIVE_CORR_NSR_HI = 0.09
ADAPTIVE_CORR_CLIP = 0.25
ADAPTIVE_CORR_MAD_DEV = 0.04
ADAPTIVE_CORR_VALUES = (1.03, 1.08, 1.00, 1.25)   # lo, mid, hi, clip


def adaptive_sigma_corr(rggb, K, sigma, scale):
    """Guidance scale in {1.00, 1.03, 1.08, 1.25} (float32 0-d tensor).
    rggb: [..., H, W, 4] in [0, 1]; K, sigma in DN; scale = wp - bl.
    Precedence: hi-noise > clip-boost > lo-noise > mid default."""
    clip_frac = torch.mean(((rggb < 0.02) | (rggb > 0.98)).float())
    mu = torch.mean(torch.clamp(rggb, 0.0, 1.0))
    return adaptive_corr_from_stats(K, sigma, scale, clip_frac, mu,
                                    mad_self_estimate(rggb))


def adaptive_corr_from_stats(K, sigma, scale, clip_frac, mu, mad):
    """adaptive_sigma_corr's rule on the frame's statistics: the clipped
    fraction, the mean of the clipped frame and the MAD (beta1, beta2)
    (the row-sharded route computes them over all ranks)."""
    c_lo, c_mid, c_hi, c_clip = ADAPTIVE_CORR_VALUES
    zero = torch.zeros((), device=mu.device)
    lower = vst(zero, sigma, gain=K)
    upper = vst(torch.ones((), device=mu.device) * scale, sigma, gain=K)
    nsr = 1.0 / (upper - lower)
    v_fit = (K / scale) * mu + (sigma / scale) ** 2
    m1, m2 = mad
    v_mad = m1 * mu + m2
    madr = torch.sqrt(torch.clamp(v_mad, min=0.0)
                      / torch.clamp(v_fit, min=1e-30))

    def const(v):
        return torch.full((), v, device=mu.device)

    corr = torch.where(nsr < ADAPTIVE_CORR_NSR_LO, const(c_lo), const(c_mid))
    boost = (clip_frac > ADAPTIVE_CORR_CLIP) \
        & (torch.abs(madr - 1.0) < ADAPTIVE_CORR_MAD_DEV)
    corr = torch.where(boost, const(c_clip), corr)
    corr = torch.where(nsr > ADAPTIVE_CORR_NSR_HI, const(c_hi), corr)
    return corr.float()


def run_net(model, z, t, guided: bool, pad_base: int = 32,
            compute_dtype=None):
    """Reflect-pad z [B, h, w, 4] to a multiple of pad_base, run the model
    on the clipped input (in compute_dtype when given) with guidance t
    (a 0-d tensor, broadcast over the batch), clip and unpad."""
    zp, p2d = pad_to_multiple(z, pad_base)
    zin = torch.clamp(zp, 0.0, 1.0)
    if compute_dtype is not None:
        zin = zin.to(compute_dtype)
    if guided:
        out = model(zin, t.reshape(1).expand(zin.shape[0]))
    else:
        out = model(zin)
    return unpad(torch.clamp(out.float(), 0.0, 1.0), p2d)


def _bayer_batch(lr_bayer, device):
    """A [B, H, W] or [H, W] bayer array/tensor -> (float32 [B, H, W]
    tensor on `device`, whether the input was a single frame)."""
    x = torch.as_tensor(lr_bayer, dtype=torch.float32, device=device)
    return (x[None], True) if x.ndim == 2 else (x, False)


class VSTDenoiser:
    """Callable holding the net and the static pipe config.

    __call__(lr_bayer [B, H, W] or [H, W], curve [2177], K, sigma, scale)
    -> denoised bayer tensor, same shape, in [0, 1], on `device` ("cuda"
    unless the caller passes "cpu"). `model` is an nn.Module on that
    device called as model(x [B, h, w, 4], t [B]) (model(x) when
    guided=False). sigma_corr: None -> 1.03 for the 'pre' bias path and
    1.00 otherwise; a float; or 'adaptive' (the measured per-frame rule).
    refine_*: the Wiener refine's settings (pipeline/refine.py). The
    net runs in compute_dtype when given (the caller loads its weights in
    that dtype, as `--bf16` does); everything around it stays float32.
    fbi=True is the blind-spot variant (FBI_Net of models/comp.py): the
    VST output is normalised by its own min and max over the batch, and
    the net takes the 1-channel Bayer mosaic [B, H, W, 1] (no padding, no
    guidance, no refine).
    """

    def __init__(self, model, *, guided: bool = True,
                 bias_corr: Optional[str] = "pre", vst_type: str = "exact",
                 pad_base: int = 32, fbi: bool = False,
                 refine: bool = False, refine_k: int = 15,
                 refine_beta: float = 1.0, refine_floor: str = "bucket",
                 refine_shrink: bool = True, refine_shrink_lam: float = 1.0,
                 refine_shrink_full_alpha: float = 1.0,
                 refine_shrink_mode: str = "oriented",
                 sigma_corr=None, compute_dtype=None, device=None):
        self.model = model
        self.guided = guided
        self.bias_corr = bias_corr
        self.vst_type = vst_type
        self.pad_base = pad_base
        self.fbi = fbi
        self.refine = refine
        self.refine_k = refine_k
        self.refine_beta = refine_beta
        self.refine_floor = refine_floor
        self.refine_shrink = refine_shrink
        self.refine_shrink_lam = refine_shrink_lam
        self.refine_shrink_full_alpha = refine_shrink_full_alpha
        self.refine_shrink_mode = refine_shrink_mode
        if sigma_corr is None:
            sigma_corr = 1.03 if bias_corr == "pre" else 1.00
        self.sigma_corr = sigma_corr
        self.compute_dtype = compute_dtype
        self.exact_inverse = bias_corr is None and vst_type == "exact"
        self.device = resolve_device(device)

    def _scalar(self, v):
        return torch.as_tensor(v, dtype=torch.float32, device=self.device)

    def _denoise(self, lr_rggb, curve, K, sigma, scale, corr=None):
        """-> (output, raw net output) RGGB. corr None resolves the
        instance's sigma_corr policy from the call's own pixels."""
        x = lr_rggb * scale
        z = vst(x, sigma, gain=K)
        if self.bias_corr == "pre":
            coeffs = cheb_fit_curve(curve)
            z = z - lookup_bias_curve_cheb(torch.clamp(x, min=0.0), coeffs,
                                           K)
        if self.fbi:
            lower, upper = torch.min(z), torch.max(z)
        else:
            lower = vst(self._scalar(0.0), sigma, gain=K)
            upper = vst(self._scalar(1.0) * scale, sigma, gain=K)
        nsr = 1.0 / (upper - lower)
        z = (z - lower) * nsr
        if self.fbi:
            zin = torch.clamp(rggb2bayer(z)[..., None], 0.0, 1.0)
            if self.compute_dtype is not None:
                zin = zin.to(self.compute_dtype)
            out = torch.clamp(self.model(zin).float(), 0.0, 1.0)
            z = z_raw = bayer2rggb(out[..., 0])
        else:
            if corr is None:
                corr = adaptive_sigma_corr(lr_rggb, K, sigma, scale) \
                    if self.sigma_corr == "adaptive" \
                    else self._scalar(float(self.sigma_corr))
            z_noisy = z
            z = run_net(self.model, z, nsr * corr, self.guided,
                        self.pad_base, self.compute_dtype)
            z_raw = z
        if self.refine and not self.fbi:
            z = wiener_refine(
                z, z_noisy, noise_var=nsr ** 2, k=self.refine_k,
                beta=self.refine_beta, x01=z, noise_floor=self.refine_floor,
                residual_shrink=self.refine_shrink,
                shrink_lam=self.refine_shrink_lam,
                shrink_full_alpha=self.refine_shrink_full_alpha,
                shrink_mode=self.refine_shrink_mode)

        def finish(zz):
            zz = zz * (upper - lower) + lower
            xx = inverse_vst(zz, sigma, gain=K, exact=self.exact_inverse)
            return torch.clamp(xx / scale, 0.0, 1.0)

        # the raw (un-refined) output feeds the next round's collab NLE
        out = finish(z)
        return out, (finish(z_raw) if self.refine and not self.fbi else out)

    def __call__(self, lr_bayer, curve, K, sigma, scale):
        return self.denoise_pair(lr_bayer, curve, K, sigma, scale)[0]

    @torch.no_grad()
    def denoise_pair(self, lr_bayer, curve, K, sigma, scale, corr=None):
        """-> (output, raw_net_output) bayer pair; they differ only when
        refine=True. corr: optional guidance-scale override (the tiled
        runner's frame-scoped value); None = the sigma_corr policy."""
        x, single = _bayer_batch(lr_bayer, self.device)
        out, raw = self._denoise(
            bayer2rggb(x), self._scalar(np.asarray(curve, np.float32)),
            self._scalar(K), self._scalar(sigma), self._scalar(scale),
            None if corr is None else self._scalar(corr))
        out, raw = rggb2bayer(out), rggb2bayer(raw)
        return (out[0], raw[0]) if single else (out, raw)

    @torch.no_grad()
    def denoise_rggb(self, rggb, curve, K, sigma, scale):
        """Packed-plane entry point (already [B, h, w, 4])."""
        rggb = torch.as_tensor(rggb, dtype=torch.float32, device=self.device)
        return self._denoise(rggb, self._scalar(np.asarray(curve,
                                                           np.float32)),
                             self._scalar(K), self._scalar(sigma),
                             self._scalar(scale))[0]


class BM3DVSTDenoiser:
    """Host BM3D in VST space (yondx/pipeline/denoiser.py:239-280): scale
    -> VST -> bias subtraction by the curve's gather ('pre') ->
    normalize by the VST output's own min/max over the whole batch ->
    BM3D of each crop at sigma = nsr on the host (`native.bm3d`) ->
    un-normalize -> inverse VST (exact only without a bias correction)
    -> rescale and clip. Everything but BM3D runs on `device`; the
    normalized batch is copied to the host once and the result back
    once. The crops' BM3D calls run on a thread pool (each call is
    independent, so the result is the serial one). `host_s` accumulates
    the seconds spent in BM3D."""

    def __init__(self, *, bias_corr: Optional[str] = "pre",
                 vst_type: str = "exact", device=None):
        self.bias_corr = bias_corr
        self.exact_inverse = bias_corr is None and vst_type == "exact"
        self.model = None
        self.pad_base = 1
        self.device = resolve_device(device)
        self.host_s = 0.0

    def __call__(self, lr_bayer, curve, K, sigma, scale):
        return self.denoise_pair(lr_bayer, curve, K, sigma, scale)[0]

    @torch.no_grad()
    def denoise_pair(self, lr_bayer, curve, K, sigma, scale, corr=None):
        """-> (output, output): BM3D has no raw net output apart from its
        result; corr (a net's guidance scale) does not apply."""
        K, sigma, scale = float(K), float(sigma), float(scale)
        x, single = _bayer_batch(lr_bayer, self.device)
        xs = bayer2rggb(x) * scale
        z = vst(xs, sigma, gain=K)
        if self.bias_corr == "pre":
            c = torch.as_tensor(np.asarray(curve, np.float32),
                                device=self.device)
            z = z - lookup_bias_curve(torch.clamp(xs, min=0.0), c, K)
        lower, upper = float(z.min()), float(z.max())
        nsr = 1.0 / max(upper - lower, 1e-8)
        zn = ((z - lower) * nsr).cpu().numpy()
        t = time.perf_counter()
        with ThreadPoolExecutor(max_workers=zn.shape[0]) as pool:
            out = np.stack(list(pool.map(lambda b: native.bm3d(zn[b], nsr),
                                         range(zn.shape[0]))))
        self.host_s += time.perf_counter() - t
        z = torch.from_numpy(out).to(self.device) * (upper - lower) + lower
        xd = inverse_vst(z, sigma, gain=K, exact=self.exact_inverse)
        bayer = rggb2bayer(torch.clamp(xd / scale, 0.0, 1.0))
        out = bayer[0] if single else bayer
        return out, out


class SimpleDenoiser:
    """Non-VST path: clamp -> net -> clamp on packed planes."""

    def __init__(self, model, *, guided: bool = False, pad_base: int = 32,
                 device=None):
        self.model = model
        self.guided = guided
        self.pad_base = pad_base
        self.device = resolve_device(device)

    @torch.no_grad()
    def __call__(self, lr_bayer, t=0.0):
        x, single = _bayer_batch(lr_bayer, self.device)
        t = torch.as_tensor(t, dtype=torch.float32, device=self.device)
        out = rggb2bayer(run_net(self.model, bayer2rggb(x), t, self.guided,
                                 self.pad_base))
        return out[0] if single else out
