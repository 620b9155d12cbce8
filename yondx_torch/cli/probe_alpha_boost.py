"""`python -m yondx_torch.cli.probe_alpha_boost [--scenes ...] [--model M]
[--cpu]`: the refine's Wiener weight dissected (port of
scripts/probe_alpha_boost.py).

With the bucket noise floor N (pipeline/refine.py _bucket_noise_floor),
alpha = sigma_d^2 / (sigma_d^2 + N) blends the residual r = z_noisy -
z_dn back into the un-refined net output. Per scene of suite v2 (the
gru32 flagship at the robust self estimate, pre bias correction, exact
VST) it prints alpha's q50/q90/q99 and the fraction above 0.5, then the
PSNR of the output under alpha -> alpha' transforms:
  wiener    alpha itself;
  poly b    min(1, alpha (1 + b alpha)) for b = 1, 2, 4;
  hard>.3   1 where alpha > 0.3, else alpha.
K1 runs once a scene (the self fit).
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

from ..eval.heldout import BL, SUITES, WP
from ..eval.metrics import psnr
from ..isp.bayer import bayer2rggb, rggb2bayer
from ..nle.boxfilter import box_mean
from ..nle.robust import self_nlf_robust
from ..pipeline.denoiser import VSTDenoiser
from ..pipeline.refine import _bucket_noise_floor
from ..vst.lut import BiasLUT, cheb_fit_curve, lookup_bias_curve_cheb
from ..vst.vst import inverse_vst, vst
from .probe_common import device_of, get_scene, guided_arch, load_net, \
    rggb_of

SCENES = ["satdisk_mid", "glyphs_mid", "radial_mid", "chart_anchor",
          "ramp_mid", "bubbles_mid"]
TRANSFORMS = (("wiener", lambda al: al),
              ("poly b=1", lambda al: torch.clamp(al * (1 + 1.0 * al),
                                                  max=1.0)),
              ("poly b=2", lambda al: torch.clamp(al * (1 + 2.0 * al),
                                                  max=1.0)),
              ("poly b=4", lambda al: torch.clamp(al * (1 + 4.0 * al),
                                                  max=1.0)),
              ("hard>.3", lambda al: torch.where(al > 0.3,
                                                 torch.ones_like(al), al)))


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", nargs="+", default=list(SCENES))
    ap.add_argument("--model", default="Gaussian_GRU_mix_1to50c_norm")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU)")
    return ap


def build_denoiser(model: str, device) -> VSTDenoiser:
    return VSTDenoiser(load_net(guided_arch(), model, device), guided=True,
                       bias_corr="pre", vst_type="exact", device=device)


def scene_row(den, lut, clean, noisy) -> dict:
    """alpha's quantiles and the PSNR under each transform of one scene."""
    dev = den.device
    scale = float(WP - BL)
    rggb = rggb_of(noisy, dev)
    b1, b2 = (float(v) for v in self_nlf_robust(rggb, k=29))
    K = max(b1 * scale, 1e-4)
    sig = float(np.sqrt(max(b2, 0.0))) * scale
    curve = lut.curve(K, sig)
    # the denoiser's z-space quantities
    coeffs = cheb_fit_curve(torch.as_tensor(curve, device=dev))

    def to_z(x):
        return vst(x, sig, gain=K) - lookup_bias_curve_cheb(
            torch.clamp(x, min=0.0), coeffs, K)

    lower = vst(torch.zeros((), device=dev), sig, gain=K)
    upper = vst(torch.full((), 1.0, device=dev) * scale, sig, gain=K)
    nsr = float(1.0 / (upper - lower))
    z_noisy = (to_z(rggb * scale) - lower) * nsr
    dn_raw = den(noisy, curve, K, sig, scale)       # the un-refined output
    z_dn = (to_z(bayer2rggb(dn_raw) * scale) - lower) * nsr
    N = _bucket_noise_floor(z_noisy, z_dn, nsr ** 2)
    r = z_noisy - z_dn
    local_pow = box_mean(r * r, 15)
    allowance = N * (1.0 + 2.0 * float(np.sqrt(2.0) / 15))
    sd2 = torch.clamp(local_pow - allowance, min=0.0)
    alpha = sd2 / (sd2 + N)
    a = alpha.reshape(-1).cpu().numpy()
    qs = np.percentile(a, [50, 90, 99])
    clean_t = torch.as_tensor(clean, device=dev)

    def finish(zz):
        xx = inverse_vst(zz / nsr + lower, sig, gain=K, exact=False)
        return rggb2bayer(torch.clamp(xx / scale, 0.0, 1.0))

    return {"q50": float(qs[0]), "q90": float(qs[1]), "q99": float(qs[2]),
            "frac_hi": float((a > 0.5).mean()),
            "psnr": {tag: float(psnr(finish(z_dn + fn(alpha) * r), clean_t))
                     for tag, fn in TRANSFORMS}}


def run(args, scenes: Optional[Dict] = None, den=None) -> dict:
    """-> {scene: row}; scenes: eval_synth.run's scene dict keyed (name,
    None), reused and filled."""
    den = den if den is not None else build_denoiser(
        args.model, device_of(args.cpu))
    lut = BiasLUT()
    specs = {s.name: s for s in SUITES["v2"]}
    rows = {}
    for name in args.scenes:
        clean, noisy = get_scene(specs[name], scenes)
        row = rows[name] = scene_row(den, lut, clean, noisy)
        print(f"== {name}: alpha q50/90/99 = {row['q50']:.3f}/"
              f"{row['q90']:.3f}/{row['q99']:.3f}  frac>0.5 = "
              f"{row['frac_hi']:.3f}", flush=True)
        base = row["psnr"]["wiener"]
        for tag, p in row["psnr"].items():
            print(f"   {tag:9s} psnr={p:6.2f} ({p - base:+.2f})", flush=True)
    return rows


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
