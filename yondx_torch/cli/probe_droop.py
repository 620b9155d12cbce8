"""`python -m yondx_torch.cli.probe_droop [--scenes ...] [--model M]
[--arch A] [--nf N] [--cpu]`: an iteration-1 PSNR droop dissected (port
of scripts/probe_droop.py).

Per held-out scene: round 0 at the robust self estimate, then round 1
under three (K, sigma) sources:
  collab   the product's robust collab estimate on (noisy, round 0);
  true     the scene's frozen ground truth;
  self     round 0's own estimate again.
If `true` droops below it0 too, the droop is a second-pass property of
the net, not of the estimator. Also prints the collab estimate's parts
(the flat-mask fit, the MAD, their combination). The net runs with pre
bias correction, the exact VST and no refine. K1 runs five times a
scene (self 1, robust collab 2, plain collab 2).
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

from ..core.logging import log
from ..eval.heldout import BL, HELDOUT_SCENES, WP
from ..eval.metrics import psnr
from ..nle.nlf import collab_nlf
from ..nle.robust import (collab_nlf_robust, mad_collab_estimate,
                          self_nlf_robust)
from ..pipeline.denoiser import VSTDenoiser
from ..vst.lut import BiasLUT
from .probe_common import device_of, get_scene, guided_arch, load_net, \
    rggb_of


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", nargs="+", default=["radial_mid"])
    ap.add_argument("--model", default="Gaussian_GRU_mix_1to50c_norm")
    ap.add_argument("--arch", default="GuidedResUnet")
    ap.add_argument("--nf", type=int, default=32)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU)")
    return ap


def build_denoiser(args, device) -> VSTDenoiser:
    return VSTDenoiser(load_net(guided_arch(args.arch, args.nf), args.model,
                                device),
                       guided=True, bias_corr="pre", vst_type="exact",
                       device=device)


def scene_row(den, lut, spec, clean, noisy) -> dict:
    """Round 0 and round 1 under each (K, sigma) source of one scene."""
    dev = den.device
    scale = float(WP - BL)

    def denoise(K, sigma):
        curve = lut.curve(max(K, 1e-4), sigma)
        return den(noisy, curve, max(K, 1e-4), sigma, scale)

    clean_t = torch.as_tensor(clean, device=dev)
    rggb = rggb_of(noisy, dev)
    b1s, b2s = (float(v) for v in self_nlf_robust(rggb, k=29))
    K0, s0 = b1s * scale, float(np.sqrt(max(b2s, 0.0))) * scale
    dn0 = denoise(K0, s0)
    rggb_dn = rggb_of(dn0, dev)
    b1c, b2c = (float(v) for v in collab_nlf_robust(
        rggb, rggb_dn, k=29, self_reg=(b1s, b2s)))
    fit = tuple(float(v) for v in collab_nlf(rggb, rggb_dn, k=29))
    mad = tuple(float(v) for v in mad_collab_estimate(rggb, rggb_dn))
    cands = {"collab": (b1c * scale, float(np.sqrt(max(b2c, 0.0))) * scale),
             "true": (spec.K, spec.sigma), "self": (K0, s0)}
    return {"noisy": float(psnr(noisy, clean)),
            "it0": float(psnr(dn0, clean_t)), "self": (b1s, b2s),
            "self_K": K0, "self_sig": s0,
            "fit": fit, "mad": mad, "comb": (b1c, b2c),
            "it1": {tag: {"K": K, "sig": sig,
                          "psnr": float(psnr(denoise(K, sig), clean_t))}
                    for tag, (K, sig) in cands.items()}}


def run(args, scenes: Optional[Dict] = None, den=None) -> dict:
    """-> {scene: row}; scenes: eval_synth.run's scene dict keyed (name,
    None), reused and filled."""
    den = den if den is not None else build_denoiser(args,
                                                     device_of(args.cpu))
    lut = BiasLUT()
    scale = float(WP - BL)
    specs = {s.name: s for s in HELDOUT_SCENES}
    rows = {}
    for name in args.scenes:
        spec = specs[name]
        clean, noisy = get_scene(spec, scenes)
        r = rows[name] = scene_row(den, lut, spec, clean, noisy)
        log(f"== {name}: true K={spec.K} sig={spec.sigma} "
            f"noisy={r['noisy']:.2f} it0={r['it0']:.2f} "
            f"(self K={r['self_K']:.2f} sig={r['self_sig']:.2f})")
        for tag, (b1, b2) in (("fit ", r["fit"]), ("mad ", r["mad"]),
                              ("comb", r["comb"])):
            log(f"   collab {tag} K={b1 * scale:7.3f} b2={b2:.3e}")
        for tag, c in r["it1"].items():
            log(f"   it1[{tag:6s}] K={c['K']:7.3f} sig={c['sig']:7.3f} "
                f"psnr={c['psnr']:.2f} ({c['psnr'] - r['it0']:+.2f} vs it0)")
    return rows


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
