"""`python -m yondx_torch.cli.probe_sigma_corr [--scenes ...] [--model M]
[--arch A] [--nf N] [--corrs C ...] [--cpu]`: the guidance scale
sigma_corr swept at the TRUE (K, sigma) (port of
scripts/probe_sigma_corr.py).

Each scene of suite v2 is denoised once per corr (pre bias correction,
exact VST, no refine) at its frozen true noise model, so the argmax is
the calibrated guidance gain of the checkpoint (the reference's fixed
value is 1.03). Prints a PSNR row per scene with its best corr, then the
median best corr. `--arch GuidedResUnetS2D` builds the S2D net (out_k 3,
nf 64; tail_nf 16 for an S2DT model). No NLE: K1 does not run.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

from ..eval.heldout import BL, SUITES, WP
from ..eval.metrics import psnr
from ..pipeline.denoiser import VSTDenoiser
from ..vst.lut import BiasLUT
from .probe_common import device_of, get_scene, guided_arch, load_net

SCENES = ["radial_mid", "satdisk_mid", "voronoi_mid", "zone_mid",
          "bubbles_mid", "glyphs_mid", "ramp_mid", "chart_anchor"]
CORRS = [0.90, 0.95, 1.00, 1.03, 1.06, 1.10, 1.15, 1.25]


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", nargs="+", default=list(SCENES))
    ap.add_argument("--model", default="Gaussian_GRU_mix_1to50c_norm")
    ap.add_argument("--arch", default="GuidedResUnet")
    ap.add_argument("--nf", type=int, default=32)
    ap.add_argument("--corrs", nargs="+", type=float, default=list(CORRS))
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU)")
    return ap


def build_denoiser(args, device) -> VSTDenoiser:
    arch = guided_arch(args.arch, args.nf)
    if args.arch == "GuidedResUnetS2D":
        arch.update(out_k=3, nf=64)
        if "S2DT" in args.model:
            arch["tail_nf"] = 16
    return VSTDenoiser(load_net(arch, args.model, device), guided=True,
                       bias_corr="pre", vst_type="exact", device=device)


def scene_row(den, lut, spec, clean, noisy, corrs) -> list:
    """PSNR of one scene at each corr, at its true (K, sigma)."""
    curve = lut.curve(spec.K, spec.sigma)
    clean_t = torch.as_tensor(clean, device=den.device)
    return [float(psnr(den.denoise_pair(noisy, curve, spec.K, spec.sigma,
                                        float(WP - BL), corr=c)[0],
                       clean_t)) for c in corrs]


def run(args, scenes: Optional[Dict] = None, den=None) -> dict:
    """-> {'rows': {scene: [PSNR per corr]}, 'best': {scene: corr},
    'median_best': float}; scenes: eval_synth.run's scene dict keyed
    (name, None), reused and filled."""
    den = den if den is not None else build_denoiser(args,
                                                     device_of(args.cpu))
    lut = BiasLUT()
    specs = {s.name: s for s in SUITES["v2"]}
    print(f"{'scene':13s} " + " ".join(f"sc={c:5.2f}" for c in args.corrs),
          flush=True)
    rows, best = {}, {}
    for name in args.scenes:
        clean, noisy = get_scene(specs[name], scenes)
        row = rows[name] = scene_row(den, lut, specs[name], clean, noisy,
                                     args.corrs)
        best[name] = args.corrs[int(np.argmax(row))]
        print(f"{name:13s} " + " ".join(f"{v:8.3f}" for v in row)
              + f"   best={best[name]:.2f}", flush=True)
    med = float(np.median(list(best.values())))
    print(f"median best sigma_corr over scenes: {med:.3f}", flush=True)
    return {"rows": rows, "best": best, "median_best": med}


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
