"""`python -m yondx_torch.cli.probe_sigma_corr_blind`: the blind-signal
probe behind the adaptive guidance scale (port of
scripts/probe_sigma_corr_blind.py, same flags and JSON layout).

    python -m yondx_torch.cli.probe_sigma_corr_blind [--cpu]
        [--scenes NAME ...] [--corrs C ...] [--out F]

For each held-out scene (default: the 33 scenes of suite v2 at size 512)
it sweeps the guidance scale sigma_corr over --corrs in the product's
denoiser (robust self-NLE estimate, pre bias correction, bucket refine
with the oriented shrink, the gru32 flagship) and records the best corr
beside the blind predictors the pipeline already computes:

- mad_ratio   sqrt(MAD-based variance / fit-based variance) at the
              scene's mean intensity: < 1 flags a content-inflated fit;
- clip_lo/hi  the fraction of RGGB values below 0.02 / above 0.98;
- nsr         the VST normalisation width (a noise-level proxy);

plus `adaptive_corr`, the value pipeline/denoiser.py's
adaptive_corr_from_stats picks for the scene (the rule these rows set).
Runs on the GPU ("cuda"; it raises when there is none) unless --cpu is
given. The record goes to --out (default sigma_corr_blind.json in the
working directory), never into docs/ unless asked.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..core.logging import log
from ..eval.heldout import BL, SUITES, WP, build_scene
from ..eval.metrics import psnr
from ..io.ckpt import find_checkpoint
from ..isp.bayer import bayer2rggb
from ..models.unets import GRU32_ARCH, load_model
from ..nle.robust import mad_self_estimate
from ..pipeline.denoiser import VSTDenoiser, adaptive_sigma_corr
from ..pipeline.engine import PipelineConfig, YONDEngine
from ..vst.lut import BiasLUT
from ..vst.vst import vst

CORRS = [0.85, 0.90, 0.95, 1.00, 1.03, 1.08, 1.15, 1.25]


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", nargs="+", default=None,
                    help="default: every v2 scene of size 512")
    ap.add_argument("--model", default="Gaussian_GRU_mix_1to50c_norm")
    ap.add_argument("--ckpt-dir", default="checkpoints/Gaussian")
    ap.add_argument("--corrs", nargs="+", type=float, default=list(CORRS))
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU)")
    ap.add_argument("--out", default="sigma_corr_blind.json")
    return ap


def parse_args(argv=None):
    args = build_parser().parse_args(argv)
    args.device = "cpu" if args.cpu else "cuda"
    return args


def build_engine(args) -> YONDEngine:
    """The product's denoiser with the flagship of --model (guidance
    given per call) under an engine that only estimates (max_iter 0)."""
    ck = find_checkpoint(args.ckpt_dir, args.model)
    if ck is None:
        raise FileNotFoundError(f"no checkpoint {args.model} under "
                                f"{args.ckpt_dir!r}")
    model = load_model(GRU32_ARCH, ck, device=args.device)
    den = VSTDenoiser(model, guided=True, bias_corr="pre", vst_type="exact",
                      refine=True, refine_floor="bucket", device=args.device)
    return YONDEngine(den, PipelineConfig(est_type="simple", max_iter=0),
                      biaslut=BiasLUT())


def blind_signals(eng, noisy) -> dict:
    """The product's self estimate of a scene and the blind predictors:
    K_est, sigma_est (DN), mad_ratio, clip_lo, clip_hi, nsr and the
    adaptive rule's corr."""
    scale = float(WP - BL)
    fit = eng._estimate_self(noisy)
    K = max(fit[0], 1e-4 / scale) * scale
    sig = float(np.sqrt(max(fit[1], 0.0))) * scale
    rggb = bayer2rggb(torch.as_tensor(noisy, dtype=torch.float32,
                                      device=eng.device))
    mu = float(torch.mean(torch.clamp(rggb, 0.0, 1.0)))
    mad = mad_self_estimate(rggb)
    v_fit = fit[0] * mu + fit[1]
    v_mad = float(mad[0]) * mu + float(mad[1])
    zero = torch.zeros((), device=eng.device)
    lower = float(vst(zero, sig, gain=K))
    upper = float(vst(zero + scale, sig, gain=K))
    return {"K_est": K, "sigma_est": sig,
            "mad_ratio": float(np.sqrt(max(v_mad, 0.0) / max(v_fit, 1e-30))),
            "clip_lo": float(torch.mean((rggb < 0.02).float())),
            "clip_hi": float(torch.mean((rggb > 0.98).float())),
            "nsr": 1.0 / (upper - lower),
            "adaptive_corr": float(adaptive_sigma_corr(
                rggb, torch.tensor(K, device=eng.device),
                torch.tensor(sig, device=eng.device),
                torch.tensor(scale, device=eng.device)))}


def probe_row(eng, spec, clean, noisy, corrs) -> dict:
    """One scene: its blind signals and the PSNR at each corr (corrs
    holds 1.03, the fixed default the gain is measured against)."""
    s = blind_signals(eng, noisy)
    curve = eng.biaslut.curve(s["K_est"], s["sigma_est"])
    clean_t = torch.as_tensor(clean, device=eng.device)
    psnrs = []
    for corr in corrs:
        dn, _ = eng.denoiser.denoise_pair(noisy, curve, s["K_est"],
                                          s["sigma_est"], float(WP - BL),
                                          corr=corr)
        psnrs.append(float(psnr(dn, clean_t)))
    best_i = int(np.argmax(psnrs))
    row = {"scene": spec.name, "kind": spec.kind,
           "K_true": spec.K, "sigma_true": spec.sigma,
           **{k: s[k] for k in ("K_est", "sigma_est", "mad_ratio",
                                "clip_lo", "clip_hi", "nsr")},
           "corrs": list(corrs), "psnrs": psnrs,
           "best_corr": corrs[best_i],
           "gain_vs_103": psnrs[best_i] - psnrs[corrs.index(1.03)],
           "adaptive_corr": s["adaptive_corr"]}
    return row


def run(args, scenes: Optional[Dict] = None, engine=None) -> dict:
    """The probe of parsed `args` -> {'model', 'rows'}, written to
    args.out. scenes: built held-out scenes keyed (name, None), as
    eval_synth.run's, reused and filled."""
    eng = engine if engine is not None else build_engine(args)
    specs = {s.name: s for s in SUITES["v2"]}
    names = args.scenes or [s.name for s in SUITES["v2"] if s.size == 512]
    rows = []
    for name in names:
        key = (name, None)
        if scenes is not None and key in scenes:
            clean, noisy = scenes[key]
        else:
            clean, noisy = build_scene(specs[name])
            if scenes is not None:
                scenes[key] = (clean, noisy)
        r = probe_row(eng, specs[name], clean, noisy, args.corrs)
        rows.append(r)
        log(f"{name:13s} best={r['best_corr']:.2f} "
            f"(+{r['gain_vs_103']:.2f} dB vs 1.03) "
            f"adaptive={r['adaptive_corr']:.2f} "
            f"mad_ratio={r['mad_ratio']:.2f} clip=({r['clip_lo']:.2f},"
            f"{r['clip_hi']:.2f}) nsr={r['nsr']:.4f}")
    out = {"model": args.model, "rows": rows}
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    log(f"wrote {args.out}")
    return out


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
