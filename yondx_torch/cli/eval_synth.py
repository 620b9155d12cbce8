"""`python -m yondx_torch.cli.eval_synth`: the data-free quality gate on
the GPU (port of scripts/eval_synth.py).

    python -m yondx_torch.cli.eval_synth --heldout --suite v3 \
        --refine bucket --shrink on --json out.json

With --heldout it runs the frozen generator-disjoint suites of
eval/heldout.py (v1, v2, v3) through the full iterative engine and
writes eval_synth.py's JSON layout, so the file diffs against the
committed docs/heldout/*.json. Without it, N ad-hoc scenes of 8 Bayer
crops (flat-patch or texture content) with Poisson-Gaussian noise at a
random (K, sigma) report per-iteration PSNR / SSIM. Same flags,
choices and defaults as the JAX script, plus --device ("cuda" by
default; --cpu means --device cpu). A missing checkpoint raises, where
the JAX script runs random weights.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..core.logging import log
from ..core.rng import PRNGKey
from ..data.datasets import SyntheticSRGBDataset
from ..data.unprocess import srgb_to_pseudo_raw
from ..eval.metrics import matlab_ssim, psnr
from ..io.ckpt import find_checkpoint
from ..isp.bayer import rggb2bayer
from ..models.unets import load_model
from ..pipeline.denoiser import BM3DVSTDenoiser, VSTDenoiser
from ..pipeline.engine import PipelineConfig, YONDEngine
from ..pipeline.estnet import EstNet
from ..vst.lut import BiasLUT

EST_ARCH = {"name": "est_UNet", "in_nc": 4, "out_nc": 2, "nf": 16,
            "depth": 3}


def make_scene(i, n_crops=8, wp=1023, bl=64, rng=None, content="flat"):
    """n_crops clean bayer crops + PG noise at a scene-level (K, sigma).

    content='flat': SIDD-like scenes dominated by flat regions.
    content='texture': procedural multi-octave scenes with gradient
    energy at every scale (data/datasets.py SyntheticSRGBDataset).
    Returns (clean [n, 512, 512], noisy, K, sigma).
    """
    rng = rng or np.random.default_rng(1000 + i)
    if content == "flat":
        S = 512
        imgs = np.zeros((n_crops, S, S, 3), np.float32)
        for n in range(n_crops):
            img = np.ones((S, S, 3), np.float32) * rng.random(3)
            for _ in range(rng.integers(6, 14)):  # big flat patches
                y0, x0 = rng.integers(0, S - 32, 2)
                h, w = rng.integers(S // 8, S // 2, 2)
                img[y0:y0 + h, x0:x0 + w] = rng.random(3)
            if rng.random() < 0.5:                # one textured region
                y0, x0 = rng.integers(0, S // 2, 2)
                t = int(rng.integers(S // 8, S // 4))
                img[y0:y0 + t, x0:x0 + t] *= rng.random((t, t, 1)) * 0.5 + 0.5
            imgs[n] = np.clip(img * (0.4 + rng.random() * 0.6), 0, 1)
    else:
        ds = SyntheticSRGBDataset(length=n_crops, size=512, seed=31 * i + 7)
        imgs = np.stack([ds[j] for j in range(n_crops)]).astype(np.float32)
        if imgs.max() > 1.5:
            imgs = imgs / 255.0
    rggb, _, _, _ = srgb_to_pseudo_raw(PRNGKey(i), imgs,
                                       bayer_aug_enabled=False)
    clean = rggb2bayer(rggb).numpy()  # [n, 512, 512]
    scale = wp - bl
    # SIDD-like noise range: input PSNR roughly 22-34 dB
    K = float(np.exp(rng.uniform(np.log(2.0), np.log(24.0))))
    sigma = float(K * np.exp(rng.uniform(np.log(0.5), np.log(3.0))))
    electrons = np.clip(clean, 0, 1) * scale / K
    noisy = (K * rng.poisson(electrons) +
             rng.normal(0, sigma, clean.shape)) / scale
    return clean, np.clip(noisy, 0, 1).astype(np.float32), K, sigma


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", type=int, default=10)
    ap.add_argument("--nf", type=int, default=32)
    ap.add_argument("--arch", default="GuidedResUnet",
                    help="arch name (e.g. GuidedResUnetS2D with --nf 64)")
    ap.add_argument("--model", default="Gaussian_GRU_mix_5to50_norm")
    ap.add_argument("--ckpt-dir", default="checkpoints/Gaussian")
    ap.add_argument("--out-k", type=int, default=None,
                    help="conv_out kernel size override (S2D archs)")
    ap.add_argument("--tail-nf", type=int, default=None,
                    help="full-res tail width (S2D tail variant)")
    ap.add_argument("--bf16", action="store_true",
                    help="run the net in bfloat16")
    ap.add_argument("--cpu", action="store_true",
                    help="same as --device cpu")
    ap.add_argument("--device", default="cuda",
                    help="torch device the pipeline runs on")
    ap.add_argument("--content", default="flat",
                    choices=["flat", "texture"])
    ap.add_argument("--heldout", action="store_true",
                    help="run the frozen generator-disjoint suite "
                         "(eval/heldout.py) instead of ad-hoc scenes")
    ap.add_argument("--suite", default="v1", choices=["v1", "v2", "v3"],
                    help="held-out suite version: v1 = the 15 round-3 "
                         "scenes, v2 = 36 scenes incl. second seeds, "
                         "high-noise band and a 1024-px tier, v3 = v2 + "
                         "the frozen photographic class")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="with --heldout: also dump the per-scene rows + "
                         "summary as JSON")
    ap.add_argument("--est", default="robust",
                    choices=["robust", "simple", "pge"],
                    help="round-1 estimator: 'robust' = flat-mask fit + "
                         "wavelet-MAD cross-check, 'simple' = plain "
                         "flat-mask fit, 'pge' = the est_UNet scalar net "
                         "(EstPGE_d3nf16 checkpoint)")
    ap.add_argument("--refine", default=None,
                    choices=["local", "fixed", "bucket"],
                    help="method-noise Wiener refinement with the given "
                         "noise floor")
    ap.add_argument("--shrink", default=None, choices=["on", "off"],
                    help="with --refine: shrink the restored residual in "
                         "the a-trous domain first (default: on whenever "
                         "--refine is given)")
    ap.add_argument("--shrink-full-alpha", type=float, default=1.0,
                    help="alpha above which the ramp hands back the raw "
                         "residual; >= 1.0 = shrink everywhere + full-"
                         "weight coherent-structure restore")
    ap.add_argument("--shrink-lam", type=float, default=1.0,
                    help="a-trous shrink threshold scale")
    ap.add_argument("--shrink-mode", default="oriented",
                    choices=["iso", "oriented"],
                    help="shrink gain: 'iso' = isotropic empirical "
                         "Wiener, 'oriented' = + orientation-coherence "
                         "structure gate")
    ap.add_argument("--sigma-corr", default=None,
                    help="guidance scale: unset = the fixed 1.03, a float "
                         "= that fixed value, 'adaptive' = the measured "
                         "blind rule")
    ap.add_argument("--scene-filter", default=None,
                    help="with --heldout: comma-separated substring "
                         "filter on scene names (probe runs, not a gate)")
    ap.add_argument("--denoiser", default="net", choices=["net", "bm3d"],
                    help="'bm3d' = the host BM3D in VST space")
    return ap


def parse_args(argv=None):
    """Parse and settle --shrink as eval_synth.py does."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if (args.shrink == "on" or args.shrink_lam != 1.0
            or args.shrink_full_alpha != 1.0) and args.refine is None:
        ap.error("--shrink/--shrink-lam/--shrink-full-alpha require "
                 "--refine (they would be silently ignored)")
    args.shrink = (args.shrink == "on") if args.shrink is not None \
        else (args.refine is not None)
    if args.cpu:
        args.device = "cpu"
    return args


def build_denoiser(args):
    """The denoiser of the flags: the host BM3D in VST space with
    --denoiser bm3d, else the VSTDenoiser of the net from the committed
    checkpoint."""
    if args.denoiser == "bm3d":
        log("denoiser: native BM3D (VST space)")
        return BM3DVSTDenoiser(bias_corr="pre", vst_type="exact",
                               device=args.device)
    arch = {"name": args.arch, "guided": True, "in_nc": 4, "out_nc": 4,
            "nf": args.nf, "nframes": 1, "res": True, "norm": True}
    if args.out_k is not None:
        arch["out_k"] = args.out_k
    if args.tail_nf is not None:
        arch["tail_nf"] = args.tail_nf
    ck = find_checkpoint(args.ckpt_dir, args.model)
    if ck is None:
        raise FileNotFoundError(f"no checkpoint {args.model}[_best_model|"
                                f"_last_model].ckpt under "
                                f"{args.ckpt_dir!r}")
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = load_model(arch, ck, device=args.device, dtype=dtype)
    log(f"loaded {ck}")
    sc = args.sigma_corr
    if sc is not None and sc != "adaptive":
        sc = float(sc)
    return VSTDenoiser(model, guided=True, bias_corr="pre",
                       vst_type="exact", refine=args.refine is not None,
                       refine_floor=args.refine or "bucket",
                       refine_shrink=args.shrink,
                       refine_shrink_lam=args.shrink_lam,
                       refine_shrink_full_alpha=args.shrink_full_alpha,
                       refine_shrink_mode=args.shrink_mode, sigma_corr=sc,
                       compute_dtype=dtype if args.bf16 else None,
                       device=args.device)


def build_engine(args, denoiser=None):
    """YONDEngine of the flags: max_iter 1, the --est column."""
    den = denoiser if denoiser is not None else build_denoiser(args)
    est_models, extras, est_type = {}, {}, "simple"
    if args.est == "simple":
        extras["robust_nle"] = False
    elif args.est == "pge":
        est_type = "pge"
        eck = find_checkpoint(args.ckpt_dir, "EstPGE_d3nf16")
        if eck is None:
            raise FileNotFoundError("--est pge needs the EstPGE_d3nf16 "
                                    f"checkpoint under {args.ckpt_dir!r}")
        est_models["est_net"] = EstNet(
            load_model(EST_ARCH, eck, device=args.device), den.device)
    return YONDEngine(den, PipelineConfig(est_type=est_type, max_iter=1,
                                          extras=extras),
                      biaslut=BiasLUT(), est_models=est_models)


def json_record(args, rows):
    """eval_synth.py's --json layout."""
    return {"model": args.model, "arch": args.arch, "refine": args.refine,
            "shrink": args.shrink, "shrink_lam": args.shrink_lam,
            "shrink_full_alpha": args.shrink_full_alpha,
            "shrink_mode": args.shrink_mode, "sigma_corr": args.sigma_corr,
            "suite": args.suite, "est": args.est, "rows": rows}


def run(args, engine=None, scenes=None):
    """Run the gate of parsed `args`; returns the held-out rows (with
    --heldout) or the ad-hoc stats {'noisy', 'psnr', 'ssim'}. scenes:
    an optional dict of built held-out scenes shared between runs."""
    eng = engine if engine is not None else build_engine(args)
    if args.heldout:
        from ..eval.heldout import run_heldout
        flt = args.scene_filter.split(",") if args.scene_filter else None
        rows = run_heldout(eng, suite=args.suite, scene_filter=flt,
                           scenes=scenes)
        if args.json:
            with open(args.json, "w") as f:
                json.dump(json_record(args, rows), f, indent=1)
            log(f"wrote {args.json}")
        return rows

    stats = {0: [], 1: []}
    ssims = {0: [], 1: []}
    noisy_psnr = []
    for i in range(args.scenes):
        clean, noisy, K, sigma = make_scene(i, content=args.content)
        p = {"wp": 1023, "bl": 64, "ratio": 1, "scale": 959.0,
             "gain": 1.0, "sigma": 0.0}
        res = eng.iter_denoise({"lr": noisy}, p)
        noisy_psnr.append(float(psnr(noisy, clean)))
        clean_t = torch.as_tensor(clean, device=eng.device)
        for it, dn in enumerate(res["raw_dns"]):
            dn_t = torch.as_tensor(dn, device=eng.device)
            stats[it].append(float(psnr(dn_t, clean_t)))
            ssims[it].append(float(matlab_ssim(dn_t * 255, clean_t * 255)))
        K_est = res["regs"][0][0] * 959
        log(f"scene {i}: K={K:.2f} est={K_est:.2f} "
            f"noisy={noisy_psnr[-1]:.2f} "
            + " ".join(f"iter{it}={stats[it][-1]:.2f}"
                       for it in stats if stats[it]))
    log(f"noisy PSNR: {np.mean(noisy_psnr):.2f}")
    for it in stats:
        if stats[it]:
            log(f"Iter{it}: PSNR={np.mean(stats[it]):.2f}, "
                f"SSIM={np.mean(ssims[it]):.4f}")
    return {"noisy": noisy_psnr, "psnr": stats, "ssim": ssims}


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
