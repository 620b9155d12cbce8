"""`python -m yondx_torch.cli.probe_underest_e2e [--arch gru32] [--cpu]`: the
product engine on clipped-dark content (port of
scripts/probe_underest_e2e.py).

The gru32 flagship (Gaussian_GRU_mix_1to50c_norm) in bf16 with the bucket
refine under YONDEngine (est_type simple, robust NLE, rescue policy,
max_iter 1) on four darkfields: prints noisy / it0 / it1 PSNR, the self,
collab and true (beta1, beta2), and whether the rescue fired. K1 runs
three times a scene (self 1, collab 2). Complements
cli/probe_underest_scene.py (the estimator alone).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..eval.metrics import psnr
from ..pipeline.denoiser import VSTDenoiser
from ..pipeline.engine import PipelineConfig, YONDEngine
from ..vst.lut import BiasLUT
from .probe_common import device_of, guided_arch, load_net

WP, BL = 1023, 64
SCALE = WP - BL
MODEL = "Gaussian_GRU_mix_1to50c_norm"
DTYPE = torch.bfloat16      # the net's weights and compute
# name, darkfield seed, bright fraction, K, sigma
CASES = (("darkclip_a", 3, 0.30, 3.0, 14.0),
         ("darkclip_b", 5, 0.25, 2.0, 20.0),
         ("darkclip_c", 9, 0.35, 4.0, 18.0),
         ("darkclip_d", 11, 0.20, 2.5, 24.0))


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gru32", choices=["gru32"])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU)")
    return ap


def darkfield(rng, S=512, bright_frac=0.3, lev=0.45):
    img = np.full((S, S), 0.004, np.float32)
    area, tries = 0.0, 0
    while area < bright_frac and tries < 80:
        h, w = rng.integers(40, 140, 2)
        y, x = rng.integers(0, S - h), rng.integers(0, S - w)
        img[y:y + h, x:x + w] = lev * (0.6 + 0.8 * rng.random())
        area = float((img > 0.1).mean())
        tries += 1
    return img


def scenes():
    """-> [(name, K, sigma, clean, noisy)] of CASES (numpy seeds as the
    script's)."""
    rng = np.random.default_rng(7)
    out = []
    for name, seed, bf, K, sigma in CASES:
        clean = darkfield(np.random.default_rng(seed), bright_frac=bf)
        electrons = np.clip(clean, 0, 1) * SCALE / K
        noisy = np.clip((K * rng.poisson(electrons)
                         + rng.normal(0, sigma, clean.shape)) / SCALE,
                        0, 1).astype(np.float32)
        out.append((name, K, sigma, clean, noisy))
    return out


def build_engine(device, dtype=DTYPE) -> YONDEngine:
    model = load_net(guided_arch(), MODEL, device, dtype)
    den = VSTDenoiser(model, guided=True, bias_corr="pre", vst_type="exact",
                      refine=True, refine_floor="bucket",
                      compute_dtype=None if dtype == torch.float32
                      else dtype, device=device)
    return YONDEngine(den, PipelineConfig(est_type="simple", max_iter=1),
                      biaslut=BiasLUT())


def scene_row(eng, K, sigma, clean, noisy) -> dict:
    p = {"wp": WP, "bl": BL, "ratio": 1, "scale": float(SCALE),
         "gain": 1.0, "sigma": 0.0}
    res = eng.iter_denoise({"lr": noisy}, p)
    return {"noisy": float(psnr(noisy, clean)),
            "it0": float(psnr(res["raw_dns"][0], clean)),
            "it1": float(psnr(res["raw_dns"][-1], clean)),
            "self": tuple(res["regs"][0]), "collab": tuple(res["regs"][-1]),
            "true": (K / SCALE, (sigma / SCALE) ** 2),
            "fired": res["signals"][0]["fired"]}


def run(args, engine=None) -> dict:
    """-> {name: row} over CASES."""
    eng = engine if engine is not None else build_engine(device_of(args.cpu))
    rows = {}
    for name, K, sigma, clean, noisy in scenes():
        r = rows[name] = scene_row(eng, K, sigma, clean, noisy)
        r0, r1, rt = r["self"], r["collab"], r["true"]
        print(f"{name} K={K} sg={sigma}: noisy {r['noisy']:.2f} it0 "
              f"{r['it0']:.2f} it1 {r['it1']:.2f} "
              f"(d={r['it1'] - r['it0']:+.2f}) | "
              f"self=({r0[0]:.2e},{r0[1]:.2e}) "
              f"collab=({r1[0]:.2e},{r1[1]:.2e}) "
              f"true=({rt[0]:.2e},{rt[1]:.2e}) "
              f"rescue={'fired' if r['fired'] else 'held'}", flush=True)
    return rows


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
