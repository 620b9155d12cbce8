"""`python -m yondx_torch.cli.probe_underest_scene [--cpu]`: does clipped-dark
content make the product's SELF noise estimate under-estimate? (port of
scripts/probe_underest_scene.py)

Four darkfields (near-black fields with a few bright flat rectangles, PG
noise clipped at the sensor floor, numpy seeds as the script's) through
the self estimator alone: the k = 29 / inner = 19 box moments (K1 on a
CUDA tensor, once a scene), the flat-mask line fit (pipeline/fused.py
_nlf_core), the wavelet-MAD estimate and their combination. Prints the
true (beta1, beta2), the fit, the MAD, the combined estimate and
v_est / v_true at the frame's mean: below 1 is the under-estimate regime
the rescue policy exists for.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..nle.moments import nle_moments
from ..nle.robust import combine_estimates, mad_self_estimate
from ..pipeline.fused import _nlf_core
from .probe_common import device_of, rggb_of

WP, BL = 1023, 64
SCALE = WP - BL
# name, darkfield seed, bright fraction, K, sigma
CASES = (("darkfield15", 1, .15, 3.0, 14.0),
         ("darkfield08", 2, .08, 3.0, 14.0),
         ("darkfield30", 3, .30, 3.0, 14.0),
         ("darkfield_hiK", 4, .12, 16.0, 10.0))


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU)")
    return ap


def synth_noisy(clean, K, sigma, rng):
    electrons = np.clip(clean, 0, 1) * SCALE / K
    noisy = (K * rng.poisson(electrons)
             + rng.normal(0, sigma, clean.shape)) / SCALE
    return np.clip(noisy, 0, 1).astype(np.float32)


def darkfield(rng, S=512, bright_frac=0.15, lev=0.45):
    """Near-black field with a few bright flat rectangles (most flat
    windows ride the sensor floor)."""
    img = np.full((S, S), 0.004, np.float32)
    area = 0.0
    tries = 0
    while area < bright_frac and tries < 50:
        h, w = rng.integers(40, 120, 2)
        y, x = rng.integers(0, S - h), rng.integers(0, S - w)
        img[y:y + h, x:x + w] = lev * (0.6 + 0.8 * rng.random())
        area = float((img > 0.1).mean())
        tries += 1
    return img


def self_estimate(noisy_bayer, device):
    """The product's robust self NLE, from the fused path's pieces ->
    (fit, mad, combined) (beta1, beta2) pairs."""
    x = rggb_of(noisy_bayer[None], device)
    k = 29
    inner = k // 3 * 2 + 1
    mean, var, tex = nle_moments(x, k, inner)
    fit = _nlf_core(var, mean, tex, 5)
    mad = mad_self_estimate(x)
    comb = combine_estimates(fit, mad, torch.mean(torch.clamp(x, 0, 1)))
    return tuple(tuple(float(v) for v in e) for e in (fit, mad, comb))


def scenes():
    """-> [(name, K, sigma, noisy)] of CASES (numpy seeds as the
    script's)."""
    rng = np.random.default_rng(7)
    return [(name, K, sigma,
             synth_noisy(darkfield(np.random.default_rng(seed),
                                   bright_frac=bf), K, sigma, rng))
            for name, seed, bf, K, sigma in CASES]


def run(args) -> dict:
    """-> {name: row} over CASES."""
    dev = device_of(args.cpu)
    rows = {}
    for name, K, sigma, noisy in scenes():
        fit, mad, comb = self_estimate(noisy, dev)
        b1t, b2t = K / SCALE, (sigma / SCALE) ** 2
        mu = float(np.mean(np.clip(noisy, 0, 1)))
        v_true = b1t * mu + b2t
        v_est = comb[0] * mu + comb[1]
        rows[name] = {"K": K, "sigma": sigma, "true": (b1t, b2t),
                      "fit": fit, "mad": mad, "comb": comb,
                      "ratio": v_est / v_true}
        print(f"{name:14s} K={K:5.1f} sg={sigma:5.1f} "
              f"true(b1,b2)=({b1t:.2e},{b2t:.2e}) "
              f"fit=({fit[0]:.2e},{fit[1]:.2e}) "
              f"mad=({mad[0]:.2e},{mad[1]:.2e}) "
              f"comb=({comb[0]:.2e},{comb[1]:.2e}) "
              f"v_est/v_true={v_est / v_true:.3f}", flush=True)
    return rows


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
