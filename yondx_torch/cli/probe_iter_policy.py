"""`python -m yondx_torch.cli.probe_iter_policy [--scenes ...] [--model M]
[--cpu]`: which second-round rule beats round 0? (port of
scripts/probe_iter_policy.py)

The gru32 flagship with pre bias correction, the exact VST and the
Wiener refine on its 'local' floor. Per held-out scene: round 0 at the
robust self estimate (it0), the robust collab re-estimate on the raw
round-0 output, then round 1 under each policy:
  collab   the second pass at the collab estimate;
  true     the second pass at the scene's true (K, sigma) (an oracle);
  avg      0.5 it0 + 0.5 collab;
  wavg     it0 when self and collab agree to 3%, else avg;
  tboost   the second pass at collab (K, 1.05 sigma);
  avg_tb   0.5 it0 + 0.5 tboost.
Prints each scene's deltas to it0, then each policy's mean delta over
all scenes and the '_mid' scenes, and its worst delta. K1 runs three
times a scene (self 1, collab 2).
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

from ..core.logging import log
from ..eval.heldout import BL, HELDOUT_SCENES, WP
from ..eval.metrics import psnr
from ..nle.robust import collab_nlf_robust, self_nlf_robust
from ..pipeline.denoiser import VSTDenoiser
from ..vst.lut import BiasLUT
from .probe_common import device_of, get_scene, guided_arch, load_net, \
    rggb_of

SCENES = ["voronoi_mid", "radial_mid", "zone_mid", "glyphs_mid",
          "bubbles_mid", "ramp_mid", "satdisk_mid", "chart_anchor",
          "glyphs_lo", "zone_lo"]
POLICIES = ("collab", "true", "avg", "wavg", "tboost", "avg_tb")


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", nargs="+", default=list(SCENES))
    ap.add_argument("--model", default="Gaussian_GRU_mix_1to50c_norm")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU)")
    return ap


def build_denoiser(model: str, device) -> VSTDenoiser:
    return VSTDenoiser(load_net(guided_arch(), model, device), guided=True,
                       bias_corr="pre", vst_type="exact", refine=True,
                       refine_floor="local", device=device)


def scene_row(den, lut, spec, clean, noisy) -> dict:
    """One scene: noisy and it0 PSNR, the self/collab agreement and the
    PSNR under each policy."""
    scale = float(WP - BL)

    def denoise(K, sigma):
        """-> (refined output, raw net output); collab NLE sees the raw
        one (the engine's contract)."""
        curve = lut.curve(max(K, 1e-4), sigma)
        return den.denoise_pair(noisy, curve, max(K, 1e-4), sigma, scale)

    rggb = rggb_of(noisy, den.device)
    b1s, b2s = (float(v) for v in self_nlf_robust(rggb, k=29))
    K0, s0 = b1s * scale, float(np.sqrt(max(b2s, 0.0))) * scale
    dn0, dn0_raw = denoise(K0, s0)
    b1c, b2c = (float(v) for v in collab_nlf_robust(
        rggb, rggb_of(dn0_raw, den.device), k=29, self_reg=(b1s, b2s)))
    Kc = b1c * scale
    sc = float(np.sqrt(max(b2c, 0.0))) * scale
    dn_c, _ = denoise(Kc, sc)
    dn_t, _ = denoise(spec.K, spec.sigma)
    dn_tb, _ = denoise(Kc, sc * 1.05)
    # self/collab agreement: total variance at the raw proxy's mean
    mu = float(torch.mean(dn0_raw))
    v_self = b1s * mu + b2s
    v_col = b1c * mu + b2c
    agree = abs(v_col - v_self) / max(v_self, 1e-12)
    pols = {"collab": dn_c, "true": dn_t, "avg": 0.5 * dn0 + 0.5 * dn_c,
            "wavg": dn0 if agree < 0.03 else 0.5 * dn0 + 0.5 * dn_c,
            "tboost": dn_tb, "avg_tb": 0.5 * dn0 + 0.5 * dn_tb}
    clean_t = torch.as_tensor(clean, device=den.device)
    row = {"noisy": float(psnr(noisy, clean)),
           "it0": float(psnr(dn0, clean_t)), "agree": agree,
           "self": (b1s, b2s), "collab_reg": (b1c, b2c)}
    for tag, dn in pols.items():
        row[tag] = float(psnr(dn, clean_t))
    return row


def summary(table: Dict[str, dict]) -> dict:
    mids = [n for n in table if n.endswith("_mid")]
    out = {}
    for tag in POLICIES:
        d_all = [table[n][tag] - table[n]["it0"] for n in table]
        d_mid = [table[n][tag] - table[n]["it0"] for n in mids]
        out[tag] = {"all": float(np.mean(d_all)),
                    "mid": float(np.mean(d_mid)), "min": float(np.min(d_all))}
        log(f"policy {tag:7s} mean_delta all={out[tag]['all']:+.3f} "
            f"mid={out[tag]['mid']:+.3f} min={out[tag]['min']:+.3f}")
    return out


def run(args, scenes: Optional[Dict] = None, den=None) -> dict:
    """-> {'rows': {scene: row}, 'summary': {policy: deltas}}; scenes:
    eval_synth.run's scene dict keyed (name, None), reused and filled."""
    den = den if den is not None else build_denoiser(
        args.model, device_of(args.cpu))
    lut = BiasLUT()
    specs = {s.name: s for s in HELDOUT_SCENES}
    table = {}
    for name in args.scenes:
        clean, noisy = get_scene(specs[name], scenes)
        row = table[name] = scene_row(den, lut, specs[name], clean, noisy)
        log(f"{name:13s} noisy={row['noisy']:6.2f} it0={row['it0']:6.2f} "
            f"agree={row['agree']:5.3f} | " + " ".join(
                f"{t}={row[t] - row['it0']:+.2f}" for t in POLICIES))
    return {"rows": table, "summary": summary(table)}


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
