"""`python -m yondx_torch.cli.probe_s2d_phase [--scenes ...] [--cpu]`: where
the packed S2D net loses PSNR against the flagship (port of
scripts/probe_s2d_phase.py).

One crop of each held-out scene through the gru32 flagship and the S2D
net (GuidedResUnetS2D nf 64, out_k 3: Gaussian_GRUS2D3_mix_1to50c_norm)
at the TRUE (K, sigma), pre bias correction, exact VST, no refine. The
error e = dn - clean of each is split into its per-2x2-phase means, the
energy of its 2x2 cell means (low) and of the disagreement within each
cell (grid); then the S2D output's PSNR with the flagship's within-cell
part grafted in isolates what the phase disagreement costs. No NLE: K1
does not run.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np

from ..core.logging import log
from ..eval.heldout import BL, HELDOUT_SCENES, WP
from ..eval.metrics import psnr
from ..pipeline.denoiser import VSTDenoiser
from ..vst.lut import BiasLUT
from .probe_common import device_of, get_scene, guided_arch, load_net

SCENES = ["ramp_mid", "bubbles_mid", "ramp_lo", "voronoi_mid", "glyphs_mid"]
NETS = (("flag", guided_arch("GuidedResUnet", 32),
         "Gaussian_GRU_mix_1to50c_norm"),
        ("s2d", guided_arch("GuidedResUnetS2D", 64, out_k=3),
         "Gaussian_GRUS2D3_mix_1to50c_norm"))


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", nargs="+", default=list(SCENES))
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU)")
    return ap


def build_denoisers(device) -> dict:
    return {tag: VSTDenoiser(load_net(arch, model, device), guided=True,
                             bias_corr="pre", vst_type="exact",
                             device=device)
            for tag, arch, model in NETS}


def phase_stats(err):
    """err: [H, W] bayer-domain error -> (per-phase means, low MSE, grid
    MSE)."""
    ph = [err[i::2, j::2] for i in (0, 1) for j in (0, 1)]
    means = [float(p.mean()) for p in ph]
    cells = np.stack(ph, axis=-1)                # [H/2, W/2, 4]
    cell_mean = cells.mean(-1, keepdims=True)
    grid = cells - cell_mean                     # within-cell disagreement
    return means, float((cell_mean ** 2).mean()), float((grid ** 2).mean())


def scene_row(dens, lut, spec, clean, noisy) -> dict:
    """One crop through both nets -> each net's PSNR and error split, and
    the S2D output's PSNR with the flagship's grid part."""
    curve = lut.curve(spec.K, spec.sigma)
    outs = {tag: den(noisy[None], curve, spec.K, spec.sigma,
                     float(WP - BL))[0].cpu().numpy()
            for tag, den in dens.items()}
    row = {"noisy": float(psnr(noisy, clean))}
    for tag, dn in outs.items():
        means, e_low, e_grid = phase_stats(dn - clean)
        row[tag] = {"psnr": float(psnr(dn, clean)), "phase_means": means,
                    "low_mse": e_low, "grid_mse": e_grid,
                    "grid_share": e_grid / (e_low + e_grid + 1e-30)}
    # keep the s2d cell means, graft the flagship's within-cell part
    e, d = outs["s2d"] - clean, outs["flag"] - clean
    ec = np.stack([e[i::2, j::2] for i in (0, 1) for j in (0, 1)], -1)
    dc = np.stack([d[i::2, j::2] for i in (0, 1) for j in (0, 1)], -1)
    hyb = ec.mean(-1, keepdims=True) + (dc - dc.mean(-1, keepdims=True))
    row["s2d_flag_grid"] = float(-10 * np.log10(float((hyb ** 2).mean())))
    return row


def run(args, scenes: Optional[Dict] = None, dens=None) -> dict:
    """-> {scene: row}; scenes: a scene dict keyed (name, 1) (one crop),
    reused and filled."""
    dens = dens if dens is not None else build_denoisers(device_of(args.cpu))
    lut = BiasLUT()
    specs = {s.name: s for s in HELDOUT_SCENES}
    rows = {}
    for name in args.scenes:
        spec = specs[name]
        clean, noisy = get_scene(spec, scenes, n_crops=1)
        r = rows[name] = scene_row(dens, lut, spec, clean[0], noisy[0])
        log(f"== {name} (K={spec.K}, sigma={spec.sigma}) "
            f"noisy={r['noisy']:.2f}")
        for tag in dens:
            s = r[tag]
            log(f"  {tag:5s} psnr={s['psnr']:6.2f}  phase_means="
                + " ".join(f"{m:+.2e}" for m in s["phase_means"])
                + f"  low_mse={s['low_mse']:.3e} grid_mse={s['grid_mse']:.3e} "
                f"grid_share={s['grid_share']:.2f}")
        log(f"  s2d with flag's grid part: psnr={r['s2d_flag_grid']:6.2f}"
            f"  (isolates the within-cell disagreement cost)")
    return rows


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
