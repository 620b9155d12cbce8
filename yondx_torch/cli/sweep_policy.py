"""`python -m yondx_torch.cli.sweep_policy`: the rescue policy's threshold
sweep (port of scripts/sweep_policy.py, same flags and JSON layout).

    python -m yondx_torch.cli.sweep_policy [--cpu] [--suite v2] [--out F]
    python -m yondx_torch.cli.sweep_policy --regrid docs/policy_sweep_r5.json

The rescue policy (pipeline/policy.py: DEFAULT_TOL, DEFAULT_FLOOR_FRAC)
gates the product's only iteration behaviour. The sweep measures its
pass/fail landscape over a (tol, floor_frac) grid on two axes:

1. The held-out suite (v2: 36 scenes, the gru32 flagship, the product's
   engine settings), each scene run once with the second pass forced
   (policy 'replace'): the decision signals (agree, the signed collab
   vs self disagreement; frac, the dn0 noise fraction; ffrac, the
   input's noise floor against the self model) beside PSNR(round 0) and
   PSNR(forced round 1). A grid point fires on a scene iff agree > tol
   and ffrac > floor_frac, and scores its forced round-1 PSNR there (an
   upper bound on the shipped blend's effect) and round 0 elsewhere.
2. A fault ladder: a flat-patch 512x512 scene whose self estimate is
   scaled by f in FAULT_LADDER. A grid point is acceptable only if it
   fires on every faulted rung (f < 1) where the forced second pass
   gains more than RESCUE_GAIN_MIN dB; f = 1.0 is the control rung.

A grid point is acceptable when no fire harms a scene by more than 0.1
dB, none takes a scene below its noisy input that round 0 kept above,
and no rung that needs rescue is missed. The process exits nonzero when
(DEFAULT_TOL, DEFAULT_FLOOR_FRAC) is not acceptable.

--regrid recomputes an existing artifact's grid: its hold/fire PSNRs and
agree signals do not depend on the gate, so only each row's ffrac is
computed anew, from the scene and the self NLE alone (no net); it runs
on the CPU, as the JAX script's does. The full sweep runs on the GPU
("cuda"; it raises when there is none) unless --cpu is given. The
record goes to --out (default policy_sweep.json in the working
directory), never into docs/ unless asked.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.logging import log
from ..eval.heldout import BL, SUITES, WP, build_scene
from ..eval.metrics import psnr
from ..io.ckpt import find_checkpoint
from ..isp.bayer import bayer2rggb
from ..models.unets import GRU32_ARCH, load_model
from ..nle.robust import flat_floor_stats, self_nlf_robust
from ..pipeline.denoiser import VSTDenoiser
from ..pipeline.engine import PipelineConfig, YONDEngine
from ..pipeline.policy import DEFAULT_FLOOR_FRAC, DEFAULT_TOL
from ..vst.lut import BiasLUT

TOLS = [0.05, 0.10, 0.15, 0.25, 0.40]
FFS = [1.1, 1.3, 1.5, 2.0, 3.0]               # input_floor_frac gate
FAULT_LADDER = [1.0, 0.5, 0.25, 0.10, 0.04]   # self-estimate K scale
RESCUE_GAIN_MIN = 0.3                          # dB: a rung counts as
#                                                "needs rescue" above this
FAULT_P = {"wp": 1023, "bl": 64, "ratio": 1, "scale": 959.0,
           "gain": 1.0, "sigma": 0.0}
NOTE = ("fire PSNR is the FORCED-replace upper bound on the rescue's "
        "effect; the shipped rescue blends with weight clip((agree-tol)/"
        "(2 tol), 0, 1); gate axis = input_floor_frac (pipeline/policy.py)")


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--suite", default="v2", choices=["v1", "v2", "v3"])
    ap.add_argument("--model", default="Gaussian_GRU_mix_1to50c_norm")
    ap.add_argument("--ckpt-dir", default="checkpoints/Gaussian")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU)")
    ap.add_argument("--regrid", default=None,
                    help="path to an existing sweep artifact: recompute "
                         "ffrac + the grid without re-running the "
                         "denoiser (on the CPU)")
    ap.add_argument("--out", default="policy_sweep.json")
    return ap


def parse_args(argv=None):
    args = build_parser().parse_args(argv)
    args.device = "cpu" if args.cpu or args.regrid else "cuda"
    return args


def build_engine(args, policy: str):
    """The product's engine with the gru32 flagship of --model: pre bias
    correction, exact VST, bucket refine with the oriented shrink, the
    fixed guidance 1.03, robust self NLE, max_iter 1, `policy`."""
    ck = find_checkpoint(args.ckpt_dir, args.model)
    if ck is None:
        raise FileNotFoundError(f"no checkpoint {args.model} under "
                                f"{args.ckpt_dir!r}")
    model = load_model(GRU32_ARCH, ck, device=args.device)
    den = VSTDenoiser(model, guided=True, bias_corr="pre", vst_type="exact",
                      refine=True, refine_floor="bucket", device=args.device)
    return YONDEngine(den, PipelineConfig(
        est_type="simple", max_iter=1, extras={"iter_policy": policy}),
        biaslut=BiasLUT())


def suite_row(eng, spec, clean, noisy) -> dict:
    """One scene through the forced-replace engine -> its signal row."""
    p = {"wp": WP, "bl": BL, "ratio": 1, "scale": float(WP - BL),
         "gain": 1.0, "sigma": 0.0}
    res = eng.iter_denoise({"lr": noisy}, p)
    sig = res["signals"][0] if res["signals"] else None
    return {
        "scene": spec.name, "kind": spec.kind,
        "noisy_psnr": float(psnr(noisy, clean)),
        "psnr_hold": float(psnr(res["raw_dns"][0], clean)),
        "psnr_fire": (float(psnr(res["raw_dns"][1], clean))
                      if len(res["raw_dns"]) > 1 else None),
        "agree": sig["agree"] if sig else None,
        "frac": sig["frac"] if sig else None,
        "ffrac": sig["ffrac"] if sig else None,
    }


def sweep_suite(args, engine=None, scenes: Optional[Dict] = None
                ) -> List[dict]:
    """Forced-second-pass run over the held-out suite -> signal rows.
    scenes: an optional dict of built scenes keyed (name, None), as
    eval_synth.run's, reused and filled."""
    eng = engine if engine is not None else build_engine(args, "replace")
    rows = []
    for spec in SUITES[args.suite]:
        key = (spec.name, None)
        if scenes is not None and key in scenes:
            clean, noisy = scenes[key]
        else:
            clean, noisy = build_scene(spec)
            if scenes is not None:
                scenes[key] = (clean, noisy)
        row = suite_row(eng, spec, clean, noisy)
        rows.append(row)
        log(f"[suite] {spec.name:13s} hold={row['psnr_hold']:6.2f} "
            f"fire={row['psnr_fire'] if row['psnr_fire'] else -1:6.2f} "
            + (f"agree={row['agree']:+.3f} frac={row['frac']:.3f} "
               f"ffrac={row['ffrac']:.3f}" if row["agree"] is not None
               else "no collab round"))
    return rows


def fault_scene():
    """The fault ladder's flat-patch scene: (clean, noisy) [512, 512]
    bayer in [0, 1], PG noise at K 24, sigma 6 (numpy, seed 11)."""
    rng = np.random.default_rng(11)
    H = W = 512
    clean = np.kron(rng.random((4, 4)) * 0.6 + 0.2,
                    np.ones((H // 4, W // 4))).astype(np.float32)
    K, sigma, scale = 24.0, 6.0, FAULT_P["scale"]
    noisy = np.clip((K * rng.poisson(clean * scale / K)
                     + rng.normal(0, sigma, clean.shape)) / scale,
                    0, 1).astype(np.float32)
    return clean, noisy


def fault_row(eng, f: float, clean, noisy) -> dict:
    """One rung: the self estimate scaled by f (beta1 by f, beta2 by f^2)
    through the forced-replace engine `eng` -> its row."""
    real_est = eng._estimate_self

    def bad_est(raw, _f=f, _real=real_est):
        b1, b2 = _real(raw)
        return b1 * _f, b2 * _f ** 2

    eng._estimate_self = bad_est
    try:
        res = eng.iter_denoise({"lr": noisy}, dict(FAULT_P))
    finally:
        del eng._estimate_self
    sig = res["signals"][0]
    row = {
        "fault_scale": f,
        "psnr_hold": float(psnr(res["raw_dns"][0], clean)),
        "psnr_fire": float(psnr(res["raw_dns"][1], clean)),
        "agree": sig["agree"], "frac": sig["frac"], "ffrac": sig["ffrac"],
    }
    # f = 1.0 is the control rung (no injected fault): the policy holds
    # round 0 + refine there, so it carries no must-fire requirement
    row["needs_rescue"] = f < 1.0 and (
        row["psnr_fire"] > row["psnr_hold"] + RESCUE_GAIN_MIN)
    return row


def sweep_faults(args, engine=None) -> List[dict]:
    """Under-estimate fault ladder with the real net -> per-rung rows."""
    eng = engine if engine is not None else build_engine(args, "replace")
    clean, noisy = fault_scene()
    rows = []
    for f in FAULT_LADDER:
        row = fault_row(eng, f, clean, noisy)
        rows.append(row)
        log(f"[fault] f={f:5.2f} hold={row['psnr_hold']:6.2f} "
            f"fire={row['psnr_fire']:6.2f} agree={row['agree']:+.3f} "
            f"frac={row['frac']:.3f} ffrac={row['ffrac']:.3f} "
            f"needs={row['needs_rescue']}")
    return rows


def grid_verdicts(suite_rows, fault_rows) -> List[dict]:
    grid = []
    for tol in TOLS:
        for ff in FFS:
            fires = [r for r in suite_rows
                     if r["agree"] is not None and r["agree"] > tol
                     and r["ffrac"] > ff and r["psnr_fire"] is not None]
            deltas = [r["psnr_fire"] - r["psnr_hold"] for r in fires]
            dnh_fail = [r["scene"] for r in fires
                        if r["psnr_fire"] < r["noisy_psnr"]
                        and r["psnr_hold"] >= r["noisy_psnr"]]
            missed = [r["fault_scale"] for r in fault_rows
                      if r["needs_rescue"]
                      and not (r["agree"] > tol and r["ffrac"] > ff)]
            harm = [r["scene"] for r, d in zip(fires, deltas) if d < -0.1]
            grid.append({
                "tol": tol, "floor_frac": ff,
                "suite_fires": [r["scene"] for r in fires],
                "suite_mean_delta_when_fired":
                    float(np.mean(deltas)) if deltas else 0.0,
                "suite_harmful_fires": harm,
                "suite_dnh_breaks": dnh_fail,
                "fault_rungs_missed": missed,
                "ok": not dnh_fail and not missed and not harm,
            })
    return grid


def _compute_ffrac(lr, reg, device="cpu") -> float:
    """input_floor_frac from the scene and the NLE alone (no denoiser);
    mirrors pipeline/engine.py YONDEngine._input_floor_frac."""
    rggb = bayer2rggb(torch.as_tensor(lr, dtype=torch.float32,
                                      device=device))
    fl, mu_mid = flat_floor_stats(rggb)
    v_self = reg[0] * float(mu_mid) + max(reg[1], 0.0)
    return float(fl) ** 2 / max(v_self, 1e-30)


def _self_reg(lr, device="cpu"):
    reg = self_nlf_robust(bayer2rggb(torch.as_tensor(
        lr, dtype=torch.float32, device=device)))
    return float(reg[0]), float(reg[1])


def regrid(args, scenes: Optional[Dict] = None):
    """Recompute the grid of an existing artifact under the ffrac gate.

    The hold/fire PSNRs and agree signals are gate-independent (the
    artifact ran policy 'replace', which always fires), so only ffrac
    needs computing: scenes + self NLE, no net. -> (suite rows, fault
    rows, the artifact)."""
    with open(args.regrid) as f:
        art = json.load(f)
    specs = {s.name: s for s in SUITES[art["suite"]]}
    for row in art["suite_rows"]:
        key = (row["scene"], None)
        if scenes is not None and key in scenes:
            lr = scenes[key][1]
        else:
            lr = build_scene(specs[row["scene"]])[1]
        row["ffrac"] = _compute_ffrac(lr, _self_reg(lr, args.device),
                                      args.device)
    _, noisy = fault_scene()
    b1, b2 = _self_reg(noisy, args.device)
    for row in art["fault_rows"]:
        f = row["fault_scale"]
        row["ffrac"] = _compute_ffrac(noisy, (b1 * f, b2 * f * f),
                                      args.device)
        row["needs_rescue"] = f < 1.0 and (
            row["psnr_fire"] > row["psnr_hold"] + RESCUE_GAIN_MIN)
    return art["suite_rows"], art["fault_rows"], art


def record(suite, model, platform, suite_rows, fault_rows) -> dict:
    """The sweep's JSON record: rows, grid, acceptable region and the
    defaults' verdict (main exits on `defaults.ok`)."""
    grid = grid_verdicts(suite_rows, fault_rows)
    chosen = next((g for g in grid if g["tol"] == DEFAULT_TOL
                   and g["floor_frac"] == DEFAULT_FLOOR_FRAC), None)
    ok_region = [(g["tol"], g["floor_frac"]) for g in grid if g["ok"]]
    return {"suite": suite, "model": model, "platform": platform,
            "note": NOTE, "suite_rows": suite_rows,
            "fault_rows": fault_rows, "grid": grid, "ok_region": ok_region,
            "defaults": {"tol": DEFAULT_TOL,
                         "floor_frac": DEFAULT_FLOOR_FRAC,
                         "ok": bool(chosen and chosen["ok"])}}


def run(args, scenes: Optional[Dict] = None, engine=None) -> dict:
    """The sweep (or --regrid) of parsed `args` -> its record, written to
    args.out. scenes: built held-out scenes keyed (name, None), shared
    with the caller; engine: an optional forced-replace engine."""
    if args.regrid:
        suite_rows, fault_rows, art = regrid(args, scenes)
        suite, model = art["suite"], art["model"]
        platform = art.get("platform", "cpu") + "+regrid"
    else:
        eng = engine if engine is not None else build_engine(args,
                                                             "replace")
        suite_rows = sweep_suite(args, eng, scenes)
        fault_rows = sweep_faults(args, eng)
        suite, model = args.suite, args.model
        platform = "gpu" if eng.device.type == "cuda" else eng.device.type
    out = record(suite, model, platform, suite_rows, fault_rows)
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    log(f"wrote {args.out}")
    log(f"acceptable region ({len(out['ok_region'])}/{len(out['grid'])} "
        f"points): {out['ok_region']}")
    log(f"defaults (tol={DEFAULT_TOL}, ff={DEFAULT_FLOOR_FRAC}) ok: "
        f"{out['defaults']['ok']}")
    return out


def main(argv=None):
    out = run(parse_args(argv))
    sys.exit(0 if out["defaults"]["ok"] else 1)


if __name__ == "__main__":
    main()
