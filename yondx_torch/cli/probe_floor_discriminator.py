"""`python -m yondx_torch.cli.probe_floor_discriminator [--cpu]`: can the
INPUT noise floor discriminate true under-estimates? (port of
scripts/probe_floor_discriminator.py)

The rescue gate's signal: mad_noise_floor's level-1 floor of the noisy
input is a content-free lower bound on the noise, so a self estimate
below it (ffrac = floor^2 / v_self > 1.5, v_self at the floor's own
mid-tone mean) proves an under-estimate from the input alone. Prints one
row per case: the fault ladder (the flat-block scene of
cli/sweep_policy.py, its self estimate scaled by f in FAULT_LADDER; all
but f = 1 should FIRE), then 12 named scenes of suite v2 at their true
estimates (all should hold). No net. K1 runs once per self fit (13).
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional

from ..eval.heldout import SUITES
from ..nle.robust import flat_floor_stats, self_nlf_robust
from .probe_common import device_of, get_scene, rggb_of
from .sweep_policy import FAULT_LADDER, fault_scene

GATE = 1.5          # pipeline/policy.py DEFAULT_FLOOR_FRAC
NAMES = {"glyphs_lo", "glyphs_lo2", "glyphs_hi", "glyphs_big", "ramp_big",
         "zone_lo", "zone_lo2", "voronoi_mid", "satdisk_lo", "radial_lo",
         "ramp_mid2", "chart_anchor"}


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU)")
    return ap


def floor_frac(lr, reg, device):
    """-> (ffrac, floor) of bayer `lr` under the noise model `reg`;
    mirrors pipeline/engine.py YONDEngine._input_floor_frac."""
    fl, mu_mid = flat_floor_stats(rggb_of(lr, device))
    fl = float(fl)
    v_self = reg[0] * float(mu_mid) + max(reg[1], 0.0)
    return fl ** 2 / max(v_self, 1e-30), fl


def self_reg(lr, device):
    b1, b2 = self_nlf_robust(rggb_of(lr, device))
    return float(b1), float(b2)


def case_row(case: str, lr, reg, device) -> dict:
    ff, fl = floor_frac(lr, reg, device)
    row = {"case": case, "ffrac": ff, "floor": fl, "beta1": reg[0],
           "fire": ff > GATE}
    print(f"{case:16s} {ff:8.3f} {fl:9.5f} {reg[0]:10.3e} "
          f"{'FIRE' if row['fire'] else 'hold'}", flush=True)
    return row


def run(args, scenes: Optional[Dict] = None) -> dict:
    """-> {'faults': [row per rung], 'scenes': [row per suite scene]};
    scenes: eval_synth.run's scene dict keyed (name, None), reused and
    filled."""
    dev = device_of(args.cpu)
    print(f"{'case':16s} {'ffrac':>8s} {'floor':>9s} {'beta1':>10s} note",
          flush=True)
    _, noisy = fault_scene()
    b1, b2 = self_reg(noisy, dev)
    faults = [dict(case_row(f"fault f={f:5.2f}", noisy,
                            (b1 * f, b2 * f * f), dev), fault_scale=f)
              for f in FAULT_LADDER]
    rows = []
    for spec in SUITES["v2"]:
        if spec.name in NAMES:
            _, lr = get_scene(spec, scenes)
            rows.append(case_row(spec.name, lr, self_reg(lr, dev), dev))
    return {"faults": faults, "scenes": rows}


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
