"""Readings that the limits of check.py are set from, for one cell, in
one process on the card:

    python3 -m perfbench.calibrate --workload <cell> --seeds 1 2 ... \\
        [--control-seeds 1 2 3] [--out file.json]

For each seed: the cell's pool from the seed, every pool frame through
the program's entry once (after the warm-up calls a run makes), and the
check's numbers of those outputs against the reference (the program's
readings, the lower ones). For each control seed: the same frames
through the reference computed in the configuration's control precision
in the program's place (the upper readings). The benchmark's own runs
do not run the control.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def calibrate(cell, seeds, control_seeds, root, device="cuda", log=None):
    """(summary, rows): the program's numbers for each of `seeds` and the
    control's for each of `control_seeds`; the summary holds the largest
    program reading and the smallest control reading of each number."""
    import torch
    from . import check, frames
    from .run import (Window, build_program, build_reference, compare,
                      set_tf32, warm)
    cuda = torch.device(device).type == "cuda"
    cfg = cell.config
    fn, _ = build_program(cfg, root, device)
    ref, _ = build_reference(cfg, root, device)
    ctl = build_reference(cfg, root, device, control=True)
    rows = []
    for seed in sorted(set(seeds) | set(control_seeds)):
        t0 = time.perf_counter()
        pool, order = frames.make_pool(cell.traffic, seed, device)
        set_tf32(cfg["tf32"])
        warm(fn, pool, order, cuda)
        win = Window(fn, pool, order, cuda)
        win.run(1e9, len(order))
        row = {"seed": seed,
               "frames": [{"camera": f.camera, "K": f.K, "sigma": f.sigma}
                          for f in pool]}
        if seed in seeds:
            per = compare(ref, pool, win.kept)
            row["program"] = check.worst(per)
            row["program_frames"] = per
        if seed in control_seeds:
            per = compare(ref, pool, win.kept, ctl)
            row["control"] = check.worst(per)
            row["control_frames"] = per
        row["seconds"] = time.perf_counter() - t0
        if log:
            log(json.dumps({k: v for k, v in row.items()
                            if not k.endswith("_frames")}))
        rows.append(row)
        del pool, win
        if cuda:
            torch.cuda.empty_cache()
    summary = {"workload": cell.name}
    for side in ("program", "control"):
        got = [r[side] for r in rows if side in r]
        if got:
            pick = max if side == "program" else min
            summary[side] = {n: pick(g[n] for g in got) for n in check.NAMES}
    return summary, rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    root = os.getcwd()
    from .run import set_cache_dirs
    set_cache_dirs(root)
    import torch
    from .spec import load_cell
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(root, args.workload)
    summary, rows = calibrate(cell, args.seeds, args.control_seeds, root,
                              log=lambda s: print(s, flush=True))
    summary["card"] = torch.cuda.get_device_name()
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
