"""Does the est recipe repeat on one card, and what does cuDNN add?

    python scripts/torch_est_repeat.py [--runs 2]

Runs `chip_smoke.py`'s phase 11c (runfiles/Gaussian/EstPGE.yml as
written, "torch" fields from a seeded generator, TF32 off) `--runs`
times with cuDNN as phase 11c meets it inside chip_smoke.py (benchmark on,
left so by phase 5; deterministic off), then `--runs` times with
cudnn.deterministic = True and benchmark = False. Prints each run's mean
loss per epoch, the largest gap between the runs of each setting at each
tenth epoch and over all epochs, and the PGE eval loss of each trained
net on the fixed eval set. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=2)
    runs = ap.parse_args(argv).runs
    import chip_smoke
    from yondx_torch.train.pg_trainer import eval_pge, pge_eval_batches
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batches = pge_eval_batches("cuda")
    per_mode = {}
    for mode, (bench, det) in (("default", (True, False)),
                               ("deterministic", (False, True))):
        torch.backends.cudnn.benchmark = bench
        torch.backends.cudnn.deterministic = det
        curves = []
        for r in range(runs):
            with tempfile.TemporaryDirectory() as tmp:
                os.chdir(tmp)
                try:
                    tr, _, epochs = chip_smoke.est_pge_recipe(
                        os.path.join(tmp, "c"))
                finally:
                    os.chdir(REPO)
            losses = np.array([[s["loss"] for s in tr.steps
                                if s["epoch"] == e]
                               for e in range(1, epochs + 1)]).mean(axis=1)
            curves.append(losses)
            ev = eval_pge(tr.model, batches)
            print(f"repeat {mode} run {r + 1} (cudnn benchmark {bench}, "
                  f"deterministic {det}): eval loss {ev:.6f}; mean loss "
                  "per epoch " + " ".join(f"{v:.5f}" for v in losses),
                  flush=True)
        gap = np.max(curves, axis=0) - np.min(curves, axis=0)
        per_mode[mode] = gap
        print(f"repeat {mode}: largest gap between runs at epochs 1, 10, "
              "..., 80: " + " ".join(f"{gap[e - 1]:.5f}" for e in
                                    (1, *range(10, len(gap) + 1, 10)))
              + f"; over all epochs {gap.max():.5f} (epoch "
              f"{int(gap.argmax()) + 1}); first epoch with a gap "
              f"{next((i + 1 for i, g in enumerate(gap) if g > 0), None)}",
              flush=True)


if __name__ == "__main__":
    main()
