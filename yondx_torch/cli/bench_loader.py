"""On-disk npy corpus loader benchmark (port of scripts/bench_loader.py,
same flags).

    python -m yondx_torch.cli.bench_loader [--root DIR] [--n 1024] [--steps 48] [--step-time S]

Writes a corpus of `--n` procedural sRGB crops (uint8 npy, 256x256x3: the
YOND/train_mix format the reference trains from) under --root/train
unless it holds as many already, reads it once in a cold epoch, then
measures how long the BatchLoader's next() blocks in a warm loop of
`--steps` batches of `--batch`, each followed by a simulated device step
of `--step-time` seconds (a host sleep). Gate, as the script's: the
loader's wait under 5% of the step time (the reference's num_workers=8
DataLoader keeps its GPU fed, trainer_AWGN.py:45-50); the exit code is
0 when it holds and 1 when not. Host work only: no device.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from ..core.logging import log
from ..data.datasets import BatchLoader, NpyFolderDataset, \
    SyntheticSRGBDataset

# the gru32 trainer's step at batch 64 on the card: 65.33-72.71 ms in
# chip_smoke.py's phase 10b on an NVIDIA H100 80GB HBM3 at 700.00 W
STEP_TIME = 0.07


def build_corpus(root: str, n: int, size: int = 256) -> None:
    """`n` crops of SyntheticSRGBDataset (seed 1997, no cache) as
    {root}/train/crop_{i:05d}.npy, unless that directory holds `n` npy
    files or more."""
    d = os.path.join(root, "train")
    os.makedirs(d, exist_ok=True)
    existing = len([f for f in os.listdir(d) if f.endswith(".npy")])
    if existing >= n:
        return
    gen = SyntheticSRGBDataset(length=n, size=size, cache=False,
                               disk_cache=None)
    for i in range(n):
        np.save(os.path.join(d, f"crop_{i:05d}.npy"), gen[i])


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.join(
        tempfile.gettempdir(), "yondx_torch_loader_bench"))
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=48)
    ap.add_argument("--step-time", type=float, default=STEP_TIME,
                    help="simulated device step seconds (the gru32 batch-64 "
                         "step, 65.33-72.71 ms on an NVIDIA H100 80GB HBM3 "
                         "at 700.00 W)")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--fresh", action="store_true",
                    help="rebuild the corpus from scratch")
    return ap


def main(argv=None) -> dict:
    """-> {'rc', 'corpus_s', 'cold_s', 'n_cold', 'steps', 'waits',
    'wait_ms', 'pct'}; rc 0 when the wait is under 5%."""
    args = build_parser().parse_args(argv)
    if args.fresh and os.path.isdir(args.root):
        shutil.rmtree(args.root)
    t0 = time.perf_counter()
    build_corpus(args.root, args.n)
    corpus_s = time.perf_counter() - t0
    log(f"corpus ready ({args.n} x 256x256x3 uint8 npy) in {corpus_s:.1f}s")
    # nothing is dropped from the page cache: the steady-state epochs
    # re-read warm files, as the reference's do; cold is the first epoch

    ds = NpyFolderDataset(args.root, "train")
    loader = BatchLoader(ds, args.batch, shuffle=True, seed=0,
                         prefetch=8, workers=args.workers)

    t0 = time.perf_counter()
    n_cold = sum(1 for _ in loader.epoch(0))
    cold_s = time.perf_counter() - t0
    log(f"cold epoch: {n_cold} batches in {cold_s:.2f}s")

    def batches():
        e = 1
        while True:
            yield from loader.epoch(e)
            e += 1

    it = batches()
    next(it)  # warm the pool
    waits, steps = [], 0
    for _ in range(args.steps):
        t = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            break
        waits.append(time.perf_counter() - t)
        if batch.shape[0] != args.batch:
            raise AssertionError(f"a batch of {batch.shape[0]} items, "
                                 f"expected {args.batch}")
        time.sleep(args.step_time)      # the simulated device step
        steps += 1
    loader.close()
    wait = float(np.sum(waits))
    total = wait + steps * args.step_time
    pct = 100.0 * wait / total
    wait_ms = wait * 1000 / max(steps, 1)
    log(f"batch={args.batch} workers={args.workers} steps={steps}: "
        f"loader wait {wait_ms:.1f} ms/step = "
        f"{pct:.2f}% of step time (gate <5%): "
        f"{'PASS' if pct < 5.0 else 'FAIL'}")
    return {"rc": 0 if pct < 5.0 else 1, "corpus_s": corpus_s,
            "cold_s": cold_s, "n_cold": n_cold, "steps": steps,
            "waits": waits, "wait_ms": wait_ms, "pct": pct}


if __name__ == "__main__":
    sys.exit(main()["rc"])
