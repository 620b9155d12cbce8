"""`trainer_awgn` CLI: AWGN denoiser training (port of
yondx/cli/trainer_awgn.py, same flags).

    python -m yondx_torch.cli.trainer_awgn -f runfiles/Gaussian/GRU_5to50_norm_mix.yml [--cpu]

Trains on the GPU ("cuda"; it raises when there is none) unless --cpu is
given, with the training fields drawn from a torch.Generator on the
device (train/draws.py), then reloads the best checkpoint and evaluates
over dst_test.sigma_list. The runfile's fast_ckpt, checkpoint and
result_dir are where it writes, and ./logs/ under the working directory:
point them at a scratch directory for a trial run, since an eval record
overwrites {fast_ckpt}/{model_name}_best_model.ckpt.

Data parallel as JAX's trainer: on the GPU it trains on as many cards as
divide hyper.batch_size (all of them when they do; CUDA_VISIBLE_DEVICES
picks them), one rank a card under DistributedDataParallel, starting
the ranks itself; under torchrun it joins torchrun's group instead
(`torchrun --nproc-per-node N -m yondx_torch.cli.trainer_awgn ...`,
with --cpu N gloo ranks on the CPU). The log says the count. Rank 0
writes the checkpoints and the logs.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

from ..config import load_runfile
from ..core import logging as core_logging
from ..core.logging import log
from ..train import AWGNTrainer
from ..train.ckpt import find_checkpoint, load_checkpoint


def build_parser():
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--runfile", "-f",
                   default="runfiles/Gaussian/GRU_5to50_norm_mix.yml")
    p.add_argument("--mode", "-m", default="train")
    p.add_argument("--debug", action="store_true", default=False,
                   help="tiny synthetic dataset, few steps")
    p.add_argument("--nofig", action="store_true", default=False)
    p.add_argument("--nohost", action="store_true", default=False)
    p.add_argument("--cpu", action="store_true", default=False)
    p.add_argument("--epochs", type=int, default=None,
                   help="override stop_epoch")
    p.add_argument("--steps-per-epoch", type=int, default=None)
    return p


def default_world_size(device: str, batch_size: int) -> int:
    """JAX's rule: the cards, reduced until they divide the batch (one
    on the CPU)."""
    n = torch.cuda.device_count() \
        if device == "cuda" and torch.cuda.is_available() else 1
    while n > 1 and batch_size % n:
        n -= 1
    return max(n, 1)


def _load_args(opts):
    args = load_runfile(opts.runfile, mode=opts.mode)
    if opts.debug:
        for k in ("dst_train", "dst_eval", "dst_test"):
            if k in args:
                args[k]["synthetic_len"] = 16
        args["hyper"]["stop_epoch"] = min(args["hyper"]["stop_epoch"],
                                          args["hyper"].get("last_epoch", 0)
                                          + 2)
    if opts.epochs:
        args["hyper"]["stop_epoch"] = opts.epochs
    return args


def _train(argv, mesh=None):
    """The run on one process, or on one rank of a mesh."""
    opts = build_parser().parse_args(argv)
    args = _load_args(opts)
    trainer = AWGNTrainer(args, device="cpu" if opts.cpu else "cuda",
                          field="torch", mesh=mesh)
    mode = args["mode"]
    if mode == "train":
        trainer.train(steps_per_epoch=opts.steps_per_epoch)
        mode = "evaltest"

    if "eval" in mode:
        if mesh is not None:
            # rank 0 may still be writing the best checkpoint
            import torch.distributed as dist
            dist.barrier(group=mesh.group)
        # reload the best model for the final sweep
        path = find_checkpoint(trainer.fast_ckpt, trainer.model_name)
        if path:
            trainer.load_params(load_checkpoint(path)["params"])
        sigma_list = args.get("dst_test", args.get("dst_eval", {})).get(
            "sigma_list", [10, 25, 50])
        for sigma in sigma_list:
            log(f"AWGN Datasets: sigma={sigma}",
                logfile=f"./logs/log_{trainer.model_name}.log")
            trainer.eval(epoch=-1, sigma=sigma)
    log(f"Metrics have been saved in "
        f"./metrics/{trainer.model_name}_metrics.pkl")
    return trainer


def _rank_main(mesh, argv):
    core_logging.set_enabled(mesh.is_main)
    _train(argv, mesh)


def main(argv=None):
    """Train; returns the trainer, or None where the ranks ran as new
    processes."""
    argv = sys.argv[1:] if argv is None else list(argv)
    opts = build_parser().parse_args(argv)
    args = _load_args(opts)
    device = "cpu" if opts.cpu else "cuda"
    import torch.distributed as dist
    from ..parallel.mesh import make_mesh, spawn
    mesh = None
    if dist.is_initialized() or "WORLD_SIZE" in os.environ:
        mesh = make_mesh(device=device)
        core_logging.set_enabled(mesh.is_main)
        n = mesh.size
    else:
        n = default_world_size(device, int(args["hyper"]["batch_size"]))
    log(f"Data parallel: {n} rank(s) on {device} "
        f"(batch {args['hyper']['batch_size']})",
        logfile=f"./logs/log_{args.get('model_name', 'model')}.log")
    if mesh is not None:
        return _train(argv, mesh)
    if n == 1:
        return _train(argv)
    spawn(n, _rank_main, argv, device=device)
    return None


if __name__ == "__main__":
    main()
