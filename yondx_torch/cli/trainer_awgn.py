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
"""
from __future__ import annotations

import argparse

from ..config import load_runfile
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


def main(argv=None):
    opts = build_parser().parse_args(argv)
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

    trainer = AWGNTrainer(args, device="cpu" if opts.cpu else "cuda",
                          field="torch")
    mode = args["mode"]
    if mode == "train":
        trainer.train(steps_per_epoch=opts.steps_per_epoch)
        mode = "evaltest"

    if "eval" in mode:
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


if __name__ == "__main__":
    main()
