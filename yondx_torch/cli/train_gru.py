"""Train the flagship SNR-Net (GuidedResUnet nf=32) on synthetic pseudo-raw
(port of scripts/train_gru.py, same argument).

    python -m yondx_torch.cli.train_gru [stop_epoch] [--out DIR] [--cpu]

The headline recipe runfiles/Gaussian/GRU_5to50_norm_mix.yml with batch
64, T 2, plot_freq 20, save_freq 10 and the procedural sRGB set standing
in for DIV2K+SID (2048 training crops, 64 for eval and test; built once
into the port's disk cache), stop_epoch 400 unless given; train(), then
eval(epoch=-1). Trains on the GPU ("cuda"; it raises when there is none)
unless --cpu is given, with the training fields drawn from a
torch.Generator on the device.

Every file it writes lies under --out (default runs/ under the working
directory): the runfile's fast_ckpt, checkpoint and result_dir are moved
there (config.redirect_outputs) and the run's ./logs/ is taken there,
since an eval record saves {fast_ckpt}/{model_name}_best_model.ckpt and
the runfile's fast_ckpt is the repo's committed checkpoints/Gaussian.
"""
from __future__ import annotations

import argparse
import contextlib
import os

from ..config import load_runfile, redirect_outputs
from ..train import AWGNTrainer

RUNFILE = "runfiles/Gaussian/GRU_5to50_norm_mix.yml"
# the synthetic sets' sizes of the one-off trainers
SYNTHETIC_LEN = {"dst_train": 2048, "dst_eval": 64, "dst_test": 64}


def edit_recipe(args, stop_epoch: int, **hyper) -> dict:
    """The one-off trainers' edits to a runfile: batch 64, plot 20, save
    10, stop_epoch, `hyper`'s other keys, and the synthetic sets' sizes
    (2048 training crops, 64 for eval and test)."""
    args["hyper"].update(batch_size=64, stop_epoch=stop_epoch, **hyper)
    args["hyper"]["plot_freq"] = 20
    args["hyper"]["save_freq"] = 10
    for k, n in SYNTHETIC_LEN.items():
        args[k]["synthetic_len"] = n
    return args


def add_out_flags(ap) -> None:
    ap.add_argument("--out", default="runs", metavar="DIR",
                    help="every file the run writes goes under DIR")
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU (default: the GPU)")


def under(args, out: str):
    """Move args' outputs under `out` (made if missing) and return a
    context whose working directory is `out`, so that the trainer's
    ./logs/ lands there too."""
    redirect_outputs(args, out)
    os.makedirs(out, exist_ok=True)
    return contextlib.chdir(out)


def run_recipe(runfile: str, default_stop: int, argv=None, **hyper) -> dict:
    """The train_gru / train_unet recipe of `runfile`: -> {'args', 'out',
    'trainer', 'eval': (PSNR, SSIM) of eval(epoch=-1)}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("stop_epoch", nargs="?", type=int, default=default_stop)
    add_out_flags(ap)
    opts = ap.parse_args(argv)
    out = os.path.abspath(opts.out)
    args = edit_recipe(load_runfile(runfile, mode="train"), opts.stop_epoch,
                       **hyper)
    with under(args, out):
        tr = AWGNTrainer(args, device="cpu" if opts.cpu else "cuda",
                         field="torch")
        tr.train()
        res = tr.eval(epoch=-1)
    return {"args": args, "out": out, "trainer": tr, "eval": res}


def main(argv=None) -> dict:
    return run_recipe(RUNFILE, 400, argv, T=2)


if __name__ == "__main__":
    main()
