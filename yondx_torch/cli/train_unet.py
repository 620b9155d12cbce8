"""Train UNetSeeInDark, the no-guidance variant (port of
scripts/train_unet.py, same argument).

    python -m yondx_torch.cli.train_unet [stop_epoch] [--out DIR] [--cpu]

The Unet_5to50_norm.yml recipe with T 1 and stop_epoch 200 unless given;
the rest as cli/train_gru.py: batch 64, plot_freq 20, save_freq 10, 2048
synthetic training crops and 64 for eval and test, train() then
eval(epoch=-1), on the GPU unless --cpu, every file under --out (default
runs/).
"""
from __future__ import annotations

from .train_gru import run_recipe

RUNFILE = "runfiles/Gaussian/Unet_5to50_norm.yml"


def main(argv=None) -> dict:
    return run_recipe(RUNFILE, 200, argv, T=1)


if __name__ == "__main__":
    main()
