"""Train a noise-estimation net (PGEstTrainer) from a runfile (port of
scripts/train_est.py, same arguments).

    python -m yondx_torch.cli.train_est [runfile] [stop_epoch] [--cpu]

The default runfile is runfiles/Gaussian/EstPGE.yml, the PGE scalar net
that serves the engine's est_type 'pge' path. Trains on the GPU ("cuda";
it raises when there is none) unless --cpu is given, with the training
fields drawn from a torch.Generator on the device. The runfile's
fast_ckpt is where `{model_name}_last_model.ckpt` lands every save_freq
epochs: EstPGE.yml's is the committed checkpoints/Gaussian, so point it
at a scratch directory for a trial run.
"""
from __future__ import annotations

import sys

from ..config import load_runfile
from ..train.pg_trainer import PGEstTrainer


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    cpu = "--cpu" in argv
    argv = [a for a in argv if a != "--cpu"]
    runfile = argv[0] if argv else "runfiles/Gaussian/EstPGE.yml"
    stop = int(argv[1]) if len(argv) > 1 else None
    args = load_runfile(runfile, mode="train")
    trainer = PGEstTrainer(args, device="cpu" if cpu else "cuda",
                           field="torch")
    return trainer.train(epochs=stop)


if __name__ == "__main__":
    main()
