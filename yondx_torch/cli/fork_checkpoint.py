"""`python -m yondx_torch.cli.fork_checkpoint SRC_MODEL DST_MODEL
[--ckpt-dir DIR] [--last]`: fork a checkpoint under a new model name for
a fine-tune recipe (port of scripts/fork_checkpoint.py).

Copies SRC_MODEL's best (or, with --last, last) checkpoint under
--ckpt-dir to DST_MODEL's *_last_model.ckpt there, with epoch and
best_psnr reset and the optimizer state dropped, so a runfile with
hyper.last_epoch: -1 resumes the weights while the LR schedule and
Adam's moments start fresh. It never touches the source, and refuses to
overwrite an existing destination. Host work only.
"""
from __future__ import annotations

import argparse
import os

from ..core.logging import log
from ..train.ckpt import find_checkpoint, load_checkpoint, save_checkpoint


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--ckpt-dir", default="checkpoints/Gaussian")
    ap.add_argument("--last", action="store_true",
                    help="fork the last (not best) checkpoint")
    return ap


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)
    src = find_checkpoint(args.ckpt_dir, args.src,
                          prefer="last" if args.last else "best")
    if src is None:
        raise FileNotFoundError(f"no checkpoint for {args.src} under "
                                f"{args.ckpt_dir}")
    dst = os.path.join(args.ckpt_dir, f"{args.dst}_last_model.ckpt")
    if os.path.exists(dst):
        raise FileExistsError(f"{dst} exists; refusing to clobber")
    state = load_checkpoint(src)
    save_checkpoint(dst, state["params"], None, epoch=0, best_psnr=0.0)
    log(f"forked {src} -> {dst} (epoch 0, best 0, no opt state)")
    return dst


if __name__ == "__main__":
    main()
