"""`python -m yondx_torch.cli.ship_weights SRC DST [SRC DST ...]`: strip
the optimizer state from checkpoints for shipping (port of
scripts/ship_weights.py).

Each SRC checkpoint is written to DST with its params, epoch and
best_psnr and an empty opt_state (a params-only s2dt16 file is ~45 MB
against 134 MB with Adam's moments). It takes explicit pairs only and
refuses to overwrite an existing DST; with no arguments it ships nothing
and prints its usage. Host work only.
"""
from __future__ import annotations

import os
import sys

from ..core.logging import log
from ..train.ckpt import load_checkpoint, save_checkpoint

USAGE = ("usage: python -m yondx_torch.cli.ship_weights SRC DST "
         "[SRC DST ...]  (params-only copies; DST must not exist)")


def ship(src: str, dst: str) -> dict:
    """Write `src`'s params, epoch and best_psnr to `dst` with no
    optimizer state -> {src, dst, epoch, bytes_src, bytes_dst}."""
    if os.path.exists(dst):
        raise FileExistsError(f"{dst} exists; refusing to clobber")
    state = load_checkpoint(src)
    save_checkpoint(dst, state["params"], None,
                    epoch=state.get("epoch", 0),
                    best_psnr=state.get("best_psnr", 0.0))
    rec = {"src": src, "dst": dst, "epoch": state.get("epoch"),
           "bytes_src": os.path.getsize(src),
           "bytes_dst": os.path.getsize(dst)}
    log(f"{src} -> {dst} (params only, epoch {rec['epoch']}; "
        f"{rec['bytes_src']} -> {rec['bytes_dst']} bytes)")
    return rec


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or len(argv) % 2 or argv[0] in ("-h", "--help"):
        print(USAGE)
        if argv and argv[0] not in ("-h", "--help"):
            sys.exit(2)
        return []
    return [ship(s, d) for s, d in zip(argv[0::2], argv[1::2])]


if __name__ == "__main__":
    main()
