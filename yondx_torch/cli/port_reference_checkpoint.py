"""`python -m yondx_torch.cli.port_reference_checkpoint --pth F.pth
--out F.ckpt [--arch GuidedResUnet] [--nf 32] [--in-nc 4] [--out-nc 4]`:
port a reference PyTorch checkpoint (.pth) into a .ckpt (port of
scripts/port_reference_checkpoint.py).

The reference's state_dict goes through models/torch_port.py's
converters into the flax layout every entry point reads (the port's and
the JAX package's), after a check that its parameter count equals a
fresh net's of the arch. Refuses to overwrite --out. Host work only.
"""
from __future__ import annotations

import argparse
import os

from ..core.logging import log
from ..models.registry import build_model, param_count
from ..models.torch_port import port_checkpoint
from ..train.ckpt import save_checkpoint


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pth", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--arch", default="GuidedResUnet")
    ap.add_argument("--nf", type=int, default=32)
    ap.add_argument("--in-nc", type=int, default=4)
    ap.add_argument("--out-nc", type=int, default=4)
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if os.path.exists(args.out):
        raise FileExistsError(f"{args.out} exists; refusing to clobber")
    arch = {"name": args.arch, "guided": args.arch in
            ("GuidedResUnet", "SNRnet", "GuidedSelfUnet"),
            "in_nc": args.in_nc, "out_nc": args.out_nc, "nf": args.nf,
            "nframes": 1, "res": True, "norm": True}
    params = port_checkpoint(args.arch, args.pth)
    # sanity: shapes must match a fresh net
    n_ref, n_got = param_count(build_model(arch)), param_count(params)
    if n_ref != n_got:
        raise ValueError(f"param count mismatch: {n_got} vs {n_ref}")
    save_checkpoint(args.out, params)
    log(f"ported {n_got / 1e6:.2f}M params -> {args.out}")
    return {"out": args.out, "params": n_got}


if __name__ == "__main__":
    main()
