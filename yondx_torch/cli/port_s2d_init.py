"""`python -m yondx_torch.cli.port_s2d_init [--src M] [--dst M]
[--ckpt-dir DIR] [--nf 64] [--out-k 1] [--cpu]`: build the
GuidedResUnetS2D warm-start checkpoint from the gru32 flagship (port of
scripts/port_s2d_init.py).

Copies the shape-twin stages of the trained GuidedResUnet `--src` into a
fresh S2D net (flax's default init from key 1, `flax_init_params`; the
stage map is train/s2d_port.py's) and writes it as the fine-tune's
resume checkpoint `{dst}_last_model.ckpt` under --ckpt-dir (epoch 0, no
optimizer state), refusing to overwrite one. The merged net then runs
one forward pass on the GPU ("cuda"; it raises when there is none)
unless --cpu is given.
"""
from __future__ import annotations

import argparse
import os

import torch

from .. import resolve_device
from ..core.logging import log
from ..models.convert import params_to_state_dict, state_dict_to_params
from ..models.registry import build_model, flax_init_params
from ..models.unets import GRU32_ARCH
from ..train.ckpt import find_checkpoint, load_checkpoint, save_checkpoint
from ..train.s2d_port import port_guidedresunet_to_s2d


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default="Gaussian_GRU_mix_1to50c_norm")
    ap.add_argument("--dst", default="Gaussian_GRUS2D_mix_1to50c_norm")
    ap.add_argument("--ckpt-dir", default="checkpoints/Gaussian")
    ap.add_argument("--nf", type=int, default=64)
    ap.add_argument("--out-k", type=int, default=1,
                    help="conv_out kernel size (1 or 3)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the check on the CPU (default: the GPU)")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    path = find_checkpoint(args.ckpt_dir, args.src)
    if path is None:
        raise FileNotFoundError(f"no checkpoint for {args.src} under "
                                f"{args.ckpt_dir}")
    out = os.path.join(args.ckpt_dir, f"{args.dst}_last_model.ckpt")
    if os.path.exists(out):
        raise FileExistsError(f"{out} exists; refusing to clobber")
    src_sd = params_to_state_dict(load_checkpoint(path)["params"])
    log(f"flagship: {path}")
    dst_arch = {"name": "GuidedResUnetS2D", "guided": True, "in_nc": 4,
                "out_nc": 4, "nf": args.nf, "nframes": 1, "res": True,
                "norm": True, "out_k": args.out_k}
    net = build_model(dst_arch)
    merged, ported, fresh = port_guidedresunet_to_s2d(
        src_sd, flax_init_params(net, seed=1))
    log(f"ported stages: {ported}")
    log(f"fresh stages:  {fresh}")
    # smoke: the merged weights drive a forward pass
    net.load_state_dict(merged, strict=True)
    net = net.to(dev).eval()
    with torch.no_grad():
        y = net(torch.zeros((1, 64, 64, 4), device=dev),
                torch.full((1,), 0.1, device=dev))
    assert y.shape == (1, 64, 64, 4)
    save_checkpoint(out, state_dict_to_params(merged), None, epoch=0,
                    best_psnr=0.0)
    log(f"wrote {out}")
    return {"src": path, "out": out, "ported": ported, "fresh": fresh}


if __name__ == "__main__":
    main()
