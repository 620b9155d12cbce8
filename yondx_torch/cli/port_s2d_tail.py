"""`python -m yondx_torch.cli.port_s2d_tail [--src M] [--dst M]
[--ckpt-dir DIR] [--nf 64] [--out-k 3] [--tail-nf 16] [--cpu]`: extend a
trained tail-less GuidedResUnetS2D checkpoint with the zero-init
full-resolution tail (arch key tail_nf) and save it under a new model
name, ready for the tail-only distillation phase
(runfiles/Gaussian/GRUS2DT_distill_tail.yml); port of
scripts/port_s2d_tail.py.

The tail's fresh weights are flax's default init from key 1
(`flax_init_params`) with tail_2's kernel zero, as the JAX net declares
it, so the extended net's output is bit-identical to the source's until
the tail trains: checked here on one [1, 128, 128, 4] input on the GPU
("cuda"; it raises when there is none) unless --cpu is given, with
cuDNN's deterministic algorithm choice. Writes `{dst}_last_model.ckpt`
under --ckpt-dir (epoch 0), refusing to overwrite one.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import resolve_device
from ..core.logging import log
from ..models.convert import params_to_state_dict, state_dict_to_params
from ..models.registry import build_model, flax_init_params
from ..train.ckpt import find_checkpoint, load_checkpoint, save_checkpoint
from ..train.s2d_port import extend_with_tail


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default="Gaussian_GRUS2D3_mix_1to50c_norm")
    ap.add_argument("--dst", default="Gaussian_GRUS2DT_mix_1to50c_norm")
    ap.add_argument("--ckpt-dir", default="checkpoints/Gaussian")
    ap.add_argument("--nf", type=int, default=64)
    ap.add_argument("--out-k", type=int, default=3)
    ap.add_argument("--tail-nf", type=int, default=16)
    ap.add_argument("--cpu", action="store_true",
                    help="run the check on the CPU (default: the GPU)")
    return ap


def tail_init(net) -> dict:
    """Fresh weights of a tailed GuidedResUnetS2D as flax's init with key
    1 makes them: tail_2's kernel is zero (kernel_init=zeros)."""
    sd = flax_init_params(net, seed=1)
    sd["tail_2.weight"] = torch.zeros_like(sd["tail_2.weight"])
    return sd


def identity_check(src_net, tail_net, device, x=None) -> np.ndarray:
    """Both nets on one input (default: numpy seed 0's [1, 128, 128, 4]
    uniform, guidance 0.05) must give the same bits -> the output."""
    if x is None:
        x = np.random.default_rng(0).random((1, 128, 128, 4))
    x = torch.as_tensor(np.asarray(x, np.float32), device=device)
    t = torch.full((x.shape[0],), 0.05, device=device)
    with torch.no_grad(), torch.backends.cudnn.flags(
            enabled=True, benchmark=False, deterministic=True,
            allow_tf32=False):
        y0 = src_net(x, t).cpu().numpy()
        y1 = tail_net(x, t).cpu().numpy()
    np.testing.assert_array_equal(y0, y1)
    return y1


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    ck = find_checkpoint(args.ckpt_dir, args.src)
    if ck is None:
        raise FileNotFoundError(f"no checkpoint for {args.src} under "
                                f"{args.ckpt_dir}")
    out = os.path.join(args.ckpt_dir, f"{args.dst}_last_model.ckpt")
    if os.path.exists(out):
        raise FileExistsError(f"{out} exists; refusing to clobber")
    base = {"name": "GuidedResUnetS2D", "guided": True, "in_nc": 4,
            "out_nc": 4, "nf": args.nf, "nframes": 1, "res": True,
            "norm": True, "out_k": args.out_k}
    src_sd = params_to_state_dict(load_checkpoint(ck)["params"])
    src_net = build_model(base)
    src_net.load_state_dict(src_sd, strict=True)
    tail_net = build_model(dict(base, tail_nf=args.tail_nf))
    merged = extend_with_tail(src_sd, tail_init(tail_net))
    tail_net.load_state_dict(merged, strict=True)
    identity_check(src_net.to(dev).eval(), tail_net.to(dev).eval(), dev)
    n_tail = sum(t.numel() for k, t in merged.items()
                 if k.startswith("tail_"))
    save_checkpoint(out, state_dict_to_params(merged), epoch=0)
    log(f"saved {out} (tail params: {n_tail}); identity check PASSED")
    return {"src": ck, "out": out, "tail_params": n_tail}


if __name__ == "__main__":
    main()
