"""Chroma-bias probe: the net's per-channel DC bias on chroma-extreme flat
patches (port of scripts/chroma_probe.py, same arguments).

    python -m yondx_torch.cli.chroma_probe [ckpt ...] [--sigma 5] [--cpu]

Each checkpoint is loaded into the GuidedResUnet nf=32 arch the script
names (io/ckpt.py reads the committed flax checkpoints). For white-balance
ratios B/G = r in 1, 1.5, 2, 2.8, 4 (R/G = 1/r) at G 0.30, a constant
128x128 RGGB patch plus AWGN of sigma/255 (default_rng(0), one stream
over every checkpoint) goes through the net guided at that sigma, and
the mean of (out - clean) per channel is printed as the R, G (the two
G planes' mean) and B bias, then the worst |bias|. Nets trained on the
procedural generator carry a gray-world prior and desaturate colored
flats; a chroma_aug fine-tune drives these biases toward 0.

The default checkpoint, Gaussian_GRU_mix_1to50_norm_best_model.ckpt,
is the script's and is not in the repo (its ..._1to50c_... and
..._5to50_... are): name one. A missing file raises. On the GPU unless
--cpu.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..models.unets import load_model
from .probe_common import device_of, guided_arch

RATIOS = (1.0, 1.5, 2.0, 2.8, 4.0)


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpts", nargs="*",
                    default=["checkpoints/Gaussian/"
                             "Gaussian_GRU_mix_1to50_norm_best_model.ckpt"])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU)")
    ap.add_argument("--sigma", type=float, default=5.0, help="/255 AWGN")
    return ap


def main(argv=None) -> dict:
    """-> {ckpt: {'bias': {r: [R, G1, G2, B] biases}, 'out': {r: the
    net's output}, 'worst': worst |bias|}}."""
    args = build_parser().parse_args(argv)
    dev = device_of(args.cpu)
    arch = guided_arch()
    sig = args.sigma / 255.0
    rng = np.random.default_rng(0)
    res = {}
    for path in args.ckpts:
        net = load_model(arch, path, device=dev)
        print(f"== {path} (sigma {args.sigma}/255)", flush=True)
        worst, rec = 0.0, {"bias": {}, "out": {}}
        for r in RATIOS:
            g = 0.30
            clean = np.stack([np.full((128, 128), min(g / r, 1.0)),
                              np.full((128, 128), g),
                              np.full((128, 128), g),
                              np.full((128, 128), min(g * r, 1.0))],
                             axis=-1)[None].astype(np.float32)  # R G G B
            noisy = clean + rng.normal(0, sig, clean.shape).astype(
                np.float32)
            t = torch.full((1,), sig, dtype=torch.float32, device=dev)
            with torch.no_grad():
                out = net(torch.from_numpy(noisy).to(dev), t).cpu().numpy()
            bias = (out - clean).mean(axis=(0, 1, 2))
            worst = max(worst, float(np.abs(bias).max()))
            rec["bias"][r], rec["out"][r] = bias, out
            print(f"  B/G={r:>3}: bias R {bias[0]:+.4f}  G "
                  f"{(bias[1] + bias[2]) / 2:+.4f}  B {bias[3]:+.4f}",
                  flush=True)
        print(f"  worst |bias| = {worst:.4f}", flush=True)
        res[path] = {**rec, "worst": worst}
    return res


if __name__ == "__main__":
    main()
