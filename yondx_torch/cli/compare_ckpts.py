"""`python -m yondx_torch.cli.compare_ckpts CKPT [CKPT ...] [--cpu]`:
compare checkpoints on the flat-content quality gate, the selection
step before shipping a net (port of scripts/compare_ckpts.py).

Each checkpoint's net runs the engine (pre bias correction, robust self
NLE, one collab round under the rescue policy) on eight flat-content
scenes of eight 512-px crops (eval_synth.make_scene(i, content='flat'),
i = 0..7) and prints its mean PSNR beside the noisy mean and each
scene's PSNR. The arch is read off each file's parameter tree: the
gru32 GuidedResUnet, or a GuidedResUnetS2D with its width, head kernel
and tail (the JAX script takes the gru32 arch only). Runs on the GPU
("cuda"; it raises when there is none) unless --cpu is given.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict

import numpy as np

from .. import resolve_device
from ..core.logging import log
from ..eval.metrics import psnr
from ..models.unets import GRU32_ARCH, load_model
from ..pipeline.denoiser import VSTDenoiser
from ..pipeline.engine import PipelineConfig, YONDEngine
from ..io.ckpt import load_checkpoint
from ..vst.lut import BiasLUT
from .eval_synth import make_scene


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpts", nargs="+")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU)")
    return ap


def arch_of(params: Dict[str, Any]) -> Dict[str, Any]:
    """The arch block of a checkpoint's flax params: the gru32 flagship
    (a `unet` tree) or a GuidedResUnetS2D (width from conv_in, head
    kernel from conv_out, tail width from tail_1)."""
    tree = params.get("params", params)
    if "unet" in tree:
        return dict(GRU32_ARCH)
    arch = {"name": "GuidedResUnetS2D", "guided": True, "in_nc": 4,
            "out_nc": 4, "nf": int(tree["conv_in"]["kernel"].shape[-1]),
            "nframes": 1, "res": True, "norm": True,
            "out_k": int(tree["conv_out"]["kernel"].shape[0])}
    if "tail_1" in tree:
        arch["tail_nf"] = int(tree["tail_1"]["kernel"].shape[-1])
    return arch


def compare(path: str, scenes, device) -> dict:
    """One checkpoint through the gate's engine -> {path, arch, mean,
    noisy, psnrs}."""
    arch = arch_of(load_checkpoint(path)["params"])
    den = VSTDenoiser(load_model(arch, path, device=device), guided=True,
                      bias_corr="pre", device=device)
    eng = YONDEngine(den, PipelineConfig(est_type="simple", max_iter=1),
                     biaslut=BiasLUT())
    vals = []
    for clean, noisy, _, _ in scenes:
        p = {"wp": 1023, "bl": 64, "ratio": 1, "scale": 959.0,
             "gain": 1.0, "sigma": 0.0}
        res = eng.iter_denoise({"lr": noisy}, p)
        vals.append(float(psnr(res["raw_dns"][-1], clean)))
    noisy_p = float(np.mean([float(psnr(n, c)) for c, n, _, _ in scenes]))
    log(f"{path}: mean {np.mean(vals):.2f} (noisy {noisy_p:.2f}) "
        f"per-scene {[round(v, 1) for v in vals]}")
    return {"path": path, "arch": arch["name"], "mean": float(np.mean(vals)),
            "noisy": noisy_p, "psnrs": vals}


def main(argv=None) -> list:
    args = build_parser().parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")
    scenes = [make_scene(i, content="flat") for i in range(8)]
    return [compare(path, scenes, device) for path in args.ckpts]


if __name__ == "__main__":
    main()
