"""What the probe CLIs of the port share (cli/probe_*.py, cli/bench_matrix.py).

Each probe is a host wrapper over the port's functions that prints the rows
of the JAX script it ports and returns them from `main`. Like the scripts,
they read checkpoints from `checkpoints/Gaussian` under the working
directory (run them from the repo root), and run on the GPU unless --cpu.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .. import resolve_device
from ..eval.heldout import build_scene
from ..io.ckpt import find_checkpoint
from ..isp.bayer import bayer2rggb
from ..models.unets import load_model

CKPT_DIR = "checkpoints/Gaussian"


def device_of(cpu: bool) -> torch.device:
    """"cpu" with --cpu, else "cuda" (raises when there is no card)."""
    return resolve_device("cpu" if cpu else "cuda")


def guided_arch(name: str = "GuidedResUnet", nf: int = 32, **extra) -> dict:
    """The arch dict the probes build their SNR-Nets from."""
    return {"name": name, "guided": True, "in_nc": 4, "out_nc": 4,
            "nf": nf, "nframes": 1, "res": True, "norm": True, **extra}


def load_net(arch: dict, model: str, device, dtype=torch.float32):
    """The committed checkpoint `model` under CKPT_DIR in a net of `arch`
    (raises when it is missing)."""
    ck = find_checkpoint(CKPT_DIR, model)
    if ck is None:
        raise FileNotFoundError(f"no checkpoint {model} under {CKPT_DIR!r}")
    return load_model(arch, ck, device=device, dtype=dtype)


def get_scene(spec, scenes: Optional[Dict] = None,
              n_crops: Optional[int] = None):
    """build_scene(spec, n_crops), taken from and kept in `scenes` (keyed
    (name, n_crops), as eval_synth.run's scene dict) when given."""
    key = (spec.name, n_crops)
    if scenes is not None and key in scenes:
        return scenes[key]
    pair = build_scene(spec, n_crops)
    if scenes is not None:
        scenes[key] = pair
    return pair


def rggb_of(bayer, device):
    """A bayer array or tensor -> float32 RGGB planes on `device`."""
    return bayer2rggb(torch.as_tensor(bayer, dtype=torch.float32,
                                      device=device))
