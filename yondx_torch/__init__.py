"""yondx_torch: the PyTorch + CUDA port of yondx (blind raw-image denoising).

The JAX package `yondx` is the reference; every module here mirrors the
module of the same name there. Public functions take channels-last
tensors ([..., h, w, 4] RGGB), as the JAX ones do. Entry points run on
the GPU (`device="cuda"`) unless the caller passes `device="cpu"`.
"""
from __future__ import annotations

import os

import torch

from .core import vml

# MKL's vector math started on this thread before any intra-op worker
# calls it: a first call on several threads at once can leave a worker's
# chunk inexact (core/vml.py)
vml.warm()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: "cuda" unless told otherwise.

    Raises when CUDA is asked for (explicitly or by default) and absent;
    an entry point never carries on quietly on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "yondx_torch runs on the GPU by default and no CUDA device is "
            "available; pass device='cpu' to run the plain CPU path")
    return dev


def child_env() -> dict:
    """os.environ with this package's root first on PYTHONPATH: the
    environment of a child interpreter that imports yondx_torch from any
    working directory."""
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    return env
