"""Model registry: YAML arch name -> nn.Module (port of
yondx/models/registry.py, for the models the port has), and the fresh
weights of a new net, equal to the JAX package's."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..core import rng
from . import comp, unets
from .convert import flax_shape, params_to_state_dict

MODEL_REGISTRY = {
    "GuidedResUnet": unets.GuidedResUnet,
    "GuidedResUnetS2D": unets.GuidedResUnetS2D,
    "est_UNet": comp.est_UNet,
}

# Models whose forward takes (x, t)
GUIDED_MODELS = {"GuidedResUnet", "GuidedResUnetS2D", "SNRnet",
                 "GuidedSelfUnet"}


def build_model(arch: Dict[str, Any]):
    """arch: the YAML `arch:` block (must contain 'name'). The module's
    parameters are PyTorch's default init: load a checkpoint into it."""
    name = arch["name"]
    if name not in MODEL_REGISTRY:
        raise KeyError(f"Unknown arch name {name!r}; known: "
                       f"{sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name](arch)


def is_guided(arch: Dict[str, Any]) -> bool:
    return arch.get("guided", arch["name"] in GUIDED_MODELS)


def init_params(net, seed: int = 42, std: float = 0.02
                ) -> Dict[str, torch.Tensor]:
    """Fresh weights of `net` equal to the JAX package's
    `initialize_weights(init_params(model, PRNGKey(0), ...),
    PRNGKey(seed))`: walking the flax leaves in sorted path order with one
    split of the key per leaf, every `kernel`, and every `bias` outside a
    `deconv`, becomes N(0, std) drawn with `core.rng.normal` (bit-equal
    to jax.random.normal); deconv biases keep flax's zero init, which is
    all PRNGKey(0) decides for these nets. Returns a CPU float32
    state_dict for `net.load_state_dict`."""
    leaves = []
    for name, t in net.state_dict().items():
        *path, leaf = name.split(".")
        if leaf not in ("weight", "bias"):
            raise ValueError(f"no flax init rule for {name}")
        fpath = ("params", *path, "kernel" if leaf == "weight" else leaf)
        leaves.append((fpath, name, flax_shape(name, tuple(t.shape))))
    key = rng.PRNGKey(seed)
    tree: Dict[str, Any] = {}
    for fpath, name, shape in sorted(leaves):
        key, sub = rng.split(key)
        if fpath[-1] == "kernel" or not any("deconv" in n for n in fpath):
            arr = rng.normal(sub, shape) * np.float32(std)
        else:
            arr = np.zeros(shape, np.float32)
        node = tree
        for k in fpath[1:-1]:
            node = node.setdefault(k, {})
        node[fpath[-1]] = arr
    return params_to_state_dict(tree)


def param_count(params) -> int:
    """Number of parameters of a module, state_dict or flax tree."""
    if isinstance(params, torch.nn.Module):
        return sum(p.numel() for p in params.parameters())
    total = 0
    for v in params.values():
        total += param_count(v) if isinstance(v, dict) \
            else int(np.prod(np.shape(v)))
    return total
