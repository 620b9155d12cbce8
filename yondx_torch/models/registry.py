"""Model registry: YAML arch name -> nn.Module (port of
yondx/models/registry.py), and the fresh weights of a new net, equal to
the JAX package's: `init_params` (flax's init followed by the reference's
N(0, 0.02), the AWGN trainer's) and `flax_init_params` (flax's own
default init, the est trainer's)."""
from __future__ import annotations

import hashlib
from typing import Any, Dict

import numpy as np
import torch

from ..core import rng
from . import comp, unets
from .convert import flax_shape, params_to_state_dict

MODEL_REGISTRY = {
    "UNetSeeInDark": unets.UNetSeeInDark,
    "ResUnet": unets.ResUnet,
    "ResUnet2": unets.ResUnet2,
    "SNRnet": unets.SNRnet,
    "GuidedResUnet": unets.GuidedResUnet,
    "GuidedResUnetS2D": unets.GuidedResUnetS2D,
    "EstUnet": unets.EstUnet,
    "DnCNN": comp.DnCNN,
    "est_UNet": comp.est_UNet,
    "FBI_Net": comp.FBI_Net,
    "SelfSupUNet": comp.SelfSupUNet,
    "SelfResUNet": comp.SelfResUNet,
    "GuidedSelfUnet": comp.GuidedSelfUnet,
    "N2NF_Unet": comp.N2NF_Unet,
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


# flax's init of the leaves that are neither kernels nor biases: a
# PReLU's alpha, a BatchNorm's scale and its batch stats
_CONST_INIT = {"alpha": 0.0, "scale": 1.0, "mean": 0.0, "var": 1.0}
_BATCH_STATS = ("mean", "var")


def _tree_set(tree, path, leaf, arr) -> None:
    node = tree
    for k in path:
        node = node.setdefault(k, {})
    node[leaf] = arr


def init_params(net, seed: int = 42, std: float = 0.02
                ) -> Dict[str, torch.Tensor]:
    """Fresh weights of `net` equal to the JAX package's
    `initialize_weights(init_params(model, PRNGKey(0), ...),
    PRNGKey(seed))`: walking flax's variables (the `batch_stats`
    collection, then `params`) in sorted path order with one split of the
    key per leaf, every `kernel`, and every `bias` outside a `deconv`,
    becomes N(0, std) drawn with `core.rng.normal` (bit-equal to
    jax.random.normal); deconv biases keep flax's zero init, which is all
    PRNGKey(0) decides for these nets, and PReLU alphas, BatchNorm scales
    and batch stats flax's constants. Returns a CPU float32 state_dict for
    `net.load_state_dict`."""
    leaves = []
    for name, t in net.state_dict().items():
        *path, leaf = name.split(".")
        if leaf not in ("weight", "bias") and leaf not in _CONST_INIT:
            raise ValueError(f"no flax init rule for {name}")
        col = "batch_stats" if leaf in _BATCH_STATS else "params"
        fpath = (col, *path, "kernel" if leaf == "weight" else leaf)
        leaves.append((fpath, name, flax_shape(name, tuple(t.shape))))
    key = rng.PRNGKey(seed)
    tree: Dict[str, Any] = {}
    for fpath, name, shape in sorted(leaves):
        key, sub = rng.split(key)
        if fpath[-1] in _CONST_INIT:
            arr = np.full(shape, _CONST_INIT[fpath[-1]], np.float32)
        elif fpath[-1] == "kernel" or not any("deconv" in n for n in fpath):
            arr = rng.normal(sub, shape) * np.float32(std)
        else:
            arr = np.zeros(shape, np.float32)
        _tree_set(tree, fpath[1:-1], fpath[-1], arr)
    return params_to_state_dict(tree)


# erf(-+2 / sqrt(2)) in XLA's float32 erf: the uniform bounds of
# jax.random.truncated_normal(key, -2, 2)
_TRUNC_LO = np.uint32(0xBF745A18).view(np.float32)
_TRUNC_HI = np.uint32(0x3F745A18).view(np.float32)


def _flax_rng(key, path) -> np.ndarray:
    """flax's key for a module path: PRNGKey folded in with the first 4
    bytes of the SHA-1 of the path's names and the scope's rng counter
    (core/scope.py _fold_in_static, no separators)."""
    m = hashlib.sha1()
    for x in path:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
    return rng.fold_in(key, int.from_bytes(m.digest()[:4], "big"))


def lecun_normal(key, shape) -> np.ndarray:
    """flax's default kernel init for an HWIO or [in, out] `shape`:
    truncated_normal(key, -2, 2) * sqrt(1 / fan_in) / 0.8796256610342398,
    fan_in = the product of all but the last dimension."""
    f32 = np.float32
    fan_in = int(np.prod(shape[:-1]))
    std = np.sqrt(f32(1.0 / fan_in)) / f32(0.87962566103423978)
    u = rng.uniform(key, shape, _TRUNC_LO, _TRUNC_HI)
    out = f32(np.sqrt(2)) * rng.erfinv_f32(u)
    out = np.clip(out, np.nextafter(f32(-2), f32(np.inf)),
                  np.nextafter(f32(2), f32(-np.inf)))
    return (out * std).astype(f32)


def flax_init_params(net, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Fresh weights of `net` equal to the JAX package's
    `init_params(model, PRNGKey(seed), ...)` with no `initialize_weights`:
    each Conv / ConvTranspose / Dense kernel (the masked convs' too) is
    lecun_normal drawn from flax's key for its module path (its first
    param, rng counter 1), each bias 0, PReLU alphas, BatchNorm scales and
    batch stats flax's constants. Returns a CPU float32 state_dict for
    `net.load_state_dict`."""
    key = rng.PRNGKey(seed)
    tree: Dict[str, Any] = {}
    for name, t in net.state_dict().items():
        *path, leaf = name.split(".")
        shape = flax_shape(name, tuple(t.shape))
        if leaf == "weight" and len(shape) in (2, 4):
            arr = lecun_normal(_flax_rng(key, (*path, 1)), shape)
            leaf = "kernel"
        elif leaf == "bias":
            arr = np.zeros(shape, np.float32)
        elif leaf in _CONST_INIT:
            arr = np.full(shape, _CONST_INIT[leaf], np.float32)
        else:
            raise ValueError(f"no flax default init rule for {name}")
        _tree_set(tree, path, leaf, arr)
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
