"""flax parameter tree <-> the port's PyTorch state_dict.

The port's modules carry the flax module names, so a flax path
`conv1/guide/gamma_in/kernel` becomes `conv1.guide.gamma_in.weight`.
Layouts (the inverse of yondx/models/torch_port.py):
- Conv kernel [kh, kw, in, out] (HWIO) -> Conv2d weight [out, in, kh, kw];
- Dense kernel [in, out] -> Linear weight [out, in];
- ConvTranspose kernel (flax module name `deconv`, transpose_kernel=False)
  -> spatial flip, then ConvTranspose2d weight [in, out, kh, kw].
`state_dict_to_params` is the inverse, for the checkpoints the port writes.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _leaf_to_torch(path, name: str, arr: np.ndarray) -> np.ndarray:
    arr = np.asarray(arr)
    if name != "kernel":
        return arr
    if arr.ndim == 4:
        if path and path[-1] == "deconv":
            return np.transpose(arr[::-1, ::-1], (2, 3, 0, 1))
        return np.transpose(arr, (3, 2, 0, 1))
    if arr.ndim == 2:
        return arr.T
    raise ValueError(f"unexpected kernel rank {arr.ndim} at {'/'.join(path)}")


def params_to_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax params (numpy leaves; the variable dict {'params': tree} or the
    tree itself) -> state_dict of contiguous float32 CPU tensors."""
    if set(params) == {"params"}:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, path):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, path + (key,))
                continue
            arr = _leaf_to_torch(path, key, val)
            tname = "weight" if key == "kernel" else key
            out[".".join(path + (tname,))] = torch.from_numpy(
                np.array(arr, dtype=np.float32, order="C"))

    walk(params, ())
    return out


def _leaf_to_flax(path, name: str, arr: np.ndarray) -> np.ndarray:
    if name != "weight":
        return arr
    if arr.ndim == 4:
        if path and path[-1] == "deconv":
            return np.transpose(arr, (2, 3, 0, 1))[::-1, ::-1]
        return np.transpose(arr, (2, 3, 1, 0))
    if arr.ndim == 2:
        return arr.T
    raise ValueError(f"unexpected weight rank {arr.ndim} at {'.'.join(path)}")


def state_dict_to_params(state_dict) -> Dict[str, Any]:
    """state_dict (or a dict of tensors/arrays laid out like one) -> the
    flax variable dict {'params': tree} of contiguous float32 numpy
    leaves; the inverse of params_to_state_dict."""
    tree: Dict[str, Any] = {}
    for name, val in state_dict.items():
        arr = val.detach().cpu().numpy() if isinstance(val, torch.Tensor) \
            else np.asarray(val)
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node["kernel" if leaf == "weight" else leaf] = np.array(
            _leaf_to_flax(tuple(path), leaf, arr), dtype=np.float32,
            order="C")
    return {"params": tree}


def flax_shape(name: str, shape) -> tuple:
    """The flax shape of the state_dict entry `name` of torch `shape`."""
    *path, leaf = name.split(".")
    return _leaf_to_flax(tuple(path), leaf, np.empty(shape, np.uint8)).shape
