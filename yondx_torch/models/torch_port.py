"""The reference's PyTorch .pth checkpoints <-> flax parameter trees (port
of yondx/models/torch_port.py), for the GuidedResUnet and UNetSeeInDark
nets; `load_reference_pth` carries a .pth into the port's module through
`convert.params_to_state_dict`.

The reference's layouts differ from the port's own: its guidance MLP is
1x1 convs in `nn.Sequential`s (`gamma.0`, `gamma.2`, `beta.1`), its
shortcut conv `short_cut.0`, its up-convs bare `upv{i}`. So a .pth goes
to the flax tree first (numpy copies), and from there to the port.
Conventions:
- Conv2d weight [out, in, kh, kw] -> flax kernel [kh, kw, in, out];
- ConvTranspose2d weight [in, out, kh, kw] -> flax ConvTranspose kernel
  [kh, kw, in, out], spatially flipped (transpose_kernel False; kernel ==
  stride, the only case here);
- a 1x1 conv on the [B, 1, 1, 1] guidance map -> Dense kernel [in, out].
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .convert import params_to_state_dict


def _numpy_sd(state_dict: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """state_dict of tensors or arrays, DataParallel's `module.` prefix
    dropped -> numpy values."""
    return {k.replace("module.", ""): v.detach().cpu().numpy()
            if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in state_dict.items()}


def _conv(w, b=None):
    out = {"kernel": np.transpose(np.asarray(w), (2, 3, 1, 0))}
    if b is not None:
        out["bias"] = np.asarray(b)
    return out


def _deconv(w, b=None):
    k = np.transpose(np.asarray(w), (2, 3, 0, 1))[::-1, ::-1]
    out = {"kernel": np.ascontiguousarray(k)}
    if b is not None:
        out["bias"] = np.asarray(b)
    return out


def _dense_from_1x1(w, b=None):
    out = {"kernel": np.transpose(np.asarray(w)[:, :, 0, 0], (1, 0))}
    if b is not None:
        out["bias"] = np.asarray(b)
    return out


def _grb_from_torch(sd: Dict[str, Any], prefix: str, has_shortcut: bool):
    """The reference's GuidedResidualBlock -> the flax block tree."""
    tree = {
        "conv1": _conv(sd[f"{prefix}.conv1.weight"],
                       sd[f"{prefix}.conv1.bias"]),
        "conv2": _conv(sd[f"{prefix}.conv2.weight"],
                       sd[f"{prefix}.conv2.bias"]),
        "guide": {
            "gamma_in": _dense_from_1x1(sd[f"{prefix}.gamma.0.weight"],
                                        sd[f"{prefix}.gamma.0.bias"]),
            "gamma_out": _dense_from_1x1(sd[f"{prefix}.gamma.2.weight"],
                                         sd[f"{prefix}.gamma.2.bias"]),
            "beta_out": _dense_from_1x1(sd[f"{prefix}.beta.1.weight"],
                                        sd[f"{prefix}.beta.1.bias"]),
        },
    }
    if has_shortcut:
        tree["short_cut"] = {"conv": _conv(sd[f"{prefix}.short_cut.0.weight"],
                                           sd[f"{prefix}.short_cut.0.bias"])}
    return tree


def guidedresunet_from_torch(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """The reference GuidedResUnet's state_dict -> flax variables
    {'params': {'unet': tree}}."""
    sd = _numpy_sd(state_dict)
    unet: Dict[str, Any] = {
        "conv_in": _conv(sd["conv_in.weight"], sd["conv_in.bias"]),
        "conv10": _conv(sd["conv10.weight"], sd["conv10.bias"]),
    }
    # encoder blocks 1..5 keep their channels (no shortcut conv); decoder
    # blocks 6..9 halve them after the concat (shortcut conv)
    for i in range(1, 6):
        unet[f"conv{i}"] = _grb_from_torch(sd, f"conv{i}", has_shortcut=False)
    for i in range(6, 10):
        unet[f"conv{i}"] = _grb_from_torch(sd, f"conv{i}", has_shortcut=True)
    for i in range(1, 5):
        unet[f"pool{i}"] = {"conv": _conv(sd[f"pool{i}.conv.weight"],
                                          sd[f"pool{i}.conv.bias"])}
    for i in range(6, 10):
        unet[f"upv{i}"] = {"deconv": _deconv(sd[f"upv{i}.weight"],
                                             sd[f"upv{i}.bias"])}
    return {"params": {"unet": unet}}


def unetseeindark_from_torch(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """The reference UNetSeeInDark's state_dict -> flax variables."""
    sd = _numpy_sd(state_dict)
    tree: Dict[str, Any] = {}
    for i in range(1, 10):
        tree[f"conv{i}_1"] = _conv(sd[f"conv{i}_1.weight"],
                                   sd[f"conv{i}_1.bias"])
        tree[f"conv{i}_2"] = _conv(sd[f"conv{i}_2.weight"],
                                   sd[f"conv{i}_2.bias"])
    for i in range(6, 10):
        tree[f"upv{i}"] = {"deconv": _deconv(sd[f"upv{i}.weight"],
                                             sd[f"upv{i}.bias"])}
    tree["conv10_1"] = _conv(sd["conv10_1.weight"], sd["conv10_1.bias"])
    return {"params": tree}


def _conv_to_torch(tree):
    return np.transpose(np.asarray(tree["kernel"]), (3, 2, 0, 1)), \
        np.asarray(tree["bias"])


def _deconv_to_torch(tree):
    k = np.asarray(tree["kernel"])[::-1, ::-1]
    return np.ascontiguousarray(np.transpose(k, (2, 3, 0, 1))), \
        np.asarray(tree["bias"])


def _grb_to_torch(tree, prefix: str, has_shortcut: bool) -> Dict[str, Any]:
    """flax GuidedResidualBlock tree -> the reference's state_dict
    entries (inverse of _grb_from_torch)."""
    sd = {}
    for cn in ("conv1", "conv2"):
        sd[f"{prefix}.{cn}.weight"], sd[f"{prefix}.{cn}.bias"] = \
            _conv_to_torch(tree[cn])
    g = tree["guide"]
    for tname, fname in (("gamma.0", "gamma_in"), ("gamma.2", "gamma_out"),
                         ("beta.1", "beta_out")):
        k = np.transpose(np.asarray(g[fname]["kernel"]), (1, 0))
        sd[f"{prefix}.{tname}.weight"] = k[:, :, None, None]
        sd[f"{prefix}.{tname}.bias"] = np.asarray(g[fname]["bias"])
    if has_shortcut:
        sd[f"{prefix}.short_cut.0.weight"], \
            sd[f"{prefix}.short_cut.0.bias"] = _conv_to_torch(
                tree["short_cut"]["conv"])
    return sd


def guidedresunet_to_torch(params: Dict[str, Any]) -> Dict[str, Any]:
    """flax GuidedResUnet variables -> the reference's state_dict (numpy
    values); the inverse of guidedresunet_from_torch."""
    unet = params["params"]["unet"]
    sd: Dict[str, Any] = {}
    for name in ("conv_in", "conv10"):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = _conv_to_torch(unet[name])
    for i in range(1, 6):
        sd.update(_grb_to_torch(unet[f"conv{i}"], f"conv{i}", False))
    for i in range(6, 10):
        sd.update(_grb_to_torch(unet[f"conv{i}"], f"conv{i}", True))
    for i in range(1, 5):
        sd[f"pool{i}.conv.weight"], sd[f"pool{i}.conv.bias"] = \
            _conv_to_torch(unet[f"pool{i}"]["conv"])
    for i in range(6, 10):
        sd[f"upv{i}.weight"], sd[f"upv{i}.bias"] = _deconv_to_torch(
            unet[f"upv{i}"]["deconv"])
    return sd


def unetseeindark_to_torch(params: Dict[str, Any]) -> Dict[str, Any]:
    """flax UNetSeeInDark variables -> the reference's state_dict (numpy
    values); the inverse of unetseeindark_from_torch."""
    tree = params["params"]
    sd: Dict[str, Any] = {}
    for i in range(1, 10):
        for j in (1, 2):
            sd[f"conv{i}_{j}.weight"], sd[f"conv{i}_{j}.bias"] = \
                _conv_to_torch(tree[f"conv{i}_{j}"])
    for i in range(6, 10):
        sd[f"upv{i}.weight"], sd[f"upv{i}.bias"] = _deconv_to_torch(
            tree[f"upv{i}"]["deconv"])
    sd["conv10_1.weight"], sd["conv10_1.bias"] = _conv_to_torch(
        tree["conv10_1"])
    return sd


def load_pth(path: str) -> Dict[str, Any]:
    """A torch checkpoint file (tensors only) -> its state_dict (the
    `state_dict` entry when the file wraps one)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return sd


def pth_transfer(src_path: str, dst_path: str, key: str = "netG") -> None:
    """Write the sub-network state_dict under `key` of a composite
    checkpoint (ELD-style files wrap the denoiser under 'netG') to
    dst_path. The source is unpickled in full: read only trusted files."""
    blob = torch.load(src_path, map_location="cpu", weights_only=False)
    sd = blob[key] if key in blob else blob
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    torch.save(sd, dst_path)


PORTERS = {
    "GuidedResUnet": guidedresunet_from_torch,
    "UNetSeeInDark": unetseeindark_from_torch,
}


def port_checkpoint(arch_name: str, pth_path: str) -> Dict[str, Any]:
    """A reference .pth of `arch_name` -> flax variables {'params': ...}."""
    if arch_name not in PORTERS:
        raise KeyError(f"No torch porter for {arch_name}")
    return PORTERS[arch_name](load_pth(pth_path))


def load_reference_pth(net: torch.nn.Module, arch_name: str,
                       pth_path: str) -> torch.nn.Module:
    """Load a reference .pth of `arch_name` into the port's module `net`
    (strict: every weight must match) and return it."""
    net.load_state_dict(params_to_state_dict(
        port_checkpoint(arch_name, pth_path)))
    return net
