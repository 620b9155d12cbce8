"""Warm-start a GuidedResUnetS2D from a trained GuidedResUnet (port of
yondx/train/s2d_port.py, on the port's state_dicts).

Every encoder/decoder stage of the flagship from scale 2 down has an exact
shape twin in the packed net: flagship conv2/3/4/5 <-> s2d conv1/2/3/4,
pools 2/3/4 <-> 1/2/3, deconvs upv6/7/8 <-> upv5/6/7, decoder blocks
conv6/7/8 <-> conv5/6/7. The packing-boundary layers (conv_in, conv_out,
the tail) have no counterpart and keep their fresh init. The trainer's
`distill.freeze: 'ported'` freezes the stages of S2D_PORT_MAP.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

# s2d layer -> flagship layer (inside the flagship's `unet` submodule)
S2D_PORT_MAP = {
    "conv1": "conv2", "conv2": "conv3", "conv3": "conv4",
    "conv4": "conv5",
    "pool1": "pool2", "pool2": "pool3", "pool3": "pool4",
    "upv5": "upv6", "upv6": "upv7", "upv7": "upv8",
    "conv5": "conv6", "conv6": "conv7", "conv7": "conv8",
}


def _stages(sd: Dict[str, torch.Tensor]) -> Dict[str, Dict[str, torch.Tensor]]:
    """state_dict -> {top-level stage: {rest of the name: tensor}}."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, t in sd.items():
        stage, _, rest = name.partition(".")
        out.setdefault(stage, {})[rest] = t
    return out


def extend_with_tail(src_sd, dst_sd) -> Dict[str, torch.Tensor]:
    """Port a tail-less GuidedResUnetS2D state_dict into the tail_nf > 0
    variant: every other stage copies over verbatim (a shape twin, or
    raise); the tail stages keep `dst_sd`'s values."""
    src, dst = _stages(src_sd), _stages(dst_sd)
    out = {}
    for stage, leaves in dst.items():
        if not stage.startswith("tail_"):
            if stage not in src:
                raise KeyError(f"stage {stage} missing from source checkpoint")
            twin = src[stage]
            if {k: tuple(v.shape) for k, v in leaves.items()} != \
                    {k: tuple(v.shape) for k, v in twin.items()}:
                raise ValueError(f"stage {stage} is not a shape twin")
            leaves = twin
        for rest, t in leaves.items():
            out[f"{stage}.{rest}"] = t.clone()
    return out


def port_guidedresunet_to_s2d(src_sd, dst_sd
                              ) -> Tuple[Dict[str, torch.Tensor], List[str],
                                         List[str]]:
    """Copy every shape-twin stage of a GuidedResUnet state_dict (its
    `unet.` submodule) into a GuidedResUnetS2D state_dict. Returns
    (merged state_dict, ported stage names, fresh stage names); raises on
    a missing twin leaf or a shape mismatch."""
    src = _stages({k[len("unet."):]: v for k, v in src_sd.items()
                   if k.startswith("unet.")})
    dst = _stages(dst_sd)
    out, ported, fresh = {}, [], []
    for stage, leaves in dst.items():
        if stage in S2D_PORT_MAP:
            twin = src[S2D_PORT_MAP[stage]]
            for rest, t in leaves.items():
                if rest not in twin:
                    raise KeyError(f"{stage}.{rest} has no twin in flagship "
                                   f"{S2D_PORT_MAP[stage]}")
                if tuple(twin[rest].shape) != tuple(t.shape):
                    raise ValueError(
                        f"shape mismatch at {stage}.{rest}: "
                        f"{tuple(twin[rest].shape)} vs {tuple(t.shape)}")
            leaves = twin
            ported.append(stage)
        else:
            fresh.append(stage)
        for rest, t in leaves.items():
            out[f"{stage}.{rest}"] = t.clone()
    return out, sorted(ported), sorted(fresh)
