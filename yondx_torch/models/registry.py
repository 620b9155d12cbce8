"""Model registry: YAML arch name -> nn.Module (port of
yondx/models/registry.py:40-52, for the models the port has)."""
from __future__ import annotations

from typing import Any, Dict

from . import comp, unets

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
