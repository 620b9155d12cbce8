"""YAML runfile loading (port of yondx/config/__init__.py), read with the
port's own reader of the YAML subset the runfiles use
(config.yaml_subset), and the same normalisations: default dst clip,
bias_corr 'none' -> None, the mode override and host_prefix on every
dst*.root_dir.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

from .yaml_subset import load


def load_runfile(path: str, mode: Optional[str] = None,
                 host_prefix: Optional[str] = None) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as f:
        args = load(f.read())
    if mode is not None:
        args["mode"] = mode
    if "dst" in args and "clip" not in args["dst"]:
        args["dst"]["clip"] = False
    if "pipeline" in args and args["pipeline"].get("bias_corr") == "none":
        args["pipeline"]["bias_corr"] = None
    if host_prefix:
        for key in args:
            if "dst" in key and isinstance(args[key], dict) \
                    and "root_dir" in args[key]:
                args[key]["root_dir"] = os.path.join(host_prefix,
                                                     args[key]["root_dir"])
    return args
