"""Generalized Anscombe VST and its inverses (port of yondx/vst/vst.py)."""
from __future__ import annotations

import torch

_SQ32 = 1.2247448713915890  # sqrt(3/2)


def vst(x, sigma, mu=0.0, gain=1.0):
    """Forward generalized Anscombe transform."""
    fz = gain * x + (3.0 / 8.0) * gain ** 2 + sigma ** 2 - gain * mu
    fz = torch.clamp(fz, min=0.0)
    return (2.0 / gain) * torch.sqrt(fz)


def inverse_vst(z, sigma, gain=1.0, exact: bool = False):
    """Inverse VST; `exact` selects the closed-form exact-unbiased
    approximation (z <= 0 maps to 0 on that path)."""
    s = sigma / gain
    if exact:
        zs = torch.where(z > 0, z, torch.ones_like(z))
        inv = 1.0 / zs
        fz = ((zs / 2.0) ** 2 + 0.25 * _SQ32 * inv - (11.0 / 8.0) * inv ** 2
              + (5.0 / 8.0) * _SQ32 * inv ** 3 - 1.0 / 8.0 - s ** 2)
        fz = torch.where(z > 0, fz, torch.zeros_like(fz))
    else:
        fz = (z / 2.0) ** 2 - 3.0 / 8.0 - s ** 2
    fz = torch.clamp(fz, min=0.0)
    return fz * gain
