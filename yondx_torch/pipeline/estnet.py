"""A noise-estimation net as the engine's estimator callable (port of the
`_apply` that yondx/cli/yond.py:129-138 wraps around each est_* net, and
of scripts/eval_synth.py's `_est`).

raw bayer [N, H, W] or [H, W] -> bayer2rggb -> clip to [0, 1] -> the net;
a scalar estimator's [N, 2] output (est_UNet: beta1 and sigma in [0, 1]
units) is pooled to one scene-level prediction by the mean over the
crops. Both CLIs build their est nets with it.
"""
from __future__ import annotations

import torch

from ..isp.bayer import bayer2rggb


class EstNet:
    """Callable raw -> numpy prediction on `device`; counts its calls and
    keeps its outputs."""

    def __init__(self, model, device):
        self.model = model
        self.device = device
        self.calls = 0
        self.outputs = []

    @torch.no_grad()
    def __call__(self, raw):
        x = bayer2rggb(torch.as_tensor(raw, dtype=torch.float32,
                                       device=self.device))
        if x.ndim == 3:
            x = x[None]
        out = self.model(torch.clamp(x, 0.0, 1.0))
        out = out.mean(dim=0) if out.ndim == 2 else out
        out = out.float().cpu().numpy()
        self.calls += 1
        self.outputs.append(out)
        return out
