"""Iteration-1 output policy (port of yondx/pipeline/policy.py:69-125).

'rescue' (default) blends toward the collab round only when collab says
the noise was UNDER-estimated by more than `tol` and the input's noise
floor certifies the self model low.
"""
from __future__ import annotations

import torch

POLICIES = ("replace", "avg", "guard", "avg_guard", "rescue")
DEFAULT_POLICY = "rescue"
DEFAULT_TOL = 0.15
DEFAULT_FLOOR_FRAC = 1.5


def reg_agreement(self_reg, collab_reg, mean_intensity):
    """Signed relative disagreement of the two noise models' total
    variance at the mean intensity (positive = collab says higher)."""
    b1s, b2s = self_reg
    b1c, b2c = collab_reg
    v_self = b1s * mean_intensity + b2s
    v_col = b1c * mean_intensity + b2c
    return (v_col - v_self) / torch.clamp(torch.as_tensor(v_self),
                                          min=1e-30)


def combine_rounds(dn0, dn1, disagree, policy: str = DEFAULT_POLICY,
                   tol: float = DEFAULT_TOL, floor_frac=None,
                   floor_frac_tol: float = DEFAULT_FLOOR_FRAC):
    """Combine the round-0 and round-1 outputs per the policy."""
    if policy == "replace":
        return dn1
    if policy == "avg":
        return 0.5 * dn0 + 0.5 * dn1
    disagree = torch.as_tensor(disagree, dtype=torch.float32,
                               device=dn0.device)
    if policy == "rescue":
        w = torch.clamp((disagree - tol) / (2.0 * tol), 0.0, 1.0)
        if floor_frac is not None:
            ff = torch.as_tensor(floor_frac, device=dn0.device)
            w = w * (ff > floor_frac_tol)
        return (1.0 - w) * dn0 + w * dn1
    take = torch.abs(disagree) > tol
    if policy == "guard":
        return torch.where(take, dn1, dn0)
    if policy == "avg_guard":
        return torch.where(take, 0.5 * dn0 + 0.5 * dn1, dn0)
    raise ValueError(f"unknown iter policy {policy!r}; one of {POLICIES}")
