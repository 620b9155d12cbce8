"""The comparison that decides `correct`: the program's outputs for the
frames of the window against the plain reference run on the same frames.

Numbers, over the frames compared:
- self_gap: the round-0 (self) noise model's gap to the reference's,
  max(|d beta1| * mu, |d beta2|) / (beta1 * mu + beta2) of the
  reference at the frame's mean mu, a share of the noise variance: its
  median over the frames of each frame shape, and the largest of those
  medians. The median, because the flat mask of a fit turns on a
  threshold picked among percentiles: on a frame or two in a hundred
  the two sides pick a different one; per shape, so that a fault that
  only one shape's frames reach (a band plan, a camera's range) is not
  outvoted by the others;
- collab_gap: the same of the collab round's model;
- dn_rms: the largest over the frames of the RMS of the denoised
  frame's difference, over the reference's noise std at the frame's mean
  (sqrt(beta1 * mu + beta2));
- dn_max: the largest absolute difference, over the same std;
- gate_mismatch: frames whose rescue-gate decision differs (exact).
A cell compares the numbers its limits file names (limits/<cell>.json).
"""
from __future__ import annotations

import math
import statistics

import torch

NAMES = ("self_gap", "collab_gap", "dn_rms", "dn_max", "gate_mismatch")


def _reg_gap(reg, ref, mu):
    var = float(ref[0]) * mu + float(ref[1])
    if not math.isfinite(var) or var <= 0:
        return math.inf
    gap = max(abs(float(reg[0]) - float(ref[0])) * mu,
              abs(float(reg[1]) - float(ref[1])))
    return gap / var if math.isfinite(gap) else math.inf


def frame_numbers(dn, regs, fired, ref_dn, ref_regs, ref_fired, x):
    """The numbers of one frame: program (dn, regs, fired) against the
    reference's, on the input frame x [1, h, w, 4]."""
    mu = float(torch.mean(torch.clamp(x, 0.0, 1.0)))
    ref_regs = ref_regs.detach().double().cpu()
    regs = regs.detach().double().cpu()
    std = math.sqrt(max(float(ref_regs[0, 0]) * mu + float(ref_regs[0, 1]),
                        1e-30))
    d = (dn.double() - ref_dn.double())
    finite = bool(torch.isfinite(d).all())
    return {
        "self_gap": _reg_gap(regs[0], ref_regs[0], mu),
        "collab_gap": _reg_gap(regs[1], ref_regs[1], mu),
        "dn_rms": float(torch.sqrt(torch.mean(d * d))) / std
        if finite else math.inf,
        "dn_max": float(torch.max(torch.abs(d))) / std if finite else math.inf,
        "gate_mismatch": int(bool(fired) != bool(ref_fired)),
        "shape": tuple(x.shape[1:3]),
    }


def _median_per_shape(values, shapes):
    groups = {}
    for v, s in zip(values, shapes):
        groups.setdefault(tuple(s), []).append(v)
    return max(statistics.median(g) for g in groups.values())


AGGREGATE = {"dn_rms": max, "dn_max": max, "gate_mismatch": sum}
PER_FRAME = ("dn_rms", "dn_max", "gate_mismatch")


def worst(per_frame):
    """Each number over the frames: the noise-model gaps as the largest
    median of a frame shape, the others as AGGREGATE takes them."""
    shapes = [f["shape"] for f in per_frame]
    return {n: AGGREGATE[n]([f[n] for f in per_frame]) if n in AGGREGATE
            else _median_per_shape([f[n] for f in per_frame], shapes)
            for n in NAMES}


def verdict(numbers, limits):
    """(correct, {name: {value, limit}}) over the numbers `limits` names;
    NaN fails."""
    table = {n: {"value": numbers[n], "limit": limits[n]} for n in limits}
    return all(numbers[n] <= limits[n] for n in limits), table


def failed_frames(per_frame, limits):
    """Frames whose output or gate decision fails a limit of its own."""
    names = [n for n in PER_FRAME if n in limits]
    return sum(any(not (f[n] <= limits[n]) for n in names)
               for f in per_frame)
