"""Multi-frame index plumbing for video/burst denoising (port of
yondx/data/video.py): sliding nframes windows over a 7-frame burst with
reflect or clip boundary handling."""
from __future__ import annotations

import numpy as np
import torch


def num_clip(nums, lo, hi):
    return np.clip(np.array(nums), lo, hi)


def num_reflect(nums, lo, hi):
    nums = np.abs(np.array(nums) - lo)
    return hi - np.abs(hi - nums)


def frame_index_splitor(nframes: int = 1, pad: bool = True,
                        reflect: bool = True):
    """Index groups for a 7-frame burst: one window of nframes indices
    per output frame (7 with pad, else 8 - nframes)."""
    r = nframes // 2
    if pad:
        frames = [[i + k - r for k in range(nframes)] for i in range(7)]
    else:
        frames = [[i + k for k in range(nframes)]
                  for i in range(8 - nframes)]
    return num_reflect(frames, 0, 6) if reflect else num_clip(frames, 0, 6)


def multi_frame_loader(frames, index, gt: bool = False,
                       keepdims: bool = False):
    """Gather [B, 7, h, w, c] burst frames into per-window stacks ->
    [n_windows, B, nframes, h, w, c] (or the center frame of each window
    when gt=True, [n_windows, B, h, w, c], or [..., B, 1, ...] with
    keepdims)."""
    out = []
    for ind in index:
        if gt:
            t = frames[:, int(ind[len(index[0]) // 2])]
            if keepdims:
                t = t[:, None]
        else:
            t = torch.stack([frames[:, int(i)] for i in ind], dim=1)
        out.append(t)
    return torch.stack(out, dim=0)
