"""Real-raw AWGN training data: SID-style long-exposure crops (port of
yondx/data/raw_dataset.py).

Normalized raw frames -> CFA-phase rotation -> RGGB pack -> crops (host
numpy, SIDRawDataset); then on the device (raw_awgn_batch): a 50% sqrt
VST-range aug, a 50% WB re-gain toward a random camera prior, and AWGN
with per-sample log-uniform sigma. The coin flips, gains and sigmas are
host draws from the JAX key (core/rng.py); the Gaussian field comes from
the caller's train.draws.FieldSource.
"""
from __future__ import annotations

import glob
import os

import numpy as np
import torch

from ..core import rng
from ..core.io import dataload
from ..isp.bayer import bayer2rggb
from .noise import awgn_log_uniform
from .unprocess import random_gains

_F32 = np.float32


class SIDRawDataset:
    """Host side: yields clean RGGB crop stacks [crops, ps/2, ps/2, 4].

    root layout: {root}/{mode}/*.{npy|mat} raw bayer frames in DN."""

    def __init__(self, root_dir: str, mode: str = "train",
                 patch_size: int = 256, crop_per_image: int = 8,
                 croptype: str = "non-overlapped", wp: int = 16383,
                 bl: int = 512, seed: int = 0):
        self.dir = os.path.join(root_dir, mode)
        self.paths = sorted(glob.glob(os.path.join(self.dir, "*.npy")) +
                            glob.glob(os.path.join(self.dir, "*.mat")))
        if not self.paths:
            raise FileNotFoundError(f"no raw frames under {self.dir}")
        self.mode = mode
        self.ps = patch_size
        self.cpi = crop_per_image
        self.croptype = croptype
        self.wp, self.bl = wp, bl
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.paths)

    def _crop_points(self, h, w):
        ps2 = self.ps // 2  # rggb domain
        starts = []
        if self.croptype == "non-overlapped":
            nh, nw = h // ps2, w // ps2
            h0 = self.rng.integers(0, h - nh * ps2 + 1)
            w0 = self.rng.integers(0, w - nw * ps2 + 1)
            for i in range(nh):
                for j in range(nw):
                    starts.append((h0 + i * ps2, w0 + j * ps2))
        else:
            for _ in range(self.cpi):
                starts.append((self.rng.integers(0, h - ps2 + 1),
                               self.rng.integers(0, w - ps2 + 1)))
        return starts

    def __getitem__(self, idx: int):
        raw = dataload(self.paths[idx]).astype(np.float32)
        raw = (raw - self.bl) / (self.wp - self.bl)
        pattern = int(self.rng.integers(4)) if self.mode == "train" \
            else idx % 4
        raw = np.rot90(raw, k=pattern, axes=(-2, -1))
        rggb = np.clip(bayer2rggb(torch.from_numpy(raw.copy())).numpy(),
                       0, 1)
        h, w = rggb.shape[:2]
        ps2 = self.ps // 2
        if self.mode == "train":
            starts = self._crop_points(h, w)[: self.cpi]
            crops = np.stack([rggb[y:y + ps2, x:x + ps2]
                              for (y, x) in starts])
        else:
            crops = rggb[None, :h // ps2 * ps2, :w // ps2 * ps2]
        return crops.astype(np.float32)


def raw_awgn_batch(key, hr_crops, sigma_min: float = 5.0,
                   sigma_max: float = 50.0, vst_aug: bool = True,
                   wb_aug: bool = True, clip: bool = True, *, field):
    """Device augmentation of raw crops [B, h, w, 4] (RGGB): 50% sqrt
    VST-range aug, 50% WB re-gain toward a random camera prior, AWGN with
    per-sample log-uniform sigma. Returns (lr, hr, sigma)."""
    k_v, k_w, k_g, k_n = rng.split(key, 4)
    hr = hr_crops
    if vst_aug and rng.randint(k_v, (), 0, 2) > 0:
        hr = torch.sqrt(torch.clamp(hr, min=0.0))
    if wb_aug and rng.randint(k_w, (), 0, 2) > 0:
        rgb_gain, red, blue = random_gains(k_g)
        gains = np.array([_F32(1) / red, 1, 1, _F32(1) / blue],
                         _F32) * rgb_gain
        hr = hr * torch.from_numpy(gains.astype(_F32)).to(hr.device)
    lr, sigma = awgn_log_uniform(k_n, hr, sigma_min, sigma_max, field=field)
    if clip:
        lr = torch.clamp(lr, 0.0, 1.0)
        hr = torch.clamp(hr, 0.0, 1.0)
    return lr, hr, sigma


def awgn_one_channel_batch(key, hr_crops, sigma_min: float = 5.0,
                           sigma_max: float = 50.0, channel: int = 2, *,
                           field):
    """The 3-clean + 1-noisy variant: AWGN on one RGGB channel only.
    Returns (lr, sigma)."""
    lr, sigma = awgn_log_uniform(key, hr_crops, sigma_min, sigma_max,
                                 field=field)
    mask = torch.zeros(hr_crops.shape[-1], device=hr_crops.device)
    mask[channel] = 1.0
    return hr_crops + (lr - hr_crops) * mask, sigma
