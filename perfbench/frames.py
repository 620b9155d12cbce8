"""The traffic generator: a pool of noisy raw frames made on the device
from a seed, as a traffic file under `traffic/` describes them.

Content: a grid of random flat levels (`levels` rows x columns, each
level uniform in [level_lo, level_lo + level_span]) stretched over the
Bayer frame by nearest neighbour. Noise: Poisson-Gaussian in DN,
(K * Poisson(clean * scale / K) + N(0, sigma^2)) / scale, clipped to
[0, 1], with scale = white level - black level. Each camera's frames
take ln K stratified over its calibrated [Kmin, Kmax] (one draw in each
of n equal slices, in a seeded order), and ln sigma from the camera's
sigGs regression on ln K with its Gaussian scatter.

Frames are handed to the entry packed RGGB, [1, H/2, W/2, 4] float32.
The visiting order cycles: round r holds the r-th frame of every camera
that has one, cameras in a seeded order.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Frame:
    camera: str
    rggb: torch.Tensor          # [1, H/2, W/2, 4] float32 on the device
    scale: float
    K: float
    sigma: float

    @property
    def mp(self):
        return self.rggb.shape[1] * self.rggb.shape[2] * 4 / 1e6


def _noisy_rggb(levels, H, W, K, sigma, scale, gen, device):
    rows = torch.div(torch.arange(H, device=device) * levels.shape[0], H,
                     rounding_mode="floor")
    cols = torch.div(torch.arange(W, device=device) * levels.shape[1], W,
                     rounding_mode="floor")
    clean = levels[rows][:, cols]
    noisy = K * torch.poisson(clean * (scale / K), generator=gen)
    noisy += sigma * torch.randn((H, W), generator=gen, device=device)
    noisy = torch.clamp(noisy / scale, 0.0, 1.0)
    x = noisy.reshape(H // 2, 2, W // 2, 2).permute(0, 2, 1, 3)
    return x.reshape(1, H // 2, W // 2, 4).contiguous()


def make_pool(mix, seed, device):
    """(frames, order) of the mix `mix` (a parsed traffic file) for
    `seed`: the same seed gives the same frames and the same order."""
    rng = np.random.default_rng(seed % 2 ** 64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(2 ** 62)))
    n_lv = mix["levels"]
    per_cam = []
    for cam in mix["cameras"]:
        reg = cam["regression"]
        n = cam["frames"]
        u = (rng.permutation(n) + rng.random(n)) / n
        frames = []
        for j in range(n):
            log_k = reg["Kmin"] + u[j] * (reg["Kmax"] - reg["Kmin"])
            log_s = rng.normal(reg["sigGsk"] * log_k + reg["sigGsb"],
                               reg["sigGssig"])
            K, sigma = float(np.exp(log_k)), float(np.exp(log_s))
            scale = float(reg["wp"] - reg["bl"])
            lv = rng.random((n_lv[0], n_lv[1])) * mix["level_span"] \
                + mix["level_lo"]
            levels = torch.as_tensor(lv, dtype=torch.float32, device=device)
            frames.append(Frame(cam["name"], _noisy_rggb(
                levels, cam["height"], cam["width"], K, sigma, scale, gen,
                device), scale, K, sigma))
        per_cam.append(frames)
    pool, order = [], []
    index = {}
    for c, frames in enumerate(per_cam):
        for j, f in enumerate(frames):
            index[c, j] = len(pool)
            pool.append(f)
    for r in range(max(len(f) for f in per_cam)):
        cams = [c for c in range(len(per_cam)) if r < len(per_cam[c])]
        order += [index[c, r] for c in rng.permutation(cams)]
    return pool, order
