"""Data augmentation (port of yondx/data/augment.py).

- `data_aug8`: the 8-way rot/flip augmentation of the RGB mode;
- `get_aug_param`: per-sample channel gain offsets from the camera WB
  prior ('augv5') or around identity ('augv2'), renormalized so that the
  least offset is 0; host draws from the JAX key (core/rng.py);
- `sna`: shot-noise-aware augmentation, brightness added to the GT
  matched with extra Poisson noise on the noisy frame (the Poisson field
  from the caller's train.draws.FieldSource); the reference's BiSNA
  (negative-gain) branch raises NotImplementedError and is likewise
  left out;
- `HighBitRecovery`: quantized read-noise codes mapped back to
  continuous values through the read-noise distribution's inverse CDF
  (host numpy and scipy, equal to the JAX package's for one
  np.random.Generator);
- `illuminance_correct`: least-squares scalar brightness alignment on
  non-saturated pixels.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import rng
from .noise import get_camera_noisy_params, get_specific_noise_params
from .unprocess import random_gains

_F32 = np.float32


def data_aug8(imgs, modes):
    """8-way rot/flip augmentation of square crops: imgs [B, S, S, C],
    modes [B] ints; mode % 4 = rot90 count over (H, W), mode // 4 > 0 =
    then a flip of the width axis."""
    modes = [int(m) for m in torch.as_tensor(modes).tolist()]
    out = []
    for img, mode in zip(imgs, modes):
        img = torch.rot90(img, mode % 4, dims=(0, 1))
        if mode // 4 > 0:
            img = torch.flip(img, dims=(1,))
        out.append(img)
    return torch.stack(out)


def get_aug_param(key, wb, command: str = "augv5",
                  camera_type: str = "SonyA7S2"):
    """-> (aug_r, aug_g, aug_b) float32 [B] numpy; wb: [B, 3]."""
    wb = np.asarray(torch.as_tensor(wb).cpu(), _F32)
    b = wb.shape[0]
    ks = rng.split(key, 6)
    r = _F32(rng.randint(ks[0], (), 0, 2)) * _F32(0.25) + _F32(0.25)
    apply = rng.randint(ks[1], (), 0, 4) > 0
    if "augv5" in command:
        rgb_gain, red_gain, blue_gain = random_gains(ks[2])
        rgb_gain = _F32(1.0) / rgb_gain
        rg = wb[:, 0] / red_gain
        bg = wb[:, 2] / blue_gain
        aug_g = rng.uniform(ks[3], (b,)) * r + rgb_gain - _F32(0.9)
        aug_r = rng.uniform(ks[4], (b,)) * r + rg * (1 + aug_g) - _F32(1.1)
        aug_b = rng.uniform(ks[5], (b,)) * r + bg * (1 + aug_g) - _F32(1.1)
    else:  # augv2
        u = r
        aug_g = np.clip(rng.normal(ks[3], (b,)) * r, 0, 4 * u)
        aug_r = np.clip((1 + rng.normal(ks[4], (b,)) * r) * (1 + aug_g) - 1,
                        0, 4 * u)
        aug_b = np.clip((1 + rng.normal(ks[5], (b,)) * r) * (1 + aug_g) - 1,
                        0, 4 * u)
    zero = np.zeros(b, _F32)
    aug_r, aug_g, aug_b = (np.where(apply, x, zero).astype(_F32)
                           for x in (aug_r, aug_g, aug_b))
    # renormalize so that the least gain offset is 0 (non-negative dy)
    daug = np.minimum(np.minimum(np.minimum(aug_r, aug_g), aug_b), _F32(0))
    return tuple(((1 + x) / (1 + daug) - 1).astype(_F32)
                 for x in (aug_r, aug_g, aug_b))


def sna(key, gt, aug_wb, K: float, wp: int, bl: int, ratio: float = 1.0,
        black_lr: bool = False, ori: bool = True, *, field):
    """Shot-noise-aware augmentation. gt: [h, w, 4] RGGB planes in [0,1];
    aug_wb: [4] per-channel gain offsets (>= 0). Returns (dn, dy): the
    noise increment for the noisy frame and the signal increment for the
    GT, both normalized."""
    scale = wp - bl
    gte = gt * scale / ratio
    aug = torch.as_tensor(np.asarray(aug_wb, _F32)).to(gt.device)
    dy = gte * aug.reshape(1, 1, -1)
    dn = field.poisson(key, torch.clamp(dy, min=0.0) / K) * K
    if black_lr:
        dy = dy - gte
    dy = dy * ratio / scale
    dn = dn / scale
    if not ori:
        dn = dn * ratio
    return dn, dy


def illuminance_correct(predict, source):
    """Scalar brightness alignment argmin_s ||s pred - src|| over the
    non-saturated pixels, per leading index of [..., H, W, C]."""
    pred = torch.clamp(predict, 0.0, 1.0)
    mask = (source != 1).to(pred.dtype)
    dims = tuple(range(pred.ndim - 3, pred.ndim)) if pred.ndim >= 3 \
        else tuple(range(pred.ndim))
    num = torch.sum(pred * source * mask, dim=dims, keepdim=True)
    den = torch.sum(pred * pred * mask, dim=dims, keepdim=True)
    return num / torch.clamp(den, min=1e-12) * pred


class HighBitRecovery:
    """Quantized-read-noise de-quantization LUT: for each integer code x
    in [-factor sigma, factor sigma], occurrences map back to continuous
    values by sampling the read-noise distribution's inverse CDF inside
    the code's quantization bin. Host-side (scipy distributions)."""

    def __init__(self, camera_type: str = "IMX686", noise_code: str = "prq",
                 perturb: bool = True, factor: int = 6,
                 use_float: bool = True):
        self.camera_type = camera_type
        self.noise_code = noise_code
        self.perturb = perturb
        self.factor = factor
        self.use_float = use_float
        self.lut = {}

    def _params(self, iso):
        p = get_specific_noise_params(self.camera_type, iso)
        if p is None:
            p = dict(get_camera_noisy_params(self.camera_type))
            p["Kmax"] = np.exp(p["Kmax"])
        p = dict(p)
        p.setdefault("K", p["Kmax"])
        return p

    def get_lut(self, iso_list, blc_mean=None,
                rng: Optional[np.random.Generator] = None):
        gen = rng or np.random.default_rng()
        for iso in iso_list:
            bias = 0.0 if blc_mean is None else float(np.mean(blc_mean[iso]))
            if self.perturb:
                bias += gen.standard_normal() * 0.1
            self.lut[iso] = self._build(iso, bias)

    def _build(self, iso, bias):
        from scipy import stats
        p = self._params(iso)
        if "g" in self.noise_code.lower():
            dist = stats.tukeylambda(p["lam"], loc=bias, scale=p["sigTL"])
            sigma = p["sigTL"]
        else:
            dist = stats.norm(loc=bias, scale=p["sigGs"])
            sigma = p["sigGs"]
        low = max(int(-sigma * self.factor + bias), -int(p["bl"]) + 1)
        high = int(sigma * self.factor + bias)
        info = {"param": p, "dist": dist, "low": low, "high": high,
                "bias": bias, "sigma": sigma}
        for x in range(low, high):
            info[x] = {"cdf": dist.cdf(x - 0.5),
                       "range": dist.cdf(x + 0.5) - dist.cdf(x - 0.5)}
        return info

    def map(self, data: np.ndarray, iso=6400, norm: bool = True,
            rng: Optional[np.random.Generator] = None) -> np.ndarray:
        gen = rng or np.random.default_rng()
        info = self.lut[iso]
        p = info["param"]
        scale = p["wp"] - p["bl"]
        data = np.asarray(data, np.float64)
        if data.max() <= 1:
            data = data * scale
        data_float = data.copy()
        data = np.round(data_float)
        delta = data_float - data if self.use_float else 0.0
        rand = gen.uniform(0, 1, size=data.shape)
        for x in range(info["low"], info["high"]):
            keys = data == x
            if not keys.any():
                continue
            c, r = info[x]["cdf"], info[x]["range"]
            data[keys] = info["dist"].ppf(c + rand[keys] * r)
        if self.use_float:
            data = data + delta
        return (data / scale if norm else data + p["bl"]).astype(np.float32)
