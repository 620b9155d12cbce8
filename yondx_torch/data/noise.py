"""AWGN samplers of the AWGN trainer (port of yondx/data/noise.py:187-233).

Per-sample sigmas are drawn on the host from the JAX key with the numpy
threefry and XLA's float32 exp (core/rng.py), so they equal the JAX
package's bit for bit; the Gaussian field comes from the caller's
train.draws.FieldSource `field` ("jax": bit-equal to jax.random.normal;
"torch": a torch.Generator on the device). The noise is added on the
clean tensor's device. Each returns (noisy, sigma [B]).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import rng

_F32 = np.float32
INV255 = _F32(1.0 / 255.0)      # XLA folds x / 255 into x * (1 / 255)


def _add_field(clean, sigma: np.ndarray, key, field):
    sig = torch.from_numpy(np.asarray(sigma, _F32)).to(clean.device)
    bshape = (clean.shape[0],) + (1,) * (clean.ndim - 1)
    noisy = clean + field.normal(key, clean.shape) * sig.reshape(bshape)
    return noisy, sig


def awgn_log_uniform(key, clean, sigma_min: float = 5.0,
                     sigma_max: float = 50.0, *, field):
    """Per-sample AWGN with log-uniform sigma in [smin, smax]/255."""
    k1, k2 = rng.split(key)
    u = rng.uniform(k1, (clean.shape[0],), np.log(sigma_min),
                    np.log(sigma_max))
    return _add_field(clean, rng.exp_f32(u) * INV255, k2, field)


def awgn_log_uniform_lowmix(key, clean, sigma_min: float = 1.0,
                            sigma_max: float = 50.0, p_low: float = 0.5,
                            low_max: float = 8.0, *, field):
    """Log-uniform AWGN with emphasis on the low band: with probability
    p_low a sample's sigma is log-uniform in [smin, low_max] instead of
    [smin, smax] (the 'low_sigma' command)."""
    B = clean.shape[0]
    k1, k2, k3 = rng.split(key, 3)
    lo = _F32(np.log(sigma_min))
    u = rng.uniform(k1, (B,))
    hi = np.where(rng.uniform(k3, (B,)) < _F32(p_low),
                  _F32(np.log(low_max)), _F32(np.log(sigma_max)))
    sigma = rng.exp_f32(rng._fma(u, (hi - lo).astype(_F32), lo)) * INV255
    return _add_field(clean, sigma, k2, field)


def awgn_uniform(key, clean, sigma_min: float = 5.0,
                 sigma_max: float = 50.0, *, field):
    """Per-sample AWGN with uniform sigma in [smin, smax]/255 (the plain
    sRGB RGB_Img_Dataset sampler)."""
    k1, k2 = rng.split(key)
    u = rng.uniform(k1, (clean.shape[0],), sigma_min, sigma_max)
    return _add_field(clean, u * INV255, k2, field)
