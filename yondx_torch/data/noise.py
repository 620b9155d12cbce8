"""Physics-based noise synthesis and the calibrated camera tables (port
of yondx/data/noise.py).

- `get_camera_noisy_params` / `get_specific_noise_params`: the calibrated
  regressions and per-ISO tables of the port's own copy of
  calibrations.json (NikonD850, IMX686, SonyA7S2 low/high + 28 ISOs,
  CRVD);
- `sample_params` / `sample_params_max`: host numpy samplers, equal to
  the JAX package's for the same np.random.Generator;
- `generate_noisy` (noise_code letters p: Poisson shot, g: Tukey-lambda
  read, else Gaussian read, r: row noise, q: quantization, d: channel
  bias, b: black frame), the Brooks and Poisson-Gaussian samplers;
- the AWGN samplers of the AWGN trainer.

Per-sample scalars (sigmas, gains, levels) are drawn on the host from
the JAX key with the numpy threefry and XLA's float32 exp (core/rng.py),
so they equal the JAX package's bit for bit. The large draws (the
normal, uniform and Poisson fields of an image's shape) come from the
caller's train.draws.FieldSource `field` ("jax": bit-equal to
jax.random; "torch": a torch.Generator on the device). The noise is
added on the clean tensor's device. The AWGN samplers return (noisy,
sigma [B]).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core import rng

with open(os.path.join(os.path.dirname(__file__), "calibrations.json")) as f:
    CAMERA_NOISE_PARAMS: Dict[str, Any] = json.load(f)

DUAL_ISO_CAMERAS = ("SonyA7S2",)

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


# ------------------------------------------------------------------ cameras

def get_camera_noisy_params(camera_type: str) -> Dict[str, float]:
    """The camera's log-linear noise regression (NikonD850's when the
    camera has none)."""
    reg = CAMERA_NOISE_PARAMS["regression"]
    return reg.get(camera_type, reg["NikonD850"])


def get_specific_noise_params(camera_type: str, iso) -> Optional[dict]:
    """The per-ISO point calibration, or None."""
    return CAMERA_NOISE_PARAMS["per_iso"].get(camera_type, {}).get(str(iso))


def sample_params(camera_type: str = "NikonD850", ln_ratio: bool = False,
                  rng: Optional[np.random.Generator] = None) -> dict:
    """Host noise-parameter sampler: log-uniform K in [Kmin, Kmax],
    log-linear sigTL/sigR/sigGs with Gaussian scatter, exposure ratio."""
    gen = rng or np.random.default_rng()
    if camera_type in DUAL_ISO_CAMERAS:
        camera_type += "_lowISO" if gen.integers(2) < 1 else "_highISO"
    p = get_camera_noisy_params(camera_type)
    q, wp, bl, lam = p["q"], p["wp"], p["bl"], p["lam"]
    log_K = gen.uniform(p["Kmin"], p["Kmax"])
    K = float(np.exp(log_K))
    mu_TL = p["sigTLk"] * log_K + p["sigTLb"] if "sigTLk" in p else q
    mu_R = p["sigRk"] * log_K + p["sigRb"] if "sigRk" in p else q
    mu_Gs = p["sigGsk"] * log_K + p["sigGsb"] if "sigGsk" in p else q
    sigTL = float(np.exp(gen.normal(mu_TL, p.get("sigTLsig", 0.0))))
    sigR = float(np.exp(gen.normal(mu_R, p.get("sigRsig", 0.0))))
    sigGs = float(np.exp(gen.normal(mu_Gs, p.get("sigGssig", 0.0))))
    if "uReadk" in p:
        mu_b = p["uReadk"] * log_K + p["uReadb"]
        bias = float(np.exp(gen.normal(mu_b, p["uReadsig"])))
    else:
        bias = 0.0
    if ln_ratio:
        high = 1.0 if "CRVD" in camera_type else 5.0
        ratio = float(np.exp(gen.uniform(-0.01, high)))
    else:
        ratio = float(gen.uniform(100, 300))
    return {"K": K, "sigTL": sigTL, "sigR": sigR, "sigGs": sigGs,
            "bias": bias, "lam": lam, "q": q, "ratio": ratio,
            "wp": wp, "bl": bl}


def sample_params_max(camera_type: str = "NikonD850",
                      ratio: Optional[float] = None, iso=None,
                      rng: Optional[np.random.Generator] = None) -> dict:
    """Max-ISO sampler: K at Kmax with 1% jitter, sigmas from the
    regression at log Kmax (or the per-ISO point calibration when `iso`
    is given), exposure ratio U(100, 300) for Sony, exp-U(0, 2.08)
    otherwise."""
    gen = rng or np.random.default_rng()
    params = get_specific_noise_params(camera_type, iso) \
        if iso is not None else None
    if params is None:
        cam = camera_type
        if cam in DUAL_ISO_CAMERAS:
            cam += "_lowISO" if gen.integers(2) < 1 else "_highISO"
        p = get_camera_noisy_params(cam)
        log_K = p["Kmax"] + gen.uniform(-0.01, 0.01)
        K = float(np.exp(log_K))
        sigTL = float(np.exp(p["sigTLk"] * log_K + p["sigTLb"]))
        sigR = float(np.exp(p["sigRk"] * log_K + p["sigRb"]))
        mu_Gs = p["sigGsk"] * log_K + p["sigGsb"] if "sigGsk" in p \
            else 2 ** -14
        sigGs = float(np.exp(gen.normal(mu_Gs, p.get("sigGssig", 0.0))))
        bias = 0.0
    else:
        p = params
        K = float(p["Kmax"] * (1 + gen.uniform(-0.01, 0.01)))
        sigGs = float(gen.normal(p["sigGs"], p.get("sigGssig", 0.0)))
        sigTL = float(gen.normal(p["sigTL"], p.get("sigTLsig", 0.0)))
        sigR = float(gen.normal(p["sigR"], p.get("sigRsig", 0.0)))
        bias = p.get("bias", 0.0)
    if ratio is None:
        if "SonyA7S2" in camera_type:
            ratio = float(gen.uniform(100, 300))
        else:
            ratio = float(np.exp(gen.uniform(0, 2.08)))
    return {"K": K, "sigTL": sigTL, "sigR": sigR, "sigGs": sigGs,
            "bias": bias, "lam": p["lam"], "q": p["q"], "ratio": ratio,
            "wp": p["wp"], "bl": p["bl"]}


# --------------------------------------------------------- noise on a frame

def brooks_noise_levels(key):
    """Brooks et al.'s log-log (shot, read) sampler -> float32 scalars."""
    k1, k2 = rng.split(key)
    log_shot = rng.uniform(k1, (), np.log(1e-4), np.log(0.012))
    log_read = (_F32(2.18) * log_shot + _F32(1.20)) \
        + _F32(0.26) * rng.normal(k2)
    return rng.exp_f32(log_shot), rng.exp_f32(log_read)


def brooks_add_noise(key, image, shot_noise=0.01, read_noise=0.0005, *,
                     field):
    """var = shot * I + read Gaussian corruption."""
    var = image * shot_noise + read_noise
    return image + field.normal(key, image.shape) * torch.sqrt(var)


def _tukeylambda(key, lam, shape, *, field):
    """Tukey-lambda samples by the quantile transform
    Q(u) = (u^lam - (1-u)^lam) / lam (the logit at lam == 0)."""
    u = field.uniform(key, shape, 1e-7, 1 - 1e-7)
    lam = float(_F32(lam))
    if abs(lam) < 1e-6:
        return torch.log(u / (1.0 - u))
    return (u ** lam - (1.0 - u) ** lam) / lam


def generate_noisy(key, y, param: dict, noise_code: str = "p",
                   ori: bool = False, clip: bool = False, *, field):
    """Noise synthesis on a clean normalized frame y [..., h, w, c] (RGGB
    planes, channels last); `noise_code` letters select the components.
    Row noise varies along H and is drawn on the host (one value a row)."""
    p = param
    code = noise_code.lower()
    scale = p["wp"] - p["bl"]
    ye = y * scale / p["ratio"]
    ks = rng.split(key, 5)
    if "p" in code:
        shot = field.poisson(ks[0], ye / p["K"]) * p["K"]
    else:
        shot = ye + field.normal(ks[0], ye.shape) * torch.sqrt(
            torch.clamp(ye / p["K"], min=1e-10)) * p["K"]
    noise = shot
    if "b" not in code:
        if "g" in code:
            noise = noise + _tukeylambda(ks[1], p["lam"], ye.shape,
                                         field=field) * p["sigTL"]
        else:
            noise = noise + field.normal(ks[1], ye.shape) * p["sigGs"]
        if "r" in code:
            row = rng.normal(ks[2], tuple(ye.shape[:-2]) + (1, 1))
            noise = noise + torch.from_numpy(row).to(y.device) * p["sigR"]
        if "q" in code:
            noise = noise + field.uniform(ks[3], ye.shape, -0.5, 0.5)
        if "d" in code:
            b = np.reshape(np.atleast_1d(p["bias"]), (1, 1, -1))
            noise = noise + torch.from_numpy(b.astype(_F32)).to(y.device)
    z = noise / scale
    z = torch.clamp(z, 0.0, 1.0) if clip \
        else torch.clamp(z, -p["bl"] / p["wp"], 1.0)
    return z if ori else z * p["ratio"]


def sample_pg_params(key, k_range=(1e-3, 1e-1), sig_read_range=(1e-4, 1e-2)):
    """Log-uniform Poisson-Gaussian (K, sigma_read) in normalized units ->
    float32 scalars."""
    k1, k2 = rng.split(key)
    K = rng.exp_f32(rng.uniform(k1, (), np.log(k_range[0]),
                                np.log(k_range[1])))
    sig = rng.exp_f32(rng.uniform(k2, (), np.log(sig_read_range[0]),
                                  np.log(sig_read_range[1])))
    return K, sig


def add_pg_noise(key, clean, K, sig_read, *, field):
    """Poisson-Gaussian corruption in normalized units: var = K y + sig^2."""
    k1, k2 = rng.split(key)
    K = float(K)
    shot = field.poisson(k1, torch.clamp(clean, min=0.0) / K) * K
    return shot + field.normal(k2, clean.shape) * float(sig_read)
