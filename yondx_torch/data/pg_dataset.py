"""Poisson-Gaussian training transform of the noise-estimation nets (port
of yondx/data/pg_dataset.py).

sRGB crops -> the device unprocess and CFA turn (data/unprocess.py) ->
Poisson-Gaussian corruption with per-sample (K, sigma) from the
IMX686-style log-regression prior, and for the EstUnet ('map' flavour)
the feature/target stacks: features [lr_std | lr_blur | lr], target
sqrt(beta1 * blur(hr) + beta2), and a flat-region mask from the score2
threshold of the clean std map.

The batch walks the JAX package's key chain: split(key, 4) into the
unprocess, prior and two noise keys; the per-sample priors are host
float32 draws from split(k_prior, B) in XLA's arithmetic (bit-equal to
the JAX function's); the Poisson and Gaussian fields come from the
caller's train.draws.FieldSource. The blur and std maps are K1
(nle/moments.py) at k = 19 with texture off, one launch on the stacked
[lr; hr] on a CUDA tensor, its plain version on a CPU tensor.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..core import rng
from ..nle import moments
from ..nle.threshold import score2_rows
from .unprocess import srgb_to_pseudo_raw_device

_F32 = np.float32

# PG prior (a wider K range than the calibrated IMX686 regression)
PG_PRIOR = {
    "Kmin": -2.5, "Kmax": 3.5, "q": 1 / (2 ** 10), "wp": 1023, "bl": 64,
    "sigGsk": 0.85187, "sigGsb": 0.67991, "sigGssig": 0.02921,
}


def sample_pg_prior_each(keys) -> Tuple[np.ndarray, np.ndarray]:
    """(beta1, beta2) float32 [n] in normalized units, one per key of
    keys [n, 2], as XLA evaluates the JAX package's sample_pg_prior: mu
    and log sigma in fmas, sqrt(2) of the normal folded into sigGssig,
    and the division by wp - bl a product with its reciprocal."""
    p = PG_PRIOR
    kk = rng.split_each(keys, 4)
    log_K = rng.uniform_each(kk[:, 0], (), p["Kmin"], p["Kmax"])
    slope = _F32(p["sigGsk"]) + rng.uniform_each(kk[:, 1], (), -0.2, 0.2)
    inter = _F32(p["sigGsb"]) + rng.uniform_each(kk[:, 2], (), -1.0, 1.0)
    u = rng.uniform_each(kk[:, 3], (), np.nextafter(_F32(-1), _F32(0)), 1.0)
    scatter = _F32(_F32(np.sqrt(2)) * _F32(p["sigGssig"]))
    log_sig = rng._fma(rng.erfinv_f32(u), scatter,
                       rng._fma(slope, log_K, inter))
    inv = _F32(1) / _F32(p["wp"] - p["bl"])
    sig = rng.exp_f32(log_sig) * inv
    return (rng.exp_f32(log_K) * inv).astype(_F32), (sig * sig).astype(_F32)


def sample_pg_prior(key) -> Tuple[np.float32, np.float32]:
    """(beta1, beta2) of one key."""
    b1, b2 = sample_pg_prior_each(np.asarray(key, np.uint32)[None])
    return b1[0], b2[0]


def pg_training_batch(key, imgs, *, field):
    """sRGB [B, H, W, 3] float tensor in [0, 1] -> (noisy rggb, clean
    rggb [B, H/2, W/2, 4], meta) on the images' device; meta holds beta1,
    beta2 [B] tensors, pattern and wb. One (K, sigma) per sample."""
    k_un, k_p, k_n1, k_n2 = rng.split(key, 4)
    hr, wb, _, pattern = srgb_to_pseudo_raw_device(k_un, imgs)
    B = hr.shape[0]
    b1, b2 = sample_pg_prior_each(rng.split(k_p, B))
    beta1 = torch.from_numpy(b1).to(hr.device)
    beta2 = torch.from_numpy(b2).to(hr.device)
    bshape = (B,) + (1,) * (hr.ndim - 1)
    b1r, b2r = beta1.reshape(bshape), beta2.reshape(bshape)
    shot = field.poisson(k_n1, torch.clamp(hr, min=0.0) / b1r) * b1r
    lr = shot + field.normal(k_n2, hr.shape) * torch.sqrt(b2r)
    return lr, hr, {"beta1": beta1, "beta2": beta2, "pattern": pattern,
                    "wb": wb}


def pg_est_features(lr, hr, beta1, beta2, k: int = 19
                    ) -> Dict[str, torch.Tensor]:
    """EstUnet feature/target stacks, batched. lr/hr: [B, h, w, 4];
    beta1/beta2: [B]. Returns features [B,h,w,12] = [lr_std | lr_blur |
    lr], target [B,h,w,4] = sqrt(beta1 hr_blur + beta2), the flat mask
    [B,h,w,4] (texture of the clean std map at or under its score2
    threshold; all ones where a sample's mask would be empty), and the
    four maps. The blur and std maps are box moments of [lr; hr] stacked
    on the batch axis: one K1 launch on a CUDA tensor."""
    B = lr.shape[0]
    mean, var, _ = moments.nle_moments(torch.cat([lr, hr], dim=0), k, k,
                                       texture=False)
    std = torch.sqrt(var)
    lr_blur, hr_blur = mean[:B], mean[B:]
    lr_std, hr_std = std[:B], std[B:]
    bshape = (B,) + (1,) * (lr.ndim - 1)
    target = torch.sqrt(torch.clamp(beta1.reshape(bshape) * hr_blur
                                    + beta2.reshape(bshape), min=0.0))
    th = score2_rows(hr_std.reshape(B, -1))[0].reshape(bshape)
    mask = (hr_std <= th).to(torch.float32)
    empty = mask.reshape(B, -1).sum(dim=1) == 0
    mask = torch.where(empty.reshape(bshape), torch.ones_like(mask), mask)
    feats = torch.cat([lr_std, lr_blur, lr], dim=-1)
    return {"features": feats, "target": target, "mask": mask,
            "lr_std": lr_std, "hr_std": hr_std, "lr_blur": lr_blur,
            "hr_blur": hr_blur}
