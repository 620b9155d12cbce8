"""sRGB -> pseudo-raw "unprocessing" (port of yondx/data/unprocess.py;
Brooks et al.).

- random_ccm: convex combination of 4 xyz2cam matrices (weights
  U(1e-8, 1e8)) times rgb2xyz, row-normalized;
- random_gains: rgb_gain ~ 1/N(0.8, 0.1) (10%: 0.2/N), red ~ U(1.4, 2.5),
  blue ~ U(1.5, 2.4);
- inverse_smoothstep, gamma_expansion, apply_ccm, safe_invert_gains with
  the highlight mask;
- mosaic: RGGB plane extraction.

One key per sample, drawn with the port's numpy threefry (core/rng.py),
so a seed gives the cameras `jax.random` gives. The camera draws are a
few float32 scalars per crop. The chain runs on the host in float32
numpy, in the order XLA's CPU backend evaluates the JAX package's ops
(fused multiply-adds where XLA fuses them; sin, atan2 and pow from the C
library, which XLA calls): so a crop's clean pixels equal JAX's bit for
bit, and the Poisson draws that follow them in eval/heldout.py consume
the same uniforms. This is not a fallback for the card: scene synthesis
is host-side data preparation, like the numpy content generators and
the noise draws, and it keeps a card run's scenes identical to the CPU
tests' scenes. The denoising runs on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import libm, rng
from ..isp.bayer import bayer_aug

_F32 = np.float32

# 4 candidate XYZ->Camera CCMs
XYZ2CAMS = np.array([
    [[1.0234, -0.2969, -0.2266],
     [-0.5625, 1.6328, -0.0469],
     [-0.0703, 0.2188, 0.6406]],
    [[0.4913, -0.0541, -0.0202],
     [-0.613, 1.3513, 0.2906],
     [-0.1564, 0.2151, 0.7183]],
    [[0.838, -0.263, -0.0639],
     [-0.2887, 1.0725, 0.2496],
     [-0.0627, 0.1427, 0.5438]],
    [[0.6596, -0.2079, -0.0562],
     [-0.4782, 1.3016, 0.1933],
     [-0.097, 0.1581, 0.5181]],
], np.float32)

RGB2XYZ = np.array([
    [0.4124564, 0.3575761, 0.1804375],
    [0.2126729, 0.7151522, 0.0721750],
    [0.0193339, 0.1191920, 0.9503041],
], np.float32)


def _fma(a, b, c):
    """a * b + c rounded once to float32."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F32)


def _dot3(a, m, batch_of_one: bool = False):
    """a[..., :3] contracted with m[d, :3] for each d, in XLA's CPU
    order: a0*m0, then fma(a1, m1, .), then fma(a2, m2, .). For a batch
    of one crop XLA emits an elemental dot whose first two outputs are
    plain sums of the three products (its vector code adds them without
    fusing); the third keeps the fma chain."""
    a = np.asarray(a, _F32)
    out = []
    for d in range(m.shape[0]):
        p0 = a[..., 0] * m[d, 0]
        if batch_of_one and d < 2:
            out.append((p0 + a[..., 1] * m[d, 1]) + a[..., 2] * m[d, 2])
        else:
            out.append(_fma(a[..., 2], m[d, 2],
                            _fma(a[..., 1], m[d, 1], p0)))
    return np.stack(out, axis=-1).astype(_F32)


def _sum3(a):
    """Sum over a last axis of 3, left to right."""
    return (a[..., 0] + a[..., 1]) + a[..., 2]


def _inv3(a):
    """float32 inverse of a [3,3] matrix as JAX computes it on the CPU:
    LAPACK LU with partial pivoting, then the two triangular solves."""
    from scipy.linalg import blas, lapack
    lu, piv, info = lapack.sgetrf(np.asarray(a, _F32))
    if info != 0:
        raise np.linalg.LinAlgError(f"sgetrf info={info}")
    perm = np.arange(3)
    for i, p in enumerate(piv):
        perm[i], perm[p] = perm[p], perm[i]
    b = np.eye(3, dtype=_F32)[perm]
    x = blas.strsm(1.0, lu, b, side=0, lower=1, trans_a=0, diag=1)
    x = blas.strsm(1.0, lu, x, side=0, lower=0, trans_a=0, diag=0)
    return np.asarray(x, _F32)


def _ccms(keys):
    """rgb2cam [n,3,3] float32 for each ccm key of keys [n,2]."""
    w = rng.uniform_each(keys, (4, 1, 1), 1e-8, 1e8)
    terms = XYZ2CAMS * w
    num = ((terms[:, 0] + terms[:, 1]) + terms[:, 2]) + terms[:, 3]
    den = ((w[:, 0] + w[:, 1]) + w[:, 2]) + w[:, 3]
    rgb2cam = _dot3((num / den).astype(_F32), RGB2XYZ.T)
    return (rgb2cam / _sum3(rgb2cam)[..., None]).astype(_F32)


def _gains(keys):
    """(rgb_gain, red, blue) [n,3] float32 for each gain key of keys
    [n,2]."""
    kg = rng.split_each(keys, 4)                   # [n, 4, 2]
    nrm = (_F32(0.8) + (_F32(0.1) * rng.normal_each(kg[:, 0])
                        ).astype(_F32)).astype(_F32)
    dark = rng.uniform_each(kg[:, 1]) >= _F32(0.9)
    rgb_gain = np.where(dark, _F32(0.2) / nrm, _F32(1.0) / nrm)
    red = rng.uniform_each(kg[:, 2], (), 1.4, 2.5)
    blue = rng.uniform_each(kg[:, 3], (), 1.5, 2.4)
    return np.stack([rgb_gain, red, blue], axis=1).astype(_F32)


def _cameras(keys):
    """Each crop's camera from its key of keys [n,2], as the JAX package
    draws it (split into a ccm and a gain key): rgb2cam [n,3,3], cam2rgb
    [n,3,3] (its LAPACK inverse) and (rgb_gain, red, blue) [n,3]."""
    k = rng.split_each(keys)                       # [n, (ccm, gain), 2]
    rgb2cam = _ccms(k[:, 0])
    cam2rgb = np.stack([_inv3(m) for m in rgb2cam])
    return rgb2cam, cam2rgb, _gains(k[:, 1])


def _wb(gains):
    """[n,3] (rgb_gain, red, blue) -> white balance [n,3] (red, 1, blue)."""
    return np.stack([gains[:, 1], np.ones(len(gains), _F32), gains[:, 2]],
                    axis=1)


def random_ccm(key):
    """-> (rgb2cam [3,3], cam2rgb [3,3]) float32 numpy."""
    rgb2cam = _ccms(np.asarray(key, np.uint32)[None])[0]
    return rgb2cam, _inv3(rgb2cam)


def random_gains(key):
    """-> (rgb_gain, red, blue) float32 scalars."""
    return tuple(_gains(np.asarray(key, np.uint32)[None])[0])


# The image arithmetic below is float32 numpy in the JAX package's order;
# sin, atan2 and pow are the C library's, as XLA's CPU backend calls them.
# Each public function takes an array or a tensor and returns a CPU tensor.

def _asin(x):
    """asin(x) = 2 atan2(x, 1 + sqrt((1 - x)(1 + x))) (XLA's form)."""
    t = libm.atan2f(x, np.sqrt((_F32(1) - x) * (x + _F32(1))) + _F32(1))
    return t + t


def _inverse_smoothstep(x):
    x = np.clip(x, _F32(0.0), _F32(1.0))
    a = _asin(_F32(1.0) - _F32(2.0) * x) / _F32(3.0)
    return _F32(0.5) - libm.sinf(a)


def _gamma_expansion(x):
    return libm.powf(np.maximum(x, _F32(1e-8)), 2.2)


def _safe_invert_gains(img, rgb_gain, red, blue):
    gains = np.array([_F32(1.0) / red, _F32(1.0), _F32(1.0) / blue],
                     _F32) / _F32(rgb_gain)
    gray = (_sum3(img) * _F32(1.0 / 3.0))[..., None]
    mask = np.maximum(gray - _F32(0.9), _F32(0.0)) / _F32(1.0 - 0.9)
    mask = mask * mask
    safe_gains = np.maximum(mask + (_F32(1.0) - mask) * gains, gains)
    return img * safe_gains


def _arr(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, _F32)


def inverse_smoothstep(x):
    return torch.from_numpy(_inverse_smoothstep(_arr(x)))


def gamma_expansion(x):
    return torch.from_numpy(_gamma_expansion(_arr(x)))


def apply_ccm(img, ccm):
    """img [..., 3] x ccm [3,3] (contraction over the last img dim)."""
    return torch.from_numpy(_dot3(_arr(img), _arr(ccm)))


def safe_invert_gains(img, rgb_gain, red, blue):
    return torch.from_numpy(_safe_invert_gains(
        _arr(img), _F32(rgb_gain), _F32(red), _F32(blue)))


def _mosaic(img):
    return np.stack([img[0::2, 0::2, 0], img[0::2, 1::2, 1],
                     img[1::2, 0::2, 1], img[1::2, 1::2, 2]], axis=-1)


def mosaic(img):
    """[H, W, 3] RGB -> [H/2, W/2, 4] RGGB planes."""
    return torch.from_numpy(_mosaic(_arr(img)))


def _unprocess_one(img, rgb2cam, gains, batch_of_one: bool = False):
    """One sRGB [H,W,3] float32 array through its camera -> raw rggb
    [H/2,W/2,4] float32."""
    rgb_gain, red, blue = gains
    x = _inverse_smoothstep(img)
    x = _gamma_expansion(x)
    x = _dot3(x, rgb2cam, batch_of_one)
    x = _safe_invert_gains(x, rgb_gain, red, blue)
    x = np.clip(x, _F32(0.0), _F32(1.0))
    return _mosaic(x)


def unprocess_batch(key, imgs):
    """imgs [B,H,W,3] float in [0,1] (array or tensor) -> (raw [B,h,w,4],
    wb [B,3], cam2rgb [B,3,3]) float32 CPU tensors. One random camera
    per sample, from split(key, B)."""
    imgs = _arr(imgs)
    rgb2cam, cam2rgb, gains = _cameras(rng.split(key, imgs.shape[0]))
    raw = np.stack([_unprocess_one(im, m, g, len(imgs) == 1)
                    for im, m, g in zip(imgs, rgb2cam, gains)])
    return tuple(torch.from_numpy(a) for a in (raw, _wb(gains), cam2rgb))


def srgb_to_pseudo_raw(key, imgs, bayer_aug_enabled: bool = True):
    """The training-data transform minus the noise: unprocess + a random
    CFA phase rotation. imgs [B,H,W,3] in [0,1]. Returns (clean_rggb
    [B,h,w,4], wb [B,3], cam2rgb [B,3,3], pattern [B] int32) CPU tensors.

    With bayer_aug_enabled the JAX package draws pattern ~ U{0..3} per
    crop, but its `lax.switch` branches all close over the comprehension's
    last index, so every crop's mosaic turns by k = 3 whatever its
    pattern; the port reproduces that and returns the drawn patterns."""
    k_un, k_pat = rng.split(key)
    raw, wb, cam2rgb = unprocess_batch(k_un, imgs)
    B = raw.shape[0]
    if bayer_aug_enabled:
        pattern = rng.randint(k_pat, (B,), 0, 4)
        raw = bayer_aug(raw, 3)
    else:
        pattern = np.zeros((B,), np.int32)
    return raw, wb, cam2rgb, torch.from_numpy(pattern)


# ---------------------------------------------------------------------------
# The trainer's transform on the device. Each crop's camera (CCM, gains)
# and CFA pattern are drawn on the host from the same keys as above (a few
# numbers per crop); the image arithmetic runs in float32 torch on the
# images' device, within ~1e-6 of the JAX package (its sin/asin/pow are
# not libm's bit for bit). The host chain above stays the bit-exact one
# for the held-out scenes.

def srgb_to_pseudo_raw_device(key, imgs, bayer_aug_enabled: bool = True):
    """The training-data transform minus the noise, on the device of
    `imgs` (a float [B,H,W,3] tensor in [0,1]): inverse smoothstep, gamma
    2.2, the crop's rgb2cam, inverse gains with the highlight mask, clip,
    RGGB mosaic, and with bayer_aug_enabled the CFA turn. Returns
    (clean_rggb [B,h,w,4], wb [B,3], cam2rgb [B,3,3], pattern [B] int32)
    tensors on that device.

    As in the JAX package (and `srgb_to_pseudo_raw` above), every crop's
    mosaic turns by k = 3 whatever pattern it drew: its `lax.switch`
    branches close over the comprehension's last index."""
    dev = imgs.device
    B = imgs.shape[0]
    k_un, k_pat = rng.split(key)
    rgb2cam, cam2rgb, g = _cameras(rng.split(k_un, B))
    inv = (_F32(1.0) / _wb(g)) / g[:, :1]
    m = torch.from_numpy(rgb2cam).to(dev)
    gains = torch.from_numpy(inv.astype(_F32)).to(dev)[:, None, None, :]
    x = torch.clamp(imgs, 0.0, 1.0)
    x = 0.5 - torch.sin(torch.asin(1.0 - 2.0 * x) / 3.0)
    x = torch.clamp(x, min=1e-8) ** 2.2
    # the 3x3 colour matrix as explicit fp32 sums (no TF32 matmul)
    x = torch.stack([x[..., 0] * m[:, d, 0, None, None]
                     + x[..., 1] * m[:, d, 1, None, None]
                     + x[..., 2] * m[:, d, 2, None, None]
                     for d in range(3)], dim=-1)
    gray = torch.mean(x, dim=-1, keepdim=True)
    mask = (torch.clamp(gray - 0.9, min=0.0) / (1.0 - 0.9)) ** 2
    x = torch.clamp(x * torch.maximum(mask + (1.0 - mask) * gains, gains),
                    0.0, 1.0)
    raw = torch.stack([x[:, 0::2, 0::2, 0], x[:, 0::2, 1::2, 1],
                       x[:, 1::2, 0::2, 1], x[:, 1::2, 1::2, 2]], dim=-1)
    if bayer_aug_enabled:
        pattern = rng.randint(k_pat, (B,), 0, 4)
        raw = bayer_aug(raw, 3)
    else:
        pattern = np.zeros((B,), np.int32)
    return (raw, torch.from_numpy(_wb(g)).to(dev),
            torch.from_numpy(cam2rgb).to(dev),
            torch.from_numpy(pattern).to(dev))
