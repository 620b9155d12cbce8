"""Image quality metrics (port of yondx/eval/metrics.py).

- `psnr`: skimage-compatible peak SNR at data_range 1 (raw crops);
- `matlab_ssim`: the MATLAB-equivalent SSIM: 11x11 Gaussian window
  sigma 1.5, valid, as separable float32 multiply-adds (no convolution
  library, so no process-wide TF32 flag reaches the window sums, and
  threads may score concurrently), C1 = (0.01*255)^2, C2 =
  (0.03*255)^2, inputs scaled to [0, 255];
- `quality_assess`: the PSNR + SSIM dict;
- `cal_kld`: forward KL between pixel-error histograms (numpy).

Tensors run on their own device, numpy arrays on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device or x.device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def psnr(pred, target, data_range: float = 1.0, dim=None):
    """PSNR of the mean squared error over every element (float32 0-d
    tensor), or over `dim` only (one PSNR per remaining index, e.g.
    dim=(-2, -1) for each crop of a stack)."""
    pred = _tensor(pred)
    target = _tensor(target, pred.device)
    d2 = (pred - target) ** 2
    mse = torch.mean(d2) if dim is None else torch.mean(d2, dim=dim)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-20))


def _gaussian_taps_11():
    """cv2.getGaussianKernel(11, 1.5): the window is their outer product."""
    x = np.arange(11) - 5
    k = np.exp(-(x ** 2) / (2 * 1.5 ** 2))
    return [float(v) for v in (k / k.sum()).astype(np.float32)]


_TAPS = _gaussian_taps_11()


def _filt_valid(img):
    """Valid 2-D correlation of [..., H, W] with the 11x11 window: the
    rows' 11 taps, then the columns', each a float32 multiply-add."""
    H, W = img.shape[-2:]
    rows = sum(g * img[..., :, k:k + W - 10] for k, g in enumerate(_TAPS))
    return sum(g * rows[..., k:k + H - 10, :] for k, g in enumerate(_TAPS))


def _ssim_single(img1, img2):
    C1 = (0.01 * 255) ** 2
    C2 = (0.03 * 255) ** 2
    mu1, mu2, e11, e22, e12 = _filt_valid(torch.stack(
        [img1, img2, img1 * img1, img2 * img2, img1 * img2]))
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1, s2, s12 = e11 - mu1_sq, e22 - mu2_sq, e12 - mu1_mu2
    num = (2 * mu1_mu2 + C1) * (2 * s12 + C2)
    den = (mu1_sq + mu2_sq + C1) * (s1 + s2 + C2)
    return torch.mean(num / den, dim=(-2, -1))


def matlab_ssim(pred, target):
    """MATLAB-equivalent SSIM on [0,255]-scaled arrays: [H, W] (gray),
    [H, W, 3] (mean over channels) or batched [..., H, W]; the mean over
    everything but the last two dims (float32 0-d tensor)."""
    pred = _tensor(pred)
    target = _tensor(target, pred.device)
    if pred.ndim >= 3 and pred.shape[-1] == 3:
        vals = torch.stack([_ssim_single(pred[..., c], target[..., c])
                            for c in range(3)], dim=-1)
        return torch.mean(vals)
    return torch.mean(_ssim_single(pred, target))


def quality_assess(pred, target, data_range: float = 255.0):
    """{'PSNR', 'SSIM'} floats."""
    pred = _tensor(pred)
    target = _tensor(target, pred.device)
    return {
        "PSNR": float(psnr(pred, target, data_range=data_range)),
        "SSIM": float(matlab_ssim(pred * (255.0 / data_range),
                                  target * (255.0 / data_range))),
    }


def cal_kld(p_data, q_data):
    """Forward KL between error histograms."""
    bw = 0.2 / 64
    edges = np.concatenate(([-1000.0], np.arange(-0.1, 0.1 + 1e-9, bw),
                            [1000.0]))
    p, _ = np.histogram(np.asarray(p_data), edges)
    q, _ = np.histogram(np.asarray(q_data), edges)
    p = p / max(p.sum(), 1)
    q = q / max(q.sum(), 1)
    idx = (p > 0) & (q > 0)
    p, q = p[idx], q[idx]
    return float(np.sum(p * (np.log(p) - np.log(q))))
