"""Image quality metrics (port of yondx/eval/metrics.py).

- `psnr`: skimage-compatible peak SNR at data_range 1 (raw crops);
- `matlab_ssim`: the MATLAB-equivalent SSIM: 11x11 Gaussian window
  sigma 1.5 as a valid `F.conv2d` in float32 with TF32 off, C1 =
  (0.01*255)^2, C2 = (0.03*255)^2, inputs scaled to [0, 255];
- `quality_assess`: the PSNR + SSIM dict;
- `cal_kld`: forward KL between pixel-error histograms (numpy).

Tensors run on their own device, numpy arrays on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _tensor(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device or x.device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def psnr(pred, target, data_range: float = 1.0):
    """Mean PSNR over every element (float32 0-d tensor)."""
    pred = _tensor(pred)
    target = _tensor(target, pred.device)
    mse = torch.mean((pred - target) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-20))


def _gaussian_kernel_11():
    """cv2.getGaussianKernel(11, 1.5) as an outer product."""
    x = np.arange(11) - 5
    k = np.exp(-(x ** 2) / (2 * 1.5 ** 2))
    k = k / k.sum()
    return (k[:, None] * k[None, :]).astype(np.float32)


_WIN = _gaussian_kernel_11()


def _filt_valid(img, win):
    """Valid 2-D correlation of [..., H, W] with an 11x11 window."""
    lead = img.shape[:-2]
    H, W = img.shape[-2:]
    y = F.conv2d(img.reshape(-1, 1, H, W), win)
    return y.reshape(lead + (H - 10, W - 10))


def _ssim_single(img1, img2):
    C1 = (0.01 * 255) ** 2
    C2 = (0.03 * 255) ** 2
    win = torch.as_tensor(_WIN, device=img1.device)[None, None]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False       # fp32 window sums
    try:
        mu1 = _filt_valid(img1, win)
        mu2 = _filt_valid(img2, win)
        mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
        s1 = _filt_valid(img1 * img1, win) - mu1_sq
        s2 = _filt_valid(img2 * img2, win) - mu2_sq
        s12 = _filt_valid(img1 * img2, win) - mu1_mu2
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
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
