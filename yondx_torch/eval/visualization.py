"""Figures: the sample triptych, image helpers and quality numbers (port
of yondx/eval/visualization.py).

`plot_sample` writes `{filename}_denoised.png` through core/png.py and
the noisy / denoised / GT triptych `{filename}-Epoch{epoch}.jpg` through
matplotlib, which it imports where it is called: without matplotlib it
raises ImportError before it writes a file.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..core.png import write_png
from .metrics import matlab_ssim, psnr as _psnr


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def scale_down(img):
    return np.float32(_np(img)) / 255.0


def scale_up(img):
    return np.uint8(np.clip(_np(img), 0, 1) * 255.0)


def tensor2im(x, video: bool = False) -> np.ndarray:
    """[B, H, W, C] (or [B, T, H, W, C] with video=True) -> the first
    image (all frames with video) scaled to [0, 255], float32."""
    arr = np.asarray(_np(x), np.float32)
    if not video:
        arr = arr[0]
    return np.clip(arr * 255.0, 0, 255)


def quality_assess(X, Y, data_range: float = 255.0) -> dict:
    """{'PSNR', 'SSIM'} of the estimate X against the reference Y, [H, W,
    C] arrays or tensors (SSIM per channel, at x 255 / data_range)."""
    p = float(_psnr(X, Y, data_range=data_range))
    s255 = 255.0 / data_range
    x = torch.as_tensor(np.asarray(_np(X), np.float32) * s255).movedim(-1, 0)
    y = torch.as_tensor(np.asarray(_np(Y), np.float32) * s255).movedim(-1, 0)
    return {"PSNR": p, "SSIM": float(matlab_ssim(x, y))}


def _png_pixels(img) -> np.ndarray:
    """What cv2.imwrite stores of an RGB image: uint8 and uint16 as
    they are, other types rounded and saturated to uint8."""
    img = _np(img)
    if img.dtype in (np.uint8, np.uint16):
        return img
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def plot_sample(img_lr, img_dn, img_hr, filename: str = "result",
                model_name: str = "Unet", epoch: int = -1,
                print_metrics: bool = False, save_plot: bool = True,
                save_path: str = "./", res=None):
    """The noisy / denoised / GT triptych jpg and the denoised png in
    save_path; images in [0, 1] are scaled to uint8 first. Returns
    (psnr, ssim, filename), each list (noisy, denoised, -1), from `res`
    (psnr_lr, ssim_lr, psnr_dn, ssim_dn) where given."""
    img_lr, img_dn, img_hr = map(_np, (img_lr, img_dn, img_hr))
    if np.max(img_hr) <= 1:
        img_lr, img_dn, img_hr = map(scale_up, (img_lr, img_dn, img_hr))
    if res is None:
        q_lr = quality_assess(img_lr, img_hr)
        q_dn = quality_assess(img_dn, img_hr)
        psnr = [q_lr["PSNR"], q_dn["PSNR"], -1]
        ssim = [q_lr["SSIM"], q_dn["SSIM"], -1]
    else:
        psnr = [res[0], res[2], -1]
        ssim = [res[1], res[3], -1]
    os.makedirs(save_path, exist_ok=True)
    if save_plot:
        try:
            import matplotlib
        except ImportError as e:
            raise ImportError("plot_sample's triptych needs matplotlib, "
                              "which is not installed") from e
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        images = {"Noisy Image": img_lr, model_name: img_dn,
                  "Ground Truth": img_hr}
        fig, axes = plt.subplots(1, 3, figsize=(20, 6))
        for i, (title, img) in enumerate(images.items()):
            axes[i].imshow(img)
            axes[i].set_title(f"{title}\n{img.shape} - psnr:{psnr[i]:.2f}"
                              f" - ssim{ssim[i]:.4f}")
            axes[i].axis("off")
        plt.suptitle(f"{filename} - Epoch: {epoch}")
        write_png(os.path.join(save_path, f"{filename}_denoised.png"),
                  _png_pixels(img_dn))
        fig.savefig(os.path.join(save_path,
                                 f"{filename}-Epoch{epoch}.jpg"),
                    bbox_inches="tight")
        plt.close(fig)
    return psnr, ssim, filename
