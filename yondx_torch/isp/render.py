"""sRGB renders for figures and sRGB-domain metrics (port of
yondx/isp/render.py).

`process_rggb` is a batched float32 render on tensors (half resolution,
no demosaic). `fast_isp` and `process_sidd_image` demosaic through the
port's own edge-aware demosaic (isp/demosaic.py, cv2's COLOR_BayerBG2RGB_EA
to the bit) and run where their input lies: a tensor on its device, a
numpy array on the CPU. They keep the JAX package's host arithmetic: its
float32 and float64 steps in its order (the CCM as a left-to-right sum
over its length-3 axis), and its truncating uint8 cast. On the CPU the
power runs through numpy, so the output is JAX's to the bit; on the card
it runs in float64 on the device, within one level of the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.png import write_png
from .bayer import bayer2rggb, flip_bayer
from .demosaic import demosaic_ea

# sRGB D65 primaries
RGB2XYZ = np.array([
    [0.4124564, 0.3575761, 0.1804375],
    [0.2126729, 0.7151522, 0.0721750],
    [0.0193339, 0.1191920, 0.9503041],
])

# the Sony CCM fast_isp uses when none is given
SONY_CCM = np.array([
    [1.9712269, -0.6789218, -0.29230508],
    [-0.29104823, 1.748401, -0.45735288],
    [0.02051281, -0.5380369, 1.5175241],
])

WP14 = 16383    # the 14-bit white point both demosaicing renders use


def _tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def _pow(x, e: float):
    """x ** e; on the CPU through numpy, whose pow the JAX package's
    host renders use (torch's CPU pow can sit an ulp away)."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.power(x.numpy(), e))
    return x ** e


def _ccm(img, ccm):
    """sum_c img[..., c] * ccm[d, c] over d, left to right in c, float64:
    numpy's np.sum(img[..., None, :] * ccm, axis=-1)."""
    p = img.to(torch.float64)[..., None, :] * ccm
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def process_rggb(rggb, wb, cam2rgb, gamma: float = 2.2):
    """RGGB planes [..., h, w, 4] -> half-resolution sRGB [..., h, w, 3]
    in float32: wb gains [..., 4] (R, G1, G2, B) -> clip -> green mean ->
    CCM [..., 3, 3] -> clip -> gamma -> 8-bit quantization."""
    x = torch.clamp(rggb * wb[..., None, None, :], 0.0, 1.0)
    rgb = torch.stack([x[..., 0], (x[..., 1] + x[..., 2]) * 0.5, x[..., 3]],
                      dim=-1)
    rgb = torch.einsum("...hwc,...dc->...hwd", rgb, cam2rgb)
    rgb = torch.clamp(torch.clamp(rgb, 0.0, 1.0), min=1e-8) ** (1.0 / gamma)
    return torch.clamp(torch.floor(rgb * 255.0), 0, 255) / 255.0


def _gain(v):
    """A wb gain as the JAX package's numpy multiplies by it: float64
    unless it is a float32 scalar (float32 times float32 rounds the same
    whether formed in float32 or in float64)."""
    return float(v.item() if hasattr(v, "item") else v)


def fast_isp(img4c, wb=None, ccm=None, gamma: float = 2.2):
    """RGBG planes [h, w, 4] (R, G1, G2, B) -> sRGB [2h, 2w, 3] float64 in
    [0, 1]: R and B gains (wb[0], wb[2]; 2 without wb) into a float32
    mosaic, clip, the edge-aware demosaic at the 14-bit white point, the
    CCM (SONY_CCM without one), clip, gamma. Runs on the input's device
    (a numpy input on the CPU, giving a numpy output)."""
    as_numpy = not isinstance(img4c, torch.Tensor)
    x = _tensor(img4c)
    h, w = x.shape[:2]
    dev = x.device
    rg = _gain(wb[0]) if wb is not None else 2.0
    bg = _gain(wb[2]) if wb is not None else 2.0
    x64 = x.to(torch.float64)
    raw = torch.empty((h, 2, w, 2), dtype=torch.float32, device=dev)
    raw[:, 0, :, 0] = (x64[..., 0] * rg).to(torch.float32)
    raw[:, 0, :, 1] = x[..., 1].to(torch.float32)
    raw[:, 1, :, 0] = x[..., 2].to(torch.float32)
    raw[:, 1, :, 1] = (x64[..., 3] * bg).to(torch.float32)
    raw = torch.clamp(raw.reshape(2 * h, 2 * w), 0, 1)
    dem = demosaic_ea((raw * WP14).to(torch.int32))
    img = dem.to(torch.float64) / WP14
    m = torch.as_tensor(np.asarray(SONY_CCM if ccm is None else ccm,
                                   np.float64), device=dev)
    out = _pow(torch.clamp(_ccm(img, m), 0, 1), 1 / gamma)
    return out.numpy() if as_numpy else out


def simple_isp(rggb, bl=512, wp=16383, wb=(2, 1, 1, 2), gamma: float = 2.2):
    """Half-resolution render without demosaic: (x - bl) / (wp - bl) in
    float32, times wb (promoted as numpy promotes: integer gains give
    float64), clip, channels (0, 1, 3), gamma."""
    as_numpy = not isinstance(rggb, torch.Tensor)
    x = _tensor(rggb).to(torch.float32)
    wbn = np.asarray(wb).reshape(1, 1, -1)
    dt = torch.from_numpy(np.zeros(0, np.result_type(np.float32,
                                                     wbn.dtype))).dtype
    raw = (x - bl) / (wp - bl)
    raw = raw.to(dt) * torch.as_tensor(wbn, dtype=dt, device=x.device)
    out = _pow(torch.clamp(raw, 0, 1)[:, :, (0, 1, 3)], 1 / gamma)
    return out.numpy() if as_numpy else out


def raw2rgb_rawpy(packed_raw, raw=None, wb=None, ccm=None,
                  template: str | None = None):
    """LibRaw template render: the packed RGBG planes (or a bare bayer
    frame) written into a template raw file's visible area and
    rawpy.postprocess with the camera's (or the given) wb. Needs rawpy,
    which raises ImportError where it is absent."""
    try:
        import rawpy
    except ImportError as e:
        raise ImportError(
            "raw2rgb_rawpy needs rawpy (LibRaw), which is not installed; "
            "process_sidd_image and fast_isp render without a template") \
            from e
    from .raw_io import bayer2raw
    if raw is None:
        if template is None:
            big = np.asarray(packed_raw).shape[-2] > 1500
            template = "templet.dng" if big else "templet.ARW"
        raw = rawpy.imread(template)
        wp, bl = (1023, 64) if template.endswith(".dng") else (16383, 512)
    else:
        wp, bl = 1023, 64
    if wb is None:
        wb = np.array(raw.camera_whitebalance, np.float64)
        wb = wb / wb[1]
    wb = list(np.asarray(wb).reshape(-1))
    if np.asarray(packed_raw).ndim >= 3:
        raw.raw_image_visible[:] = np.asarray(
            bayer2raw(packed_raw, wp=wp, bl=bl))
    else:
        raw.raw_image_visible[:] = np.asarray(packed_raw)
    return raw.postprocess(use_camera_wb=False, user_wb=wb, half_size=False,
                           no_auto_bright=True, output_bps=8, bright=1,
                           user_black=None, user_sat=None)


def sidd_cam2rgb(cst2) -> np.ndarray:
    """The row-normalized inverse of cst2 @ RGB2XYZ (float64, host)."""
    cam2rgb = np.linalg.inv(np.matmul(np.asarray(cst2), RGB2XYZ))
    return cam2rgb / np.sum(cam2rgb, axis=-1, keepdims=True)


def process_sidd_image(bayer, bayer_2by2, wb, cst2,
                       save_file_rgb: str | None = None):
    """SIDD render: bayer [H, W] -> uint8 BGR sRGB [H, W, 3]: clip, flip
    the CFA to RGGB, the wb gains, the edge-aware demosaic at 14 bits,
    cam2rgb (sidd_cam2rgb), gamma 2.2. save_file_rgb writes the image as
    an RGB PNG (core/png.py). Runs on the input's device (a numpy input
    on the CPU, giving a numpy output)."""
    as_numpy = not isinstance(bayer, torch.Tensor)
    image = torch.clamp(_tensor(bayer), 0, 1)
    dev = image.device
    rggb = bayer2rggb(flip_bayer(image, bayer_2by2))
    wbv = np.asarray(wb).reshape(-1)
    gains = torch.as_tensor(np.array([1 / wbv[0], 1 / wbv[1], 1 / wbv[1],
                                      1 / wbv[2]]), device=dev)
    x = torch.clamp(rggb.to(torch.float64) * gains, 0.0, 1.0)
    h, w = x.shape[:2]
    bay = x.to(torch.float32).reshape(h, w, 2, 2).permute(0, 2, 1, 3) \
        .reshape(2 * h, 2 * w)
    dem = demosaic_ea(torch.clamp(bay * WP14, 0, WP14).to(torch.int32))
    dem = dem.to(torch.float32) / WP14
    m = torch.as_tensor(sidd_cam2rgb(cst2), device=dev)
    rgb = torch.clamp(_ccm(dem, m), 0.0, 1.0)
    rgb = _pow(torch.clamp(rgb, min=1e-8), 1.0 / 2.2)
    out = (rgb.flip(-1) * 255.0).to(torch.uint8)
    if save_file_rgb:
        write_png(save_file_rgb, out.flip(-1).cpu().numpy())
    return out.numpy() if as_numpy else out
