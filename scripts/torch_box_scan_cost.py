"""What the plain box filter's float64 prefix sums on the card cost the
product path, and what they buy.

yondx_torch/nle/boxfilter.py accumulates its prefix sums in float64 on a
CUDA device (float32 before). This script times chip_smoke.py's product
path (the s2dt16 net in bf16, bench.py's configuration) on its 3072x4096
frame with the float32 scan and with the float64 scan, in turns (f32,
f64, f64, f32; 5 frames each after a warm-up), and box_mean alone at the
refine's shape, and prints each version's max abs error of box_mean (k
7 and 29) against float64 on the frame's RGGB planes. Needs one CUDA
card and the committed s2dt16 checkpoint and bias table.

    python3 scripts/torch_box_scan_cost.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from yondx_torch.core.tiling import reflect_pad  # noqa: E402
from yondx_torch.isp.bayer import bayer2rggb  # noqa: E402
from yondx_torch.nle import boxfilter  # noqa: E402

FLOAT64_SCAN = boxfilter._box1d_cumsum


def float32_scan(x, k: int, axis: int):
    """The box pass as it ran before: float32 prefix sums on the card."""
    pad = k // 2
    axis = axis % x.ndim
    xp = reflect_pad(x, axis, pad, pad)
    cs = torch.cumsum(xp if xp.dtype == torch.float64 else xp.float(),
                      dim=axis)
    zshape = list(cs.shape)
    zshape[axis] = 1
    cs = torch.cat([cs.new_zeros(zshape), cs], dim=axis)
    n = x.shape[axis]
    return (cs.narrow(axis, k, n) - cs.narrow(axis, 0, n)) * (1.0 / k)


def make_frame(H=3072, W=4096, seed=7):
    """chip_smoke.py's make_frame."""
    rng = np.random.default_rng(seed)
    levels = rng.random((12, 16)) * 0.7 + 0.05
    clean = np.kron(levels, np.ones((H // 12, W // 16))).astype(np.float32)
    K, sig, scale = 8.74, 12.81, 959.0
    noisy = (K * rng.poisson(clean * scale / K)
             + rng.normal(0, sig, clean.shape)).astype(np.float32) / scale
    return np.clip(noisy, 0, 1)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True).stdout.strip(), flush=True)
    from yondx_torch.io.ckpt import find_checkpoint
    from yondx_torch.models.unets import load_guided_s2d
    from yondx_torch.pipeline.fused import make_fused_blind_denoiser
    from yondx_torch.vst.lut import BiasLUT
    torch.backends.cudnn.benchmark = True
    ck = find_checkpoint(os.path.join(REPO, "checkpoints", "Gaussian"),
                         "Gaussian_GRUS2DT_mix_1to50c_norm")
    net = load_guided_s2d(ck, device="cuda", dtype=torch.bfloat16)
    fused = make_fused_blind_denoiser(
        net, BiasLUT().lut, compute_dtype=torch.bfloat16, device="cuda",
        guided=True, max_iter=1, refine=True, sigma_corr="adaptive")
    rggb = bayer2rggb(torch.from_numpy(make_frame()).cuda())[None]
    out = {}
    for scan in ("float32", "float64", "float64", "float32"):
        boxfilter._box1d_cumsum = float32_scan if scan == "float32" \
            else FLOAT64_SCAN
        fused(rggb, 959.0)
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            t = time.perf_counter()
            fused(rggb, 959.0)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        x = rggb[0]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(10):
            boxfilter.box_mean(x, 7)
        ev[1].record()
        torch.cuda.synchronize()
        box_ms = ev[0].elapsed_time(ev[1]) / 10
        mine = boxfilter._box1d_cumsum
        boxfilter._box1d_cumsum = FLOAT64_SCAN
        ref = {k: boxfilter.box_mean(x.double(), k) for k in (7, 29)}
        boxfilter._box1d_cumsum = mine
        errs = {k: float((boxfilter.box_mean(x, k).double() - r).abs().max())
                for k, r in ref.items()}
        rec = {"ms_frame": float(np.median(times)), "runs": times,
               "box_mean_k7_ms": box_ms, "err_k7": errs[7],
               "err_k29": errs[29]}
        print(f"{scan} scan: product path {rec['ms_frame']:.2f} ms/frame "
              f"(median of 5: {[round(t, 2) for t in times]}); box_mean "
              f"k=7 on [1536, 2048, 4] {box_ms:.3f} ms; max abs err "
              f"against float64: k=7 {errs[7]:.2e}, k=29 {errs[29]:.2e}",
              flush=True)
        out.setdefault(scan, []).append(rec)
    boxfilter._box1d_cumsum = FLOAT64_SCAN
    print(json.dumps(out))


if __name__ == "__main__":
    main()
