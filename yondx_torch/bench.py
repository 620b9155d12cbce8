"""`python -m yondx_torch.bench`: end-to-end blind raw denoise throughput
on one GPU (the port of bench.py).

Runs the fused product path (self NLE -> bias curve -> VST -> SNR-Net in
bf16 -> refine -> inverse VST -> collab NLE -> rescue gate) on a
synthetic 3072x4096 Bayer frame (K=8.74, sigma=12.81 DN, seed 7): one
warm-up, then the median of 5 frames, each ended by a device sync.
Prints ONE JSON line, with bench.py's keys:
  {"metric": ..., "value": MP/s, "unit": "MP/s", "vs_baseline": value/50}
--arch picks the net and its committed checkpoint: s2dt16 (default,
GuidedResUnetS2D with the full-resolution tail), s2d64 (no tail) or
gru32 (the GuidedResUnet flagship). --pallas-nle keeps its JAX meaning in
the port, the NLE band margins; the moments run through kernel K1
either way.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from . import resolve_device
from .io.ckpt import find_checkpoint
from .isp.bayer import bayer2rggb, rggb2bayer
from .models.unets import GRU32_ARCH, S2D64_ARCH, S2DT16_ARCH, load_model
from .pipeline.fused import make_fused_blind_denoiser
from .vst.lut import BiasLUT

# arch -> (YAML arch dict, checkpoint names in search order)
ARCHS = {
    "gru32": (GRU32_ARCH, ["Gaussian_GRU_mix_1to50c_norm",
                           "Gaussian_GRU_mix_1to50_norm",
                           "Gaussian_GRU_mix_5to50_norm"]),
    "s2d64": (S2D64_ARCH, ["Gaussian_GRUS2D3_mix_1to50c_norm"]),
    "s2dt16": (S2DT16_ARCH, ["Gaussian_GRUS2DT_mix_1to50c_norm"]),
}
CKPT_DIR = os.path.join("checkpoints", "Gaussian")


def make_frame(H=3072, W=4096, seed=7):
    """Synthetic SIDD-like noisy Bayer frame in [0,1] (PG noise) and its
    clean frame; a copy of bench.py's make_frame."""
    rng = np.random.default_rng(seed)
    levels = rng.random((12, 16)) * 0.7 + 0.05
    clean = np.kron(levels, np.ones((H // 12, W // 16))).astype(np.float32)
    K, sig, scale = 8.74, 12.81, 959.0
    electrons = clean * scale / K
    noisy = (K * rng.poisson(electrons) +
             rng.normal(0, sig, clean.shape)).astype(np.float32) / scale
    return np.clip(noisy, 0, 1), clean


def psnr(pred, target):
    mse = float(np.mean((np.asarray(pred, np.float64)
                         - np.asarray(target, np.float64)) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-20))


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="s2dt16", choices=list(ARCHS),
                    help="s2dt16 = GuidedResUnetS2D + full-res tail (the "
                         "shipped net); s2d64 = without the tail; gru32 = "
                         "the GuidedResUnet flagship")
    ap.add_argument("--refine", default="on", choices=["on", "off"],
                    help="method-noise Wiener refinement (bucket floor)")
    ap.add_argument("--nle-max-px", type=int, default=None,
                    help="banded-NLE sample budget (0 = full-frame "
                         "moments; default = the library default)")
    ap.add_argument("--sigma-corr", default="adaptive",
                    help="guidance scale: 'adaptive' or a fixed float")
    ap.add_argument("--pallas-nle", default="off", choices=["on", "off"],
                    help="the JAX package's Pallas-NLE flag; in the port "
                         "it picks the band margins (K1 runs either way)")
    ap.add_argument("--frames", type=int, default=1,
                    help="N > 1 = N frames, each with its own NLE "
                         "(batch_mode='frames')")
    ap.add_argument("--device", default="cuda")
    return ap


def run(cli, runs: int = 5):
    """The bench of parsed arguments -> (its JSON record, the readings a
    caller checks: PSNR in and out, K_est, frame times, second passes)."""
    dev = resolve_device(cli.device)
    arch, names = ARCHS[cli.arch]
    ck = next((c for c in (find_checkpoint(CKPT_DIR, n) for n in names)
               if c), None)
    if ck is None:
        raise FileNotFoundError(f"no checkpoint for --arch {cli.arch} "
                                f"({names}) under {CKPT_DIR}")
    # bf16 compute, as bench.py runs the net
    net = load_model(arch, ck, device=dev, dtype=torch.bfloat16)
    kw = {}
    if cli.nle_max_px is not None:
        kw["nle_max_px"] = cli.nle_max_px or None
    if cli.frames > 1:
        kw["batch_mode"] = "frames"
    sigma_corr = cli.sigma_corr if cli.sigma_corr == "adaptive" \
        else float(cli.sigma_corr)
    fused = make_fused_blind_denoiser(
        net, BiasLUT().lut, guided=True, sigma_corr=sigma_corr, max_iter=1,
        compute_dtype=torch.bfloat16, use_pallas_nle=cli.pallas_nle == "on",
        refine=cli.refine == "on", device=dev, **kw)

    noisy, clean = make_frame()
    H, W = noisy.shape
    mp = H * W / 1e6 * cli.frames
    rggb1 = bayer2rggb(torch.from_numpy(noisy).to(dev))
    rggb = torch.stack([rggb1] * cli.frames) if cli.frames > 1 \
        else rggb1[None]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    dn, regs = fused(rggb, 959.0)
    sync()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        dn, regs = fused(rggb, 959.0)
        sync()
        times.append(time.perf_counter() - t0)
    value = mp / float(np.median(times))
    out = rggb2bayer(dn[0]).float().cpu().numpy()
    p_in, p_out = psnr(noisy, clean), psnr(out, clean)
    regs = regs.cpu().numpy()
    k_est = float((regs[0, 0, 0] if cli.frames > 1 else regs[0, 0]) * 959)
    record = {
        "metric": "fused blind Bayer denoise iter=1 "
                  "(2xNLE + adaptive 1-2x[VST+SNR-Net+iVST]) on "
                  + (f"{cli.frames}x" if cli.frames > 1 else "")
                  + f"{H * W / 1e6:.1f}MP frame"
                  + ("s" if cli.frames > 1 else "")
                  + f"; psnr {p_in:.2f}->{p_out:.2f}dB; "
                  f"K_est={k_est:.2f}",
        "value": round(value, 2),
        "unit": "MP/s",
        "vs_baseline": round(value / 50.0, 3),
    }
    return record, {"psnr_in": p_in, "psnr_out": p_out, "k_est": k_est,
                    "times_s": times, "second_passes":
                    fused.stats["second_passes"]}


def main(argv=None):
    record, _ = run(build_parser().parse_args(argv))
    print(json.dumps(record))


if __name__ == "__main__":
    main()
