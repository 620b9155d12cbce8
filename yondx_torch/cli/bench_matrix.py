"""`python -m yondx_torch.cli.bench_matrix [--cpu]`: the fused entry's
benchmark matrix on the 12.6 MP synthetic frame (port of
scripts/bench_matrix.py).

The gru32 net Gaussian_GRU_mix_5to50_norm in fp32 and bf16, each through
make_fused_blind_denoiser (guided, max_iter 1, its other defaults) with
three NLE settings:
  xla-sort     exact sort percentiles for the score3 threshold;
  xla-hist     histogram percentiles;
  pallas-hist  histogram percentiles with the Pallas path's band margins.
On the GPU every box moment of the three runs through kernel K1 (3
launches a frame); the names keep the JAX script's. Then the
orchestrated fp32 engine (YONDEngine, est_type simple, max_iter 1) on
the same frame. Each row: MP/s (median of 5 frames after a warm-up, host
clock around synchronised calls), PSNR in -> out, K_est. A configuration
that fails raises.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import bench as benchmod
from ..eval.metrics import psnr
from ..isp.bayer import bayer2rggb, rggb2bayer
from ..nle import moments
from ..pipeline.denoiser import VSTDenoiser
from ..pipeline.engine import PipelineConfig, YONDEngine
from ..pipeline.fused import make_fused_blind_denoiser
from ..vst.lut import BiasLUT
from .probe_common import device_of, guided_arch, load_net

MODEL = "Gaussian_GRU_mix_5to50_norm"
DTYPES = (("fp32", torch.float32), ("bf16", torch.bfloat16))
# name, use_pallas_nle (the band margins), th_impl
MATRIX = (("xla-sort", False, "sort"), ("xla-hist", False, "hist"),
          ("pallas-hist", True, "hist"))
REPS = 5
SCALE = 959.0


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU)")
    return ap


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def timeit(fn, *args, reps=REPS, device="cuda"):
    """One warm-up call, then `reps` timed ones -> (median s, the last
    output)."""
    out = fn(*args)
    _sync(device)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        _sync(device)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), out


def fused_row(fn, rggb, clean, p_in, mp, reps, device) -> dict:
    """One configuration's timed frames -> MP/s, PSNR in -> out, K_est,
    regs, and K1 launches and second passes over its reps + 1 calls."""
    n0 = moments.LAUNCHES["nle_moments"]
    s0 = fn.stats["second_passes"]
    dt, (dn, regs) = timeit(lambda r: fn(r, SCALE), rggb[None], reps=reps,
                            device=device)
    out = rggb2bayer(dn[0]).float()
    regs = regs.cpu().numpy()
    return {"mps": mp / dt, "ms": dt * 1e3, "psnr_in": p_in,
            "psnr_out": float(psnr(out, torch.as_tensor(clean,
                                                        device=out.device))),
            "k_est": float(regs[0, 0]) * SCALE, "regs": regs,
            "calls": reps + 1,
            "launches": moments.LAUNCHES["nle_moments"] - n0,
            "second_passes": fn.stats["second_passes"] - s0}


def run_matrix(noisy, clean, device, reps=REPS, after=None) -> dict:
    """The fused matrix on one frame -> {'fp32/xla-sort': row, ...}.
    after(tag, name, net, kwargs), when given, runs after each
    configuration with its net still loaded."""
    mp = noisy.size / 1e6
    rggb = bayer2rggb(torch.as_tensor(noisy, device=device))
    lut = BiasLUT().lut
    p_in = float(psnr(noisy, clean))
    rows = {}
    for tag, dtype in DTYPES:
        net = load_net(guided_arch(), MODEL, device, dtype)
        for name, use_pallas, th in MATRIX:
            kw = {"guided": True, "max_iter": 1,
                  "use_pallas_nle": use_pallas, "th_impl": th}
            fn = make_fused_blind_denoiser(
                net, lut, compute_dtype=None if dtype == torch.float32
                else dtype, device=device, **kw)
            r = rows[f"{tag}/{name}"] = fused_row(fn, rggb, clean, p_in, mp,
                                                  reps, device)
            print(f"{tag}/{name}: {r['mps']:.1f} MP/s, psnr "
                  f"{p_in:.2f}->{r['psnr_out']:.2f} "
                  f"(K_est={r['k_est']:.2f})", flush=True)
            if after is not None:
                after(tag, name, net, kw)
        del net
    return rows


def run_orchestrated(noisy, clean, device) -> dict:
    """The orchestrated fp32 engine on the frame: one warm-up, one timed
    run."""
    den = VSTDenoiser(load_net(guided_arch(), MODEL, device), guided=True,
                      bias_corr="pre", device=device)
    eng = YONDEngine(den, PipelineConfig(est_type="simple", max_iter=1),
                     biaslut=BiasLUT())
    p = {"wp": 1023, "bl": 64, "ratio": 1, "scale": SCALE, "gain": 1.0,
         "sigma": 0.0}
    eng.iter_denoise({"lr": noisy}, dict(p))        # warm-up
    n0 = moments.LAUNCHES["nle_moments"]
    t0 = time.perf_counter()
    res = eng.iter_denoise({"lr": noisy}, dict(p))
    dt = time.perf_counter() - t0
    mp = noisy.size / 1e6
    row = {"mps": mp / dt, "ms": dt * 1e3,
           "psnr_in": float(psnr(noisy, clean)),
           "psnr_out": float(psnr(res["raw_dns"][-1], clean)),
           "k_est": res["regs"][0][0] * SCALE,
           "launches": moments.LAUNCHES["nle_moments"] - n0}
    print(f"orchestrated fp32/xla: {row['mps']:.1f} MP/s, psnr -> "
          f"{row['psnr_out']:.2f} (K_est={row['k_est']:.2f})", flush=True)
    return row


def run(args) -> dict:
    dev = device_of(args.cpu)
    noisy, clean = benchmod.make_frame()
    print(f"frame {noisy.size / 1e6:.1f}MP, noisy psnr "
          f"{float(psnr(noisy, clean)):.2f}", flush=True)
    return {"matrix": run_matrix(noisy, clean, dev),
            "orchestrated": run_orchestrated(noisy, clean, dev)}


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
