"""GPU smoke run of the PyTorch port (yondx_torch) on one NVIDIA card.

    python3 chip_smoke.py [--out DIR]

Builds the port's CUDA kernel K1 (NLE box moments) with plain nvcc, holds
it against its plain PyTorch version on the card in its three flavours
(self fit; collab fit of dn and of lr) at the fused path's band shape and
the engine's whole-plane shape and times each, holds the card path
against the port's CPU path end to end on a small frame, then drives the
product path (s2dt16 net from the committed checkpoint, bf16, robust NLE,
refine, adaptive guidance, rescue policy, banded NLE) on a synthetic
3072x4096 Bayer frame and checks the result. It then drives the
ANY-camera CLI path (`yondx_torch.cli.yond` with
runfiles/YOND/ANY_simple+full_pre_grumix.yml: the gru32 flagship in fp32,
whole-frame NLE, tiles of 1024 with halo 64, batch 8) on the same frame,
holds that engine on the card against the CPU on a small frame, and runs
`python -m yondx_torch.bench --arch gru32` once. Last, the frozen
held-out quality gate (`yondx_torch.cli.eval_synth --heldout`): the v3
suite's 39 scenes, built once on the host, through the s2dt16 and gru32
nets in fp32 (each held to its committed artifact in docs/heldout/), the
s2dt16 net in bf16 (printed beside), the gru32 net with the PGE
estimator on suite v1, and the engine on the card against the CPU on
two reduced scenes. Phase 10 trains the gru32 SNR-Net (trainer_awgn's
AWGNTrainer): one step card vs CPU, the full-width
GRU_5to50_norm_mix.yml run, the eval anchor, a resumed distillation
run. Phase 11 trains the noise-estimation nets (train_est's
PGEstTrainer): one step of each flavour card vs CPU, K1 at k = 19
against its plain version and its bound, the EstPGE.yml recipe at full
width, 20 steps of the EstUnet map flavour (K1 once a step), the PGE
eval loss of the committed and the new estimator, a resume of the
committed estimator, and the new estimator served through
`eval_synth --heldout --suite v1 --est pge`. Phase 12 runs what a
runfile or an eval_synth flag can name besides: the committed
UNetSeeInDark card vs CPU, the 'unetn' CLI path (the ANY runfile with
that net, unguided) on the 3072x4096 frame and card vs CPU on a crop of
it, its AWGN recipe (Unet_5to50_norm.yml, 12 steps) and its eval
anchor, the est_* block of runfiles/YOND/SIDD_pge_pre_grumix.yml through
engine.iter_denoise card vs CPU and through --input, and the host BM3D
column `eval_synth --heldout --scene-filter photo --denoiser bm3d` held to
docs/heldout/r5_bm3d_photo_cpu.json. Phase 13 runs the runfiles' eval
and test modes through the CLI (`yondx_torch.cli.yond -f <runfile>
[-m test] [--limit N]`) in a temporary working directory that holds
numpy-seeded fixtures in each reader's layout at the real datasets'
shapes: (a) the default SIDD runfile's eval on [40, 32, 256, 256]
validation blocks, profiled once, (b) its test mode (the npy cache), (c)
the PGE estimator's runfile on 8 scenes, (d) the ELD runfile with the
committed 5to50 net on two 4256x2848 SonyA7S2 frames (whole-frame route,
illuminance alignment), (e) the LRID runfile on a 3472x4624 frame (tiled
route), (f) the DND submission bundle of 20 boxes of 512 px, written and
read back, and (g) the first 2 scenes of (a) and boxes of (f) on the CPU
against the card. Every phase prints one
line with its elapsed seconds; any failure raises (exit code != 0). The
last two lines are the kernels' JSON record and the device JSON record.
With --out, each held-out column's eval_synth JSON is written into DIR.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

T0 = time.perf_counter()
REPO = os.path.dirname(os.path.abspath(__file__))
ANY_RUNFILE = "runfiles/YOND/ANY_simple+full_pre_grumix.yml"
# the held-out gate's columns: eval_synth flags, and the committed TPU
# artifact each is held to or printed beside
S2DT16_FLAGS = ["--arch", "GuidedResUnetS2D", "--nf", "64", "--out-k", "3",
                "--tail-nf", "16", "--model",
                "Gaussian_GRUS2DT_mix_1to50c_norm", "--refine", "bucket"]
GRU32_FLAGS = ["--arch", "GuidedResUnet", "--nf", "32", "--model",
               "Gaussian_GRU_mix_1to50c_norm", "--refine", "bucket"]
HELDOUT_ART = {"s2dt16": "docs/heldout/r5_s2dt_oriented_v3_tpu.json",
               "gru32": "docs/heldout/r5_flagship_oriented_v3_tpu.json",
               "pge": "docs/heldout/r4_flagship_pge_tpu.json"}


def say(phase: str, msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f}s] {phase}: {msg}", flush=True)


def make_frame(H=3072, W=4096, seed=7):
    """Synthetic SIDD-like noisy Bayer frame in [0,1] (PG noise); a copy
    of bench.py's make_frame."""
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


# published peaks of the cards this script has run on (NVIDIA data sheet,
# dense, at the full power limit): device-memory bytes/s and fp32
# (non-tensor-core) FLOP/s. A card joins the table when a run on it does.
_PEAKS = {"H100 80GB HBM3": (3.35e12, 67e12)}          # H100 SXM5


def card_peaks(name: str):
    for key, val in _PEAKS.items():
        if key in name:
            return key, val
    raise KeyError(f"no peak rates for card {name!r}; add its data-sheet "
                   "memory rate and fp32 rate to _PEAKS")


# fp32 operations one output of K1's function needs when every box sum
# slides (add the entering sample, subtract the leaving one; 2 per pass,
# 2 passes), by flavour. self (mean, var, tex): 5 boxes (x, x^2, t1 =
# box_inner(x), t1, t1^2) = 20; the squares x^2, t1^2 = 2; scaling the 5
# sums by 1/k^2 or 1/inner^2 = 5; var = max(E[x^2] - mean^2, 0) = 3; tex =
# sqrt(max(E[t1^2] - E[t1]^2, 0)) = 4; shifting x and adding the shift
# back to mean = 2. collab dn (mean, var): 2 boxes = 8, x^2 = 1, scaling
# = 2, var = 3, shift and back = 2. collab lr (var): as dn without
# adding the shift back.
K1_FLAVOURS = {"self": (True, True, 36), "collab_dn": (False, True, 16),
               "collab_lr": (False, False, 15)}


def cuda_ms(fn, reps: int, flush=None) -> float:
    """Median time of fn() in ms from CUDA events, one event pair per
    synchronised call; `flush` runs untimed before each call (cold L2).
    A pair also holds the host's enqueue of the call (the wrapper's
    Python and the launch)."""
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


_GROUPS = (("K1 nle_moments", ("nle_moments",)),
           ("conv/gemm", ("conv", "gemm", "xmma", "cutlass", "sm90", "cudnn",
                          "implicit", "winograd", "fprop", "dgrad")),
           ("sort", ("sort", "radix")),
           ("scan", ("scan", "cumsum")),
           ("scatter/index", ("scatter", "index", "gather")),
           ("reduce", ("reduce",)),
           ("elementwise", ("elementwise", "vectorized", "unrolled")))


def profile_run(label: str, run) -> None:
    """One run() under torch.profiler: device busy time against the host
    wall time, and device time by kernel group and top kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        kernels.append((us / 1e3, evt.count, evt.key))
    busy = sum(k[0] for k in kernels)
    groups = {}
    for ms, _, key in kernels:
        low = key.lower()
        group = next((g for g, words in _GROUPS
                      if any(w in low for w in words)), "other")
        groups[group] = groups.get(group, 0.0) + ms
    top = sorted(kernels, reverse=True)[:8]
    say(label, f"wall {wall_ms:.2f} ms (profiled), device busy "
        f"{busy:.2f} ms ({100 * busy / wall_ms:.1f}%), {len(kernels)} "
        "kernel names; by group ms: " + ", ".join(
            f"{g} {v:.2f}" for g, v in sorted(groups.items(),
                                              key=lambda kv: -kv[1]))
        + "; top: " + "; ".join(f"{key[:60]} x{n} {ms:.2f}"
                                for ms, n, key in top))


def net_flop_per_pixel(net) -> float:
    """FLOP (2 x multiply-adds) of the net's convolutions per RGGB pixel,
    counted with forward hooks on one 64x64 input."""
    from torch import nn
    macs = [0]

    def hook(m, inp, out):
        if isinstance(m, nn.Conv2d):
            macs[0] += out.numel() * m.in_channels * m.kernel_size[0] \
                * m.kernel_size[1] // m.groups
        elif isinstance(m, nn.ConvTranspose2d):
            macs[0] += inp[0].numel() * m.out_channels * m.kernel_size[0] \
                * m.kernel_size[1]

    dev = next(net.parameters()).device
    hooks = [m.register_forward_hook(hook) for m in net.modules()]
    with torch.no_grad():
        net(torch.rand((1, 64, 64, 4), device=dev),
            torch.full((1,), 0.1, device=dev))
    for h in hooks:
        h.remove()
    return 2.0 * macs[0] / (64 * 64)


def any_params():
    """The CLI's frame parameters (yond --wp 1023 --bl 64 --ratio 1)."""
    return {"wp": 1023, "bl": 64, "ratio": 1.0, "scale": 959.0,
            "gain": 1.0, "sigma": 0.0}


def cli_path(noisy, clean, runfile=ANY_RUNFILE, label="cli path",
             min_gain=10.0) -> dict:
    """The ANY-camera CLI path on the 3072x4096 frame: one run of the
    CLI as a user types it (K1 counts read around it), then its engine
    timed on the same frame and profiled once; the output's PSNR gain
    held at `min_gain` dB or more. fp32, TF32 off."""
    from yondx_torch.cli import yond
    from yondx_torch.nle import moments
    H, W = noisy.shape
    with tempfile.TemporaryDirectory() as tmp:
        fin, fout = os.path.join(tmp, "frame.npy"), os.path.join(tmp,
                                                                 "dn.npy")
        np.save(fin, noisy)
        moments.reset_launches()
        t = time.perf_counter()
        app = yond.main(["-f", runfile, "--input", fin, "--output",
                         fout])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t
        launches = moments.LAUNCHES["nle_moments"]
        out = np.load(fout)
    if out.shape != (H, W) or not np.isfinite(out).all():
        raise AssertionError(f"CLI output {out.shape} not finite {H}x{W}")
    if out.min() < 0.0 or out.max() > 1.0:
        raise AssertionError(f"CLI output outside [0, 1]: {out.min()}, "
                             f"{out.max()}")
    p_in, p_out = psnr(noisy, clean), psnr(out, clean)
    say(label, f"yond --input ({H}x{W}) in {cli_s:.2f} s (first run: "
        f"model load and cuDNN planning included); PSNR {p_in:.2f} -> "
        f"{p_out:.2f} dB; K1 launches {launches}")
    if p_out < p_in + min_gain:
        raise AssertionError(f"CLI PSNR gain {p_out - p_in:.2f} dB < "
                             f"{min_gain} dB")
    # one self fit + two collab fits (lr, dn) on whole planes
    if launches != 3:
        raise AssertionError(f"K1 launched {launches} times in the CLI "
                             "run, expected 3")

    engine = app.engine

    def frame():
        return engine.iter_denoise_tiled({"lr": noisy}, any_params(),
                                         tile=1024, halo=64)

    frame()
    torch.cuda.synchronize()
    moments.reset_launches()
    runs, times, fired = 3, [], 0
    for _ in range(runs):
        t = time.perf_counter()
        res = frame()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        fired += sum(sig["fired"] for sig in res["signals"])
    timed_launches = moments.LAUNCHES["nle_moments"]
    dt = float(np.median(times))
    k_est = float(res["regs"][0][0] * 959)
    dn = res["raw_dns"][-1]
    say(label, f"engine.iter_denoise_tiled {H}x{W}, tiles 1024/64, "
        f"batch 8: {dt * 1e3:.2f} ms/frame, {H * W / 1e6 / dt:.2f} MP/s "
        f"(median of {runs}; runs {[round(x * 1e3, 2) for x in times]} "
        f"ms); PSNR {p_in:.2f} -> {psnr(dn, clean):.2f} dB; K_est "
        f"{k_est:.3f}; second pass fired {fired}/{runs}; K1 launches "
        f"{timed_launches}; regs {res['regs']}")
    if abs(k_est - 8.74) > 0.1 * 8.74:
        raise AssertionError(f"CLI K_est {k_est:.3f} not within 10% of "
                             "8.74")
    if timed_launches != 3 * runs:
        raise AssertionError(f"K1 launched {timed_launches} times in "
                             f"{runs} frames, expected {3 * runs}")
    from yondx_torch.core.tiling import tile_grid
    ny, nx, _, _ = tile_grid(H, W, 1024, 64)
    n_tiles = -(-ny * nx // 8) * 8              # padded to the batch of 8
    side = 1024 // 2 + 64                       # RGGB side of a tile
    per_px = net_flop_per_pixel(app.model)
    say(label, f"net {per_px * n_tiles * side ** 2 / 1e12:.3f} TFLOP a "
        f"pass ({n_tiles} tiles of {side}x{side}x4, {per_px / 1e6:.4f} "
        "MFLOP per RGGB pixel)")
    profile_run(f"{label} profile", frame)
    return {"launches": launches, "ms_frame": dt * 1e3}


def engine_card_vs_cpu(runfile=ANY_RUNFILE, small=None,
                       label="engine cuda vs cpu") -> None:
    """The CLI's engine (gru32 fp32) on a 504x768 frame, tiles of 256 with
    halo 64 (2x3 tiles, one padded chunk of 8), on the card and on the
    CPU: regs of both rounds to the larger of rtol 1e-3 and the card's
    own +-1e-6 frame-shift spread (as phase 4), the output to 1e-3."""
    from yondx_torch.cli import yond
    if small is None:
        small, _ = make_frame(512, 768, seed=3)
    res = {}
    for d in ("cuda", "cpu"):
        engine = yond.YOND(["-f", runfile, "--device", d]).engine
        res[d] = engine.iter_denoise_tiled({"lr": small}, any_params(),
                                           tile=256, halo=64)
        if d == "cuda":
            spread = np.max([np.abs(np.array(engine.iter_denoise_tiled(
                {"lr": small + s}, any_params(), tile=256,
                halo=64)["regs"]) - np.array(res[d]["regs"]))
                for s in (1e-6, -1e-6)], axis=0)
    rg, rc = np.array(res["cuda"]["regs"]), np.array(res["cpu"]["regs"])
    allowed = np.maximum(1e-3 * np.abs(rc), spread)
    err_r = np.abs(rg - rc)
    err_o = float(np.abs(res["cuda"]["raw_dns"][-1]
                         - res["cpu"]["raw_dns"][-1]).max())
    say(label, f"{small.shape[0]}x{small.shape[1]}: regs "
        f"cuda {rg.tolist()} cpu {rc.tolist()}; |diff| {err_r.tolist()}, "
        f"allowed {allowed.tolist()} (+-1e-6 shift spread on the card "
        f"{spread.tolist()}); output max abs diff {err_o:.3e}")
    if not (err_r <= allowed).all():
        raise AssertionError("engine regs disagree between cuda and cpu")
    if err_o > 1e-3:
        raise AssertionError(f"engine output differs by {err_o} > 1e-3")


def bench_gru32() -> None:
    """`python -m yondx_torch.bench --arch gru32` as a user runs it; its
    JSON line is printed, and its PSNR gain and K_est checked."""
    t = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "yondx_torch.bench",
                          "--arch", "gru32"], cwd=REPO, capture_output=True,
                         text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"bench --arch gru32 failed:\n{res.stderr}")
    line = res.stdout.strip().splitlines()[-1]
    rec = json.loads(line)
    print(line, flush=True)
    m = re.search(r"psnr ([\d.]+)->([\d.]+)dB; K_est=([\d.]+)",
                  rec["metric"])
    p_in, p_out, k_est = (float(v) for v in m.groups())
    say("bench gru32", f"{rec['value']} MP/s in {time.perf_counter() - t:.1f}"
        f" s of process; PSNR {p_in} -> {p_out} dB; K_est {k_est}")
    if p_out < p_in + 10.0:
        raise AssertionError(f"bench PSNR gain {p_out - p_in:.2f} dB < 10")
    if abs(k_est - 8.74) > 0.1 * 8.74:
        raise AssertionError(f"bench K_est {k_est} not within 10% of 8.74")


def _artifact(key):
    with open(os.path.join(REPO, HELDOUT_ART[key])) as f:
        return json.load(f)["rows"]


def heldout_column(label, flags, scenes, out_dir, suite="v3",
                   k1_per_scene=3):
    """One eval_synth --heldout run on the card over the shared scenes
    (its JSON into out_dir when given): -> (rows, K1 launches, the
    engine). K1 runs once for the self fit (not with the PGE estimator)
    and twice for the collab fit of each scene."""
    from yondx_torch.cli import eval_synth
    from yondx_torch.nle import moments
    json_flag = ["--json", os.path.join(
        out_dir, f"heldout_{label}_{suite}.json")] if out_dir else []
    args = eval_synth.parse_args(
        ["--heldout", "--suite", suite, *flags, *json_flag])
    eng = eval_synth.build_engine(args)
    torch.cuda.synchronize()
    moments.reset_launches()
    t = time.perf_counter()
    rows = eval_synth.run(args, engine=eng, scenes=scenes)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = moments.LAUNCHES["nle_moments"]
    n = len(rows) - 1
    sm = rows["_summary"]
    glyph = sm["glyphs_min_margin"]
    say(f"heldout {label}", f"suite {suite}, {n} scenes in {wall:.2f} s "
        f"({n / wall:.3f} scenes/s), K1 launches {launches}; mean "
        f"{sm['mean_psnr']:.4f} dB (noisy {sm['mean_noisy']:.4f}), "
        f"{sm['n_below_input']} below input, glyph margin "
        + ("none" if glyph is None else f"{glyph:+.4f}") + "; gain by class "
        + ", ".join(f"{k} {v['mean']:+.3f}"
                    for k, v in sm["per_class_gain"].items()))
    if launches != k1_per_scene * n:
        raise AssertionError(f"heldout {label}: K1 launched {launches} "
                             f"times for {n} scenes, expected "
                             f"{k1_per_scene * n}")
    return rows, launches, eng


def hold_to_artifact(label, rows, art):
    """0 held-out scenes below input, the suite mean within 0.15 dB of
    the artifact's, the glyph margin >= +1.0 dB; scenes more than 0.3 dB
    from their artifact row are named."""
    sm, am = rows["_summary"], art["_summary"]
    far = [f"{k} {rows[k]['psnr'][-1]:.3f} (artifact "
           f"{art[k]['psnr'][-1]:.3f})" for k in rows
           if k != "_summary"
           and abs(rows[k]["psnr"][-1] - art[k]["psnr"][-1]) > 0.3]
    say(f"heldout {label}", f"mean {sm['mean_psnr']:.4f} vs artifact "
        f"{am['mean_psnr']:.4f} ({sm['mean_psnr'] - am['mean_psnr']:+.4f}"
        f" dB); glyph margin {sm['glyphs_min_margin']:+.4f} (artifact "
        f"{am['glyphs_min_margin']:+.4f}); scenes > 0.3 dB from the "
        f"artifact: {far if far else 'none'}")
    if sm["n_below_input"] != 0:
        raise AssertionError(f"heldout {label}: {sm['n_below_input']} "
                             "scenes below input")
    if abs(sm["mean_psnr"] - am["mean_psnr"]) > 0.15:
        raise AssertionError(f"heldout {label}: mean {sm['mean_psnr']:.4f}"
                             f" not within 0.15 dB of {am['mean_psnr']:.4f}")
    if sm["glyphs_min_margin"] < 1.0:
        raise AssertionError(f"heldout {label}: glyph margin "
                             f"{sm['glyphs_min_margin']:.4f} < +1.0 dB")


def heldout_card_vs_cpu():
    """ramp_lo and photo_mid cut to 128 px and one crop, s2dt16 fp32
    through the engine on the card and on the CPU: PSNR within 0.01 dB,
    regs within the larger of rtol 1e-3 and the card's +-1e-6 shift
    spread (as phase 4)."""
    from yondx_torch.cli import eval_synth
    from yondx_torch.eval import heldout
    from yondx_torch.eval.metrics import psnr as t_psnr
    engines = {d: eval_synth.build_engine(eval_synth.parse_args(
        ["--device", d, *S2DT16_FLAGS])) for d in ("cuda", "cpu")}
    p = {"wp": heldout.WP, "bl": heldout.BL, "ratio": 1,
         "scale": float(heldout.WP - heldout.BL), "gain": 1.0, "sigma": 0.0}
    for name in ("ramp_lo", "photo_mid"):
        spec = next(s for s in heldout.SUITES["v3"] if s.name == name)
        clean, noisy = heldout.build_scene(
            dataclasses.replace(spec, size=128, n_crops=1))
        res = {d: e.iter_denoise({"lr": noisy}, dict(p))
               for d, e in engines.items()}
        rg = np.array(res["cuda"]["regs"])
        rc = np.array(res["cpu"]["regs"])
        spread = np.max([np.abs(np.array(engines["cuda"].iter_denoise(
            {"lr": noisy + sh}, dict(p))["regs"]) - rg)
            for sh in (1e-6, -1e-6)], axis=0)
        allowed = np.maximum(1e-3 * np.abs(rc), spread)
        pg, pc = (float(t_psnr(res[d]["raw_dns"][-1], clean))
                  for d in ("cuda", "cpu"))
        say("heldout cuda vs cpu", f"{name} (128 px, 1 crop): PSNR cuda "
            f"{pg:.4f} cpu {pc:.4f} dB; regs cuda {rg.tolist()} cpu "
            f"{rc.tolist()}, |diff| {np.abs(rg - rc).tolist()}, allowed "
            f"{allowed.tolist()}")
        if abs(pg - pc) > 0.01:
            raise AssertionError(f"{name}: card and CPU PSNR differ by "
                                 f"{abs(pg - pc):.4f} dB > 0.01")
        if not (np.abs(rg - rc) <= allowed).all():
            raise AssertionError(f"{name}: regs disagree between cuda and "
                                 "cpu")


def heldout_gate(out_dir=None):
    """Phase 9: the frozen held-out gate on the card (see the module
    docstring); returns K1's launches per column, the scenes and column
    (d)'s mean PSNR."""
    from yondx_torch.eval import heldout
    from yondx_torch.eval.metrics import psnr as t_psnr
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    say("heldout", f"numpy {np.__version__} (the Poisson and normal "
        "streams of the scenes are numpy's)")
    t = time.perf_counter()
    scenes = {(s.name, None): heldout.build_scene(s)
              for s in heldout.SUITES["v3"]}
    noisy = [float(t_psnr(scenes[(s.name, None)][1],
                          scenes[(s.name, None)][0]))
             for s in heldout.SUITES["v3"] if s.heldout]
    art_noisy = _artifact("s2dt16")["_summary"]["mean_noisy"]
    say("heldout", f"built the {len(scenes)} v3 scenes on the host in "
        f"{time.perf_counter() - t:.2f} s; held-out noisy mean "
        f"{np.mean(noisy):.5f} dB (artifact {art_noisy:.5f})")
    if abs(np.mean(noisy) - art_noisy) > 0.01:
        raise AssertionError(f"held-out noisy mean {np.mean(noisy):.5f} "
                             f"not within 0.01 dB of {art_noisy:.5f}")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    launches = {}
    # (a) s2dt16 fp32 and (b) gru32 fp32, each held to its artifact
    cols = {}
    for label, flags in (("s2dt16", S2DT16_FLAGS), ("gru32", GRU32_FLAGS)):
        rows, launches[label], _ = heldout_column(label, flags, scenes,
                                                  out_dir)
        hold_to_artifact(label, rows, _artifact(label))
        cols[label] = rows
    # (c) s2dt16 with --bf16, printed beside (a)
    rows_bf, launches["s2dt16_bf16"], _ = heldout_column(
        "s2dt16_bf16", S2DT16_FLAGS + ["--bf16"], scenes, out_dir)
    fa, fb = cols["s2dt16"]["_summary"], rows_bf["_summary"]
    say("heldout bf16 - fp32", f"s2dt16 mean {fb['mean_psnr']:.4f} - "
        f"{fa['mean_psnr']:.4f} = {fb['mean_psnr'] - fa['mean_psnr']:+.4f} "
        f"dB; below input {fb['n_below_input']}; glyph margin "
        f"{fb['glyphs_min_margin']:+.4f}; by class " + ", ".join(
            f"{k} {fb['per_class_gain'][k]['mean'] - v['mean']:+.3f}"
            for k, v in fa["per_class_gain"].items()))
    # (d) gru32 with the PGE estimator on suite v1
    rows_pge, launches["gru32_pge_v1"], eng = heldout_column(
        "gru32_pge", GRU32_FLAGS + ["--est", "pge"], scenes, out_dir,
        suite="v1", k1_per_scene=2)
    est = eng.est_models["est_net"]
    specs = heldout.SUITES["v1"]
    say("heldout gru32_pge", "K_est / K per scene: " + ", ".join(
        f"{s.name} {float(o[0]) * 959:.2f}/{s.K}"
        for s, o in zip(specs, est.outputs))
        + f"; mean {rows_pge['_summary']['mean_psnr']:.4f} dB (r4 "
        f"history: {_artifact('pge')['_summary']['mean_psnr']:.2f})")
    outs = np.array(est.outputs, np.float64)
    if est.calls != len(specs) or outs.shape != (len(specs), 2):
        raise AssertionError(f"est net ran {est.calls} times for "
                             f"{len(specs)} scenes")
    if not (np.isfinite(outs).all() and (outs > 0).all()):
        raise AssertionError(f"est net gave non-finite or non-positive "
                             f"(K, sigma): {outs.tolist()}")
    # (e) the engine on the card against the CPU
    heldout_card_vs_cpu()
    return launches, scenes, rows_pge["_summary"]["mean_psnr"]


TRAIN_RUNFILE = "runfiles/Gaussian/GRU_5to50_norm_mix.yml"
DISTILL_RUNFILE = "runfiles/Gaussian/GRUS2DT_distill_ftC.yml"
CKPTS = os.path.join(REPO, "checkpoints", "Gaussian")
# AWGNTrainer.eval of the JAX package on the CPU with the committed
# Gaussian_GRU_mix_5to50_norm best checkpoint, the runfile's eval set cut
# to 64 crops (SyntheticSRGBDataset v6, seed 2024): sigma -> (PSNR, SSIM)
JAX_EVAL = {10: (31.0084, 0.9092), 25: (30.0677, 0.8855),
            50: (28.7428, 0.8368)}
# the same for the committed Gaussian_Unet_mix_5to50_norm best checkpoint
# (UNetSeeInDark nf 32) on Unet_5to50_norm.yml's eval set cut to 64 crops:
# tests/test_torch_unets_zoo.py::test_jax_eval_unet_anchor_of_chip_smoke
# recomputes it
JAX_EVAL_UNET = {10: (31.3701, 0.9073), 25: (29.3729, 0.8681),
                 50: (27.2213, 0.8014)}


def _train_args(runfile, tmp, **dst):
    """A runfile with every place it writes moved under `tmp` (an eval
    record would otherwise overwrite the committed best checkpoint)."""
    from yondx_torch.config import load_runfile
    args = load_runfile(os.path.join(REPO, runfile), mode="train")
    args["fast_ckpt"] = os.path.join(tmp, "ckpt")
    args["checkpoint"] = os.path.join(tmp, "saved")
    args["result_dir"] = os.path.join(tmp, "images")
    for k in ("dst_train", "dst_eval", "dst_test"):
        args[k].update(dst.get(k, {}))
    return args


def train_step_card_vs_cpu(tmp) -> None:
    """(a) One step of gru32 (committed 5to50 weights) on 4 crops of 64
    px, card against CPU, "jax" fields on both, TF32 off and cuDNN
    deterministic. Tolerances: loss rtol 1e-4; gradients and both Adam
    moments within 1e-3 of each tensor's max; parameters within the move
    Adam's first step can make for the tensor's gradient error (see
    hold_step), and at most 1% of the entries apart by more than 3e-7."""
    from yondx_torch.data.datasets import SyntheticSRGBDataset
    from yondx_torch.io.ckpt import load_checkpoint
    from yondx_torch.train import AWGNTrainer
    from yondx_torch.train.draws import train_keys
    torch.backends.cudnn.deterministic = True
    args = _train_args(TRAIN_RUNFILE, tmp)
    args["dst_train"]["patch_size"] = 64
    args["hyper"]["batch_size"] = 4
    ds = SyntheticSRGBDataset(length=4, size=64, seed=1997, cache=False)
    batch = np.stack([ds[i] for i in range(4)])
    params = load_checkpoint(os.path.join(
        CKPTS, "Gaussian_GRU_mix_5to50_norm_best_model.ckpt"))["params"]
    lr = 4e-5
    out = {}
    for d in ("cuda", "cpu"):
        tr = AWGNTrainer(args, device=d, field="jax")
        tr.load_params(params)
        loss, m, _ = tr.train_step(batch, next(train_keys(1997)), lr)
        out[d] = dict(step_record(tr, loss), psnr=float(m))
    torch.backends.cudnn.deterministic = False
    hold_step("train (a) cuda vs cpu", f"gru32 5to50, 4 crops of 64 px, lr "
              f"{lr}, PSNR {out['cuda']['psnr']:.4f} / "
              f"{out['cpu']['psnr']:.4f} dB", out, lr, loss_rtol=1e-4,
              max_frac=1e-3)


def train_full_width(tmp, fp32_peak, peak_key, runfile=TRAIN_RUNFILE,
                     label="train (b)") -> None:
    """(b) GRU_5to50_norm_mix.yml as written (gru32 nf=32, batch 64,
    patch 256, WarmupCosine at 2e-4) from a fresh init equal to JAX's,
    one epoch of 12 steps over a 768-crop synthetic set built once
    through the disk cache, "torch" fields, TF32 off; save_freq 1 so
    that epoch 1 writes its `last` checkpoint. Another AWGN `runfile` of
    the same layout runs the same way."""
    from yondx_torch.data.datasets import SyntheticSRGBDataset
    from yondx_torch.models.registry import param_count
    from yondx_torch.models.unets import load_model
    from yondx_torch.train import AWGNTrainer
    from yondx_torch.train.draws import train_keys
    n_steps, warm = 12, 2
    args = _train_args(runfile, tmp,
                       dst_train={"synthetic_len": 64 * n_steps},
                       dst_eval={"synthetic_len": 64})
    args["hyper"]["save_freq"] = 1
    t = time.perf_counter()
    for mode, n in (("train", 64 * n_steps), ("eval", 64)):
        SyntheticSRGBDataset(length=n, size=256,
                             seed=1997 if mode == "train" else 2024)
    say(label, f"built the synthetic sets (768 + 64 crops of 256 px) "
        f"through the disk cache in {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    tr = AWGNTrainer(args, device="cuda", field="torch")
    say(label, f"trainer with a fresh init equal to JAX's "
        f"({param_count(tr.model)} parameters) in "
        f"{time.perf_counter() - t:.2f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    tr.train(stop_epoch=1)
    wall = time.perf_counter() - t
    peak_mem = torch.cuda.max_memory_allocated()
    steps = tr.steps
    if len(steps) != n_steps:
        raise AssertionError(f"{len(steps)} steps run, expected {n_steps}")
    losses = [s["loss"] for s in steps]
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    timed = steps[warm:]
    step_s = float(np.median([s["step_s"] for s in timed]))
    load_s = sum(s["loader_s"] for s in timed)
    share = load_s / (load_s + sum(s["step_s"] for s in timed))
    px = 64 * 128 * 128                     # RGGB pixels a step
    per_px = net_flop_per_pixel(tr.model)
    tflops = 3 * per_px * px / step_s / 1e12
    say(label, f"{args['arch']['name']} nf={args['arch']['nf']} fp32 (TF32 "
        f"off), batch 64 x [128,128,4]: "
        f"{step_s * 1e3:.2f} ms/step (median of steps {warm + 1}-{n_steps}, "
        f"synchronised; all {[round(s['step_s'] * 1e3, 2) for s in steps]} "
        f"ms), {64 / step_s:.1f} samples/s, {px / step_s / 1e6:.2f} RGGB "
        f"MP/s; net {tflops:.2f} TFLOP/s (3 x {per_px / 1e6:.4f} MFLOP per "
        f"RGGB pixel), {100 * tflops * 1e12 / fp32_peak:.1f}% of the "
        f"{fp32_peak / 1e12:.0f} TFLOP/s fp32 peak ({peak_key}); peak memory "
        f"{peak_mem / 2 ** 30:.2f} GiB; loader share {100 * share:.2f}%; "
        f"{wall:.2f} s for the epoch")
    say(label, "loss per step " + ", ".join(f"{v:.5f}" for v in losses)
        + f"; train PSNR {tr.train_psnr.avg:.4f} dB")
    last = os.path.join(args["fast_ckpt"],
                        f"{args['model_name']}_last_model.ckpt")
    if not os.path.exists(last):
        raise AssertionError("the last checkpoint was not written")
    # where a step's time goes: one more step under the profiler, at lr 0
    # (Adam then moves no weight, so the checkpoint still matches the net)
    ds = SyntheticSRGBDataset(length=64 * n_steps, size=256, seed=1997)
    batch = np.stack([ds[i] for i in range(64)])
    keys = next(train_keys(7))
    profile_run(f"{label} profile", lambda: tr.train_step(batch, keys, 0.0))
    p_run, _ = tr.eval(epoch=-1, sigma=25)
    tr.model = load_model(args["arch"], last, device="cuda")
    p_back, _ = tr.eval(epoch=-1, sigma=25)
    say(label, f"eval at sigma 25: {p_run:.4f} dB after the run, "
        f"{p_back:.4f} dB through load_model of the last checkpoint")
    if abs(p_run - p_back) > 1e-4:
        raise AssertionError("the last checkpoint evaluates apart from the "
                             "net that wrote it")


def train_quality_anchor(tmp, runfile=TRAIN_RUNFILE, anchor=JAX_EVAL,
                         label="train (c)") -> None:
    """(c) AWGNTrainer.eval on the card with the committed best checkpoint
    of the runfile's model (5to50 gru32) on the runfile's eval set cut to
    64 crops, against the JAX package's CPU readings (`anchor`) within
    0.02 dB."""
    from yondx_torch.io.ckpt import load_checkpoint
    from yondx_torch.train import AWGNTrainer
    args = _train_args(runfile, tmp, dst_eval={"synthetic_len": 64})
    tr = AWGNTrainer(args, device="cuda", field="torch")
    tr.load_params(load_checkpoint(os.path.join(
        CKPTS, f"{args['model_name']}_best_model.ckpt"))["params"])
    for sigma, (want_p, want_s) in anchor.items():
        t = time.perf_counter()
        p, ssim = tr.eval(epoch=-1, sigma=sigma)
        say(label, f"sigma {sigma}: eval PSNR {p:.4f} dB (JAX CPU "
            f"{want_p:.4f}, diff {p - want_p:+.4f}), SSIM {ssim:.4f} (JAX "
            f"{want_s:.4f}); {time.perf_counter() - t:.2f} s")
        if abs(p - want_p) > 0.02:
            raise AssertionError(f"eval PSNR at sigma {sigma}: {p:.4f} not "
                                 f"within 0.02 dB of {want_p}")


def train_distill_resume(tmp) -> None:
    """(d) GRUS2DT_distill_ftC.yml as written (s2dt16 student, gru32
    teacher, distill weight 0.5, chroma_aug, batch 64), resumed with
    last_epoch -1 from copies of the committed s2dt16 `last` checkpoint
    (epoch 200 with its Adam state) and the teacher; stop_epoch 201, two
    steps. The SGDR schedule gives lr 0 at epoch 201, so the steps move
    no weight: the loaded Adam moments are held, exactly, against the
    file's optax mu and nu on a conv, a Dense and a deconv leaf (laid out
    here by hand: HWIO -> OIHW, [in, out] -> [out, in], and the deconv's
    spatial flip to [in, out, kh, kw])."""
    import shutil
    from yondx_torch.io.ckpt import load_checkpoint
    from yondx_torch.train import AWGNTrainer
    args = _train_args(DISTILL_RUNFILE, tmp,
                       dst_train={"synthetic_len": 64 * 12})
    args["hyper"]["last_epoch"] = -1
    args["hyper"]["stop_epoch"] = 201
    os.makedirs(args["fast_ckpt"])
    for name in ("Gaussian_GRUS2DT_mix_1to50c_norm_last_model.ckpt",
                 "Gaussian_GRU_mix_1to50c_norm_best_model.ckpt"):
        shutil.copy(os.path.join(CKPTS, name), args["fast_ckpt"])
    tr = AWGNTrainer(args, device="cuda", field="torch")
    count0 = {int(st["step"]) for st in tr.optimizer.state.values()}
    if tr.epoch != 200 or count0 != {6400}:
        raise AssertionError(f"resumed at epoch {tr.epoch} with Adam counts "
                             f"{count0}, expected 200 and 6400")
    inner = load_checkpoint(os.path.join(
        args["fast_ckpt"], "Gaussian_GRUS2DT_mix_1to50c_norm_last_model.ckpt"),
        opt_state=True)["opt_state"]["inner_state"]["0"]
    held = {("conv1", "conv1", "kernel"): lambda a: a.transpose(3, 2, 0, 1),
            ("conv1", "guide", "gamma_out", "kernel"): lambda a: a.T,
            ("upv5", "deconv", "kernel"):
                lambda a: a[::-1, ::-1].transpose(2, 3, 0, 1),
            ("conv1", "conv1", "bias"): lambda a: a}
    hold_loaded_moments("distill resume", tr, inner, held)
    tr.train(steps_per_epoch=2)
    counts = {int(st["step"]) for st in tr.optimizer.state.values()}
    losses = [s["loss"] for s in tr.steps]
    say("train (d)", f"s2dt16 distill (teacher gru32 1to50c, w 0.5, "
        f"chroma_aug), resumed at epoch 200, Adam count 6400 -> "
        f"{sorted(counts)} (lr 0 at epoch 201; mu and nu of "
        f"{len(held)} leaves equal to the file's after the load); "
        f"losses {[round(v, 5) for v in losses]}; "
        f"{[round(s['step_s'] * 1e3, 2) for s in tr.steps]} ms/step "
        "(the first includes cuDNN planning)")
    if counts != {6402} or len(losses) != 2 or \
            not np.all(np.isfinite(losses)):
        raise AssertionError("distill resume: Adam count or losses wrong")


def train_phase(fp32_peak, peak_key) -> None:
    """Phase 10: training on the card, (a)-(d), in a temporary directory
    that also holds ./logs/; TF32 off throughout."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            train_step_card_vs_cpu(os.path.join(tmp, "a"))
            train_full_width(os.path.join(tmp, "b"), fp32_peak, peak_key)
            train_quality_anchor(os.path.join(tmp, "c"))
            train_distill_resume(os.path.join(tmp, "d"))
        finally:
            os.chdir(REPO)


EST_RUNFILE = "runfiles/Gaussian/EstPGE.yml"
EST_CKPT = os.path.join(CKPTS, "EstPGE_d3nf16_last_model.ckpt")
EST_MAP_ARCH = {"name": "EstUnet", "in_nc": 12, "out_nc": 4, "pge": False}
# the 'pge' loss of the committed EstPGE_d3nf16 on the fixed eval set
# (yondx_torch.train.pg_trainer.pge_eval_batches: 64 synthetic crops of
# 256 px, keys from PRNGKey(2024), JAX's fields) computed by the JAX
# package on the CPU: tests/test_torch_pg_train.py
# ::test_eval_pge_anchor_of_chip_smoke recomputes it
EST_EVAL_JAX = 0.3170408383011818


def _est_args(tmp, **hyper):
    """EstPGE.yml with its checkpoints written under `tmp`."""
    from yondx_torch.config import load_runfile
    args = load_runfile(os.path.join(REPO, EST_RUNFILE), mode="train")
    args["fast_ckpt"] = os.path.join(tmp, "ckpt")
    args["hyper"].update(hyper)
    return args


def hold_step(phase, label, out, lr, loss_rtol, max_frac) -> None:
    """Card against CPU after one Adam step from the same weights and
    inputs, out = {device: {loss, p, g, mu, nu}}: loss within loss_rtol;
    gradients and both moments within max_frac of each tensor's max;
    weights within the move Adam's first step lr g / (|g| + eps) can
    make for the tensor's gradient error e, lr eps e / (|g| - e + eps)^2
    while |g| > 2e (doubled here) and 2 lr where |g| <= 2e, plus 3e-7
    for rounding; at most 1% of the entries apart by more than 3e-7."""
    c, g = out["cpu"], out["cuda"]
    rel = {key: {n: float(np.abs(g[key][n] - c[key][n]).max())
                 / max(float(np.abs(c[key][n]).max()), 1e-30)
                 for n in c[key]} for key in ("g", "mu", "nu")}
    worst = {key: max(r.values()) for key, r in rel.items()}
    where = max(rel["g"], key=rel["g"].get)
    moved = total = over = 0
    for n in c["p"]:
        e = np.abs(g["g"][n] - c["g"][n]).max()
        a = np.abs(c["g"][n])
        bound = np.where(a > 2 * e, 2 * lr * 1e-8 * e / (a - e + 1e-8) ** 2,
                         2 * lr) + 3e-7
        d = np.abs(g["p"][n] - c["p"][n])
        over += int((d > bound).sum())
        moved += int((d > 3e-7).sum())
        total += d.size
    say(phase, f"{label}: loss {g['loss']:.7f} / {c['loss']:.7f}; worst "
        f"error over each tensor's max: grad {worst['g']:.2e} (at {where}), "
        f"mu {worst['mu']:.2e}, nu {worst['nu']:.2e}; params: {over} "
        f"entries beyond Adam's bound for their gradient error, {moved} of "
        f"{total} apart by > 3e-7")
    if abs(g["loss"] - c["loss"]) > loss_rtol * abs(c["loss"]):
        raise AssertionError(f"{phase} {label}: loss differs")
    if max(worst.values()) > max_frac:
        raise AssertionError(f"{phase} {label}: gradients or moments "
                             f"differ {worst}")
    if over or moved > 0.01 * total:
        raise AssertionError(f"{phase} {label}: parameters differ ({over} "
                             f"over the bound, {moved} of {total} moved)")


def step_record(tr, loss) -> dict:
    """A trainer's state after one step, for hold_step (numpy)."""
    st = tr.optimizer.state
    rec = {"loss": float(loss), "p": {}, "g": {}, "mu": {}, "nu": {}}
    for n, p in tr.model.named_parameters():
        rec["p"][n] = p.detach().cpu().numpy()
        rec["g"][n] = p.grad.detach().cpu().numpy()
        rec["mu"][n] = st[p]["exp_avg"].cpu().numpy()
        rec["nu"][n] = st[p]["exp_avg_sq"].cpu().numpy()
    return rec


def hold_loaded_moments(label, tr, inner, held) -> None:
    """The Adam moments a trainer loaded from a checkpoint, against the
    file's optax mu and nu (`inner`) on the flax paths of `held`, each
    laid out here by hand into torch's layout."""
    pmap = dict(tr.model.named_parameters())
    for path, layout in held.items():
        name = ".".join(path[:-1] + ("weight" if path[-1] == "kernel"
                                     else path[-1],))
        st = tr.optimizer.state[pmap[name]]
        for moment, mine in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            leaf = inner[moment]["params"]
            for k in path:
                leaf = leaf[k]
            if not np.array_equal(layout(np.asarray(leaf)),
                                  st[mine].cpu().numpy()):
                raise AssertionError(f"{label}: {mine} of {name} is not "
                                     f"the file's {moment}")


def est_step_card_vs_cpu(tmp) -> None:
    """(a) One step of each flavour card against CPU from the same fresh
    weights (flax's default init) and the same inputs: one "jax"-field
    batch of 4 crops of 64 px built on the CPU (its EstUnet features by
    the plain box moments; K1 is held in (b)); TF32 off, cuDNN
    deterministic. est_UNet at EstPGE.yml's widths, EstUnet at its
    default widths (nf 64, depth 3) with in_nc 12, out_nc 4."""
    from yondx_torch.core import rng
    from yondx_torch.data.datasets import SyntheticSRGBDataset, to_unit
    from yondx_torch.train.pg_trainer import PGEstTrainer
    torch.backends.cudnn.deterministic = True
    ds = SyntheticSRGBDataset(length=4, size=64, seed=1997, cache=False)
    x = to_unit(np.stack([ds[i] for i in range(4)]), "cpu")
    key = next(rng.rng_seq(0))
    lr = 1e-3
    for label, arch in (("est_UNet d3nf16", None),
                        ("EstUnet nf64 in12", EST_MAP_ARCH)):
        args = _est_args(tmp)
        if arch:
            args["arch"] = dict(arch)
        out, inputs = {}, None
        for d in ("cpu", "cuda"):
            tr = PGEstTrainer(args, device=d, field="jax")
            if inputs is None:
                inputs = tr.inputs(x, key)
            out[d] = step_record(tr, tr.step(
                {k: v.to(tr.device) for k, v in inputs.items()}, lr))
        # gradients and moments: 1e-4 of each tensor's max (phase 10a
        # holds 1e-3); EstUnet nf64's down1_1 bias gradient sits 2.3e-5
        # apart, the CPU's float32 sum's error: against float64 the CPU
        # reads 2.3e-5 and the card 1e-7 (scripts/torch_est_grad_f64.py)
        hold_step("est (a) cuda vs cpu", label, out, lr, loss_rtol=1e-5,
                  max_frac=1e-4)
    torch.backends.cudnn.deterministic = False


def est_k1_k19(bw, fp32) -> dict:
    """(b) K1 at the map flavour's k = 19, mean and var (texture off), on
    one stack [32,128,128,4] and on the stacked [lr; hr] [64,128,128,4]
    the step launches, against its plain version (phase 3's tolerances:
    mean 1e-5, var 1e-6) and timed against its bound (one read and two
    map writes), cold L2."""
    from yondx_torch.nle import moments
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(19)
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rec = {}
    for B in (32, 64):
        x = torch.rand((B, 128, 128, 4), generator=g, device=dev)
        got = moments.nle_moments(x, 19, 19, texture=False)
        torch.cuda.synchronize()
        ref = moments.nle_moments_plain(x, 19, 19, texture=False)
        errs = {key: float((gv - rv).abs().max()) for key, gv, rv in
                zip(("mean", "var"), got[:2], ref[:2])}
        if got[2] is not None or errs["mean"] > 1e-5 or errs["var"] > 1e-6:
            raise AssertionError(f"K1 k=19 [{B},128,128,4]: {errs}")
        ms = cuda_ms(lambda: moments.nle_moments(x, 19, 19, texture=False),
                     20, scratch.zero_)
        plain = cuda_ms(lambda: moments.nle_moments_plain(
            x, 19, 19, texture=False), 10, scratch.zero_)
        n = x.numel()
        t_bytes = 3 * 4 * n / bw * 1e3
        t_ops = n * K1_FLAVOURS["collab_dn"][2] / fp32 * 1e3
        bound = max(t_bytes, t_ops)
        say("est (b) K1 k=19", f"[{B},128,128,4] mean, var: max abs err "
            f"mean {errs['mean']:.3e}, var {errs['var']:.3e}; {ms:.4f} ms, "
            f"bound {bound:.4f} ms by "
            f"{'bytes' if t_bytes >= t_ops else 'operations'} "
            f"({3 * 4 * n / 1e6:.1f} MB), {ms / bound:.1f}x; plain "
            f"{plain:.4f} ms")
        rec[f"{B}x128x128x4"] = {"ms": ms, "plain_ms": plain,
                                 "bound_ms": bound, "max_abs_err": errs,
                                 "bound_by": "bytes" if t_bytes >= t_ops
                                 else "operations"}
    return rec


def est_pge_recipe(tmp):
    """(c) EstPGE.yml as written (est_UNet nf 16, depth 3, batch 32,
    patch 256 -> [32,128,128,4], WarmupCosine at 1e-3, 1024 synthetic
    crops, "torch" fields), fresh weights equal to JAX's, checkpoints
    under `tmp`; all 80 epochs unless a timed pilot says they would take
    over 90 s, then the largest multiple of save_freq that fits."""
    from yondx_torch.core import rng
    from yondx_torch.data.datasets import SyntheticSRGBDataset
    from yondx_torch.nle import moments
    from yondx_torch.train.pg_trainer import PGEstTrainer
    args = _est_args(tmp)
    dst, bs = args["dst_train"], args["hyper"]["batch_size"]
    t = time.perf_counter()
    ds = SyntheticSRGBDataset(length=dst["synthetic_len"],
                              size=dst["patch_size"], seed=1997)
    say("est (c)", f"built the synthetic set ({len(ds)} crops of "
        f"{ds.size} px) through the disk cache in "
        f"{time.perf_counter() - t:.2f} s")
    pilot = PGEstTrainer(args, device="cuda", field="torch")
    batch = np.stack([ds[i] for i in range(bs)])
    keys = rng.rng_seq(1)
    times = []
    for _ in range(12):
        t = time.perf_counter()
        float(pilot.train_step(batch, next(keys), 1e-3))
        times.append(time.perf_counter() - t)
    pilot_s = float(np.median(times[2:]))
    del pilot
    epochs = args["hyper"]["stop_epoch"]
    per_epoch = len(ds) // bs
    if epochs * per_epoch * pilot_s > 90:
        freq = args["hyper"]["save_freq"]
        epochs = max(freq, int(90 / (per_epoch * pilot_s)) // freq * freq)
    say("est (c)", f"pilot {pilot_s * 1e3:.2f} ms/step: running {epochs} of "
        f"{args['hyper']['stop_epoch']} epochs ({epochs * per_epoch} steps)"
        + ("" if epochs == args["hyper"]["stop_epoch"] else
           " -- CUT to fit about 90 s"))
    tr = PGEstTrainer(args, device="cuda", field="torch")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    moments.reset_launches()
    t = time.perf_counter()
    tr.train(epochs=epochs)
    wall = time.perf_counter() - t
    launches = moments.LAUNCHES["nle_moments"]
    peak_mem = torch.cuda.max_memory_allocated()
    steps = tr.steps
    losses = np.array([s["loss"] for s in steps])
    if len(steps) != epochs * per_epoch or not np.isfinite(losses).all():
        raise AssertionError(f"est (c): {len(steps)} steps, finite "
                             f"{np.isfinite(losses).all()}")
    timed = steps[per_epoch:] or steps[2:]
    step_s = float(np.median([s["step_s"] for s in timed]))
    load_s = sum(s["loader_s"] for s in timed)
    share = load_s / (load_s + sum(s["step_s"] for s in timed))
    say("est (c)", f"est_UNet d3nf16, batch {bs} x [{ds.size // 2},"
        f"{ds.size // 2},4], fp32 (TF32 off): {step_s * 1e3:.2f} ms/step "
        f"(median of steps {len(steps) - len(timed) + 1}-{len(steps)}, each "
        f"ending in the loss read), {bs / step_s:.1f} samples/s; peak memory "
        f"{peak_mem / 2 ** 30:.2f} GiB; loader share {100 * share:.2f}%; "
        f"{wall:.2f} s for {epochs} epochs; K1 launches {launches} (the "
        "pge flavour runs no box moments)")
    per = {e: float(np.mean([s["loss"] for s in steps if s["epoch"] == e]))
           for e in range(1, epochs + 1)}
    say("est (c)", "mean loss of epochs " + ", ".join(
        f"{e}: {per[e]:.5f}" for e in (1, *range(10, epochs + 1, 10))))
    last = os.path.join(args["fast_ckpt"], "EstPGE_d3nf16_last_model.ckpt")
    if launches or not os.path.exists(last):
        raise AssertionError("est (c): K1 ran, or no last checkpoint")
    profile_run("est (c) profile", lambda: float(tr.train_step(
        batch, next(rng.rng_seq(5)), 0.0)))
    return tr, last, epochs


def est_map_flavour() -> dict:
    """(d) The map flavour at EstUnet's default widths (nf 64, depth 3,
    in_nc 12, out_nc 4), batch 32, patch 256, 20 steps, "torch" fields:
    ms/step and K1's launches (one a step, on the stacked [lr; hr])."""
    from yondx_torch.models.registry import param_count
    from yondx_torch.nle import moments
    from yondx_torch.train.pg_trainer import PGEstTrainer
    with tempfile.TemporaryDirectory() as tmp:
        args = _est_args(tmp, stop_epoch=1, save_freq=1)
        args["arch"] = dict(EST_MAP_ARCH)
        tr = PGEstTrainer(args, device="cuda", field="torch")
        torch.cuda.synchronize()
        moments.reset_launches()
        tr.train(epochs=1, steps_per_epoch=20)
        launches = moments.LAUNCHES["nle_moments"]
    steps = tr.steps
    losses = [s["loss"] for s in steps]
    step_s = float(np.median([s["step_s"] for s in steps[2:]]))
    bs, size = args["hyper"]["batch_size"], args["dst_train"]["patch_size"]
    say("est (d)", f"EstUnet nf64 d3 in12 ({param_count(tr.model)} "
        f"parameters), batch {bs} x [{size // 2},{size // 2},4]: "
        f"{step_s * 1e3:.2f} ms/step "
        f"(median of steps 3-{len(steps)}); K1 launches {launches} in "
        f"{len(steps)} steps; losses {losses[0]:.5f} ... {losses[-1]:.5f}")
    if len(steps) != 20 or not np.all(np.isfinite(losses)):
        raise AssertionError("est (d): steps or losses wrong")
    if launches != len(steps):
        raise AssertionError(f"est (d): K1 launched {launches} times in "
                             f"{len(steps)} steps, expected one a step")
    return {"launches": launches, "steps": len(steps),
            "shape": [2 * bs, size // 2, size // 2, 4],
            "step_ms": step_s * 1e3}


def est_quality(tr) -> None:
    """(e) The 'pge' loss on the fixed eval set (64 crops, JAX's fields):
    the committed EstPGE_d3nf16 within 1e-4 of EST_EVAL_JAX; the net of
    (c) at most 1.25x the committed net's value."""
    from yondx_torch.models.unets import load_model
    from yondx_torch.train.pg_trainer import eval_pge, pge_eval_batches
    t = time.perf_counter()
    batches = pge_eval_batches("cuda")
    say("est (e)", f"built the eval set (64 crops, JAX's fields on the "
        f"host) in {time.perf_counter() - t:.2f} s")
    committed = eval_pge(load_model(tr.arch, EST_CKPT, device="cuda"),
                         batches)
    mine = eval_pge(tr.model, batches)
    say("est (e)", f"eval loss: committed EstPGE_d3nf16 {committed:.6f} "
        f"(JAX CPU {EST_EVAL_JAX:.6f}, diff {committed - EST_EVAL_JAX:+.2e});"
        f" the net trained in (c) {mine:.6f} ({mine / committed:.3f}x)")
    if abs(committed - EST_EVAL_JAX) > 1e-4:
        raise AssertionError("est (e): the committed estimator's eval loss "
                             "is not within 1e-4 of JAX's")
    if not mine <= 1.25 * committed:
        raise AssertionError(f"est (e): trained net {mine:.6f} > 1.25 x "
                             f"{committed:.6f}")


def est_resume(tmp) -> None:
    """(f) The committed EstPGE_d3nf16 checkpoint (epoch 80, optax Adam
    state) resumed with last_epoch -1 and stop_epoch 81, two steps: the
    schedule gives lr 0 at epoch 81, so the steps move no weight; the
    Adam count goes to the file's + 2, and before the steps the loaded
    moments of a conv kernel, a deconv kernel and a bias equal the
    file's (laid out here by hand)."""
    import shutil
    from yondx_torch.io.ckpt import load_checkpoint
    from yondx_torch.train.pg_trainer import PGEstTrainer
    args = _est_args(tmp, last_epoch=-1, stop_epoch=81)
    os.makedirs(args["fast_ckpt"])
    shutil.copy(EST_CKPT, args["fast_ckpt"])
    inner = load_checkpoint(EST_CKPT, opt_state=True)[
        "opt_state"]["inner_state"]["0"]
    count = int(inner["count"])
    tr = PGEstTrainer(args, device="cuda", field="torch")
    counts = {int(st["step"]) for st in tr.optimizer.state.values()}
    if tr.epoch != 80 or counts != {count}:
        raise AssertionError(f"est resume: epoch {tr.epoch}, counts "
                             f"{counts}, expected 80 and {count}")
    held = {("down0_1", "kernel"): lambda a: a.transpose(3, 2, 0, 1),
            ("up0_deconv", "deconv", "kernel"):
                lambda a: a[::-1, ::-1].transpose(2, 3, 0, 1),
            ("conv_final", "bias"): lambda a: a}
    hold_loaded_moments("est resume", tr, inner, held)
    pmap = dict(tr.model.named_parameters())
    before = {n: p.detach().clone() for n, p in pmap.items()}
    tr.train(steps_per_epoch=2)
    after = {int(st["step"]) for st in tr.optimizer.state.values()}
    still = all(torch.equal(before[n], p.detach()) for n, p in pmap.items())
    say("est (f)", f"EstPGE_d3nf16 resumed at epoch 80, Adam count {count} "
        f"-> {sorted(after)} (lr {tr.lr_fn(81)} at epoch 81; mu and nu of "
        f"{len(held)} leaves equal to the file's; weights unmoved: "
        f"{still}); losses {[round(s['loss'], 5) for s in tr.steps]}")
    if after != {count + 2} or not still:
        raise AssertionError("est resume: Adam count or weights wrong")


def est_serving(last, scenes, pge_mean, out_dir, tmp) -> None:
    """(g) The net of (c) served through `eval_synth --heldout --suite v1
    --est pge` with a --ckpt-dir holding the gru32 net and that
    estimator: its mean within 1.0 dB of column (d)."""
    import shutil
    serve = os.path.join(tmp, "serve")
    os.makedirs(serve)
    shutil.copy(last, serve)
    os.symlink(os.path.join(CKPTS,
                            "Gaussian_GRU_mix_1to50c_norm_best_model.ckpt"),
               os.path.join(serve,
                            "Gaussian_GRU_mix_1to50c_norm_best_model.ckpt"))
    rows, _, _ = heldout_column(
        "gru32_pge_port", GRU32_FLAGS + ["--est", "pge", "--ckpt-dir",
                                         serve], scenes, out_dir,
        suite="v1", k1_per_scene=2)
    mean = rows["_summary"]["mean_psnr"]
    say("est (g)", f"gru32 + the port-trained estimator, v1: mean "
        f"{mean:.4f} dB beside column (d)'s {pge_mean:.4f} "
        f"({mean - pge_mean:+.4f} dB)")
    if abs(mean - pge_mean) > 1.0:
        raise AssertionError("est (g): not within 1.0 dB of column (d)")


def est_train_phase(bw, fp32, scenes, pge_mean, out_dir) -> dict:
    """Phase 11: the noise-estimation trainer on the card, (a)-(g), in a
    temporary directory; TF32 off. Returns K1's record at k = 19."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            est_step_card_vs_cpu(os.path.join(tmp, "a"))
            rec = est_k1_k19(bw, fp32)
            tr, last, epochs = est_pge_recipe(os.path.join(tmp, "c"))
            rec["map_flavour"] = est_map_flavour()
            est_quality(tr)
            est_resume(os.path.join(tmp, "f"))
            est_serving(last, scenes, pge_mean, out_dir, tmp)
        finally:
            os.chdir(REPO)
    rec["pge_recipe_epochs"] = epochs
    return rec


UNET_RUNFILE = "runfiles/Gaussian/Unet_5to50_norm.yml"
UNET_CKPT = os.path.join(CKPTS,
                         "Gaussian_Unet_mix_5to50_norm_best_model.ckpt")
PGE_RUNFILE = "runfiles/YOND/SIDD_pge_pre_grumix.yml"
BM3D_ART = "docs/heldout/r5_bm3d_photo_cpu.json"


def unetn_runfile(tmp) -> str:
    """The ANY runfile with arch and model_name swapped to the committed
    UNetSeeInDark (unguided, in VST space: the reference's 'unetn'
    configuration), written into `tmp`."""
    with open(os.path.join(REPO, ANY_RUNFILE)) as f:
        head, arch = f.read().split("arch:")
    head = head.replace("fast_ckpt: 'checkpoints/Gaussian'",
                        f"fast_ckpt: '{CKPTS}'").replace(
        "Gaussian_GRU_mix_1to50c_norm", "Gaussian_Unet_mix_5to50_norm")
    arch = arch.replace("'GuidedResUnet'", "'UNetSeeInDark'").replace(
        "guided: True", "guided: False")
    path = os.path.join(tmp, "ANY_simple+full_pre_unetn.yml")
    with open(path, "w") as f:
        f.write(head + "arch:" + arch)
    return path


def unet_forward_card_vs_cpu() -> None:
    """(a) The committed UNetSeeInDark (nf 32) fp32, TF32 off, on a
    [2,128,128,4] stack, card against CPU within atol 1e-4."""
    from yondx_torch.config import load_runfile
    from yondx_torch.models.unets import load_model
    arch = load_runfile(os.path.join(REPO, UNET_RUNFILE))["arch"]
    x = torch.rand((2, 128, 128, 4),
                   generator=torch.Generator().manual_seed(12))
    out = {}
    for d in ("cuda", "cpu"):
        net = load_model(arch, UNET_CKPT, device=d)
        with torch.no_grad():
            out[d] = net(x.to(d)).cpu()
    n = sum(p.numel() for p in net.parameters())
    err = float((out["cuda"] - out["cpu"]).abs().max())
    say("unet (a)", f"UNetSeeInDark nf {arch['nf']} ({n} parameters) on "
        f"[2,128,128,4]: card vs CPU max abs err {err:.3e}")
    if not bool(torch.isfinite(out["cuda"]).all()) or err > 1e-4:
        raise AssertionError(f"unet (a): card and CPU differ by {err}")


def est_block_path(noisy, clean, scenes) -> dict:
    """(d) YOND from runfiles/YOND/SIDD_pge_pre_grumix.yml (gru32 with
    refine and its est_net block, the committed EstPGE_d3nf16) on the card
    and on the CPU: engine.iter_denoise on photo_mid's held-out crop stack
    [4,512,512] (round 0 from the est net, so K1 runs only for the collab
    fit: 2 launches), card against CPU: regs with phase 7's rule, PSNR
    within 0.01 dB and at most 1e-4 of the pixels apart by more than 1e-3
    (as phase 9e: the runfile's refine buckets its noise floor by
    floor(63 z), so an ulp can move a pixel by a few 1e-3); then --input
    once on the frame, which runs the self NLE whatever est_type says (as
    JAX's CLI does): its seconds, PSNR and K1 launches (3)."""
    from yondx_torch.cli import yond
    from yondx_torch.eval import heldout
    from yondx_torch.nle import moments
    hr, lr = scenes[("photo_mid", None)]
    p = {"wp": heldout.WP, "bl": heldout.BL, "ratio": 1,
         "scale": float(heldout.WP - heldout.BL), "gain": 1.0, "sigma": 0.0}
    res, apps = {}, {}
    for d in ("cuda", "cpu"):
        apps[d] = yond.YOND(["-f", PGE_RUNFILE, "--device", d])
        moments.reset_launches()
        t = time.perf_counter()
        res[d] = apps[d].engine.iter_denoise({"lr": lr}, dict(p))
        if d == "cuda":
            torch.cuda.synchronize()
            est_s = time.perf_counter() - t
            launches = moments.LAUNCHES["nle_moments"]
            spread = np.max([np.abs(np.array(apps[d].engine.iter_denoise(
                {"lr": lr + sh}, dict(p))["regs"])
                - np.array(res[d]["regs"])) for sh in (1e-6, -1e-6)],
                axis=0)
    est = apps["cuda"].est_models["est_net"]
    rg, rc = np.array(res["cuda"]["regs"]), np.array(res["cpu"]["regs"])
    allowed = np.maximum(1e-3 * np.abs(rc), spread)
    diff = np.abs(res["cuda"]["raw_dns"][-1] - res["cpu"]["raw_dns"][-1])
    apart = float(np.mean(diff > 1e-3))
    pg, pc = (psnr(res[d]["raw_dns"][-1], hr) for d in ("cuda", "cpu"))
    say("est block (d)", f"iter_denoise on photo_mid's [4,512,512] with the "
        f"est net: {est_s:.2f} s on the card (first call); est net "
        f"(K, sigma) {est.outputs[0].tolist()}; K1 launches {launches}; "
        f"regs cuda {rg.tolist()} cpu {rc.tolist()}, allowed "
        f"{allowed.tolist()}; PSNR cuda {pg:.4f} cpu {pc:.4f} dB; output "
        f"max abs diff {float(diff.max()):.3e}, {apart:.2e} of the pixels "
        "apart by > 1e-3")
    if launches != 2:
        raise AssertionError(f"est block: K1 launched {launches} times, "
                             "expected 2 (collab only)")
    if not (np.abs(rg - rc) <= allowed).all() or abs(pg - pc) > 0.01 \
            or apart > 1e-4:
        raise AssertionError("est block: card and CPU disagree")
    calls = est.calls
    H, W = noisy.shape
    with tempfile.TemporaryDirectory() as tmp:
        fin, fout = os.path.join(tmp, "frame.npy"), os.path.join(tmp,
                                                                 "dn.npy")
        np.save(fin, noisy)
        moments.reset_launches()
        t = time.perf_counter()
        app = yond.main(["-f", PGE_RUNFILE, "--input", fin, "--output",
                         fout])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t
        out = np.load(fout)
    launches_in = moments.LAUNCHES["nle_moments"]
    p_in, p_out = psnr(noisy, clean), psnr(out, clean)
    say("est block (d)", f"yond -f {PGE_RUNFILE} --input ({H}x{W}): "
        f"{cli_s * 1e3:.2f} ms for the one run (model loads and cuDNN "
        f"planning included); PSNR {p_in:.2f} -> {p_out:.2f} dB; K1 "
        f"launches {launches_in}; est net calls "
        f"{app.est_models['est_net'].calls}")
    if p_out < p_in + 10.0 or launches_in != 3 or \
            app.est_models["est_net"].calls or est.calls != calls:
        raise AssertionError("est block --input: PSNR gain, K1 launches or "
                             "est net calls wrong")
    return {"iter_denoise": launches, "input": launches_in}


def bm3d_column(scenes, out_dir) -> int:
    """(e) eval_synth --heldout --suite v3 --scene-filter photo --denoiser
    bm3d (3 scenes of 4 crops of 512 px; BM3D on the host, the rest on the
    card) held to docs/heldout/r5_bm3d_photo_cpu.json: each scene within
    0.05 dB, the mean within 0.02 dB, do_no_harm as recorded. Returns K1's
    launches (3 a scene)."""
    with open(os.path.join(REPO, BM3D_ART)) as f:
        art = json.load(f)["rows"]
    t = time.perf_counter()
    rows, launches, eng = heldout_column(
        "bm3d_photo", ["--scene-filter", "photo", "--denoiser", "bm3d"],
        scenes, out_dir)
    wall = time.perf_counter() - t
    names = [k for k in rows if k != "_summary"]
    host = eng.denoiser.host_s
    say("bm3d (e)", f"{len(names)} scenes in {wall:.2f} s: "
        f"{wall / len(names):.2f} s a scene, of which host BM3D "
        f"{host / len(names):.2f} s and the rest (the card's NLE, VST and "
        f"copies) {(wall - host) / len(names):.2f} s; rows "
        + ", ".join(f"{k} {rows[k]['psnr'][-1]:.4f} (artifact "
                    f"{art[k]['psnr'][-1]:.4f})" for k in names)
        + f"; mean {rows['_summary']['mean_psnr']:.4f} (artifact "
        f"{art['_summary']['mean_psnr']:.4f})")
    if sorted(names) != sorted(k for k in art if k != "_summary"):
        raise AssertionError(f"bm3d: scenes {names}")
    for k in names:
        if abs(rows[k]["psnr"][-1] - art[k]["psnr"][-1]) > 0.05 or \
                rows[k]["do_no_harm"] != art[k]["do_no_harm"]:
            raise AssertionError(f"bm3d: {k} apart from the artifact")
    if abs(rows["_summary"]["mean_psnr"]
           - art["_summary"]["mean_psnr"]) > 0.02:
        raise AssertionError("bm3d: mean not within 0.02 dB")
    return launches


def unetn_phase(noisy, clean, scenes, fp32_peak, peak_key, out_dir) -> dict:
    """Phase 12: the UNetSeeInDark 'unetn' denoiser, the est_* block and
    the host BM3D, (a)-(e); TF32 off. Returns K1's launches per path."""
    from yondx_torch.nle import moments
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = {}
    t = time.perf_counter()
    unet_forward_card_vs_cpu()
    say("phase 12", f"(a) in {time.perf_counter() - t:.2f} s")
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        runfile = unetn_runfile(tmp)
        # the unguided Unet gains about 7 dB on this frame's content in
        # the JAX package and the port alike (CPU, a 1024x2048 crop:
        # 24.49 -> 31.50 dB in both), against the guided nets' 19.7: its
        # floor is 5 dB; card vs CPU below holds its numerics
        cli = cli_path(noisy, clean, runfile, label="unetn cli (b)",
                       min_gain=5.0)
        rec["unetn_cli"] = cli["launches"]
        engine_card_vs_cpu(runfile, np.ascontiguousarray(noisy[:512, :1024]),
                           label="unetn cuda vs cpu (b)")
        say("phase 12", f"(b) in {time.perf_counter() - t:.2f} s")
        os.chdir(tmp)
        try:
            t = time.perf_counter()
            moments.reset_launches()
            train_full_width(os.path.join(tmp, "c"), fp32_peak, peak_key,
                             UNET_RUNFILE, label="unet recipe (c)")
            rec["unet_trainer"] = moments.LAUNCHES["nle_moments"]
            train_quality_anchor(os.path.join(tmp, "c_eval"), UNET_RUNFILE,
                                 JAX_EVAL_UNET, label="unet anchor (c)")
            if rec["unet_trainer"]:
                raise AssertionError("the Unet trainer launched K1")
            say("phase 12", f"(c) in {time.perf_counter() - t:.2f} s")
        finally:
            os.chdir(REPO)
    t = time.perf_counter()
    rec.update(est_block_path(noisy, clean, scenes))
    say("phase 12", f"(d) in {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    rec["bm3d_heldout"] = bm3d_column(scenes, out_dir)
    say("phase 12", f"(e) in {time.perf_counter() - t:.2f} s")
    return rec


# 13. the runfiles' eval and test modes -----------------------------------
SIDD_RUNFILE = "runfiles/YOND/SIDD_simple+full_pre_grumix.yml"
ELD_RUNFILE = "runfiles/YOND/ELD_simple+full_pre_grumix.yml"
LRID_RUNFILE = "runfiles/YOND/LRID_simple+full_pre_grumix.yml"
DND_RUNFILE = "runfiles/YOND/DND_simple+full_pre_grumix.yml"
# phase 13's fixtures at the real datasets' shapes: SIDD's validation
# blocks [scenes, crops, 256, 256], ELD's SonyA7S2 frames (12.1 MP, the
# whole-frame route), LRID's IMX686 frames (16.05 MP, just over the
# harness's 16 MP tiling threshold), one DND frame with its 20 boxes
EVAL_SHAPES = {"sidd": (40, 32, 256, 256), "eld": (2848, 4256),
               "lrid": (3472, 4624), "dnd": (3072, 4096), "dnd_box": 512}
# PSNR floors (dB) that catch a broken path: the denoised output against
# each fixture's clean content, about 4-5 dB under the CPU rehearsal of
# phase 13 at reduced sizes (SIDD 40.05, its PGE runfile 39.83, ELD after
# the alignment 34.36-34.46, LRID 42.39, DND 39.32; the noisy inputs read
# 23.1-26.6); PERF.md section 2
EVAL_FLOORS = {"sidd": 35.0, "sidd_pge": 35.0, "eld": 30.0, "lrid": 37.0,
               "dnd": 35.0}


def _level_frame(H, W, rng):
    """make_frame's clean content (a 12x16 grid of flat levels in
    [0.05, 0.75]) at any H x W."""
    levels = rng.random((12, 16)) * 0.7 + 0.05
    return levels[(np.arange(H) * 12) // H][:, (np.arange(W) * 16) // W] \
        .astype(np.float32)


def _pg(clean, K, sig, scale, rng):
    """Poisson-Gaussian noise on clean content in [0, 1] (K and sig in DN
    of `scale`), back in [0, 1]."""
    noisy = (K * rng.poisson(clean * (scale / K))
             + rng.normal(0, sig, clean.shape)) / scale
    return np.clip(noisy, 0.0, 1.0).astype(np.float32)


def sidd_blocks(shape, seed=13):
    """SIDD-like [scenes, crops, 256, 256] blocks: each scene's crops are
    256-px windows of make_frame's content set between its 256-px level
    blocks (so each crop holds four levels), each scene with its own
    noise, K in [2, 12] and sigma in [2, 16] DN of 959. -> (noisy,
    clean, per-scene (K, sigma))."""
    n, crops, size, _ = shape
    rng = np.random.default_rng(seed)
    noisy = np.empty(shape, np.float32)
    clean = np.empty(shape, np.float32)
    cols = 8
    rows = -(-crops // cols)
    H, W = size * (rows + 1), size * (cols + 1)
    kn = []
    for s in range(n):
        frame = _level_frame(H, W, rng)
        K, sig = rng.uniform(2, 12), rng.uniform(2, 16)
        kn.append((K, sig))
        for c in range(crops):
            y = size // 2 + size * (c // cols)
            x = size // 2 + size * (c % cols)
            clean[s, c] = frame[y:y + size, x:x + size]
        noisy[s] = _pg(clean[s], K, sig, 959.0, rng)
    return noisy, clean, kn


class _Recorder:
    """Times and regs of every YONDEngine.iter_denoise /
    iter_denoise_tiled call (each ends in the copy of its result to the
    host), and the SIDD harnesses run, while active."""

    def __init__(self):
        from yondx_torch.eval.sidd import SIDDEvalHarness
        from yondx_torch.pipeline.engine import YONDEngine
        self.targets = [(YONDEngine, "iter_denoise"),
                        (YONDEngine, "iter_denoise_tiled"),
                        (SIDDEvalHarness, "run")]
        self.calls, self.harnesses = [], []

    def __enter__(self):
        self.saved = [getattr(cls, name) for cls, name in self.targets]
        for (cls, name), orig in zip(self.targets, self.saved):
            def run(obj, *a, _orig=orig, _name=name, **kw):
                t = time.perf_counter()
                out = _orig(obj, *a, **kw)
                if _name == "run":
                    self.harnesses.append((obj, t, time.perf_counter()))
                else:
                    self.calls.append((_name, t, time.perf_counter(),
                                       out["regs"]))
                return out
            setattr(cls, name, run)
        return self

    def __exit__(self, *exc):
        for (cls, name), orig in zip(self.targets, self.saved):
            setattr(cls, name, orig)


def _repo(path):
    return os.path.join(REPO, path)


@contextlib.contextmanager
def _quiet(log):
    """Send the CLI's and the engine's log lines to the file `log`."""
    with open(log, "a") as f, contextlib.redirect_stdout(f):
        yield


def run_cli(args, log):
    """yond.main(args) with its log lines sent to `log`; -> (app, seconds,
    K1 launches)."""
    from yondx_torch.cli import yond
    from yondx_torch.nle import moments
    moments.reset_launches()
    t = time.perf_counter()
    with _quiet(log):
        app = yond.main(args)
    if app.device != "cpu":
        torch.cuda.synchronize()
    return app, time.perf_counter() - t, moments.LAUNCHES["nle_moments"]


def _quiet_call(log, fn, *args):
    with _quiet(log):
        return fn(*args)


def _metrics(method):
    import pickle
    with open(os.path.join("metrics", f"{method}_metrics.pkl"), "rb") as f:
        return pickle.load(f)


def _card_vs_cpu(label, card, cpu, regs_card, regs_cpu, spread, clean):
    """Phase 7's rule on regs, PSNR within 0.01 dB, at most 1e-4 of the
    pixels apart by more than 1e-3."""
    rg, rc = np.array(regs_card), np.array(regs_cpu)
    allowed = np.maximum(1e-3 * np.abs(rc), spread)
    diff = np.abs(card - cpu)
    apart = float(np.mean(diff > 1e-3))
    pg, pc = psnr(card, clean), psnr(cpu, clean)
    say(label, f"regs cuda {rg.tolist()} cpu {rc.tolist()}, allowed "
        f"{allowed.tolist()}; PSNR cuda {pg:.4f} cpu {pc:.4f} dB; output "
        f"max abs diff {float(diff.max()):.3e}, {apart:.2e} of the pixels "
        "apart by > 1e-3")
    if not (np.abs(rg - rc) <= allowed).all() or abs(pg - pc) > 0.01 \
            or apart > 1e-4:
        raise AssertionError(f"{label}: card and CPU disagree")


def _shift_spread(engine, items, p):
    """The card's regs spread under a +-1e-6 shift of each input."""
    out = []
    for data in items:
        base = np.array(engine.iter_denoise(dict(data), dict(p))["regs"])
        out.append(np.max([np.abs(np.array(engine.iter_denoise(
            dict(data, lr=data["lr"] + s), dict(p))["regs"]) - base)
            for s in (1e-6, -1e-6)], axis=0))
    return np.stack(out)


def _ssim_f64(a, b):
    """MATLAB SSIM of [N, H, W] stacks in float64 numpy, each crop's mean
    map meaned over the stack."""
    g = np.exp(-((np.arange(11) - 5) ** 2) / 4.5)
    g /= g.sum()

    def filt(m):
        H, W = m.shape[-2:]
        r = sum(g[k] * m[..., :, k:k + W - 10] for k in range(11))
        return sum(g[k] * r[..., k:k + H - 10, :] for k in range(11))

    a, b = a.astype(np.float64), b.astype(np.float64)
    mu1, mu2 = filt(a), filt(b)
    s1, s2 = filt(a * a) - mu1 ** 2, filt(b * b) - mu2 ** 2
    s12 = filt(a * b) - mu1 * mu2
    c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
    return float(np.mean((2 * mu1 * mu2 + c1) * (2 * s12 + c2)
                         / ((mu1 ** 2 + mu2 ** 2 + c1) * (s1 + s2 + c2))))


def ssim_threads_check(noisy, clean) -> None:
    """The SIDD harness's scoring on the card with cuDNN's TF32 at torch's
    default (on), from 4 threads at once as its pool runs it: bit-equal
    to one thread, within 1e-5 of float64, the flag left as it was."""
    from concurrent.futures import ThreadPoolExecutor
    from yondx_torch.eval.metrics import matlab_ssim
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    pairs = [(torch.as_tensor(n * 255, device="cuda"),
              torch.as_tensor(c * 255, device="cuda"))
             for n, c in zip(noisy, clean)]

    def score(pair):
        return float(matlab_ssim(*pair))

    serial = [score(pr) for pr in pairs]
    with ThreadPoolExecutor(max_workers=4) as pool:
        threaded = list(pool.map(score, pairs * 4))
    ref = [_ssim_f64(n * 255, c * 255) for n, c in zip(noisy, clean)]
    err = max(abs(a - b) for a, b in zip(serial, ref))
    after = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    say("eval (a)", f"SSIM of {len(pairs)} scenes on the card with "
        f"(cudnn, matmul) TF32 {flags}: 4 threads bit-equal to one "
        f"{threaded == serial * 4}; max |SSIM - float64| {err:.3e}; flags "
        f"after {after}")
    if threaded != serial * 4 or err > 1e-5 or after != flags:
        raise AssertionError("SSIM scoring under threads or TF32 wrong")


def sidd_cases(tmp, log) -> dict:
    """(a) SIDD eval, (g) its first 2 scenes on the CPU, (b) SIDD test,
    (c) the PGE estimator's runfile; -> K1 launches per route."""
    import scipy.io as sio
    shape = EVAL_SHAPES["sidd"]
    n = shape[0]
    t = time.perf_counter()
    noisy, clean, kn = sidd_blocks(shape)
    val = os.path.join(tmp, "SIDD", "SIDD_Validation_Raw")
    os.makedirs(val)
    for key, arr in (("ValidationNoisyBlocksRaw", noisy),
                     ("ValidationGtBlocksRaw", clean),
                     ("BenchmarkNoisyBlocksRaw", noisy)):
        sio.savemat(os.path.join(val, f"{key}.mat"), {key: arr})
    ks, sigs = np.array(kn).T
    say("eval (a)", f"SIDD fixture {list(shape)} float32 "
        f"({noisy.nbytes / 1e6:.1f} MB a file, K {ks.min():.2f}-"
        f"{ks.max():.2f}, sigma {sigs.min():.2f}-{sigs.max():.2f} DN of "
        f"959) made and written in {time.perf_counter() - t:.2f} s")
    ssim_threads_check(noisy[:4], clean[:4])
    rec = {}
    # (a) the default runfile's eval mode, as a user types it: the CLI
    # sets its own precision
    with _Recorder() as r:
        app, wall, launches = run_cli(["-f", _repo(SIDD_RUNFILE)], log)
    if torch.backends.cudnn.allow_tf32 or \
            torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the yond CLI left TF32 on")
    h, h0, h1 = r.harnesses[0]
    times = [c[2] - c[1] for c in r.calls]
    loop = h1 - r.calls[0][1]
    tail = h1 - r.calls[-1][2]
    method = app.method_name
    m = _metrics(method)
    from yondx_torch.eval.sidd import crop_means
    p_noisy, s_noisy = crop_means(noisy.reshape((-1,) + shape[2:]),
                                  clean.reshape((-1,) + shape[2:]),
                                  app.engine.device)
    its = len(h.psnrs)
    say("eval (a)", f"yond -f {SIDD_RUNFILE}: {n} scenes of "
        f"{list(shape[1:])} in {wall:.2f} s of command (model and .mat "
        f"loads included); loop {loop:.2f} s: {n / loop:.2f} scenes/s "
        f"({(n - 1) / (h1 - r.calls[1][1]):.2f} past the first scene), "
        f"{1e3 * float(np.mean(times)):.2f} ms a scene's iter_denoise "
        f"(median {1e3 * float(np.median(times)):.2f}, first "
        f"{1e3 * times[0]:.2f}); scoring (on the engine's device) "
        f"{h.score_s:.2f} "
        f"thread-s on 4 threads = {100 * h.score_s / loop:.1f}% of the "
        f"loop, unhidden tail {tail:.2f} s ({100 * tail / loop:.1f}%); "
        f"noisy PSNR {p_noisy:.2f} dB SSIM {s_noisy:.4f}; " + ", ".join(
            f"{'Iter' + str(i) if i < its - 1 else 'last'} PSNR "
            f"{h.psnrs[i].avg:.2f} SSIM {h.ssims[i].avg:.4f}"
            for i in range(its)) + f"; K1 launches {launches}")
    if launches != 3 * n:
        raise AssertionError(f"SIDD eval: K1 launched {launches} times, "
                             f"expected {3 * n}")
    if sorted(m) != [f"{i:04d}" for i in range(n)] or \
            h.psnrs[-1].avg < EVAL_FLOORS["sidd"]:
        raise AssertionError("SIDD eval: metrics missing or PSNR under "
                             f"{EVAL_FLOORS['sidd']} dB")
    rec["sidd_eval"] = launches
    p = {"wp": 1023, "bl": 64, "ratio": 1.0, "scale": 959.0, "gain": 1.0,
         "sigma": 0.0, "cfa": [[1, 2], [2, 3]]}
    items = [{"name": f"{i:04d}", "lr": noisy[i], "cfa": [[1, 2], [2, 3]]}
             for i in range(2)]
    with _quiet(log):
        app.engine.iter_denoise(dict(items[0]), dict(p))
    profile_run("eval (a) profile", lambda: _quiet_call(
        log, app.engine.iter_denoise, dict(items[0]), dict(p)))
    # (g) the first 2 scenes on the CPU, in a directory of their own
    card = np.stack([np.load(os.path.join("npy", method, f"{i:03d}.npy"))
                     for i in range(2)])
    with _quiet(log):
        spread = _shift_spread(app.engine, items, p)
    cpu_dir = os.path.join(tmp, "cpu")
    os.makedirs(cpu_dir)
    for name in ("SIDD", "checkpoints"):
        os.symlink(os.path.join(tmp, name), os.path.join(cpu_dir, name))
    os.chdir(cpu_dir)
    try:
        _, cpu_s, _ = run_cli(["-f", _repo(SIDD_RUNFILE), "--device",
                               "cpu", "--limit", "2"], log)
        cpu = np.stack([np.load(os.path.join("npy", method, f"{i:03d}.npy"))
                        for i in range(2)])
        m_cpu = _metrics(method)
    finally:
        os.chdir(tmp)
    say("eval (g)", f"the first 2 SIDD scenes on the CPU in {cpu_s:.2f} s")
    _card_vs_cpu("eval (g) SIDD", card[:, -1], cpu[:, -1],
                 [m[f"{i:04d}"]["reg"] for i in range(2)],
                 [m_cpu[f"{i:04d}"]["reg"] for i in range(2)], spread,
                 clean[:2])
    for i in range(2):
        if abs(m[f"{i:04d}"]["psnr"][-1] - m_cpu[f"{i:04d}"]["psnr"][-1]) \
                > 0.01:
            raise AssertionError("eval (g): the pickles' PSNR differ")
    # (b) test mode: the benchmark blocks, the npy cache, no scores
    import shutil
    shutil.rmtree(os.path.join("npy", method))
    with _Recorder() as r:
        _, wall, launches = run_cli(["-f", _repo(SIDD_RUNFILE), "-m",
                                     "test"], log)
    loop = r.harnesses[0][2] - r.calls[0][1]
    steady = (n - 1) / (r.harnesses[0][2] - r.calls[1][1])
    cache = sorted(os.listdir(os.path.join("npy", method)))
    ok = cache == [f"{i:03d}.npy" for i in range(n)]
    for name in cache:
        a = np.load(os.path.join("npy", method, name), mmap_mode="r")
        ok = ok and a.shape == (2,) + shape[1:] and a.dtype == np.float32 \
            and bool(np.isfinite(a[-1]).all())
    say("eval (b)", f"yond -m test: {n} scenes in {wall:.2f} s of command, "
        f"loop {loop:.2f} s: {n / loop:.2f} scenes/s ({steady:.2f} past "
        f"the first scene); npy cache "
        f"{len(cache)} files of {[2] + list(shape[1:])}, complete {ok}; K1 "
        f"launches {launches}")
    if not ok or launches != 3 * n:
        raise AssertionError("SIDD test: npy cache incomplete or K1 count "
                             "wrong")
    rec["sidd_test"] = launches
    # (c) the PGE estimator's runfile on the first 8 scenes
    nc = min(8, n)
    with _Recorder() as r:
        app_c, wall, launches = run_cli(
            ["-f", _repo(PGE_RUNFILE), "--limit", str(nc)], log)
    hc = r.harnesses[0][0]
    mc = _metrics(app_c.method_name)
    last_a = [m[f"{i:04d}"]["psnr"][-1] for i in range(nc)]
    last_c = [mc[f"{i:04d}"]["psnr"][-1] for i in range(nc)]
    calls = app_c.est_models["est_net"].calls
    say("eval (c)", f"yond -f {PGE_RUNFILE} --limit {nc}: {wall:.2f} s of "
        f"command; last PSNR {hc.psnrs[-1].avg:.2f} dB against (a)'s "
        f"{float(np.mean(last_a)):.2f} on the same {nc} scenes (per scene "
        f"{[round(c - a, 2) for a, c in zip(last_a, last_c)]} dB); est net "
        f"calls {calls}; K1 launches {launches}")
    if launches != 2 * nc or calls != nc or \
            hc.psnrs[-1].avg < EVAL_FLOORS["sidd_pge"]:
        raise AssertionError("SIDD pge: K1 launches, est net calls or PSNR "
                             "wrong")
    rec["sidd_pge"] = launches
    return rec


def _write_frames(d, frames, dn_scale, bl):
    os.makedirs(d)
    for name, frame in frames.items():
        np.save(os.path.join(d, name),
                np.round(frame * dn_scale + bl).astype(np.uint16))


def fullframe_cases(tmp, log) -> dict:
    """(d) ELD's whole-frame route with the illuminance alignment, (e)
    LRID's tiled route; -> K1 launches per route."""
    rng = np.random.default_rng(17)
    rec = {}
    # (d) ELD: GT ids 1 and 16, noisy ids 4 and 9 at 0.8x their exposure
    H, W = EVAL_SHAPES["eld"]
    t = time.perf_counter()
    scale = 16383 - 512
    clean = _level_frame(H, W, rng)
    frames = {"IMG_0001.npy": clean, "IMG_0016.npy": clean}
    for i in (4, 9):
        frames[f"IMG_{i:04d}.npy"] = _pg(0.8 * clean, 150.0, 200.0, scale,
                                         rng)
    _write_frames(os.path.join(tmp, "ELD", "SonyA7S2", "scene-1"), frames,
                  scale, 512)
    with open(os.path.join(REPO, ELD_RUNFILE)) as f:
        text = f.read()
    eld = os.path.join(tmp, "ELD_simple+full_pre_grumix_5to50.yml")
    with open(eld, "w") as f:
        f.write(text.replace("Gaussian_GRU_mix_5to50_norm_noclip",
                             "Gaussian_GRU_mix_5to50_norm"))
    say("eval (d)", f"ELD fixture: 4 frames {H}x{W} uint16 (wp 16383, bl "
        f"512) in {time.perf_counter() - t:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    with _Recorder() as r:
        app, wall, launches = run_cli(["-f", eld, "--limit", "2"], log)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    m = _metrics(app.method_name)
    routes = [c[0] for c in r.calls]
    ms = [1e3 * (c[2] - c[1]) for c in r.calls]
    pv = [m[k]["psnr"] for k in sorted(m)]
    noisy_in = [float(psnr(np.clip(frames[f"IMG_{i:04d}.npy"] / 0.8, 0, 1),
                           clean)) for i in (4, 9)]
    say("eval (d)", f"yond -f <ELD runfile with the 5to50 net> --limit 2: "
        f"{wall:.2f} s of command; routes {routes}; ms a frame "
        f"{[round(x, 2) for x in ms]}; peak memory {peak:.2f} GiB; PSNR "
        f"after alignment {[round(x, 2) for x in pv]} dB (noisy scaled by "
        f"1/0.8: {[round(x, 2) for x in noisy_in]}); K1 launches {launches}")
    if routes != ["iter_denoise"] * 2 or launches != 6 or \
            min(pv) < EVAL_FLOORS["eld"]:
        raise AssertionError("ELD: route, K1 launches or PSNR wrong")
    rec["eld"] = launches
    # (e) LRID: one indoor scene, the noisy frame first, the GT last
    H, W = EVAL_SHAPES["lrid"]
    t = time.perf_counter()
    clean = _level_frame(H, W, rng)
    noisy = _pg(clean, 8.74, 12.81, 959.0, rng)
    _write_frames(os.path.join(tmp, "LRID", "indoor", "scene-001"),
                  {"000_noisy.npy": noisy, "001_gt.npy": clean}, 959.0, 64)
    say("eval (e)", f"LRID fixture: 2 frames {H}x{W} uint16 (wp 1023, bl "
        f"64) in {time.perf_counter() - t:.2f} s")
    with _Recorder() as r:
        app, wall, launches = run_cli(["-f", _repo(LRID_RUNFILE), "--limit",
                                       "1"], log)
    m = _metrics(app.method_name)
    routes = [c[0] for c in r.calls]
    ms = 1e3 * (r.calls[0][2] - r.calls[0][1])
    pv = m["scene-001"]["psnr"]
    say("eval (e)", f"yond -f {LRID_RUNFILE} --limit 1: {wall:.2f} s of "
        f"command; routes {routes}; {ms:.2f} ms a frame ({H * W / 1e6:.2f} "
        f"MP, {H * W / 1e3 / ms:.2f} MP/s); PSNR {psnr(noisy, clean):.2f} -> "
        f"{pv:.2f} dB; K1 launches {launches}")
    if routes != ["iter_denoise_tiled"] or launches != 3 or \
            pv < EVAL_FLOORS["lrid"]:
        raise AssertionError("LRID: route, K1 launches or PSNR wrong")
    rec["lrid"] = launches
    return rec


class _DNDFrame:
    """One DND-like frame in [0, 1] (wp 1, bl 0) with its boxes."""

    def __init__(self, noisy, boxes):
        self.noisy, self.boxes = noisy, boxes

    def __len__(self):
        return 1

    def __getitem__(self, i):
        return {"name": "0001", "lr": self.noisy, "wp": 1, "bl": 0,
                "ratio": 1.0, "cfa": [[1, 2], [2, 3]], "boxes": self.boxes}


def dnd_case(tmp, log) -> dict:
    """(f) denoise_dnd and bundle_submissions_raw on one frame of 20 boxes
    of 512 px, the bundle read back with scipy; (g) its first 2 boxes on
    the CPU; -> K1 launches."""
    import scipy.io as sio
    from yondx_torch.cli import yond
    from yondx_torch.eval.dnd import bundle_submissions_raw, denoise_dnd
    from yondx_torch.nle import moments
    H, W = EVAL_SHAPES["dnd"]
    b = EVAL_SHAPES["dnd_box"]
    noisy, clean = make_frame(H, W, seed=19)
    ys = np.linspace(64, H - b - 64, 4).astype(int)
    xs = np.linspace(64, W - b - 64, 5).astype(int)
    boxes = np.array([[y + 1, x + 1, y + b, x + b] for y in ys for x in xs],
                     np.float64)                  # 1-indexed [y0,x0,y1,x1]
    with _quiet(log):
        app = yond.YOND(["-f", _repo(DND_RUNFILE)])
    out_dir = os.path.join("submits", "test", app.method_name)
    moments.reset_launches()
    with _Recorder() as r, _quiet(log):
        t = time.perf_counter()
        bundled = denoise_dnd(app.engine, _DNDFrame(noisy, boxes), out_dir,
                              logfile=app.logfile)
        n = bundle_submissions_raw(bundled)
        wall = time.perf_counter() - t
    launches = moments.LAUNCHES["nle_moments"]
    cells = sio.loadmat(os.path.join(bundled, "0001.mat"))
    crops = [np.asarray(c) for c in cells["Idenoised"][0]]
    ok = n == 1 and cells["Idenoised"].shape == (1, 20) and \
        bool(cells["israw"].squeeze()) and \
        str(np.squeeze(cells["eval_version"])) == "1.0" and all(
            c.shape == (b, b) and c.dtype == np.float32 and
            np.isfinite(c).all() for c in crops)
    gt = [clean[y:y + b, x:x + b] for y in ys for x in xs]
    p_in = float(np.mean([psnr(noisy[y:y + b, x:x + b], g)
                          for (y, x), g in zip(
                              [(y, x) for y in ys for x in xs], gt)]))
    p_out = float(np.mean([psnr(c, g) for c, g in zip(crops, gt)]))
    ms = [1e3 * (c[2] - c[1]) for c in r.calls]
    say("eval (f)", f"denoise_dnd + bundle_submissions_raw on {H}x{W} "
        f"with 20 boxes of {b}: {wall:.2f} s, {float(np.mean(ms)):.2f} ms a "
        f"crop (median {float(np.median(ms)):.2f}); bundle read back {ok}; "
        f"PSNR {p_in:.2f} -> {p_out:.2f} dB; K1 launches {launches}")
    if not ok or launches != 60 or p_out < EVAL_FLOORS["dnd"]:
        raise AssertionError("DND: bundle, K1 launches or PSNR wrong")
    # (g) the first 2 boxes on the CPU
    p = {"wp": 1, "bl": 0, "ratio": 1.0, "scale": 1.0, "gain": 1.0,
         "sigma": 0.0}
    items = [{"lr": noisy[y:y + b, x:x + b]} for y, x in
             ((ys[0], xs[0]), (ys[0], xs[1]))]
    with _quiet(log):
        spread = _shift_spread(app.engine, items, p)
        cpu_app = yond.YOND(["-f", _repo(DND_RUNFILE), "--device", "cpu"])
    with _Recorder() as rc, _quiet(log):
        cpu_dir = denoise_dnd(cpu_app.engine, _DNDFrame(noisy, boxes[:2]),
                              os.path.join(tmp, "cpu_dnd"))
    cpu = np.stack([sio.loadmat(os.path.join(cpu_dir, f"0001_0{k}.mat"))[
        "Idenoised_crop"] for k in (1, 2)])
    _card_vs_cpu("eval (g) DND", np.stack(crops[:2]), cpu,
                 [c[3] for c in r.calls[:2]], [c[3] for c in rc.calls],
                 spread, np.stack(gt[:2]))
    return {"dnd": launches}


def eval_phase(out_dir=None) -> dict:
    """Phase 13: the runfiles' eval and test modes through the CLI in a
    temporary working directory that holds the fixtures (each reader's
    layout, numpy-seeded content) and a link to checkpoints/. TF32 starts
    at torch's defaults, as in the process a user starts: the CLI sets
    its own precision. The CLI's log goes to eval_cli.log (in `out_dir`
    when given). Returns K1's launches per route."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = {}
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(os.path.abspath(out_dir or tmp), "eval_cli.log")
        os.symlink(os.path.join(REPO, "checkpoints"),
                   os.path.join(tmp, "checkpoints"))
        os.chdir(tmp)
        try:
            for label, fn in (("(a)-(c), (g)", sidd_cases),
                              ("(d)-(e)", fullframe_cases),
                              ("(f)-(g)", dnd_case)):
                t = time.perf_counter()
                rec.update(fn(tmp, log))
                say("phase 13", f"{label} in {time.perf_counter() - t:.2f} s")
        finally:
            os.chdir(REPO)
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, metavar="DIR",
                    help="write each held-out column's JSON into DIR")
    out_dir = ap.parse_args(argv).out
    if out_dir:
        out_dir = os.path.abspath(out_dir)
    # 1. device ------------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs one CUDA card")
    os.chdir(REPO)           # the CLI reads runfiles/ and checkpoints/
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    # phases 3 and 4 compare fp32 results: no TF32 in convs or matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    say("device", f"{name} x{torch.cuda.device_count()}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}; TF32 off for "
        "phases 3-4, 6-7 and 9")

    # 2. build -------------------------------------------------------------
    from yondx_torch import cuda_build
    t = time.perf_counter()
    lib = cuda_build.build(force=True, verbose=True)
    cuda_build.load_library()
    say("build", f"nvcc built {lib.name} in {time.perf_counter() - t:.2f} s")
    from yondx_torch.core import libm
    t = time.perf_counter()
    libm.sinf(np.zeros(1, np.float32))
    say("build", "host C compiler built the libm helper of the held-out "
        f"scenes in {time.perf_counter() - t:.2f} s")

    # 3. K1 against its plain version on the card ----------------------------
    from yondx_torch.nle import moments
    from yondx_torch.pipeline.fused import _take_bands
    k, inner = 29, 19
    g = torch.Generator(device=dev).manual_seed(0)
    frame_a = torch.rand((1, 1536, 2048, 4), generator=g, device=dev) * 0.7
    x_a = _take_bands(frame_a, 6, 2, 3, 256)      # main-path band view
    cases = (("a [1,2,256,2048,4] bands", x_a),
             ("w [1,1536,2048,4] whole plane", frame_a),
             ("b [1,300,520,4]", torch.rand((1, 300, 520, 4), generator=g,
                                            device=dev)),
             ("c constant", torch.full((1, 64, 96, 4), 0.37, device=dev)),
             ("d [1,20,64,4]", torch.rand((1, 20, 64, 4), generator=g,
                                          device=dev)),
             ("e [1,15,40,4]", torch.rand((1, 15, 40, 4), generator=g,
                                          device=dev)),
             ("f [1,1,37,4]", torch.rand((1, 1, 37, 4), generator=g,
                                         device=dev)),
             # the held-out gate's crop stacks (4 crops of 512 px; the
             # 1024 px tier's one crop)
             ("h [4,256,256,4] crops", torch.rand((4, 256, 256, 4),
                                                  generator=g, device=dev)),
             ("i [1,512,512,4] crop", torch.rand((1, 512, 512, 4),
                                                 generator=g, device=dev)))
    # tolerances: fp32 sliding sums over runs of <= 32 outputs of data
    # shifted per tile (kernel) vs prefix sums of per-plane centered data
    # (plain), in [0,1]: mean 1e-5 (a few ulps of a 29x29 sum), var 1e-6
    # (differences of ~1e-1 second moments at fp32), tex 5e-5 (sqrt
    # amplifies the ~1e-9 variance error of the smooth t1 field where its
    # local variance is small)
    tol = {"mean": 1e-5, "var": 1e-6, "tex": 5e-5}
    max_err = 0.0
    for label, x in cases:
        line = []
        for flavour, (texture, mean, _) in K1_FLAVOURS.items():
            got = moments.nle_moments(x, k, inner, texture, mean)
            torch.cuda.synchronize()
            ref = moments.nle_moments_plain(x, k, inner, texture, mean)
            errs = {}
            for key, gv, rv in zip(("mean", "var", "tex"), got, ref):
                if (gv is None) != (rv is None):
                    raise AssertionError(f"K1 {label} {flavour}: {key} "
                                         "returned by one side only")
                if gv is None:
                    continue
                if gv.shape != x.shape or not bool(torch.isfinite(gv).all()):
                    raise AssertionError(f"K1 {label} {flavour}: {key} has "
                                         "another shape or is not finite")
                errs[key] = float((gv - rv).abs().max())
                if errs[key] > tol[key]:
                    raise AssertionError(
                        f"K1 {label} {flavour}: {key} err {errs[key]:.3e} > "
                        f"{tol[key]:.0e}")
            if label.startswith("c") and texture:
                tmax = float(got[2].abs().max())
                if tmax > 1e-6:
                    raise AssertionError(f"K1 constant plane: tex {tmax} != 0")
            max_err = max(max_err, *errs.values())
            line.append(f"{flavour} " + ", ".join(
                f"{kk} {v:.3e}" for kk, v in errs.items()))
        say("K1 vs plain", f"{label}: max abs err " + "; ".join(line))

    scratch = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def flush():
        scratch.zero_()

    # each flavour at the fused path's band shape and at the engine's
    # whole-plane shape, cold L2, against its own bound: one read of the
    # input and one write per map
    peak_key, (bw, fp32) = card_peaks(name)

    def time_flavours(x):
        n_out, timing = x.numel(), {}
        for flavour, (texture, mean, ops) in K1_FLAVOURS.items():
            ms = cuda_ms(lambda: moments.nle_moments(x, k, inner, texture,
                                                     mean), 20, flush)
            bytes_moved = 4 * n_out * (2 + texture + mean)
            t_bytes, t_ops = bytes_moved / bw * 1e3, n_out * ops / fp32 * 1e3
            timing[flavour] = (ms, max(t_bytes, t_ops),
                               "bytes" if t_bytes >= t_ops else "operations",
                               bytes_moved)
        return timing

    timing = time_flavours(x_a)
    timing_w = time_flavours(frame_a)
    timing_h = {label: time_flavours(x) for label, x in cases
                if label[0] in "hi"}
    ms_k1, bound_ms, bound_by, _ = timing["self"]
    ms_plain = cuda_ms(lambda: moments.nle_moments_plain(x_a, k, inner), 10,
                       flush)
    ms_plain_w = cuda_ms(lambda: moments.nle_moments_plain(frame_a, k,
                                                           inner), 5, flush)
    for label, tim, plain in (("a", timing, ms_plain),
                              ("w", timing_w, ms_plain_w),
                              *((lab, tim, None)
                                for lab, tim in timing_h.items())):
        say("K1 timing", label + ", cold L2, host enqueue included ("
            + peak_key + " peaks): " + "; ".join(
                f"{f} {ms:.4f} ms, bound {b:.4f} ms by {by} "
                f"({mb / 1e6:.1f} MB), {ms / b:.1f}x"
                for f, (ms, b, by, mb) in tim.items())
            + (f"; plain (self) {plain:.4f} ms" if plain else ""))
    del scratch, frame_a, x_a, cases

    # 4. card path against the port's CPU path, end to end ------------------
    from yondx_torch.isp.bayer import bayer2rggb, rggb2bayer
    from yondx_torch.io.ckpt import find_checkpoint
    from yondx_torch.models.unets import load_guided_s2d
    from yondx_torch.pipeline.fused import make_fused_blind_denoiser
    from yondx_torch.vst.lut import BiasLUT
    ck = find_checkpoint(os.path.join(REPO, "checkpoints", "Gaussian"),
                         "Gaussian_GRUS2DT_mix_1to50c_norm")
    if ck is None:
        raise FileNotFoundError("s2dt16 checkpoint missing")
    lut = BiasLUT().lut
    product = dict(guided=True, max_iter=1, refine=True,
                   sigma_corr="adaptive")
    small, _ = make_frame(256, 384, seed=3)
    rggb_s = bayer2rggb(torch.from_numpy(small))[None]
    outs, fns = {}, {}
    for d in ("cuda", "cpu"):
        net = load_guided_s2d(ck, device=d)
        fns[d] = make_fused_blind_denoiser(net, lut, device=d, **product)
        dn, regs = fns[d](rggb_s, 959.0)
        outs[d] = (dn.cpu().numpy(), regs.cpu().numpy())
    (dg, rg), (dc, rc) = outs["cuda"], outs["cpu"]
    # regs: rtol 1e-3, or where larger the spread that shifting the frame
    # by +-1e-6 makes on the card. beta2 is ill-conditioned at that level
    # (tests/test_torch_fused.py::test_beta2_moves_under_1e6_shift: such a
    # shift moves it by more than 1e-3 in the JAX package and the port),
    # and card and CPU differ by rounding of that order.
    spread = np.max([np.abs(fns["cuda"](rggb_s + d, 959.0)[1].cpu().numpy()
                            - rg) for d in (1e-6, -1e-6)], axis=0)
    allowed = np.maximum(1e-3 * np.abs(rc), spread)
    err_r = np.abs(rg - rc)
    err_o = float(np.abs(dg - dc).max())
    say("cuda vs cpu", f"regs cuda {rg.tolist()} cpu {rc.tolist()}; "
        f"|diff| {err_r.tolist()}, allowed {allowed.tolist()} (+-1e-6 "
        f"shift spread on the card {spread.tolist()}); output max abs diff "
        f"{err_o:.3e}")
    if not (err_r <= allowed).all():
        raise AssertionError("regs disagree between cuda and cpu")
    if err_o > 1e-3:
        raise AssertionError(f"output differs by {err_o} > 1e-3")

    # 5. the main path -------------------------------------------------------
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.benchmark = True
    net = load_guided_s2d(ck, device="cuda", dtype=torch.bfloat16)
    fused = make_fused_blind_denoiser(net, lut, compute_dtype=torch.bfloat16,
                                      device="cuda", **product)
    noisy, clean = make_frame()
    H, W = noisy.shape
    rggb = bayer2rggb(torch.from_numpy(noisy).to(dev))[None]
    scale = 959.0
    t = time.perf_counter()
    dn, regs = fused(rggb, scale)
    torch.cuda.synchronize()
    say("main path", f"warm-up {time.perf_counter() - t:.2f} s")
    moments.reset_launches()
    fused.stats["second_passes"] = 0
    times = []
    runs = 5
    for _ in range(runs):
        t = time.perf_counter()
        dn, regs = fused(rggb, scale)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    launches = moments.LAUNCHES["nle_moments"]
    second = fused.stats["second_passes"]
    dt = float(np.median(times))
    out = rggb2bayer(dn[0]).float().cpu().numpy()
    regs = regs.cpu().numpy()
    p_in, p_out = psnr(noisy, clean), psnr(out, clean)
    k_est = float(regs[0, 0] * 959)
    say("main path", f"{H}x{W}: {dt * 1e3:.2f} ms/frame, "
        f"{H * W / 1e6 / dt:.2f} MP/s (median of {runs}; runs "
        f"{[round(x * 1e3, 2) for x in times]} ms); PSNR {p_in:.2f} -> "
        f"{p_out:.2f} dB; K_est {k_est:.3f}; second pass fired {second}/"
        f"{runs}; K1 launches {launches}")
    if not np.isfinite(out).all():
        raise AssertionError("main path output is not finite")
    if p_out < p_in + 10.0:
        raise AssertionError(f"PSNR gain {p_out - p_in:.2f} dB < 10 dB")
    if abs(k_est - 8.74) > 0.1 * 8.74:
        raise AssertionError(f"K_est {k_est:.3f} not within 10% of 8.74")
    # one self-fit launch + two collab-fit launches (lr, dn) per frame
    if launches != 3 * runs:
        raise AssertionError(f"K1 launched {launches} times in {runs} "
                             f"frames, expected {3 * runs}")

    # where the time goes: one more main-path run under the profiler
    profile_run("profile", lambda: fused(rggb, scale))
    del fused, net, dn, rggb

    # 6. the ANY-camera CLI path (gru32 fp32, whole-frame NLE, tiled) ----
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cli = cli_path(noisy, clean)

    # 7. its engine on the card against the CPU ----------------------------
    engine_card_vs_cpu()

    # 8. the port's bench with the gru32 flagship ---------------------------
    bench_gru32()

    # 9. the frozen held-out quality gate (eval_synth --heldout) ------------
    heldout_launches, scenes, pge_mean = heldout_gate(out_dir)

    # 10. training (trainer_awgn's AWGNTrainer) ------------------------------
    train_phase(fp32, peak_key)

    # 11. noise-estimation training (train_est's PGEstTrainer) -------------
    k19 = est_train_phase(bw, fp32, scenes, pge_mean, out_dir)

    # 12. the 'unetn' denoiser, the est_* block, the host BM3D ---------------
    phase12 = unetn_phase(noisy, clean, scenes, fp32, peak_key, out_dir)

    # 13. the runfiles' eval and test modes (SIDD, ELD, LRID, DND) ---------
    phase13 = eval_phase(out_dir)

    record = {"kernels": [{
        "name": "nle_moments", "route": "cuda",
        "source": "yondx_torch/csrc/nle_moments.cu",
        "replaces": "yondx/nle/pallas_ops.py:54",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms_k1, "plain_ms": ms_plain, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        # the engine's shape: whole planes, 3 launches a frame on the CLI
        # path (self 1, collab 2)
        "whole_plane": {
            "shape": [1, 1536, 2048, 4], "launches": cli["launches"],
            "ms": {f: t[0] for f, t in timing_w.items()},
            "bound_ms": {f: t[1] for f, t in timing_w.items()},
            "bound_by": {f: t[2] for f, t in timing_w.items()},
            "plain_ms": ms_plain_w},
        # the held-out gate's crop stacks: 3 launches a scene (2 with
        # the PGE estimator), counted per column around its run
        "heldout": {
            "launches": heldout_launches,
            "shapes": {lab.split()[1]: {
                "ms": {f: t[0] for f, t in tim.items()},
                "bound_ms": {f: t[1] for f, t in tim.items()},
                "bound_by": {f: t[2] for f, t in tim.items()}}
                for lab, tim in timing_h.items()}},
        # the est trainer's map flavour: k = 19, mean and var, one launch
        # a step on the stacked [lr; hr]
        "training_k19": k19,
        # phase 12's paths: the 'unetn' CLI run (3 a frame), iter_denoise
        # with the est net (collab only, 2 a scene), --input with the pge
        # runfile (3), the BM3D photo column (3 a scene), the Unet
        # trainer (0)
        "phase12": phase12,
        # phase 13's routes: SIDD eval and test (3 a scene), the PGE
        # runfile (2 a scene), ELD whole frames and the LRID tiled frame
        # (3 a frame), DND (3 a box)
        "phase13": phase13}]}
    print(json.dumps(record), flush=True)
    return {"ok": True, "device": {"platform": "gpu", "kind": name,
                                   "count": torch.cuda.device_count()}}


if __name__ == "__main__":
    result = main()
    print(json.dumps(result), flush=True)
    sys.exit(0)
