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
two reduced scenes; then (f) s2dt16 and gru32 in fp32 with TF32 on in
cuDNN and matmul, and gru32 in bf16, printed beside columns (a)-(c)
with 0 below input held (TF32 off again after). Phase 10 trains the
gru32 SNR-Net (trainer_awgn's
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
columns `eval_synth --heldout --denoiser bm3d` on the photo scenes and
on suites v1 and v2 (under the flags their artifacts' headers record),
each held to its CPU artifact docs/heldout/r5_bm3d_{photo,v1,v2}_cpu.json
(rows within 0.05 dB, the mean within 0.02 dB). Phase 13 runs the
runfiles' eval
and test modes through the CLI (`yondx_torch.cli.yond -f <runfile>
[-m test] [--limit N]`) in a temporary working directory that holds
numpy-seeded fixtures in each reader's layout at the real datasets'
shapes: (a) the default SIDD runfile's eval on [20, 32, 256, 256]
validation blocks, profiled once, (b) its test mode (the npy cache), (c)
the PGE estimator's runfile on 8 scenes, (d) the ELD runfile with the
committed 5to50 net on two 4256x2848 SonyA7S2 frames (whole-frame route,
illuminance alignment), (e) the LRID runfile on a 3472x4624 frame (tiled
route), (f) the DND submission bundle of 20 boxes of 512 px, written and
read back, and (g) the first 2 scenes of (a) and boxes of (f) on the CPU
against the card. Phase 14 drives every option of the fused entry on the
3072x4096 frame: scripts/bench_matrix.py's matrix through its port,
yondx_torch.cli.bench_matrix (the committed gru32
Gaussian_GRU_mix_5to50_norm in fp32 and bf16; sort and hist thresholds
with the conv margins, hist with the pallas margins; then its
orchestrated fp32 engine; any failure raises) and the product
configuration under each other iteration policy, without the bias
correction, with two collab rounds and at k = 19 and 41, each held to
phase 5's floors and a crop of each card vs CPU; then K1 against its
plain version at k = 19 and 41. Phase 15 rebuilds the sg-extension
table and three 16-column blocks of the 2-D bias table on the host,
bit-equal to the committed ones, and holds the host bias curve to the
device curve. Phase 16 runs each net of the comparison zoo card vs CPU
and VSTDenoiser(fbi=True) with FBI_Net nf 64 x 8 layers (random
weights) in tiles of 1024 over the frame. Phase 17 runs yondx_torch.parallel
on NCCL at world 1: `yond --input --mesh 1` on a 6144x8192 frame (50.3
MP, one shard, no tiling) held to the tiled single-card route (regs
within 1%, PSNR within 0.05 dB), a crop of the route on the card rank
against a CPU (gloo) rank, K1 against its plain version at the shard's
halo-extended shape, and the gru32 trainer under DDP against the plain
trainer for three steps; with two cards or more, the route and the
trainer at world 2. Phase 18 runs the ISP and the figure tools on the
card: a product-path frame inside core.profiling.trace (the JSON names
K1 3 times and cuDNN's convolutions), the demosaic and process_sidd_image
on the 3072x4096 frame card vs CPU, SIDDEvalHarness with and without
save_plot on 4 of phase 13's scenes (scenes/s, the PNGs read back,
psnr_rgb card vs CPU), the trainer's sample dump against the CPU render
of its sample, and guided_filter and row_denoise card vs CPU. Phase 19
reads and writes checkpoints and files with the port's own readers: (a)
the committed JAX-written orbax checkpoint (tests/data/torch_port/,
scripts/torch_port_fixtures.py) through the port's zstd decoder and
orbax reader, bit-equal to its .npz; (b) the s2dt16 params and one
trainer step's Adam state saved with the port's orbax writer and loaded
back bit-equal, the product frame through a net built from the loaded
params bit-equal to the msgpack net's; (c) the committed DND fixture
(MATLAB v7.3) through the port's HDF5 reader, DNDDataset and
denoise_dnd on the card. Phase 20 holds what the product ships to the
evidence that set it: (a) the v2 held-out columns of s2dt16 and gru32 in
fp32 (`eval_synth --heldout --suite v2` over phase 9's scenes), held by
phase 9's rules to docs/heldout/r5_{s2dt,flagship}_oriented_v2_tpu.json
and row for row to phase 9's v3 rows within 1e-4 dB; (b) the same with
`--sigma-corr adaptive`, held to r5_{s2dt,flagship}_adaptive_corr_v2_tpu
.json; (c) the rescue policy's full sweep (`yondx_torch.cli.sweep_policy`:
suite v2 with the second pass forced, the five fault rungs, the gru32
flagship): the shipped defaults (tol 0.15, floor_frac 1.5) must lie in
the card's acceptable region, the fault rows' needs_rescue must be
docs/policy_sweep_r5.json's and their ffrac within 1% of it, K1 3 a scene
and a rung, and a one-crop scene and rung 0.5 card vs CPU by phase 9e's
rule; (d) the sigma-corr probe (`yondx_torch.cli.probe_sigma_corr_blind`,
33 scenes x 8 corrs): the scene list as docs/sigma_corr_blind_r5.json's,
the clip fractions within 1e-6 of the host's on the same scenes (the
artifact's scenes were built in the TPU's arithmetic), the blind signals,
best and adaptive corrs printed beside the artifact's, a one-crop scene
card vs CPU; (e) the checkpoint
recipe tools (port_s2d_init, port_s2d_tail, fork_checkpoint,
ship_weights, port_reference_checkpoint, compare_ckpts) in a temporary
directory: every copy bit-equal to its source, the tail's net
bit-identical to its source on the card, both compare_ckpts means 5 dB
over noisy. Phase 21 runs the probes behind the rescue gate, the
iteration policy and the refine (yondx_torch.cli.probe_*) at their
defaults on phase 9's scenes: (a) probe_floor_discriminator, its fault
ladder held to phase 20 (c)'s rungs within 1e-3 relative, FIRE exactly
where needs_rescue is, every suite scene held, ramp_big within 1% of
1.3276; (b) probe_iter_policy; (c) probe_underest_scene; (d)
probe_underest_e2e; (e) probe_sigma_corr; (f) probe_alpha_boost; (g)
probe_droop; (h) probe_s2d_phase. Each prints its summary beside the
docs/STATUS.md line it was written from (the TPU's history, not a
target), holds K1's launches around it to what its code implies, and
holds its rows on one scene card against CPU by phase 9e's rule. Phase
22 runs the one-off benches and trainers (yondx_torch.cli.*): (a)
`train_gru 1` and `train_unet 1` under a temporary --out (one epoch of
32 steps of batch 64 over the 2048-crop synthetic set, then the eval at
sigma 10 / 25 / 50 on 64 crops; epoch 1, finite losses); (b)
`train_chunked runfiles/Gaussian/GRU_5to50_norm_mix.yml 10 10` twice
under a temporary --out (epochs 1-10 and DONE, then a resume at epoch 10
and DONE without a step; rc 0, the `last` checkpoint at epoch 10 and
unchanged); (c) bench_loader at its defaults with phase 10b's gru32 step
(the gate: wait under 5%), its corpus written from (a)'s cached set; (d)
bench_robust_overhead, the MAD regs card vs CPU at rtol 1e-3 and the two
histogram layouts equal; (e) chroma_probe on the committed 1to50c and
5to50 gru32 bests, card vs CPU within 1e-4; (f) unet_roofline in bf16
and f32, its inventory held to a CPU run's, the net's sum at 64 x 64
card vs CPU within rtol 1e-4. K1 launches 0 around each part, no file
under the repo's checkpoints/, saved_model/, images/, logs/ or runs/
changes, and the checkpoints keep their sha256. Every
profile (`profile_run`) prints K1's
events in it beside K1's launch counter over the same run, and retakes
the profile in a process of its own where they differ. Every phase
prints one line with its elapsed seconds; any failure raises (exit code
!= 0). The last two lines are the kernels' JSON record and the device
JSON record.
With --out, each held-out column's eval_synth JSON is written into DIR.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
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


def k1_err64(x, k, inner, flavours=K1_FLAVOURS) -> dict:
    """K1's max abs error against its plain version in float64 (prefix
    sums in float64), per flavour and map; tex as its square, the
    pre-blurred plane's variance."""
    from yondx_torch.nle import moments
    out = {}
    for flavour in flavours:
        texture, mean, _ = K1_FLAVOURS[flavour]
        got = moments.nle_moments(x, k, inner, texture, mean)
        ref = moments.nle_moments_plain(x.double(), k, inner, texture, mean)
        errs = {}
        for key, gv, rv in zip(("mean", "var", "tex2"), got, ref):
            if gv is not None:
                gv = gv.double()
                if key == "tex2":
                    gv, rv = gv ** 2, rv ** 2
                errs[key] = float((gv - rv).abs().max())
        out[flavour] = errs
        del got, ref
    return out


def fmt_err64(e: dict) -> str:
    return "; ".join(f"{f} " + ", ".join(f"{m} {v:.2e}" for m, v in d.items())
                     for f, d in e.items())


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


def _k1_profile(run) -> dict:
    """One run() under torch.profiler after the warm-up kernels: the host
    wall time, each kernel's device time and count, K1's events in the
    profile and K1's launch counter over the same run()."""
    from torch.profiler import ProfilerActivity, profile
    from yondx_torch.core.profiling import WARMUP_KERNELS
    from yondx_torch.nle import moments
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # tiny kernels first, as core.profiling.trace launches them: a
        # session after earlier ones missed its first two kernels
        w = torch.zeros(1, device="cuda")
        for _ in range(WARMUP_KERNELS):
            w.add_(1)
        torch.cuda.synchronize()
        before = moments.LAUNCHES["nle_moments"]
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
        launches = moments.LAUNCHES["nle_moments"] - before
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        kernels.append((us / 1e3, evt.count, evt.key))
    return {"wall_ms": wall_ms, "kernels": kernels,
            "k1_events": sum(n for _, n, key in kernels
                             if "nle_moments" in key),
            "k1_launches": launches}


def _profile_line(rec: dict) -> str:
    kernels, wall_ms = rec["kernels"], rec["wall_ms"]
    busy = sum(k[0] for k in kernels)
    groups = {}
    for ms, _, key in kernels:
        low = key.lower()
        group = next((g for g, words in _GROUPS
                      if any(w in low for w in words)), "other")
        groups[group] = groups.get(group, 0.0) + ms
    top = sorted(kernels, reverse=True)[:8]
    return (f"wall {wall_ms:.2f} ms (profiled), device busy {busy:.2f} ms "
            f"({100 * busy / wall_ms:.1f}%), {len(kernels)} kernel names; "
            f"K1 events {rec['k1_events']}, K1 launches "
            f"{rec['k1_launches']}; by group ms: " + ", ".join(
                f"{g} {v:.2f}" for g, v in sorted(groups.items(),
                                                  key=lambda kv: -kv[1]))
            + "; top: " + "; ".join(f"{key[:60]} x{n} {ms:.2f}"
                                    for ms, n, key in top))


def profile_run(label: str, run, child=None) -> dict:
    """One run() under torch.profiler: device busy time against the host
    wall time, device time by kernel group and top kernels (busy holds
    the 9 tiny warm-up kernels, a few microseconds), and K1's events in
    the profile beside K1's launch counter over the same run(). Where the
    two differ (the profiler lost events in this long-lived process), the
    profile is taken again in a process of its own: `child` is (name of a
    module-level builder, its keyword arguments), the builder returning
    the same run() there. That profile is printed too, and the phase
    fails if its counts differ as well (or there is no child)."""
    rec = _k1_profile(run)
    say(label, _profile_line(rec))
    if rec["k1_events"] == rec["k1_launches"]:
        return rec
    if child is None:
        raise AssertionError(f"{label}: the profile holds {rec['k1_events']}"
                             f" K1 events for {rec['k1_launches']} launches "
                             "and has no child process to retake it")
    builder, kwargs = child
    t = time.perf_counter()
    mod = os.path.splitext(os.path.basename(__file__))[0]
    code = (f"import json, {mod} as c; print(json.dumps("
            f"c.profile_child({builder!r}, {json.dumps(kwargs)!r})))")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise AssertionError(f"{label}: the child profile failed:\n"
                             f"{res.stdout[-3000:]}{res.stderr[-3000:]}")
    crec = json.loads(res.stdout.strip().splitlines()[-1])
    say(label, f"K1 events {rec['k1_events']} for {rec['k1_launches']} "
        f"launches in this process; retaken in a process of its own "
        f"({time.perf_counter() - t:.2f} s with its start and warm-up): "
        + _profile_line(crec))
    if crec["k1_events"] != crec["k1_launches"]:
        raise AssertionError(f"{label}: the child's profile holds "
                             f"{crec['k1_events']} K1 events for "
                             f"{crec['k1_launches']} launches too")
    rec["child"] = crec
    return rec


def profile_child(builder: str, kwargs_json: str) -> dict:
    """The body of profile_run's child process: K1 loaded, the run built
    by the named builder, run once to warm up, then profiled."""
    from yondx_torch import cuda_build
    cuda_build.load_library()
    run = globals()[builder](**json.loads(kwargs_json))
    run()
    torch.cuda.synchronize()
    return _k1_profile(run)


def _product_fused(frame_path: str):
    """(the product path's fused denoiser, the frame's RGGB on the card)."""
    from yondx_torch.io.ckpt import find_checkpoint
    from yondx_torch.isp.bayer import bayer2rggb
    from yondx_torch.models.unets import load_guided_s2d
    from yondx_torch.pipeline.fused import make_fused_blind_denoiser
    from yondx_torch.vst.lut import BiasLUT
    net = load_guided_s2d(find_checkpoint(CKPTS,
                                          "Gaussian_GRUS2DT_mix_1to50c_norm"),
                          device="cuda", dtype=torch.bfloat16)
    fused = make_fused_blind_denoiser(net, BiasLUT().lut,
                                      compute_dtype=torch.bfloat16,
                                      device="cuda", **PRODUCT)
    rggb = bayer2rggb(torch.from_numpy(np.load(frame_path)).cuda())[None]
    return fused, rggb


def child_product(frame: str):
    """profile_run's child builder for the product path (phase 5)."""
    fused, rggb = _product_fused(frame)
    return lambda: fused(rggb, 959.0)


def child_engine(frame: str, runfile: str, route: str, scene=None):
    """profile_run's child builder for a runfile's engine as yond builds
    it (TF32 off): route "tiled" (phase 6's and 12b's frame, tiles 1024 +
    64), "scene" (phase 13a's SIDD scene) or "mesh" (phase 17a's frame at
    world 1, cuDNN's benchmark mode off as there)."""
    from yondx_torch.cli import yond
    app = yond.YOND(["-f", runfile])
    engine = app.engine
    noisy = np.load(frame)
    if route == "tiled":
        return lambda: engine.iter_denoise_tiled(
            {"lr": noisy}, any_params(), tile=1024, halo=64)
    if route == "scene":
        item = {"name": "0000", "lr": noisy, "cfa": [[1, 2], [2, 3]]}
        return lambda: engine.iter_denoise(dict(item), dict(scene))
    from yondx_torch.parallel import iter_denoise_frame_sharded
    from yondx_torch.parallel.mesh import make_mesh
    torch.backends.cudnn.benchmark = False
    mesh = make_mesh(1)
    return lambda: iter_denoise_frame_sharded(mesh, engine, noisy,
                                              any_params())


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
    with _frame_file(noisy) as path:
        profile_run(f"{label} profile", frame,
                    ("child_engine", {"frame": path,
                                      "runfile": os.path.abspath(runfile),
                                      "route": "tiled"}))
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


# each held-out column's seconds on the card, by label
COLUMN_SECONDS = {}


def heldout_column(label, flags, scenes, out_dir, suite="v3",
                   k1_per_scene=3):
    """One eval_synth --heldout run on the card over the shared scenes
    (its JSON into out_dir when given): -> (rows, K1 launches, the
    engine); its seconds into COLUMN_SECONDS. K1 runs once for the self
    fit (not with the PGE estimator) and twice for the collab fit of each
    scene."""
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
    wall = COLUMN_SECONDS[label] = time.perf_counter() - t
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


# phase 9 (f): label, eval_synth flags, TF32 on, the fp32 column beside
PRECISION_COLUMNS = (("s2dt16_tf32", S2DT16_FLAGS, True, "s2dt16"),
                     ("gru32_tf32", GRU32_FLAGS, True, "gru32"),
                     ("gru32_bf16", GRU32_FLAGS + ["--bf16"], False, "gru32"))


def extra_precision_columns(scenes, out_dir, cols, launches) -> dict:
    """Phase 9 (f): the PRECISION_COLUMNS on the v3 scenes; each column's
    mean, below-input count, glyph margin, difference to its fp32 column
    and scenes/s printed beside it. TF32 is off again after each."""
    out = {}
    for label, flags, tf32, base in PRECISION_COLUMNS:
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        rows, launches[label], _ = heldout_column(label, flags, scenes,
                                                  out_dir)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        sm, fp = rows["_summary"], cols[base]["_summary"]
        n = len(rows) - 1
        say("heldout precision (f)", f"{label} (TF32 "
            f"{'on' if tf32 else 'off'}): mean {sm['mean_psnr']:.4f} dB, "
            f"{base} fp32 "
            f"{fp['mean_psnr']:.4f} ({sm['mean_psnr'] - fp['mean_psnr']:+.4f}"
            f" dB); below input {sm['n_below_input']}; glyph margin "
            f"{sm['glyphs_min_margin']:+.4f} (fp32 "
            f"{fp['glyphs_min_margin']:+.4f}); {n / COLUMN_SECONDS[label]:.3f}"
            f" scenes/s (fp32 {n / COLUMN_SECONDS[base]:.3f}); largest row "
            f"difference to fp32 {_max_row_gap(rows, cols[base]):.4f} dB")
        if sm["n_below_input"] != 0:
            raise AssertionError(f"heldout {label}: {sm['n_below_input']} "
                                 "scenes below input")
        out[label] = rows
    return out


def heldout_gate(out_dir=None):
    """Phase 9: the frozen held-out gate on the card (see the module
    docstring); returns K1's launches per column, the scenes, column
    (d)'s mean PSNR and the rows of columns (a) and (b)."""
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
    # (f) s2dt16 and gru32 in fp32 with TF32 on in cuDNN and matmul, and
    # gru32 with --bf16 (TF32 off), printed beside (a)-(c): not held to an
    # artifact; 0 below input and K1 3 a scene hold
    cols.update(extra_precision_columns(scenes, out_dir, cols, launches))
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
    return launches, scenes, rows_pge["_summary"]["mean_psnr"], cols


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
    from yondx_torch.config import load_runfile, redirect_outputs
    args = redirect_outputs(load_runfile(os.path.join(REPO, runfile),
                                         mode="train"), tmp)
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
                     label="train (b)") -> float:
    """(b) GRU_5to50_norm_mix.yml as written (gru32 nf=32, batch 64,
    patch 256, WarmupCosine at 2e-4) from a fresh init equal to JAX's,
    one epoch of 12 steps over a 768-crop synthetic set built once
    through the disk cache, "torch" fields, TF32 off; save_freq 1 so
    that epoch 1 writes its `last` checkpoint. Another AWGN `runfile` of
    the same layout runs the same way. -> the median seconds a step."""
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
    return step_s


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


def train_phase(fp32_peak, peak_key) -> float:
    """Phase 10: training on the card, (a)-(d), in a temporary directory
    that also holds ./logs/; TF32 off throughout. -> (b)'s median seconds
    a gru32 step."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            train_step_card_vs_cpu(os.path.join(tmp, "a"))
            step_s = train_full_width(os.path.join(tmp, "b"), fp32_peak,
                                      peak_key)
            train_quality_anchor(os.path.join(tmp, "c"))
            train_distill_resume(os.path.join(tmp, "d"))
        finally:
            os.chdir(REPO)
    return step_s


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


def hold_step(phase, label, out, lr, loss_rtol, max_frac,
              keys=("cuda", "cpu")) -> None:
    """Card against CPU (or out[keys[0]] against out[keys[1]]) after one
    Adam step from the same weights and inputs, out = {device: {loss, p,
    g, mu, nu}}: loss within loss_rtol;
    gradients and both moments within max_frac of each tensor's max;
    weights within the move Adam's first step lr g / (|g| + eps) can
    make for the tensor's gradient error e, lr eps e / (|g| - e + eps)^2
    while |g| > 2e (doubled here) and 2 lr where |g| <= 2e, plus 3e-7
    for rounding; at most 1% of the entries apart by more than 3e-7."""
    g, c = out[keys[0]], out[keys[1]]
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
        e64 = k1_err64(x, 19, 19, ("collab_dn",))["collab_dn"]
        say("est (b) K1 k=19", f"[{B},128,128,4] mean, var: max abs err "
            f"mean {errs['mean']:.3e}, var {errs['var']:.3e} (against "
            f"float64: mean {e64['mean']:.2e}, var {e64['var']:.2e}); "
            f"{ms:.4f} ms, "
            f"bound {bound:.4f} ms by "
            f"{'bytes' if t_bytes >= t_ops else 'operations'} "
            f"({3 * 4 * n / 1e6:.1f} MB), {ms / bound:.1f}x; plain "
            f"{plain:.4f} ms")
        rec[f"{B}x128x128x4"] = {"ms": ms, "plain_ms": plain,
                                 "bound_ms": bound, "max_abs_err": errs,
                                 "err64": e64,
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
# the host BM3D columns of phase 12 (e): label, eval_synth suite and flags,
# and the CPU artifact each is held to. The flags are those the artifact's
# header records that eval_synth takes without --refine: v1's header also
# records shrink_full_alpha 0.6, which both packages' eval_synth refuse
# without --refine (scripts/eval_synth.py:152-155); with no refine,
# neither it nor the shrink mode reaches the BM3D denoiser
BM3D_COLUMNS = (
    ("bm3d_photo", "v3", ["--scene-filter", "photo"],
     "docs/heldout/r5_bm3d_photo_cpu.json"),
    ("bm3d_v1", "v1", ["--shrink-mode", "iso"],
     "docs/heldout/r5_bm3d_v1_cpu.json"),
    ("bm3d_v2", "v2", [], "docs/heldout/r5_bm3d_v2_cpu.json"))


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


def bm3d_column(scenes, out_dir, label, suite, flags, art_path) -> int:
    """(e) one host BM3D column, `eval_synth --heldout --suite <suite>
    --denoiser bm3d <flags>` over phase 9's scenes (BM3D on the host, the
    rest on the card), held to its CPU artifact: each scene within 0.05
    dB, the mean within 0.02 dB, do_no_harm as recorded. Returns K1's
    launches (3 a scene)."""
    with open(os.path.join(REPO, art_path)) as f:
        art = json.load(f)["rows"]
    t = time.perf_counter()
    rows, launches, eng = heldout_column(
        label, ["--denoiser", "bm3d", *flags], scenes, out_dir, suite=suite)
    wall = time.perf_counter() - t
    names = [k for k in rows if k != "_summary"]
    host = eng.denoiser.host_s
    worst = max(abs(rows[k]["psnr"][-1] - art[k]["psnr"][-1]) for k in names)
    mean, amean = rows["_summary"]["mean_psnr"], art["_summary"]["mean_psnr"]
    say("bm3d (e)", f"{label}: {len(names)} scenes in {wall:.2f} s: "
        f"{wall / len(names):.2f} s a scene, of which host BM3D "
        f"{host / len(names):.2f} s and the rest (the card's NLE, VST and "
        f"copies) {(wall - host) / len(names):.2f} s; mean {mean:.4f} "
        f"(artifact {amean:.4f}, {mean - amean:+.4f} dB); largest row "
        f"difference {worst:.4f} dB; rows " + ", ".join(
            f"{k} {rows[k]['psnr'][-1]:.4f} ({art[k]['psnr'][-1]:.4f})"
            for k in names))
    if sorted(names) != sorted(k for k in art if k != "_summary"):
        raise AssertionError(f"{label}: scenes {names}")
    for k in names:
        if abs(rows[k]["psnr"][-1] - art[k]["psnr"][-1]) > 0.05 or \
                rows[k]["do_no_harm"] != art[k]["do_no_harm"]:
            raise AssertionError(f"{label}: {k} apart from the artifact")
    if abs(mean - amean) > 0.02:
        raise AssertionError(f"{label}: mean not within 0.02 dB")
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
    for label, suite, flags, art in BM3D_COLUMNS:
        t = time.perf_counter()
        rec["bm3d_heldout" if label == "bm3d_photo" else label] = \
            bm3d_column(scenes, out_dir, label, suite, flags, art)
        say("phase 12", f"(e) {label} in {time.perf_counter() - t:.2f} s")
    return rec


# 13. the runfiles' eval and test modes -----------------------------------
SIDD_RUNFILE = "runfiles/YOND/SIDD_simple+full_pre_grumix.yml"
ELD_RUNFILE = "runfiles/YOND/ELD_simple+full_pre_grumix.yml"
LRID_RUNFILE = "runfiles/YOND/LRID_simple+full_pre_grumix.yml"
DND_RUNFILE = "runfiles/YOND/DND_simple+full_pre_grumix.yml"
# phase 13's fixtures at the real datasets' shapes: SIDD's validation
# blocks [scenes, crops, 256, 256] (20 of its 40 scenes: the depth cut
# that keeps the run near 800 s with phases 20-21), ELD's SonyA7S2 frames
# (12.1 MP, the whole-frame route), LRID's IMX686 frames (16.05 MP, just
# over the harness's 16 MP tiling threshold), one DND frame with its 20
# boxes
EVAL_SHAPES = {"sidd": (20, 32, 256, 256), "eld": (2848, 4256),
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
def _frame_file(arr):
    """`arr` saved as .npy in a temporary directory, for a child process."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "frame.npy")
        np.save(path, arr)
        yield path


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
    with _frame_file(noisy[0]) as path:
        profile_run("eval (a) profile", lambda: _quiet_call(
            log, app.engine.iter_denoise, dict(items[0]), dict(p)),
            ("child_engine", {"frame": path, "runfile": _repo(SIDD_RUNFILE),
                              "route": "scene", "scene": p}))
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


# 14. every option of the fused entry -------------------------------------
S2DT16_CKPT = os.path.join(CKPTS,
                           "Gaussian_GRUS2DT_mix_1to50c_norm_best_model.ckpt")
GRU5_CKPT = os.path.join(CKPTS, "Gaussian_GRU_mix_5to50_norm_best_model.ckpt")
# the product configuration of phase 5 with one option changed each
PRODUCT = {"guided": True, "max_iter": 1, "refine": True,
           "sigma_corr": "adaptive"}
OPTIONS = (("iter_policy=replace", {"iter_policy": "replace"}),
           ("iter_policy=avg", {"iter_policy": "avg"}),
           ("iter_policy=guard", {"iter_policy": "guard"}),
           ("iter_policy=avg_guard", {"iter_policy": "avg_guard"}),
           ("bias_corr=None", {"bias_corr": None}),
           ("max_iter=2", {"max_iter": 2}),
           ("k=19", {"k": 19}),
           ("k=41", {"k": 41}))
PHASE14_REPS = 5        # timed frames of each configuration


def _run_frames(fn, rggb, reps):
    """One warm-up, then `reps` timed frames (host clock around each
    synchronised call): (median s, the last (dn, regs), K1 launches,
    second passes) of the timed frames."""
    from yondx_torch.nle import moments
    fn(rggb, 959.0)
    torch.cuda.synchronize()
    moments.reset_launches()
    fn.stats["second_passes"] = 0
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        out = fn(rggb, 959.0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return (float(np.median(times)), out, moments.LAUNCHES["nle_moments"],
            fn.stats["second_passes"])


def fused_case(label, make, net, noisy, clean, reps, kw, launches_per):
    """One fused-entry configuration on the 3072x4096 frame: ms/frame
    (median of `reps`), MP/s, PSNR in -> out, K_est, second passes and K1
    launches, held to phase 5's floors (gain >= 10 dB, K_est within 10% of
    8.74) and to `launches_per` K1 launches a frame. Returns (regs, the
    case's record)."""
    from yondx_torch.isp.bayer import bayer2rggb, rggb2bayer
    fn = make(net, **kw)
    rggb = bayer2rggb(torch.from_numpy(noisy).cuda())[None]
    dt, (dn, regs), launches, second = _run_frames(fn, rggb, reps)
    out = rggb2bayer(dn[0]).float().cpu().numpy()
    regs = regs.cpu().numpy()
    H, W = noisy.shape
    p_in, p_out = psnr(noisy, clean), psnr(out, clean)
    k_est = float(regs[0, 0] * 959)
    say("options", f"{label}: {dt * 1e3:.2f} ms/frame, "
        f"{H * W / 1e6 / dt:.2f} MP/s (median of {reps}); PSNR {p_in:.2f} "
        f"-> {p_out:.2f} dB; K_est {k_est:.3f}; second passes {second}/"
        f"{reps}; K1 launches {launches}; regs {regs.tolist()}")
    if not np.isfinite(out).all():
        raise AssertionError(f"{label}: output is not finite")
    if p_out < p_in + 10.0:
        raise AssertionError(f"{label}: PSNR gain {p_out - p_in:.2f} dB < 10")
    if abs(k_est - 8.74) > 0.1 * 8.74:
        raise AssertionError(f"{label}: K_est {k_est:.3f} not within 10% "
                             "of 8.74")
    if launches != launches_per * reps:
        raise AssertionError(f"{label}: K1 launched {launches} times in "
                             f"{reps} frames, expected {launches_per * reps}")
    return regs, {"ms": dt * 1e3, "launches": launches,
                  "second_passes": second}


def matrix_case(label, r) -> dict:
    """A row of yondx_torch.cli.bench_matrix held to phase 5's floors
    (gain >= 10 dB, K_est within 10% of 8.74) and to 3 K1 launches a
    call (self 1, collab 2) -> its record."""
    calls = r.get("calls", 1)
    say("options", f"{label}: {r['ms']:.2f} ms/frame, {r['mps']:.2f} MP/s; "
        f"PSNR {r['psnr_in']:.2f} -> {r['psnr_out']:.2f} dB; K_est "
        f"{r['k_est']:.3f}; second passes {r.get('second_passes', 0)}/"
        f"{calls}; K1 launches {r['launches']} in {calls} calls"
        + (f"; regs {r['regs'].tolist()}" if "regs" in r else ""))
    if not np.isfinite(r["psnr_out"]) or r["psnr_out"] < r["psnr_in"] + 10:
        raise AssertionError(f"{label}: PSNR gain "
                             f"{r['psnr_out'] - r['psnr_in']:.2f} dB < 10")
    if abs(r["k_est"] - 8.74) > 0.1 * 8.74:
        raise AssertionError(f"{label}: K_est {r['k_est']:.3f} not within "
                             "10% of 8.74")
    if r["launches"] != 3 * calls:
        raise AssertionError(f"{label}: K1 launched {r['launches']} times in "
                             f"{calls} calls, expected {3 * calls}")
    return {"ms": r["ms"], "launches": r["launches"], "calls": calls,
            "second_passes": r.get("second_passes", 0)}


def option_card_vs_cpu(label, nets, kw, noisy, clean):
    """The option on a 512x768 crop of the frame, fp32 on the card and on
    the CPU, by phase 9e's rule (_card_vs_cpu; the card's +-1e-6 shift
    spread for the regs)."""
    from yondx_torch.isp.bayer import bayer2rggb, rggb2bayer
    from yondx_torch.pipeline.fused import make_fused_blind_denoiser
    from yondx_torch.vst.lut import BiasLUT
    r, c = noisy.shape[0] // 6 * 2, noisy.shape[1] // 6 * 2
    crop, cclean = noisy[r:r + 512, c:c + 768], clean[r:r + 512, c:c + 768]
    rggb = bayer2rggb(torch.from_numpy(np.ascontiguousarray(crop)))[None]
    res, fns = {}, {}
    for d in ("cuda", "cpu"):
        fns[d] = make_fused_blind_denoiser(nets[d], BiasLUT().lut, device=d,
                                           **kw)
        dn, regs = fns[d](rggb, 959.0)
        res[d] = (rggb2bayer(dn[0]).cpu().numpy(), regs.cpu().numpy())
    spread = np.max([np.abs(fns["cuda"](rggb + s, 959.0)[1].cpu().numpy()
                            - res["cuda"][1]) for s in (1e-6, -1e-6)],
                    axis=0)
    _card_vs_cpu(f"options cuda vs cpu, {label}", res["cuda"][0],
                 res["cpu"][0], res["cuda"][1], res["cpu"][1], spread,
                 cclean)


def k1_at_k(k, flush, bw, fp32) -> dict:
    """K1 against its plain version at window k (texture pre-blur k // 3 *
    2 + 1) in its three flavours on the product path's band view
    [1, 2, 256, 2048, 4] (phase 3's tolerances), and each flavour timed
    (cold L2, an event pair around each synchronised call) beside its
    bound."""
    from yondx_torch.pipeline.fused import _take_bands
    g = torch.Generator(device="cuda").manual_seed(k)
    frame = torch.rand((1, 1536, 2048, 4), generator=g, device="cuda") * 0.7
    return k1_check(_take_bands(frame, 6, 2, 3, 256), k, flush, bw, fp32,
                    "K1 at k", f"k={k} (inner {k // 3 * 2 + 1}), bands "
                    "[1,2,256,2048,4]")


K1_TOL = {"mean": 1e-5, "var": 1e-6, "tex": 5e-5}


def k1_check(x, k, flush, bw, fp32, phase, label, reps=20,
             plain_reps=10, ref_dtype=None, tol=K1_TOL, tex_sq=False,
             timed=True) -> dict:
    """K1 on x against its plain version in its three flavours (phase 3's
    tolerances by default), each flavour timed (cold L2) beside its
    bound, the plain self flavour timed beside (timed=False: the check
    alone). ref_dtype=torch.float64 runs the plain version in float64
    (its prefix sums too: the float32 plain version's own error, which
    grows with the plane, is printed beside) and prints where each map's
    worst error lies; tex_sq compares tex as its square, the
    pre-blurred plane's variance, where tex falls near 0 and the square
    root would turn a variance error e into sqrt(e)."""
    from yondx_torch.nle import moments
    inner = k // 3 * 2 + 1
    rec = {}
    plain_errs = {}
    for flavour, (texture, mean, ops) in K1_FLAVOURS.items():
        got = moments.nle_moments(x, k, inner, texture, mean)
        torch.cuda.synchronize()
        ref = moments.nle_moments_plain(x if ref_dtype is None
                                        else x.to(ref_dtype), k, inner,
                                        texture, mean)
        errs = {}
        for key, gv, rv in zip(("mean", "var", "tex"), got, ref):
            if gv is None:
                continue
            gv = gv.to(rv.dtype)
            if key == "tex" and tex_sq:
                gv, rv = gv ** 2, rv ** 2
            d = (gv - rv).abs()
            errs[key] = float(d.max())
            if ref_dtype is not None:
                at = np.unravel_index(int(d.argmax()), tuple(d.shape))
                say(phase, f"{label}, {flavour} {key}"
                    f"{'^2' if key == 'tex' and tex_sq else ''}: max abs err "
                    f"{errs[key]:.3e} at {tuple(int(i) for i in at)}: exact "
                    f"{float(rv[at]):.6e}, K1 {float(gv[at]):.6e}, input "
                    f"{float(x[at]):.4f}")
        finite = all(bool(torch.isfinite(gv).all()) for gv in got
                     if gv is not None)
        if ref_dtype is not None:
            p32 = moments.nle_moments_plain(x, k, inner, texture, mean)
            plain_errs[flavour] = max(float((pv - rv).abs().max())
                                      for pv, rv in zip(p32[:2], ref[:2])
                                      if pv is not None)
            del p32
        del got, ref
        for key, e in errs.items():
            if e > tol[key] or not finite:
                raise AssertionError(f"K1 k={k} {flavour} ({label}): {key} "
                                     f"err {e:.3e} > {tol[key]:.0e}")
        if not timed:
            rec[flavour] = {"max_abs_err": max(errs.values())}
            continue
        ms = cuda_ms(lambda: moments.nle_moments(x, k, inner, texture, mean),
                     reps, flush)
        nbytes = 4 * x.numel() * (2 + texture + mean)
        t_bytes, t_ops = nbytes / bw * 1e3, x.numel() * ops / fp32 * 1e3
        rec[flavour] = {"ms": ms, "bound_ms": max(t_bytes, t_ops),
                        "bound_by": "bytes" if t_bytes >= t_ops
                        else "operations", "max_abs_err": max(errs.values()),
                        "err64": errs if ref_dtype is torch.float64 else
                        k1_err64(x, k, inner, (flavour,))[flavour]}
    if not timed:
        say(phase, f"{label}: max abs err " + "; ".join(
            f"{f} {r['max_abs_err']:.3e}" for f, r in rec.items())
            + ("" if ref_dtype is None else "; the float32 plain version "
               "is off the float64 one by " + ", ".join(
                   f"{f} {e:.3e}" for f, e in plain_errs.items())))
        return rec
    plain = cuda_ms(lambda: moments.nle_moments_plain(x, k, inner),
                    plain_reps, flush)
    rec["self"]["plain_ms"] = plain
    say(phase, f"{label}: " +
        "; ".join(f"{f} {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
                  f"{r['bound_by']} ({r['ms'] / r['bound_ms']:.1f}x), max "
                  f"abs err {r['max_abs_err']:.3e} (against float64: "
                  + ", ".join(f"{m} {v:.2e}" for m, v in r["err64"].items())
                  + ")" for f, r in rec.items())
        + f"; plain (self) {plain:.4f} ms"
        + ("" if ref_dtype is None else f"; reference: the plain version in "
           f"{ref_dtype}, against which the float32 plain version is off by "
           + ", ".join(f"{f} {e:.3e}" for f, e in plain_errs.items())))
    return rec


def options_phase(noisy, clean, bw, fp32) -> dict:
    """Phase 14: scripts/bench_matrix.py's matrix on the 3072x4096 frame
    through yondx_torch.cli.bench_matrix (the committed gru32
    Gaussian_GRU_mix_5to50_norm in fp32 and bf16, sort / hist threshold
    with the conv margins, hist with the pallas margins; hist regs within
    rtol 0.05 of sort, as
    tests/test_fused.py::test_hist_threshold_close_to_sort; its
    orchestrated fp32 engine), then phase
    5's product configuration (s2dt16 bf16) under each other iteration
    policy, without the bias correction (exact inverse), with two collab
    rounds and at k = 19 and 41; each option on a crop card vs CPU
    (fp32), and K1 against its plain version at k = 19 and 41. TF32 off.
    Returns the record of K1's launches and times."""
    from yondx_torch.cli import bench_matrix
    from yondx_torch.models.unets import GRU32_ARCH, load_guided_s2d, \
        load_model
    from yondx_torch.pipeline.fused import make_fused_blind_denoiser
    from yondx_torch.vst.lut import BiasLUT
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    lut = BiasLUT().lut
    reps = PHASE14_REPS
    rec = {"matrix": {}, "options": {}}

    def make(compute_dtype):
        def f(net, **kw):
            return make_fused_blind_denoiser(
                net, lut, compute_dtype=compute_dtype, device="cuda", **kw)
        return f

    # scripts/bench_matrix.py's matrix through its port, each fp32
    # configuration on a crop card vs CPU while its net is loaded
    gru_cpu = load_model(GRU32_ARCH, GRU5_CKPT, device="cpu")

    def crop_vs_cpu(tag, name, net, kw):
        if tag == "fp32":
            option_card_vs_cpu(f"gru32, {name}", {"cuda": net, "cpu": gru_cpu},
                               kw, noisy, clean)

    rows = bench_matrix.run_matrix(noisy, clean, "cuda", reps,
                                   after=crop_vs_cpu)
    for key, r in rows.items():
        rec["matrix"][key] = matrix_case(f"gru32 {key}", r)
    for tag, _ in bench_matrix.DTYPES:
        base = rows[f"{tag}/{bench_matrix.MATRIX[0][0]}"]["regs"]
        for name, _, _ in bench_matrix.MATRIX[1:]:
            regs = rows[f"{tag}/{name}"]["regs"]
            rel = np.abs(regs - base) / np.abs(base)
            say("options", f"gru32 {tag}: {name} regs against "
                f"{bench_matrix.MATRIX[0][0]}, relative {rel.tolist()} "
                "(rtol 0.05, atol 1e-6)")
            if not np.allclose(regs, base, rtol=0.05, atol=1e-6):
                raise AssertionError(f"gru32 {tag} {name}: regs not within "
                                     "rtol 0.05 of sort")
    del gru_cpu
    rec["orchestrated"] = matrix_case(
        "orchestrated fp32", bench_matrix.run_orchestrated(noisy, clean,
                                                           "cuda"))
    s2dt_bf16 = load_guided_s2d(S2DT16_CKPT, device="cuda",
                                dtype=torch.bfloat16)
    nets = {d: load_guided_s2d(S2DT16_CKPT, device=d)
            for d in ("cuda", "cpu")}
    for label, opt in OPTIONS:
        kw = {**PRODUCT, **opt}
        per = 1 + 2 * kw["max_iter"]
        _, rec["options"][label] = fused_case(
            f"s2dt16 bf16, {label}", make(torch.bfloat16), s2dt_bf16, noisy,
            clean, reps, kw, per)
        option_card_vs_cpu(f"s2dt16, {label}", nets, kw, noisy, clean)
    del s2dt_bf16, nets
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rec["k_sweep"] = {str(k): k1_at_k(k, scratch.zero_, bw, fp32)
                      for k in (19, 41)}
    del scratch
    return rec


# 15. the bias-table builders on the host ---------------------------------
def builders_phase() -> None:
    """Phase 15: the whole sg-extension table and three 16-column blocks
    of the 2-D table (the lowest, a middle and the highest sg), built on
    the host into a temporary directory and held bit-equal to the
    committed tables; the host curve `bias_curve_for` against the device
    curve of the fused path at one sg <= 10 e- and one above (the
    tolerances of tests/test_fused.py)."""
    from yondx_torch.pipeline.fused import device_bias_curve
    from yondx_torch.vst import lut as t_lut
    committed = np.load(os.path.join(REPO, "checkpoints", "bias_lut_2d.npy"))
    committed_ext = np.load(os.path.join(REPO, "checkpoints",
                                         "bias_lut_sgext.npy"))
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        ext = t_lut.load_sgext_lut(os.path.join(tmp, "bias_lut_2d.npy"))
        dt = time.perf_counter() - t
        written = os.path.exists(os.path.join(tmp, "bias_lut_sgext.npy"))
    worst = float(np.abs(ext - committed_ext).max())
    say("builders", f"build_bias_lut_sgext {ext.shape} in {dt:.2f} s "
        f"(written to the temporary directory: {written}); worst "
        f"difference from the committed table {worst:.3e}")
    if not (written and np.array_equal(ext, committed_ext)):
        raise AssertionError("the rebuilt sg-extension table differs from "
                             "the committed one")
    for lo in (0, 600, len(t_lut.SG_LUT) - 16):
        t = time.perf_counter()
        cols = t_lut.bias_lut_columns(lo, lo + 16).astype(np.float32)
        dt = time.perf_counter() - t
        worst = float(np.abs(cols - committed[:, lo:lo + 16]).max())
        say("builders", f"2-D table columns {lo}:{lo + 16} (sg "
            f"{t_lut.SG_LUT[lo]:.3f}-{t_lut.SG_LUT[lo + 15]:.3f} e-) in "
            f"{dt:.2f} s; worst difference {worst:.3e}")
        if not np.array_equal(cols, committed[:, lo:lo + 16]):
            raise AssertionError(f"2-D table columns {lo}:{lo + 16} differ "
                                 "from the committed ones")
    dev = torch.device("cuda")
    lut_d = torch.as_tensor(committed, device=dev)
    ext_d = torch.as_tensor(committed_ext, device=dev)
    for K, sigma in ((8.74, 12.81), (1.0, 20.0)):
        host = t_lut.bias_curve_for(K, sigma, committed)
        card = device_bias_curve(lut_d, torch.tensor(K, device=dev),
                                 torch.tensor(sigma, device=dev),
                                 ext_d).cpu().numpy()
        err = float(np.abs(card - host).max())
        sg = sigma / K
        say("builders", f"bias_curve_for against the device curve at sg "
            f"{sg:.3f} e-: max abs diff {err:.3e}")
        ok = err < 1e-3 if sg > 10 else np.allclose(card, host, atol=2e-4,
                                                    rtol=1e-3)
        if not ok:
            raise AssertionError(f"host and device bias curves differ at sg "
                                 f"{sg:.3f}")


# 16. the comparison zoo and the FBI blind-spot denoiser -------------------
ZOO = (
    {"name": "DnCNN", "in_nc": 4, "out_nc": 4, "nf": 16, "depth": 5,
     "use_bn": True, "res": True},
    {"name": "SelfSupUNet", "in_nc": 4, "out_nc": 4, "nf": 16, "depth": 3},
    {"name": "SelfResUNet", "in_nc": 4, "out_nc": 4, "nf": 8, "depth": 3},
    {"name": "N2NF_Unet", "in_nc": 4, "out_nc": 4},
    {"name": "FBI_Net", "nf": 16, "num_of_layers": 4, "mul": 1,
     "output_channel": 2, "output_type": "linear", "res": True,
     "in_nc": 1, "out_nc": 2},
    {"name": "GuidedSelfUnet", "guided": True, "in_nc": 4, "out_nc": 4,
     "nf": 8, "res": False, "norm": True, "depth": 3},
    {"name": "est_UNet", "in_nc": 4, "out_nc": 2, "nf": 16, "depth": 3})
# JAX's default depth of FBI_Net (no FBI checkpoint is committed)
FBI_ARCH = {"name": "FBI_Net", "nf": 64, "num_of_layers": 8, "mul": 1,
            "output_channel": 1, "output_type": "linear", "res": False,
            "in_nc": 1, "out_nc": 1}


def zoo_phase(noisy) -> dict:
    """Phase 16: each net of the zoo at flax's fresh init, card against
    CPU on [2, 64, 64, C]; then VSTDenoiser(fbi=True) with FBI_Net nf 64,
    8 layers (random weights: no PSNR is held) through phase 6's
    TiledRunner (tiles of 1024 with halo 64) one tile at a time over the
    3072x4096 frame: ms a tile, peak memory, and card against CPU on one
    tile. TF32 off."""
    from yondx_torch.core.tiling import tile_overlap
    from yondx_torch.models.registry import build_model, flax_init_params, \
        is_guided
    from yondx_torch.pipeline.denoiser import VSTDenoiser
    from yondx_torch.pipeline.runner import TiledRunner
    from yondx_torch.vst.lut import BiasLUT
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = np.random.default_rng(16)
    for arch in ZOO:
        net = build_model(arch)
        net.load_state_dict(flax_init_params(net, 0))
        net.eval()
        x = torch.from_numpy(g.random((2, 64, 64, arch["in_nc"]),
                                      np.float32))
        t = torch.tensor([0.1, 0.3])
        args = (x, t) if is_guided(arch) else (x,)
        with torch.no_grad():
            cpu = net(*args)
            card = net.cuda()(*(a.cuda() for a in args)).cpu()
        err = float((card - cpu).abs().max())
        scale = max(1.0, float(cpu.abs().max()))
        say("zoo", f"{arch['name']}: output {tuple(cpu.shape)}, card vs CPU "
            f"max abs diff {err:.3e} (outputs up to {scale:.3f})")
        if not bool(torch.isfinite(card).all()) or err > 1e-4 * scale:
            raise AssertionError(f"{arch['name']}: card and CPU differ by "
                                 f"{err:.3e}")
    K, sigma, scale = 8.74, 12.81, 959.0
    curve = BiasLUT().curve(K, sigma)
    dens = {}
    for d in ("cpu", "cuda"):
        fbi = build_model(FBI_ARCH)
        fbi.load_state_dict(flax_init_params(fbi, 0))
        dens[d] = VSTDenoiser(fbi.to(d).eval(), guided=False, fbi=True,
                              device=d)
    runner = TiledRunner(dens["cuda"], tile=1024, halo=64, batch=1)
    frame = torch.from_numpy(noisy).cuda()
    n_tiles = tile_overlap(frame, 1024, 64)[0].shape[0]
    runner(frame, curve, K, sigma, scale)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        t = time.perf_counter()
        out = runner(frame, curve, K, sigma, scale)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    dt = float(np.median(times))
    tile = tile_overlap(frame, 1024, 64)[0][:1]
    card = dens["cuda"](tile, curve, K, sigma, scale).cpu()
    cpu = dens["cpu"](tile.cpu(), curve, K, sigma, scale)
    err = float((card - cpu).abs().max())
    say("zoo", f"VSTDenoiser(fbi=True), FBI_Net nf 64 x 8 layers, "
        f"TiledRunner 1024/64 one tile at a time: {dt * 1e3:.2f} ms/frame "
        f"({n_tiles} tiles of {tile.shape[-1]}x{tile.shape[-2]}, "
        f"{dt * 1e3 / n_tiles:.2f} ms a tile; median of 3); peak memory "
        f"{peak:.2f} GiB; card vs CPU on one tile max abs diff {err:.3e}")
    if tuple(out.shape) != noisy.shape or not bool(torch.isfinite(out).all()):
        raise AssertionError("FBI denoiser output has another shape or is "
                             "not finite")
    if err > 1e-3:
        raise AssertionError(f"FBI denoiser: card and CPU differ by {err}")
    return {"ms_tile": dt * 1e3 / n_tiles, "peak_gib": peak}


# ---------------------------------------------------------------- phase 17
MESH_FRAME = (6144, 8192)        # 50.3 MP Bayer, [3072, 4096, 4] RGGB


def _noise_model_gap(r_a, r_b, mu) -> float:
    """|v_a - v_b| / v_b of two (beta1, beta2) noise models' variance at
    the mean intensity mu (tests/test_product_50mp.py's comparison)."""
    va, vb = r_a[0] * mu + r_a[1], r_b[0] * mu + r_b[1]
    return abs(va - vb) / max(abs(vb), 1e-30)


def _max_bin_counts(mesh, x, engine, out) -> dict:
    """The largest count of one bin of the NLE's 4096-bin log histograms
    on this frame, counted exactly (int64): the self fit's texture field
    and the collab fit's (sqrt of the round-0 output's local variance;
    the ANY runfile has no refine, so the output is the raw one). The
    route counts in float32, as JAX does, where a bin stops at 2^24."""
    from yondx_torch.isp.bayer import bayer2rggb
    from yondx_torch.nle.moments import nle_moments
    from yondx_torch.parallel import spatial
    k = engine.pipe.k
    _, _, tex = spatial.sharded_box_stats(mesh, x, k)
    dn = bayer2rggb(torch.from_numpy(out).to(mesh.device))
    dne = spatial._halo_exchange_rows(mesh, dn, k)
    _, var, _ = nle_moments(dne[None], k, k // 3 * 2 + 1, texture=False,
                            mean=False)
    t_collab = torch.sqrt(var[0, k:-k])
    return {name: int(torch.bincount(spatial.log_bins(mesh, t.reshape(-1))[0],
                                     minlength=spatial.NBINS_TH).max())
            for name, t in (("self", tex), ("collab", t_collab))}


def _sharded_rank(mesh, frame_path, clean_path, runs=2) -> dict:
    """One rank of phase 17's route at world n: the ANY runfile's engine
    on this rank's card, the frame's rows sharded over the mesh; a
    warm-up and `runs` timed frames (ms/frame from the host clock around
    synchronised work); K1 launches of the timed frames; PSNR of rank
    0's result."""
    from yondx_torch.cli import yond
    from yondx_torch.nle import moments
    from yondx_torch.parallel import iter_denoise_frame_sharded
    noisy = np.load(frame_path)
    engine = yond.YOND(["-f", ANY_RUNFILE, "--device",
                        str(mesh.device)]).engine
    iter_denoise_frame_sharded(mesh, engine, noisy, any_params())
    sync = torch.cuda.synchronize if mesh.device.type == "cuda" \
        else (lambda: None)
    sync()
    moments.reset_launches()
    times = []
    for _ in range(runs):
        t = time.perf_counter()
        res = iter_denoise_frame_sharded(mesh, engine, noisy, any_params())
        sync()
        times.append((time.perf_counter() - t) * 1e3)
    out = res["raw_dns"][-1]
    return {"ms": float(np.median(times)), "times": times,
            "launches": moments.LAUNCHES["nle_moments"],
            "regs": res["regs"], "psnr": psnr(out, np.load(clean_path)),
            "finite": bool(np.isfinite(out).all())}


def _dp_rank(mesh, args, batches, keys, lr) -> dict:
    """One rank of phase 17's data-parallel trainer: a fresh gru32
    AWGNTrainer under DDP over the mesh, one step a global batch; the
    record after step 1 (hold_step's), the losses and ms of each step
    (host clock around synchronised steps)."""
    from yondx_torch.train import AWGNTrainer
    tr = AWGNTrainer(args, field="torch", mesh=mesh)
    return _three_steps(tr, batches, keys, lr,
                        torch.cuda.synchronize
                        if mesh.device.type == "cuda" else (lambda: None))


def _three_steps(tr, batches, keys, lr, sync) -> dict:
    losses, ms, first = [], [], None
    for i, (batch, key) in enumerate(zip(batches, keys)):
        sync()
        t = time.perf_counter()
        loss, _, _ = tr.train_step(batch, key, lr)
        sync()
        ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(loss))
        if i == 0:
            first = step_record(tr, loss)
    return {"first": first, "losses": losses, "ms": ms}


def mesh_phase(bw, fp32) -> dict:
    """Phase 17, the row-sharded frame route and the data-parallel
    trainer (yondx_torch.parallel) on NCCL at world 1 (one card; NCCL puts
    no two ranks on one card):
    (a) `yond --input --mesh 1` on make_frame(6144, 8192) (50.3 MP: the
        whole [3072, 4096, 4] frame as one shard, no tiling; the ANY
        runfile's gru32 fp32), K1 counted around it (3 a frame); the
        route timed on its engine (median of 2), peak memory, one frame
        profiled; the same
        frame through the tiled single-card route (iter_denoise_tiled,
        tiles 1024 + halo 64): regs within the product gate's 1% (noise
        models at the frame's mean), PSNR within 0.05 dB; the largest
        bin count of the NLE's log histograms (exact) against 2^24;
    (b) a 512x768 crop through the route, the card rank (NCCL) against a
        CPU rank (gloo) by phase 9e's rule;
    (c) K1 against its plain version in float64 at the shard's
        halo-extended shape [1, 3130, 4096, 4]: on uniform data by phase
        3's tolerances, and on the shard's own rows (timed there beside
        its bound);
    (d) the gru32 trainer (GRU_5to50_norm_mix.yml: batch 64 of 256 px)
        under DDP at world 1, three steps, against the plain trainer's
        steps from the same init and draws (cuDNN deterministic, TF32
        off): step 1 by phase 10a's bounds, the losses of steps 2-3
        within 1e-4; ms/step of both (the gap is DDP's hooks);
    cuDNN picks its algorithms by heuristics throughout (benchmark mode
    off);
    (e) with two cards or more, (a)'s route and (d) at world 2 through
        `parallel.spawn`; else a line says why they did not run."""
    from yondx_torch.cli import yond
    from yondx_torch.data.datasets import SyntheticSRGBDataset
    from yondx_torch.isp.bayer import bayer2rggb
    from yondx_torch.nle import moments
    from yondx_torch.parallel import iter_denoise_frame_sharded, spawn
    from yondx_torch.parallel import spatial
    from yondx_torch.parallel.mesh import make_mesh
    from yondx_torch.train import AWGNTrainer
    from yondx_torch.train.draws import train_keys
    import torch.distributed as dist
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # cuDNN's heuristics, not its benchmark mode: planning the 50 MP
    # shard's convolutions took 53 s of the first frame on an H100
    bench_mode = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    rec = {}
    H, W = MESH_FRAME
    t = time.perf_counter()
    noisy, clean = make_frame(H, W)
    say("phase 17", f"make_frame({H}, {W}) on the host in "
        f"{time.perf_counter() - t:.2f} s")
    mesh = make_mesh(1)
    say("phase 17", f"mesh of {mesh.size} on {mesh.device}, backend "
        f"{dist.get_backend(mesh.group)}")
    with tempfile.TemporaryDirectory() as tmp:
        fin, fout = os.path.join(tmp, "frame.npy"), os.path.join(tmp,
                                                                 "dn.npy")
        fclean = os.path.join(tmp, "clean.npy")
        np.save(fin, noisy)
        np.save(fclean, clean)
        # (a) the CLI as a user types it, counted
        moments.reset_launches()
        t = time.perf_counter()
        app = yond.main(["-f", ANY_RUNFILE, "--input", fin, "--output",
                         fout, "--mesh", "1"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t
        launches = moments.LAUNCHES["nle_moments"]
        out = np.load(fout)
        p_in, p_cli = psnr(noisy, clean), psnr(out, clean)
        say("phase 17 (a)", f"yond --input --mesh 1 ({H}x{W}) in {cli_s:.2f} "
            f"s (model load and the first "
            f"pass over the {H // 2 + 128}x{W // 2} shard included); PSNR {p_in:.2f} -> {p_cli:.2f} dB; K1 "
            f"launches {launches}")
        if out.shape != (H, W) or not np.isfinite(out).all() \
                or out.min() < 0.0 or out.max() > 1.0:
            raise AssertionError("sharded CLI output is not a finite "
                                 f"{H}x{W} frame in [0, 1]")
        if launches != 3:
            raise AssertionError(f"K1 launched {launches} times in the "
                                 "sharded CLI run, expected 3")
        if p_cli < p_in + 10.0:
            raise AssertionError(f"sharded PSNR gain {p_cli - p_in:.2f} dB "
                                 "< 10 dB")
        engine = app.engine
        moments.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(2):
            t = time.perf_counter()
            res = iter_denoise_frame_sharded(mesh, engine, noisy,
                                             any_params())
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        peak = torch.cuda.max_memory_allocated()
        timed = moments.LAUNCHES["nle_moments"]
        dt = float(np.median(times))
        out_s = res["raw_dns"][-1]
        p_s = psnr(out_s, clean)
        say("phase 17 (a)", f"iter_denoise_frame_sharded x1, {H}x{W}: "
            f"{dt * 1e3:.2f} ms/frame, {H * W / 1e6 / dt:.2f} MP/s (median "
            f"of 2; runs {[round(x * 1e3, 2) for x in times]} ms); peak "
            f"memory {peak / 2 ** 30:.2f} GiB; PSNR {p_in:.2f} -> "
            f"{p_s:.2f} dB; K1 launches {timed}; regs {res['regs']}")
        if timed != 6:
            raise AssertionError(f"K1 launched {timed} times in 2 frames, "
                                 "expected 6")
        # where a frame's time goes: one more frame under the profiler
        profile_run("phase 17 (a) profile",
                    lambda: iter_denoise_frame_sharded(mesh, engine, noisy,
                                                       any_params()),
                    ("child_engine", {"frame": fin,
                                      "runfile": _repo(ANY_RUNFILE),
                                      "route": "mesh"}))
        x = spatial.shard_rows(mesh, bayer2rggb(torch.from_numpy(noisy)))
        counts = _max_bin_counts(mesh, x, engine, res["raw_dns"][0])
        say("phase 17 (a)", "largest log-histogram bin (exact count): "
            + ", ".join(f"{k} {v}" for k, v in counts.items())
            + f"; 2^24 = {2 ** 24}: "
            + ("passed" if max(counts.values()) > 2 ** 24 else "not passed"))
        torch.cuda.synchronize()
        tiled_times = []
        for _ in range(2):
            t = time.perf_counter()
            res_t = engine.iter_denoise_tiled({"lr": noisy}, any_params(),
                                              tile=1024, halo=64)
            torch.cuda.synchronize()
            tiled_times.append(time.perf_counter() - t)
        p_t = psnr(res_t["raw_dns"][-1], clean)
        mu = float(np.mean(noisy))
        gaps = [_noise_model_gap(rs, rt, mu)
                for rs, rt in zip(res["regs"], res_t["regs"])]
        say("phase 17 (a)", f"tiled route (tiles 1024 + halo 64): "
            f"{tiled_times[-1] * 1e3:.2f} ms/frame (runs "
            f"{[round(x * 1e3, 2) for x in tiled_times]} ms); PSNR "
            f"{p_t:.4f} dB against the sharded {p_s:.4f}; regs "
            f"{res_t['regs']}; noise models apart by "
            f"{[round(g, 5) for g in gaps]} of the tiled ones at the mean")
        if len(res_t["regs"]) != len(res["regs"]) or max(gaps) > 0.01:
            raise AssertionError("sharded and tiled regs differ by > 1%")
        if abs(p_s - p_t) > 0.05:
            raise AssertionError(f"sharded and tiled PSNR differ by "
                                 f"{abs(p_s - p_t):.4f} dB > 0.05")
        rec.update({"launches": launches + timed, "ms_frame": dt * 1e3,
                    "tiled_ms_frame": tiled_times[-1] * 1e3,
                    "peak_gib": peak / 2 ** 30, "psnr": [p_in, p_s, p_t],
                    "max_bin": counts})
        regs1 = res["regs"]
        del res, res_t, out, out_s

        # (c) K1 at the shard's halo-extended shape, the frame's rows
        k = engine.pipe.k
        xe = spatial._halo_exchange_rows(mesh, x, k)[None].contiguous()
        scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        shape = f"[1, {xe.shape[1]}, {W // 2}, 4]"
        g = torch.Generator(device="cuda").manual_seed(xe.shape[1])
        k1_check(torch.rand(xe.shape, generator=g, device="cuda") * 0.7, k,
                 scratch.zero_, bw, fp32, "phase 17 (c)",
                 f"K1 at the shard's shape {shape}, uniform in [0, 0.7)",
                 ref_dtype=torch.float64, timed=False)
        k1 = k1_check(xe, k, scratch.zero_, bw, fp32, "phase 17 (c)",
                      f"K1 on the shard's rows {shape}", reps=10,
                      plain_reps=3, ref_dtype=torch.float64, tex_sq=True)
        rec["k1"] = dict(k1, shape=list(xe.shape))
        del xe, x, scratch

        # (b) a crop, card rank against a CPU rank
        r, c = H // 6 * 2, W // 6 * 2
        crop = np.ascontiguousarray(noisy[r:r + 512, c:c + 768])
        cclean = clean[r:r + 512, c:c + 768]
        res_c = {}
        cpu_mesh = make_mesh(1, device="cpu")
        cpu_engine = yond.YOND(["-f", ANY_RUNFILE, "--device",
                                "cpu"]).engine
        for label, m, e in (("cuda", mesh, engine),
                            ("cpu", cpu_mesh, cpu_engine)):
            res_c[label] = iter_denoise_frame_sharded(m, e, crop,
                                                      any_params())
        base = np.array(res_c["cuda"]["regs"])
        spread = np.max([np.abs(np.array(iter_denoise_frame_sharded(
            mesh, engine, crop + s, any_params())["regs"]) - base)
            for s in (1e-6, -1e-6)], axis=0)
        _card_vs_cpu(f"phase 17 (b) 512x768 crop, NCCL rank vs gloo rank "
                     f"(backend {dist.get_backend(cpu_mesh.group)})",
                     res_c["cuda"]["raw_dns"][-1],
                     res_c["cpu"]["raw_dns"][-1], res_c["cuda"]["regs"],
                     res_c["cpu"]["regs"], spread, cclean)
        del engine, cpu_engine, app

        # (d) the data-parallel trainer at world 1 against the plain one
        args = _train_args(TRAIN_RUNFILE, tmp)
        ds = SyntheticSRGBDataset(length=64 * 12, size=256, seed=1997)
        batches = [np.stack([ds[i] for i in range(64 * s, 64 * (s + 1))])
                   for s in range(3)]
        chain = train_keys(1997)
        keys = [next(chain) for _ in range(3)]
        lr = 2e-4
        torch.backends.cudnn.deterministic = True
        steps = {"plain": _three_steps(AWGNTrainer(args, device="cuda",
                                                   field="torch"),
                                       batches, keys, lr,
                                       torch.cuda.synchronize),
                 "ddp": _dp_rank(mesh, args, batches, keys, lr)}
        torch.backends.cudnn.deterministic = False
        hold_step("phase 17 (d)", "step 1, DDP at world 1 vs the plain "
                  "trainer, gru32 batch 64 x [128,128,4]",
                  {k_: v["first"] for k_, v in steps.items()}, lr,
                  loss_rtol=1e-4, max_frac=1e-3, keys=("ddp", "plain"))
        for name, st in steps.items():
            say("phase 17 (d)", f"{name}: ms/step "
                f"{[round(v, 2) for v in st['ms']]} (mean of steps 2-3 "
                f"{np.mean(st['ms'][1:]):.2f}); losses {st['losses']}")
        lp, ld = np.array(steps["plain"]["losses"]), \
            np.array(steps["ddp"]["losses"])
        if not (np.abs(ld - lp) <= 1e-4 * np.abs(lp)).all():
            raise AssertionError(f"DDP losses {ld} differ from {lp}")
        rec["train_ms"] = {k_: float(np.mean(v["ms"][1:]))
                           for k_, v in steps.items()}

        # (e) world 2
        n_cards = torch.cuda.device_count()
        if n_cards >= 2:
            torch.cuda.empty_cache()
            w2 = spawn(2, _sharded_rank, fin, fclean)
            r2 = w2[0]
            gaps = [_noise_model_gap(a, b, mu)
                    for a, b in zip(r2["regs"], regs1)]
            say("phase 17 (e)", f"route at world 2: {r2['ms']:.2f} ms/frame "
                f"(runs {[round(v, 2) for v in r2['times']]}), PSNR "
                f"{r2['psnr']:.4f} dB; K1 launches per rank "
                f"{[w['launches'] for w in w2]}; regs {r2['regs']}, apart "
                f"from world 1's by {[round(g, 6) for g in gaps]}")
            if not r2["finite"] or abs(r2["psnr"] - p_s) > 0.05 \
                    or len(gaps) != len(regs1) or max(gaps) > 0.01 \
                    or any(w["launches"] != 6 for w in w2):
                raise AssertionError("world-2 route disagrees with world 1")
            d2 = spawn(2, _dp_rank, args, batches, keys, lr)
            hold_step("phase 17 (e)", "step 1, DDP at world 2 vs world 1",
                      {"w2": d2[0]["first"], "w1": steps["ddp"]["first"]},
                      lr, loss_rtol=1e-4, max_frac=1e-3, keys=("w2", "w1"))
            say("phase 17 (e)", f"DDP at world 2: ms/step "
                f"{[round(v, 2) for v in d2[0]['ms']]}; losses "
                f"{d2[0]['losses']}")
            rec["world2"] = {"ms_frame": r2["ms"],
                             "train_ms": float(np.mean(d2[0]["ms"][1:]))}
        else:
            say("phase 17 (e)", f"not run: world 2 needs two cards, one a "
                f"rank (NCCL puts no two ranks on one card), and this "
                f"machine has {n_cards}")
    dist.destroy_process_group()
    torch.backends.cudnn.benchmark = bench_mode
    return rec


# ---------------------------------------------------------------- phase 18

# SIDD-like scene metadata for the sRGB renders: the RGGB CFA, an
# as-shot white balance and a camera ColorMatrix2 of the kind the SIDD
# metadata files carry
SIDD_META = {"bayer_2by2": [[1, 2], [2, 3]], "wb": [0.5392, 1.0, 0.6074],
             "cst2": [[1.0312, -0.4196, -0.0561], [-0.4458, 1.2753, 0.1905],
                      [-0.0611, 0.1789, 0.6078]]}


def _trace_kernels(logdir):
    """(names of the CUDA kernel events, the file) of the one Chrome
    trace JSON in logdir."""
    files = [f for f in os.listdir(logdir) if f.endswith(".json")]
    if len(files) != 1:
        raise AssertionError(f"trace wrote {files}, expected one JSON")
    path = os.path.join(logdir, files[0])
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e.get("name", "") for e in events
            if e.get("cat") == "kernel"], path


def trace_frame_child(frame_path: str, logdir: str) -> dict:
    """The body of (a), run in a process of its own: the product path
    (phase 5's configuration) on the frame, a warm-up, then one frame
    inside core.profiling.trace; -> the trace's counts."""
    from yondx_torch import cuda_build
    from yondx_torch.core.profiling import trace
    from yondx_torch.nle import moments
    cuda_build.load_library()
    fused, rggb = _product_fused(frame_path)
    fused(rggb, 959.0)
    torch.cuda.synchronize()
    moments.reset_launches()
    t = time.perf_counter()
    with trace(logdir) as d:
        fused(rggb, 959.0)
    wall = time.perf_counter() - t
    names, path = _trace_kernels(d)
    conv = [n for n in names if any(w in n.lower() for w in _GROUPS[1][1])]
    return {"launches": moments.LAUNCHES["nle_moments"],
            "trace_k1_events": sum("nle_moments" in n for n in names),
            "trace_conv_events": len(conv), "kernel_events": len(names),
            "conv_example": conv[0][:60] if conv else None,
            "json_mb": os.path.getsize(path) / 1e6, "wall_s": wall}


def isp_trace_frame(noisy) -> dict:
    """(a) one product-path frame inside core.profiling.trace, in a
    process of its own (in this long-lived one, after phases 1-17, the
    profiler's traces lost kernel events: 2250 of ~2270, one of them
    K1's): the JSON names K1's kernel 3 times and cuDNN's
    convolutions."""
    with tempfile.TemporaryDirectory() as tmp:
        frame = os.path.join(tmp, "frame.npy")
        np.save(frame, noisy)
        mod = os.path.splitext(os.path.basename(__file__))[0]
        code = (f"import json, {mod} as c; print(json.dumps("
                f"c.trace_frame_child({frame!r}, {os.path.join(tmp, 'tr')!r})))")
        t = time.perf_counter()
        res = subprocess.run([sys.executable, "-c", code],
                             cwd=os.path.dirname(os.path.abspath(__file__)),
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise AssertionError(f"the traced frame's process failed:\n"
                                 f"{res.stdout[-3000:]}{res.stderr[-3000:]}")
        rec = json.loads(res.stdout.strip().splitlines()[-1])
    say("phase 18 (a)", f"one product-path frame inside core.profiling."
        f"trace, in a process of its own ({time.perf_counter() - t:.2f} s "
        f"with its start, model load and warm-up; the traced frame "
        f"{rec['wall_s']:.2f} s with the JSON's export): "
        f"{rec['json_mb']:.1f} MB, {rec['kernel_events']} kernel events, K1 "
        f"(nle_moments_kernel) {rec['trace_k1_events']}, convolution/gemm "
        f"kernels {rec['trace_conv_events']} (e.g. {rec['conv_example']}); "
        f"K1 launches {rec['launches']}")
    if rec["trace_k1_events"] != 3 or rec["launches"] != 3 \
            or not rec["trace_conv_events"]:
        raise AssertionError("the trace does not name K1 3 times and "
                             "cuDNN's convolutions")
    return rec


def isp_render_frame(noisy) -> dict:
    """(b) the demosaic and process_sidd_image on the 3072x4096 frame on
    the card against the CPU: the demosaic bit-equal, the render within
    one level; each timed on the card."""
    from yondx_torch.isp.demosaic import demosaic_ea
    from yondx_torch.isp.render import process_sidd_image
    m = SIDD_META
    mosaic = (torch.from_numpy(noisy) * 16383).to(torch.int32)
    dem_c = demosaic_ea(mosaic.cuda())
    t = time.perf_counter()
    dem_h = demosaic_ea(mosaic)
    dem_cpu_s = time.perf_counter() - t
    if not torch.equal(dem_c.cpu(), dem_h):
        raise AssertionError("demosaic: card and CPU differ")
    x = torch.from_numpy(noisy).cuda()
    img_c = process_sidd_image(x, m["bayer_2by2"], m["wb"], m["cst2"])
    t = time.perf_counter()
    img_h = process_sidd_image(noisy, m["bayer_2by2"], m["wb"], m["cst2"])
    cpu_s = time.perf_counter() - t
    diff = np.abs(img_c.cpu().numpy().astype(np.int16) - img_h)
    ms_dem = cuda_ms(lambda: demosaic_ea(mosaic.cuda()), 5)
    ms_isp = cuda_ms(lambda: process_sidd_image(
        x, m["bayer_2by2"], m["wb"], m["cst2"]), 5)
    say("phase 18 (b)", f"demosaic {tuple(noisy.shape)} -> "
        f"{tuple(dem_c.shape)} on the card {ms_dem:.2f} ms (the upload "
        f"included; CPU {dem_cpu_s * 1e3:.0f} ms), bit-equal to the CPU; "
        f"process_sidd_image {ms_isp:.2f} ms on the card (float64; CPU "
        f"{cpu_s * 1e3:.0f} ms), {int((diff > 0).sum())} of {diff.size} "
        f"values one level off the CPU, max {int(diff.max())}")
    if diff.max() > 1 or img_c.shape != (*noisy.shape, 3):
        raise AssertionError("process_sidd_image: card and CPU differ by "
                             "more than one level")
    return {"demosaic_ms": ms_dem, "process_sidd_image_ms": ms_isp,
            "levels_off": int((diff > 0).sum())}


class _MetaScenes:
    """SIDD scenes in memory, each with SIDD_META."""

    def __init__(self, noisy, clean):
        self.noisy, self.clean = noisy, clean

    def __len__(self):
        return len(self.noisy)

    def __getitem__(self, i):
        return {"name": f"{i:04d}", "lr": self.noisy[i], "hr": self.clean[i],
                "meta": dict(SIDD_META), "cfa": SIDD_META["bayer_2by2"]}


def isp_sidd_figures(tmp, n=4) -> dict:
    """(c) phase 13's SIDD fixture (its first n scenes) through the SIDD
    runfile's engine and SIDDEvalHarness without and with save_plot:
    scenes/s of each, the noisy, GT and per-round PNGs read back at
    their shape, psnr_rgb on the card against a CPU harness scoring the
    card's outputs on the first 2 scenes within 0.01 dB."""
    from yondx_torch.cli import yond
    from yondx_torch.core.png import read_png
    from yondx_torch.eval.sidd import SIDDEvalHarness
    from yondx_torch.nle import moments
    shape = (n,) + EVAL_SHAPES["sidd"][1:]
    noisy, clean, _ = sidd_blocks(shape)
    ds = _MetaScenes(noisy, clean)
    t = time.perf_counter()
    # the CLI reads checkpoints/ and writes ./metrics/ and ./logs/ in the
    # working directory
    os.symlink(os.path.join(REPO, "checkpoints"),
               os.path.join(tmp, "checkpoints"))
    os.chdir(tmp)
    rec = {}
    try:
        app = yond.YOND(["-f", _repo(SIDD_RUNFILE)])
        log = os.path.join(tmp, "sidd_fig.log")
        with _quiet(log):
            SIDDEvalHarness(app.engine, _MetaScenes(noisy[:1], clean[:1]),
                            "warm", max_iter=app.pipe.max_iter,
                            cache_npy=False, logfile=log).run()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t
        moments.reset_launches()
        for fig in (False, True):
            h = SIDDEvalHarness(app.engine, ds, f"fig{int(fig)}",
                                max_iter=app.pipe.max_iter, save_plot=fig,
                                sample_dir=os.path.join(tmp, "sidd_images"),
                                cache_npy=fig, logfile=log)
            t = time.perf_counter()
            with _quiet(log):
                out = h.run()
            torch.cuda.synchronize()
            rec[f"scenes_s_{'figures' if fig else 'plain'}"] = \
                n / (time.perf_counter() - t)
        launches = moments.LAUNCHES["nle_moments"]
        rounds = app.pipe.max_iter + 1
        pngs = sorted(os.listdir(os.path.join(tmp, "sidd_images")))
        want = sorted([f"{i:04d}_{r}.png" for i in range(n)
                       for r in range(rounds)]
                      + [f"{i:04d}_{k}.png" for i in range(n)
                         for k in ("gt", "noisy")])
        for f in pngs:
            img = read_png(os.path.join(tmp, "sidd_images", f))
            if img.shape != (shape[2], shape[1] * shape[3], 3):
                raise AssertionError(f"{f}: shape {img.shape}")
        # the CPU harness renders and scores the card's outputs
        t = time.perf_counter()
        cpu = SIDDEvalHarness(None, None, "cpu", max_iter=app.pipe.max_iter,
                              save_plot=True,
                              sample_dir=os.path.join(tmp, "cpu_images"),
                              logfile=log)
        gaps = []
        for i in range(2):
            raw = np.load(os.path.join("npy", "fig1", f"{i:03d}.npy"))
            with _quiet(log):
                cpu._score_scene(f"{i:04d}", list(raw), noisy[i], clean[i],
                                 dict(SIDD_META))
            gaps += [abs(a - b) for a, b in zip(
                h.metrics[f"{i:04d}"]["psnr_rgb"],
                cpu.metrics[f"{i:04d}"]["psnr_rgb"])]
        cpu_s = time.perf_counter() - t
        say("phase 18 (c)", f"engine and a warm-up scene {setup_s:.2f} s; "
            f"the CPU's render and scores of 2 scenes {cpu_s:.2f} s; "
            f"SIDD eval of {n} scenes of {list(shape[1:])}: "
            f"{rec['scenes_s_plain']:.2f} scenes/s without figures, "
            f"{rec['scenes_s_figures']:.2f} with (save_plot: the noisy, GT "
            f"and {rounds} round PNGs a scene, {len(pngs)} PNGs of "
            f"{shape[2]}x{shape[1] * shape[3]} read back); sRGB "
            f"PSNR/SSIM per round {[round(v, 4) for v in out['psnr_rgb']]} / "
            f"{[round(v, 4) for v in out['ssim_rgb']]}; raw "
            f"{[round(v, 4) for v in out['psnr']]}; psnr_rgb card vs CPU "
            f"on 2 scenes max {max(gaps):.2e} dB; K1 launches {launches}")
        if pngs != want or max(gaps) > 0.01 or launches != 3 * 2 * n:
            raise AssertionError("SIDD figures: PNGs missing, psnr_rgb card "
                                 "vs CPU over 0.01 dB, or K1 count wrong")
        rec.update({"launches": launches, "psnr_rgb": out["psnr_rgb"],
                    "psnr_rgb_gap_db": max(gaps)})
    finally:
        os.chdir(REPO)
    return rec


def isp_train_dump(tmp) -> dict:
    """(d) phase 10b's trainer (GRU_5to50_norm_mix.yml, batch 64 of 256
    px, one step) writes its temp_*.png; read back at the shape its
    sample's CFA gives ([256, 768, 3] at an even turn, [768, 256, 3] at
    an odd one) and within one level of the CPU render of the same
    sample."""
    import glob
    import types
    from yondx_torch.core.png import read_png
    from yondx_torch.train import AWGNTrainer
    args = _train_args(TRAIN_RUNFILE, tmp, dst_train={"synthetic_len": 64},
                       dst_eval={"synthetic_len": 64})
    tr = AWGNTrainer(args, device="cuda", field="torch")
    seen = []
    card_dump = tr._dump_temp_sample

    def dump(sample, epoch, pf):
        seen.append(([t.detach().cpu().clone() for t in sample], epoch, pf))
        card_dump(sample, epoch, pf)
    tr._dump_temp_sample = dump
    os.chdir(tmp)                       # the trainer's ./logs/
    try:
        with _quiet(os.path.join(tmp, "train.log")):
            tr.train(stop_epoch=1)
    finally:
        os.chdir(REPO)
    with open(os.path.join(tmp, "train.log")) as f:
        skipped = "sample dump skipped" in f.read()
    files = glob.glob(os.path.join(tr.sample_dir, "temp", "temp_*.png"))
    if len(files) != 1 or not seen:
        raise AssertionError(f"the trainer wrote {files}")
    got = read_png(files[0])
    sample, epoch, pf = seen[0]
    me = types.SimpleNamespace(sample_dir=os.path.join(tmp, "cpu"),
                               logfile=os.path.join(tmp, "cpu.log"))
    AWGNTrainer._dump_temp_sample(me, sample, epoch, pf)
    ref = read_png(glob.glob(os.path.join(tmp, "cpu", "temp",
                                          "temp_*.png"))[0])
    turn = int((4 - int(sample[5])) % 4)
    want = (256, 768, 3) if turn % 2 == 0 else (768, 256, 3)
    diff = np.abs(got.astype(np.int16) - ref)
    say("phase 18 (d)", f"the trainer's sample dump "
        f"{os.path.basename(files[0])}: {got.shape} {got.dtype} (the CFA "
        f"turned back by {turn}), {int((diff > 0).sum())} values one level "
        f"off the CPU render of the same sample, max {int(diff.max())}")
    if got.shape != want or diff.max() > 1 or skipped or \
            os.path.exists(me.logfile):
        raise AssertionError("trainer dump: shape or pixels wrong")
    return {"shape": list(got.shape), "levels_off": int((diff > 0).sum())}


def isp_filters_frame(noisy) -> dict:
    """(e) guided_filter (d 7, eps 1) and row_denoise (iso 800) on the
    3072x4096 frame, card against CPU within 1e-5."""
    from yondx_torch.isp.filters import guided_filter, row_denoise
    x = torch.from_numpy(noisy)
    xc = x.cuda()
    errs, ms = {}, {}
    for name, fn in (("guided_filter", lambda t: guided_filter(t, t)),
                     ("row_denoise", lambda t: row_denoise(t, 800.0))):
        errs[name] = float((fn(xc).cpu() - fn(x)).abs().max())
        ms[name] = cuda_ms(lambda: fn(xc), 5)
    say("phase 18 (e)", f"on {tuple(noisy.shape)}: " + "; ".join(
        f"{k} {ms[k]:.2f} ms on the card, max abs err against the CPU "
        f"{errs[k]:.2e}" for k in errs))
    if max(errs.values()) > 1e-5:
        raise AssertionError(f"filters: card vs CPU {errs} > 1e-5")
    return {"ms": ms, "max_abs_err": errs}


def isp_phase(noisy) -> dict:
    """Phase 18: the ISP and the figure tools on the card, (a)-(e), in a
    temporary directory."""
    rec = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, fn in (("(a)", lambda: isp_trace_frame(noisy)),
                          ("(b)", lambda: isp_render_frame(noisy)),
                          ("(c)", lambda: isp_sidd_figures(tmp)),
                          ("(d)", lambda: isp_train_dump(tmp)),
                          ("(e)", lambda: isp_filters_frame(noisy))):
            t = time.perf_counter()
            rec[label.strip("()")] = fn()
            say("phase 18", f"{label} in {time.perf_counter() - t:.2f} s")
    return rec


# 19. the port's orbax checkpoints and DND's MATLAB v7.3 files ---------------
FIXTURES = "tests/data/torch_port"      # scripts/torch_port_fixtures.py


def _fixture_get(tree, key):
    for k in key.split("/"):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def _leaves(tree, prefix=""):
    """{path: leaf} of a tree of dicts and lists (empty containers and
    None kept as leaves)."""
    if isinstance(tree, dict) and tree:
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)) and tree:
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _same_leaf(a, b) -> bool:
    if a is None or (isinstance(a, (dict, list, tuple)) and not a):
        return type(a) is type(b)
    if isinstance(a, (bool, int, float)):
        return type(a) is type(b) and a == b
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)
    b = np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def ckpt_fixture() -> dict:
    """(a) the committed JAX-written orbax checkpoint: every chunk (a zstd
    frame) through the port's decoder, then orbax_ckpt.load, bit-equal to
    the fixture's .npz."""
    from yondx_torch import native
    from yondx_torch.io import ocdbt
    from yondx_torch.train import orbax_ckpt
    root = _repo(os.path.join(FIXTURES, "orbax"))
    want = np.load(_repo(os.path.join(FIXTURES, "expected.npz")))
    t = time.perf_counter()
    store = ocdbt.Store(root)
    frames = packed = unpacked = 0
    for key in store.keys():
        if key.endswith(b"/.zarray"):
            continue
        blob = store.read(key)
        if blob[:4] != b"\x28\xb5\x2f\xfd":
            raise AssertionError(f"{key}: not a zstd frame")
        frames += 1
        packed += len(blob)
        unpacked += len(native.zstd_decompress(blob))
    tree = orbax_ckpt.load(root)
    keys = [k for k in want.files if not k.startswith("dnd/")]
    bad = [k for k in keys if not _same_leaf(want[k],
                                             _fixture_get(tree, k))]
    ok = not bad and tree["opt_state"][1] is None and \
        type(tree["meta"]["epoch"]) is int
    say("phase 19 (a)", f"the JAX-written orbax fixture: {len(store.keys())}"
        f" keys, {frames} zstd frames ({packed} -> {unpacked} bytes) "
        f"through the port's decoder; orbax_ckpt.load in "
        f"{time.perf_counter() - t:.3f} s: {len(keys) - len(bad)} of "
        f"{len(keys)} leaves bit-equal to the .npz, opt_state [dict, None], "
        "meta as Python scalars" + (f"; differ: {bad}" if bad else ""))
    if not ok:
        raise AssertionError("phase 19 (a): the fixture did not load "
                             "bit-equal")
    return {"keys": len(store.keys()), "zstd_frames": frames}


def ckpt_roundtrip(noisy, smi, tmp) -> dict:
    """(b) the s2dt16 net's params (the committed msgpack file through
    io/ckpt.py) and the Adam state of one step of phase 10b's trainer,
    saved with the port's orbax_ckpt.save and loaded back bit-equal; a net
    built from the loaded params denoises the product frame on the card
    bit-equal to the net built from the msgpack file (cuDNN
    deterministic)."""
    from yondx_torch.data.datasets import SyntheticSRGBDataset
    from yondx_torch.io.ckpt import find_checkpoint, load_checkpoint
    from yondx_torch.isp.bayer import bayer2rggb
    from yondx_torch.models.convert import params_to_state_dict
    from yondx_torch.models.registry import build_model
    from yondx_torch.models.unets import S2DT16_ARCH, load_guided_s2d
    from yondx_torch.pipeline.fused import make_fused_blind_denoiser
    from yondx_torch.train import AWGNTrainer, orbax_ckpt
    from yondx_torch.train.ckpt import optax_adam_state
    from yondx_torch.train.draws import train_keys
    from yondx_torch.vst.lut import BiasLUT
    ck = find_checkpoint(CKPTS, "Gaussian_GRUS2DT_mix_1to50c_norm")
    params = load_checkpoint(ck)["params"]
    args = _train_args(TRAIN_RUNFILE, tmp, dst_train={"synthetic_len": 64},
                       dst_eval={"synthetic_len": 64})
    tr = AWGNTrainer(args, device="cuda", field="torch")
    ds = SyntheticSRGBDataset(length=64, size=256, seed=1997)
    tr.train_step(np.stack([ds[i] for i in range(64)]),
                  next(train_keys(7)), 1e-4)
    opt = optax_adam_state(tr.optimizer, tr.model)
    path = os.path.join(tmp, "orbax_s2dt16")
    t = time.perf_counter()
    orbax_ckpt.save(path, params, opt, epoch=201, best_psnr=44.25)
    save_s = time.perf_counter() - t
    nbytes = sum(os.path.getsize(os.path.join(d, f))
                 for d, _, fs in os.walk(path) for f in fs)
    t = time.perf_counter()
    back = orbax_ckpt.load(path)
    load_s = time.perf_counter() - t
    want = _leaves({"params": params, "opt_state": opt,
                    "meta": {"epoch": 201, "best_psnr": 44.25}})
    got = _leaves(back)
    bad = sorted(k for k in want if k not in got
                 or not _same_leaf(want[k], got[k]))
    n_bytes = sum(np.asarray(v).nbytes for v in _leaves(params).values())
    # the product path from either net, on the card, cuDNN deterministic
    det, bench = torch.backends.cudnn.deterministic, \
        torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        net_a = load_guided_s2d(ck, device="cuda", dtype=torch.bfloat16)
        net_b = build_model(S2DT16_ARCH)
        net_b.load_state_dict(params_to_state_dict(back["params"]),
                              strict=True)
        net_b = net_b.to(device="cuda", dtype=torch.bfloat16).eval().to(
            memory_format=torch.channels_last)
        lut = BiasLUT().lut
        rggb = bayer2rggb(torch.from_numpy(noisy).cuda())[None]
        outs = []
        for net in (net_a, net_b):
            fused = make_fused_blind_denoiser(net, lut,
                                              compute_dtype=torch.bfloat16,
                                              device="cuda", **PRODUCT)
            outs.append(fused(rggb, 959.0))
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = det
        torch.backends.cudnn.benchmark = bench
    same = all(torch.equal(a, b) for a, b in zip(*outs))
    say("phase 19 (b)", f"{smi}: orbax_ckpt.save of the s2dt16 params "
        f"({len(_leaves(params))} leaves, {n_bytes / 1e6:.2f} MB) and the "
        f"gru32 trainer's Adam state after one step ({len(want)} leaves in "
        f"all): {save_s:.3f} s, {nbytes / 1e6:.2f} MB on disk; load "
        f"{load_s:.3f} s: {len(want) - len(bad)} of {len(want)} leaves "
        f"bit-equal; the product frame through the loaded net "
        f"{'bit-equal' if same else 'NOT equal'} to the msgpack net's "
        f"(output {tuple(outs[0][0].shape)}, regs "
        f"{outs[0][1].float().cpu().numpy().ravel().tolist()})"
        + (f"; differ: {bad[:5]}" if bad else ""))
    if bad or not same:
        raise AssertionError("phase 19 (b): the round trip is not "
                             "bit-equal")
    return {"save_s": save_s, "load_s": load_s, "bytes": nbytes}


def ckpt_dnd(tmp) -> dict:
    """(c) the committed DND fixture (MATLAB v7.3, HDF5 behind a 512-byte
    user block) read by the port's HDF5 reader bit-equal to the .npz, then
    DNDDataset -> denoise_dnd with the DND runfile's engine on the card:
    K1 three times a box, finite crops in [0, 1]."""
    import scipy.io as sio
    from yondx_torch.cli import yond
    from yondx_torch.data.eval_datasets import DNDDataset
    from yondx_torch.eval.dnd import denoise_dnd
    from yondx_torch.io import hdf5
    from yondx_torch.nle import moments
    root = _repo(os.path.join(FIXTURES, "dnd"))
    want = np.load(_repo(os.path.join(FIXTURES, "expected.npz")))
    t = time.perf_counter()
    ok = True
    for i in range(2):
        with hdf5.File(os.path.join(root, "images_raw",
                                    f"{i + 1:04d}.mat")) as f:
            ok &= f["Inoisy"][()].T.tobytes() == \
                want[f"dnd/{i + 1:04d}"].tobytes()
    ds = DNDDataset(root)
    for i in range(len(ds)):
        item = ds[i]
        ok &= item["lr"].tobytes() == want[f"dnd/{i + 1:04d}"].tobytes() \
            and item["boxes"].tobytes() == want[f"dnd/boxes_{i}"].tobytes()
    read_s = time.perf_counter() - t
    n_boxes = sum(len(ds[i]["boxes"]) for i in range(len(ds)))
    os.symlink(os.path.join(REPO, "checkpoints"),
               os.path.join(tmp, "checkpoints"))
    os.chdir(tmp)
    try:
        log = os.path.join(tmp, "dnd.log")
        with _quiet(log):
            app = yond.YOND(["-f", _repo(DND_RUNFILE)])
        moments.reset_launches()
        t = time.perf_counter()
        with _quiet(log):
            bundled = denoise_dnd(app.engine, ds, os.path.join(tmp, "sub"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = moments.LAUNCHES["nle_moments"]
    finally:
        os.chdir(REPO)
    crops = [sio.loadmat(os.path.join(bundled, f))["Idenoised_crop"]
             for f in sorted(os.listdir(bundled))]
    fine = len(crops) == n_boxes and all(
        np.isfinite(c).all() and c.min() >= 0 and c.max() <= 1
        for c in crops)
    say("phase 19 (c)", f"the DND fixture (2 MATLAB v7.3 images, one "
        f"chunked with deflate, one contiguous; info.mat's object "
        f"references) read by the port's HDF5 reader in {read_s:.3f} s, "
        f"bit-equal to the .npz: {ok}; DNDDataset -> denoise_dnd on the "
        f"card: {n_boxes} boxes of {crops[0].shape if crops else None} in "
        f"{wall:.2f} s, finite in [0, 1]: {fine}; K1 launches {launches}")
    if not ok or not fine or launches != 3 * n_boxes:
        raise AssertionError("phase 19 (c): the DND fixture, its crops or "
                             "K1's launches are wrong")
    return {"launches": launches, "boxes": n_boxes}


def ckpt_phase(noisy, smi) -> dict:
    """Phase 19: the port's orbax checkpoints and DND's MATLAB v7.3
    files, (a)-(c), in a temporary directory."""
    rec = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, fn in (("(a)", ckpt_fixture),
                          ("(b)", lambda: ckpt_roundtrip(noisy, smi, tmp)),
                          ("(c)", lambda: ckpt_dnd(tmp))):
            t = time.perf_counter()
            rec[label.strip("()")] = fn()
            say("phase 19", f"{label} in {time.perf_counter() - t:.2f} s")
    return rec


# 20. what the product ships: the v2 artifacts, the rescue-policy sweep, the
# sigma-corr probe and the checkpoint recipe tools ---------------------------
SWEEP_ART = "docs/policy_sweep_r5.json"
PROBE_ART = "docs/sigma_corr_blind_r5.json"
# JAX's CPU run of `scripts/sweep_policy.py --regrid docs/policy_sweep_r5.json`
# (the port's --regrid and tests/test_torch_sweep_policy.py reproduce it):
# its acceptable region, and ramp_big's ffrac there
JAX_CPU_REGION = [[t, 1.5] for t in (0.05, 0.1, 0.15, 0.25, 0.4)]
JAX_CPU_RAMP_BIG_FFRAC = 1.3276
FAULT_NEEDS = [False, True, True, True, True]


def _fmt(v, spec) -> str:
    return "none" if v is None else format(v, spec)


def _json(path):
    with open(_repo(path)) as f:
        return json.load(f)


def _max_row_gap(rows, rows9) -> float:
    """Largest |difference| (dB) of noisy and per-round PSNRs between a
    column's rows and phase 9's rows of the same scenes."""
    gap = 0.0
    for name, r in rows.items():
        if name == "_summary":
            continue
        q = rows9[name]
        if len(r["psnr"]) != len(q["psnr"]):
            return float("inf")
        gap = max(gap, abs(r["noisy_psnr"] - q["noisy_psnr"]),
                  *(abs(a - b) for a, b in zip(r["psnr"], q["psnr"])))
    return gap


def shipped_v2_columns(scenes, cols9, out_dir) -> dict:
    """(a) the v2 columns of s2dt16 and gru32 in fp32 over phase 9's
    scenes, held to the oriented v2 TPU artifacts and to phase 9's rows;
    (b) the same with --sigma-corr adaptive, held to the adaptive v2
    artifacts. K1 3 a scene in each column."""
    launches, means = {}, {}
    for label, flags, tag in (("s2dt16", S2DT16_FLAGS, "s2dt"),
                              ("gru32", GRU32_FLAGS, "flagship")):
        for mode, extra in (("oriented", []),
                            ("adaptive", ["--sigma-corr", "adaptive"])):
            name = f"{label}_{mode}"
            art = _json(f"docs/heldout/r5_{tag}_{mode}"
                        f"{'_corr' if mode == 'adaptive' else ''}"
                        "_v2_tpu.json")["rows"]
            rows, launches[name], _ = heldout_column(
                name, flags + extra, scenes, out_dir, suite="v2")
            if len(rows) - 1 != 36:
                raise AssertionError(f"phase 20 {name}: {len(rows) - 1} "
                                     "scenes, expected 36")
            hold_to_artifact(name, rows, art)
            means[name] = (rows["_summary"]["mean_psnr"],
                           art["_summary"]["mean_psnr"])
            if mode == "oriented":
                gap = _max_row_gap(rows, cols9[label])
                say("phase 20 (a)", f"{name}: the 36 v2 rows against phase "
                    f"9's v3 rows of the same scenes: largest difference "
                    f"{gap:.3e} dB")
                if gap > 1e-4:
                    raise AssertionError(f"phase 20 {name}: rows differ "
                                         f"from phase 9's by {gap:.3e} dB")
        d, a = (means[f"{label}_adaptive"][i] - means[f"{label}_oriented"][i]
                for i in (0, 1))
        say("phase 20 (b)", f"{label}: adaptive - oriented on v2 {d:+.4f} "
            f"dB on the card (artifacts {a:+.4f})")
    return {"launches": launches,
            "means": {k: v[0] for k, v in means.items()}}


def _hold_card_cpu(label, card, cpu, shifted, psnr_keys, sig_keys,
                   exact_keys=(), phase="phase 20", floor=None):
    """Phase 9e's rule on one row: PSNRs within 0.01 dB; each signal
    within the larger of rtol 1e-3 and the card's own spread under a
    +-1e-6 shift of the input (and of floor[key] where given); exact_keys
    within 1e-6."""
    bad = [k for k in psnr_keys if abs(card[k] - cpu[k]) > 0.01]
    parts = []
    for k in sig_keys:
        spread = max(abs(s[k] - card[k]) for s in shifted)
        allowed = max(1e-3 * abs(cpu[k]), spread, (floor or {}).get(k, 0.0))
        parts.append(f"{k} {card[k]:.6g}/{cpu[k]:.6g} (allowed "
                     f"{allowed:.2e})")
        if abs(card[k] - cpu[k]) > allowed:
            bad.append(k)
    bad += [k for k in exact_keys if abs(card[k] - cpu[k]) > 1e-6]
    say(f"{phase} cuda vs cpu", f"{label}: PSNR (card/cpu) " + ", ".join(
        f"{k} {card[k]:.4f}/{cpu[k]:.4f}" for k in psnr_keys)
        + "; " + ", ".join(parts))
    if bad:
        raise AssertionError(f"{phase} {label}: card and CPU differ in "
                             f"{bad}")


def shipped_sweep(scenes, tmp) -> dict:
    """(c) scripts/sweep_policy.py's full sweep on the card (suite v2 with
    the second pass forced, the five fault rungs, the gru32 flagship in
    fp32) through yondx_torch.cli.sweep_policy; its exit rule, the fault
    rows against the artifact; a reduced scene and rung 0.5 card vs CPU."""
    import dataclasses as dc
    from yondx_torch.cli import sweep_policy as sp
    from yondx_torch.eval import heldout
    from yondx_torch.nle import moments
    art = _json(SWEEP_ART)
    args = sp.parse_args(["--out", os.path.join(tmp, "policy_sweep.json")])
    eng = sp.build_engine(args, "replace")
    torch.cuda.synchronize()
    moments.reset_launches()
    t = time.perf_counter()
    rec = sp.run(args, scenes=scenes, engine=eng)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = moments.LAUNCHES["nle_moments"]
    n = len(rec["suite_rows"]) + len(rec["fault_rows"])
    region = [list(p) for p in rec["ok_region"]]
    arows = {r["scene"]: r for r in art["suite_rows"]}
    say("phase 20 (c)", f"sweep on the card in {wall:.2f} s ({n} scenes "
        f"and rungs, K1 launches {launches}); acceptable region "
        f"{len(region)}/25 {region}; artifact (TPU) "
        f"{len(art['ok_region'])}/25 {art['ok_region']}; JAX CPU regrid "
        f"{len(JAX_CPU_REGION)}/25 {JAX_CPU_REGION}; defaults (0.15, 1.5) "
        f"acceptable: {rec['defaults']['ok']}")
    say("phase 20 (c)", "scene ffrac / agree, card (artifact): " + "; ".join(
        f"{r['scene']} {_fmt(r['ffrac'], '.4f')} "
        f"({arows[r['scene']]['ffrac']:.4f}) / {_fmt(r['agree'], '+.4f')} "
        f"({arows[r['scene']]['agree']:+.4f})" for r in rec["suite_rows"]))
    say("phase 20 (c)", "fault rungs f: ffrac card (artifact), agree, "
        "needs_rescue: " + "; ".join(
            f"{r['fault_scale']}: {r['ffrac']:.4f} ({a['ffrac']:.4f}), "
            f"{r['agree']:+.4f}, {r['needs_rescue']}"
            for r, a in zip(rec["fault_rows"], art["fault_rows"])))
    rb = next(r for r in rec["suite_rows"] if r["scene"] == "ramp_big")
    r05 = rec["fault_rows"][1]
    say("phase 20 (c)", f"margins to the gate 1.5: ramp_big ffrac "
        f"{rb['ffrac']:.4f} ({1.5 - rb['ffrac']:+.4f}; TPU "
        f"{arows['ramp_big']['ffrac']:.4f}, JAX CPU "
        f"{JAX_CPU_RAMP_BIG_FFRAC}), fire - hold "
        f"{rb['psnr_fire'] - rb['psnr_hold']:+.3f} dB; rung 0.5 ffrac "
        f"{r05['ffrac']:.4f} "
        f"({r05['ffrac'] - 1.5:+.4f})")
    if launches != 3 * n:
        raise AssertionError(f"phase 20 (c): K1 launched {launches} times "
                             f"for {n} scenes and rungs, expected {3 * n}")
    if not rec["defaults"]["ok"]:
        raise AssertionError("phase 20 (c): the defaults (0.15, 1.5) are "
                             "not in the card's acceptable region")
    if [r["needs_rescue"] for r in rec["fault_rows"]] != FAULT_NEEDS:
        raise AssertionError("phase 20 (c): fault rows' needs_rescue "
                             f"{[r['needs_rescue'] for r in rec['fault_rows']]}")
    off = [r["fault_scale"] for r, a in zip(rec["fault_rows"],
                                            art["fault_rows"])
           if abs(r["ffrac"] / a["ffrac"] - 1) > 0.01]
    if off:
        raise AssertionError(f"phase 20 (c): rungs {off} ffrac more than 1% "
                             "from the artifact's")
    # a scene cut to one crop and rung 0.5, card vs CPU
    cpu = sp.build_engine(sp.parse_args(["--cpu"]), "replace")
    spec = dc.replace(next(s for s in heldout.SUITES["v1"]
                           if s.name == "glyphs_lo"), n_crops=1)
    clean, noisy = heldout.build_scene(spec)
    fclean, fnoisy = sp.fault_scene()
    for label, row, x in (
            ("sweep glyphs_lo (1 crop)",
             lambda e, y: sp.suite_row(e, spec, clean, y), noisy),
            ("sweep rung 0.5", lambda e, y: sp.fault_row(e, 0.5, fclean, y),
             fnoisy)):
        _hold_card_cpu(label, row(eng, x), row(cpu, x),
                       [row(eng, x + d) for d in (1e-6, -1e-6)],
                       ("psnr_hold", "psnr_fire"), ("agree", "frac", "ffrac"))
    return {"launches": launches, "ok_region": region,
            "defaults_ok": rec["defaults"]["ok"],
            "ramp_big_ffrac": rb["ffrac"], "rung05_ffrac": r05["ffrac"],
            "rung_ffrac": [r["ffrac"] for r in rec["fault_rows"]]}


def _adaptive_of(row) -> float:
    """The adaptive rule (pipeline/denoiser.py) on an artifact row's own
    signals: nsr, the clipped fraction clip_lo + clip_hi, mad_ratio."""
    from yondx_torch.pipeline import denoiser as d
    c_lo, c_mid, c_hi, c_clip = d.ADAPTIVE_CORR_VALUES
    corr = c_lo if row["nsr"] < d.ADAPTIVE_CORR_NSR_LO else c_mid
    if row["clip_lo"] + row["clip_hi"] > d.ADAPTIVE_CORR_CLIP and \
            abs(row["mad_ratio"] - 1.0) < d.ADAPTIVE_CORR_MAD_DEV:
        corr = c_clip
    return c_hi if row["nsr"] > d.ADAPTIVE_CORR_NSR_HI else corr


def _psnr_at(row, corr) -> float:
    i = min(range(len(row["corrs"])),
            key=lambda j: abs(row["corrs"][j] - corr))
    return row["psnrs"][i]


def shipped_probe(scenes, tmp) -> dict:
    """(d) scripts/probe_sigma_corr_blind.py on the card through
    yondx_torch.cli.probe_sigma_corr_blind: all 33 rows beside the
    artifact's, their clip fractions held to the host's; a scene cut to
    one crop card vs CPU."""
    import dataclasses as dc
    from yondx_torch.cli import probe_sigma_corr_blind as pb
    from yondx_torch.eval import heldout
    from yondx_torch.nle import moments
    art = _json(PROBE_ART)["rows"]
    args = pb.parse_args(["--out", os.path.join(tmp, "sigma_corr.json")])
    eng = pb.build_engine(args)
    torch.cuda.synchronize()
    moments.reset_launches()
    t = time.perf_counter()
    rows = pb.run(args, scenes=scenes, engine=eng)["rows"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = moments.LAUNCHES["nle_moments"]
    if [r["scene"] for r in rows] != [r["scene"] for r in art]:
        raise AssertionError("phase 20 (d): the scene list differs from "
                             "the artifact's")
    # the clip fractions of the same numpy-built scenes on the host: the
    # TPU artifact's scenes went through the unprocess chain in the TPU's
    # arithmetic, and JAX's CPU run differs from its fractions as the
    # port's does (voronoi_lo clip_lo 0.0849228 against 0.0846939)
    from yondx_torch.isp.bayer import bayer2rggb
    host = []
    for r in rows:
        rg = bayer2rggb(torch.from_numpy(scenes[(r["scene"], None)][1]))
        host.append({"clip_lo": float(torch.mean((rg < 0.02).float())),
                     "clip_hi": float(torch.mean((rg > 0.98).float()))})
    clip = max(abs(r[k] - h[k]) for r, h in zip(rows, host)
               for k in ("clip_lo", "clip_hi"))
    clip_tpu = [max(abs(r[k] - a[k]) for k in ("clip_lo", "clip_hi"))
                for r, a in zip(rows, art)]
    rel = {k: max(abs(r[k] - a[k]) / max(abs(r[k]), abs(a[k]), 1e-30)
                  for r, a in zip(rows, art))
           for k in ("K_est", "sigma_est", "mad_ratio", "nsr")}
    agree = sum(r["best_corr"] == a["best_corr"] for r, a in zip(rows, art))
    gain = np.mean([_psnr_at(r, r["adaptive_corr"]) - _psnr_at(r, 1.03)
                    for r in rows])
    gain_art = np.mean([_psnr_at(a, _adaptive_of(a)) - _psnr_at(a, 1.03)
                        for a in art])
    say("phase 20 (d)", f"probe on the card: {len(rows)} scenes x "
        f"{len(args.corrs)} corrs in {wall:.2f} s, K1 launches {launches}; "
        f"clip fractions within {clip:.1e} of the host's on the same scenes "
        f"(of the TPU artifact's: {max(clip_tpu):.2e} at most, "
        f"{sum(c <= 1e-6 for c in clip_tpu)}/{len(rows)} within 1e-6); "
        "largest relative difference to the artifact (TPU): " + ", ".join(
            f"{k} {v:.3e}" for k, v in rel.items())
        + f"; best_corr as the artifact's in {agree}/{len(rows)} scenes; "
        f"mean PSNR of the adaptive choice - at 1.03: {gain:+.4f} dB "
        f"(the artifact's rows under the same rule: {gain_art:+.4f})")
    say("phase 20 (d)", "scene: K_est, sigma_est, mad_ratio, nsr card "
        "(artifact); best_corr card (artifact); adaptive_corr: " + "; ".join(
            f"{r['scene']} {r['K_est']:.4f} ({a['K_est']:.4f}), "
            f"{r['sigma_est']:.4f} ({a['sigma_est']:.4f}), "
            f"{r['mad_ratio']:.4f} ({a['mad_ratio']:.4f}), "
            f"{r['nsr']:.5f} ({a['nsr']:.5f}); {r['best_corr']} "
            f"({a['best_corr']}); {r['adaptive_corr']:.2f}"
            for r, a in zip(rows, art)))
    if clip > 1e-6:
        raise AssertionError(f"phase 20 (d): clip fractions {clip:.2e} "
                             "from the host's")
    if launches != len(rows):
        raise AssertionError(f"phase 20 (d): K1 launched {launches} times "
                             f"for {len(rows)} scenes")
    # one scene cut to one crop, every corr, card vs CPU
    cpu = pb.build_engine(pb.parse_args(["--cpu"]))
    spec = dc.replace(next(s for s in heldout.SUITES["v2"]
                           if s.name == "voronoi_mid"), n_crops=1)
    clean, noisy = heldout.build_scene(spec)
    card, host = (pb.probe_row(e, spec, clean, noisy, args.corrs)
                  for e in (eng, cpu))
    shifted = [pb.blind_signals(eng, noisy + d) for d in (1e-6, -1e-6)]
    for i, c in enumerate(args.corrs):
        card[f"psnr@{c}"], host[f"psnr@{c}"] = card["psnrs"][i], \
            host["psnrs"][i]
    _hold_card_cpu("probe voronoi_mid (1 crop)", card, host, shifted,
                   [f"psnr@{c}" for c in args.corrs],
                   ("K_est", "sigma_est", "mad_ratio", "nsr"),
                   ("clip_lo", "clip_hi", "adaptive_corr"))
    return {"launches": launches, "best_corr_agree": agree,
            "adaptive_gain_db": float(gain), "artifact_gain_db":
            float(gain_art)}


def _same_tree(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return la.keys() == lb.keys() and all(_same_leaf(la[k], lb[k])
                                          for k in la)


def shipped_ckpt_tools(noisy, tmp) -> dict:
    """(e) the checkpoint recipe tools in a temporary directory on links
    to the committed checkpoints; every file they write reloads through
    train/ckpt.load_checkpoint."""
    from yondx_torch.cli import (compare_ckpts, fork_checkpoint,
                                 port_reference_checkpoint, port_s2d_init,
                                 port_s2d_tail, ship_weights)
    from yondx_torch.isp.bayer import bayer2rggb
    from yondx_torch.models.convert import params_to_state_dict
    from yondx_torch.models.registry import build_model
    from yondx_torch.models.torch_port import guidedresunet_to_torch
    from yondx_torch.models.unets import S2D64_ARCH, S2DT16_ARCH
    from yondx_torch.nle import moments
    from yondx_torch.train.ckpt import load_checkpoint
    from yondx_torch.train.s2d_port import S2D_PORT_MAP
    gru, s2d3, s2dt = ("Gaussian_GRU_mix_1to50c_norm_best_model.ckpt",
                       "Gaussian_GRUS2D3_mix_1to50c_norm_last_model.ckpt",
                       "Gaussian_GRUS2DT_mix_1to50c_norm_best_model.ckpt")
    d = os.path.join(tmp, "ckpts")
    os.makedirs(d)
    for f in (gru, s2d3, s2dt):
        os.symlink(os.path.join(CKPTS, f), os.path.join(d, f))
    rec, t = {}, time.perf_counter()
    flag = load_checkpoint(os.path.join(d, gru))["params"]
    # port_s2d_init: every ported stage is the flagship's leaf
    out = port_s2d_init.main(["--ckpt-dir", d, "--dst", "S2DInit"])
    got = params_to_state_dict(load_checkpoint(out["out"])["params"])
    fsd = params_to_state_dict(flag)
    same = all(torch.equal(v, fsd["unet." + S2D_PORT_MAP[k.split(".")[0]]
                                  + k[k.index("."):]])
               for k, v in got.items() if k.split(".")[0] in out["ported"])
    say("phase 20 (e)", f"port_s2d_init: ported {len(out['ported'])} "
        f"stages bit-equal to the flagship: {same}; fresh {out['fresh']}; "
        f"forward on the card ({time.perf_counter() - t:.2f} s)")
    if not same:
        raise AssertionError("phase 20 (e): port_s2d_init's stages differ")
    # port_s2d_tail: bit-identical output, on a crop of phase 5's frame
    t = time.perf_counter()
    out = port_s2d_tail.main(["--ckpt-dir", d, "--dst", "S2DTail"])
    src, ext = build_model(S2D64_ARCH), build_model(S2DT16_ARCH)
    src.load_state_dict(params_to_state_dict(
        load_checkpoint(os.path.join(d, s2d3))["params"]))
    ext.load_state_dict(params_to_state_dict(
        load_checkpoint(out["out"])["params"]))
    crop = bayer2rggb(torch.from_numpy(noisy[:512, :512]))[None]
    y = port_s2d_tail.identity_check(src.cuda().eval(), ext.cuda().eval(),
                                     "cuda", crop.numpy())
    say("phase 20 (e)", f"port_s2d_tail: {out['tail_params']} tail params; "
        f"the extended net's output bit-identical to the source's on the "
        f"card on [1, 128, 128, 4] noise and on a {tuple(crop.shape)} crop "
        f"of phase 5's frame (output finite: "
        f"{bool(np.isfinite(y).all())}; {time.perf_counter() - t:.2f} s)")
    # fork_checkpoint
    t = time.perf_counter()
    dst = fork_checkpoint.main(["Gaussian_GRUS2DT_mix_1to50c_norm", "Fork",
                                "--ckpt-dir", d])
    src_s = load_checkpoint(os.path.join(d, s2dt))
    fk = load_checkpoint(dst)
    fork_ok = (fk["epoch"], fk["best_psnr"], fk["opt_state"]) == (0, 0.0, {}) \
        and _same_tree(fk["params"], src_s["params"])
    try:
        fork_checkpoint.main(["Gaussian_GRUS2DT_mix_1to50c_norm", "Fork",
                              "--ckpt-dir", d])
        refused = False
    except FileExistsError:
        refused = True
    say("phase 20 (e)", f"fork_checkpoint: epoch {fk['epoch']}, best_psnr "
        f"{fk['best_psnr']}, opt_state {fk['opt_state']}, params bit-equal "
        f"to the source's: {fork_ok}; a second fork refused: {refused} "
        f"({time.perf_counter() - t:.2f} s)")
    if not (fork_ok and refused):
        raise AssertionError("phase 20 (e): fork_checkpoint")
    # ship_weights of a copy of the s2dt16 checkpoint
    t = time.perf_counter()
    copy = os.path.join(tmp, "s2dt16_copy.ckpt")
    with open(os.path.join(d, s2dt), "rb") as fi, open(copy, "wb") as fo:
        fo.write(fi.read())
    shipped = ship_weights.main([copy, os.path.join(tmp, "shipped.ckpt")])[0]
    sh = load_checkpoint(shipped["dst"])
    ship_ok = not sh["opt_state"] and sh["epoch"] == src_s["epoch"] and \
        sh["best_psnr"] == src_s["best_psnr"] and \
        _same_tree(sh["params"], src_s["params"])
    say("phase 20 (e)", f"ship_weights: {shipped['bytes_src']} -> "
        f"{shipped['bytes_dst']} bytes, params only, every leaf bit-equal: "
        f"{ship_ok} ({time.perf_counter() - t:.2f} s)")
    if not ship_ok:
        raise AssertionError("phase 20 (e): ship_weights")
    # port_reference_checkpoint of a .pth written from the gru32 net
    t = time.perf_counter()
    pth = os.path.join(tmp, "gru32.pth")
    torch.save({k: torch.from_numpy(np.array(v))
                for k, v in guidedresunet_to_torch(flag).items()}, pth)
    ported = port_reference_checkpoint.main(
        ["--pth", pth, "--out", os.path.join(tmp, "gru32_ported.ckpt")])
    ref_ok = _same_tree(load_checkpoint(ported["out"])["params"], flag)
    say("phase 20 (e)", f"port_reference_checkpoint: {ported['params']} "
        f"params from the .pth, bit-equal to the gru32 checkpoint: "
        f"{ref_ok} ({time.perf_counter() - t:.2f} s)")
    if not ref_ok:
        raise AssertionError("phase 20 (e): port_reference_checkpoint")
    # compare_ckpts over the gru32 and s2dt16 checkpoints
    t = time.perf_counter()
    moments.reset_launches()
    res = compare_ckpts.main([os.path.join(d, gru), os.path.join(d, s2dt)])
    torch.cuda.synchronize()
    launches = moments.LAUNCHES["nle_moments"]
    say("phase 20 (e)", "compare_ckpts (8 flat scenes of 8 crops): "
        + "; ".join(f"{r['arch']} mean {r['mean']:.4f} dB (noisy "
                    f"{r['noisy']:.4f})" for r in res)
        + f"; K1 launches {launches} ({time.perf_counter() - t:.2f} s)")
    if any(r["mean"] < r["noisy"] + 5.0 for r in res):
        raise AssertionError("phase 20 (e): compare_ckpts mean below noisy "
                             "+ 5 dB")
    if launches != 3 * 8 * len(res):
        raise AssertionError(f"phase 20 (e): K1 launched {launches} times, "
                             f"expected {3 * 8 * len(res)}")
    rec["compare"] = {r["arch"]: r["mean"] for r in res}
    rec["launches"] = launches
    return rec


def shipped_phase(noisy, scenes, cols9, out_dir) -> dict:
    """Phase 20: what the product ships, (a)-(e) (see the module
    docstring), in a temporary directory; prints each part's seconds."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rec, secs = {}, {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for label, fn in (
                ("ab", lambda: shipped_v2_columns(scenes, cols9, out_dir)),
                ("c", lambda: shipped_sweep(scenes, tmp)),
                ("d", lambda: shipped_probe(scenes, tmp)),
                ("e", lambda: shipped_ckpt_tools(noisy, tmp))):
            t = time.perf_counter()
            rec[label] = fn()
            secs[label] = time.perf_counter() - t
    rec["seconds"] = {**secs, "phase": time.perf_counter() - t0}
    say("phase 20", f"in {rec['seconds']['phase']:.2f} s: " + ", ".join(
        f"({k}) {v:.2f} s" for k, v in secs.items()))
    return rec


# 21. the probes behind the rescue gate, the iteration policy and the refine
# phase 20 (c)'s fault rungs' ffrac as an earlier run of this script read
# them on an NVIDIA H100 80GB HBM3 at 700 W, printed beside this run's
RUNG_FFRAC_H100 = [0.9024, 1.8481, 3.7409, 9.4208, 23.6212]
# the lines each probe's findings were written into: the TPU's history,
# printed beside the card's summaries, not targets
PROBE_HISTORY = {
    "floor": "docs/STATUS.md:45-57: fault rungs 1.85/3.7/9.4/23.6 "
             "(f=0.5..0.04), every suite scene <= 1.33, control rung 0.90",
    "iter_policy": "docs/STATUS.md:178-182: even the TRUE (K, sigma) second "
                   "pass matches-or-loses to round 0 + refine",
    "underest": "docs/STATUS.md:183-187: the robust self-NLE stays within "
                "~20% on darkfield content and the collab estimate is the "
                "one that collapses (policy correctly holds round 0)",
    "sigma_corr": "docs/STATUS.md:251-256: the optimal sigma_corr is "
                  "content-dependent (0.90-1.25, +-0.3 dB) at the TRUE "
                  "(K, sigma)",
    "alpha_boost": "scripts/probe_alpha_boost.py:5-8: 'local's too-low "
                   "floor accidentally boosts alpha and wins +3.8 dB on "
                   "satdisk_mid'",
    "droop": "docs/STATUS.md:369-372: radial_mid collab K 12.4 vs true "
             "12.0, it1 at the TRUE (K, sigma) -0.10 dB",
    "s2d_phase": "scripts/probe_s2d_phase.py:7-8: the held-out gap "
                 "profile ramp_mid -7.25 dB, glyphs ~0",
}


def _k1_run(label, fn, expected, phase="phase 21"):
    """fn() on the card with K1's launches counted around it -> (its
    result, {'launches', 'seconds'}); the count must be `expected`."""
    from yondx_torch.nle import moments
    torch.cuda.synchronize()
    moments.reset_launches()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    rec = {"launches": moments.LAUNCHES["nle_moments"],
           "seconds": time.perf_counter() - t}
    say(phase, f"{label} on the card in {rec['seconds']:.2f} s, K1 "
        f"launches {rec['launches']} (the code implies {expected})")
    if rec["launches"] != expected:
        raise AssertionError(f"{phase} {label}: K1 launched "
                             f"{rec['launches']} times, expected {expected}")
    return out, rec


def _history(key, line) -> None:
    say("phase 21", f"{line}; TPU history, not a target: "
        f"{PROBE_HISTORY[key]}")


def _one_crop(suite, name):
    from yondx_torch.eval import heldout
    spec = dataclasses.replace(next(s for s in heldout.SUITES[suite]
                                    if s.name == name), n_crops=1)
    return (spec, *heldout.build_scene(spec))


def _hold(label, flat, card, cpu, x, psnr_keys, sig_keys, exact_keys=()):
    """Phase 9e's rule (_hold_card_cpu) on flat(card side, x) against
    flat(cpu side, x), the card's spread from x +- 1e-6 -> the two
    rows. A noise model's beta2 (key '<name>_b2' beside '<name>_b1') may
    also be off by 1e-3 of the variance the pair gives at the scene's
    mean intensity mu: beta2 near 0 is ill-conditioned (a few % of that
    variance in droop's MAD collab estimate on zone_mid, which moved
    0.65% card vs CPU), as the CPU tests hold it."""
    rows = flat(card, x), flat(cpu, x)
    mu = float(np.mean(np.clip(x, 0.0, 1.0)))
    cpu_row = rows[1]
    floor = {k: 1e-3 * abs(cpu_row[k[:-1] + "1"] * mu + cpu_row[k])
             for k in sig_keys if k.endswith("_b2")}
    _hold_card_cpu(label, *rows, [flat(card, x + d) for d in (1e-6, -1e-6)],
                   psnr_keys, sig_keys, exact_keys, phase="phase 21",
                   floor=floor)
    return rows


def _pairs(**named) -> dict:
    """{'self': (b1, b2)} -> {'self_b1': b1, 'self_b2': b2}."""
    return {f"{k}_b{i + 1}": float(v[i]) for k, v in named.items()
            for i in (0, 1)}


def _pair_keys(*names) -> tuple:
    return tuple(f"{k}_b{i}" for k in names for i in (1, 2))


def probe_floor(scenes, rung_ffrac) -> dict:
    """(a) cli/probe_floor_discriminator: its ladder held to phase 20
    (c)'s rungs (the sweep's engine on the same scene and self fit)
    within 1e-3 relative, FIRE exactly where needs_rescue is, every suite
    scene held, ramp_big within 1% of JAX CPU's 1.3276; rung 0.5 and
    glyphs_lo (one crop) card vs CPU."""
    from yondx_torch.cli import probe_floor_discriminator as pf
    from yondx_torch.cli.sweep_policy import fault_scene
    res, rec = _k1_run(
        "probe_floor_discriminator",
        lambda: pf.run(pf.build_parser().parse_args([]), scenes=scenes),
        1 + len(pf.NAMES))
    ladder = [r["ffrac"] for r in res["faults"]]
    rel = max(abs(a / b - 1) for a, b in zip(ladder, rung_ffrac))
    fires = [r["fire"] for r in res["faults"]]
    suite = {r["case"]: r for r in res["scenes"]}
    top = max(suite, key=lambda k: suite[k]["ffrac"])
    rb = suite["ramp_big"]["ffrac"]
    _history("floor", "probe_floor_discriminator: rungs " + " / ".join(
        f"{v:.4f}" for v in ladder) + " (phase 20 (c) in this run "
        + " / ".join(f"{v:.4f}" for v in rung_ffrac) + ", an earlier "
        "H100 run's " + " / ".join(f"{v:.4f}" for v in RUNG_FFRAC_H100)
        + f"; largest relative difference {rel:.2e}), FIRE {fires}; "
        f"{len(suite)} suite scenes, highest ffrac {suite[top]['ffrac']:.4f}"
        f" ({top}), FIRE on {[k for k in suite if suite[k]['fire']]}; "
        f"ramp_big {rb:.4f} (JAX CPU {JAX_CPU_RAMP_BIG_FFRAC}, margin "
        f"{pf.GATE - rb:+.4f} to the gate)")
    if rel > 1e-3:
        raise AssertionError(f"phase 21 (a): the ladder is {rel:.2e} from "
                             "phase 20 (c)'s rungs")
    if fires != FAULT_NEEDS:
        raise AssertionError(f"phase 21 (a): FIRE {fires}, needs_rescue "
                             f"{FAULT_NEEDS}")
    if len(suite) != len(pf.NAMES) or any(r["fire"] for r in suite.values()):
        raise AssertionError("phase 21 (a): a suite scene fires")
    if abs(rb / JAX_CPU_RAMP_BIG_FFRAC - 1) > 0.01:
        raise AssertionError(f"phase 21 (a): ramp_big ffrac {rb:.4f}")
    _, fnoisy = fault_scene()
    _, _, gnoisy = _one_crop("v2", "glyphs_lo")
    for case, lr, f in (("rung 0.5", fnoisy, 0.5),
                        ("glyphs_lo 1 crop", gnoisy, 1.0)):
        def flat(dev, x, _f=f, _case=case):
            b1, b2 = pf.self_reg(x, dev)
            return pf.case_row(f"{_case} {dev}", x, (b1 * _f, b2 * _f * _f),
                               dev)
        _hold(f"floor {case}", flat, "cuda", "cpu", lr, (),
              ("ffrac", "floor", "beta1"), ("fire",))
    return {**rec, "ladder": ladder, "ramp_big": rb}


def probe_policy(scenes) -> dict:
    """(b) cli/probe_iter_policy at its defaults; voronoi_mid (one crop)
    card vs CPU."""
    from yondx_torch.cli import probe_iter_policy as pi
    from yondx_torch.vst.lut import BiasLUT
    args = pi.build_parser().parse_args([])
    den = pi.build_denoiser(args.model, "cuda")
    res, rec = _k1_run("probe_iter_policy", lambda: pi.run(
        args, scenes=scenes, den=den), 3 * len(args.scenes))
    _history("iter_policy", "probe_iter_policy: mean delta to it0, all / "
             "mid / min: " + "; ".join(
                 f"{t} {v['all']:+.3f} / {v['mid']:+.3f} / {v['min']:+.3f}"
                 for t, v in res["summary"].items()))
    spec, clean, noisy = _one_crop("v1", "voronoi_mid")
    lut = BiasLUT()

    def flat(d, x):
        r = pi.scene_row(d, lut, spec, clean, x)
        return {**{k: r[k] for k in ("noisy", "it0", "agree",
                                     *pi.POLICIES)},
                **_pairs(self=r["self"], collab=r["collab_reg"])}

    card, cpu = _hold("iter_policy voronoi_mid (1 crop)", flat, den,
                      pi.build_denoiser(args.model, "cpu"), noisy,
                      ("noisy", "it0", *pi.POLICIES),
                      _pair_keys("self", "collab"))
    # agree = |v_collab - v_self| / v_self subtracts two variances, each
    # held at 1e-3 above: within 2e-3 (1 + |agree|) (as the sweep's CPU
    # test holds it)
    gap = abs(card["agree"] - cpu["agree"])
    say("phase 21 cuda vs cpu", f"iter_policy voronoi_mid agree "
        f"{card['agree']:.6g}/{cpu['agree']:.6g} (allowed "
        f"{2e-3 * (1 + abs(cpu['agree'])):.2e})")
    if gap > 2e-3 * (1 + abs(cpu["agree"])):
        raise AssertionError("phase 21 (b): agree differs card vs CPU")
    return {**rec, "summary": res["summary"]}


def probe_underest() -> dict:
    """(c) cli/probe_underest_scene and (d) cli/probe_underest_e2e at
    their defaults (the e2e engine's gru32 in bf16); darkfield15 and
    darkclip_a card vs CPU (the engine in fp32 on both)."""
    from yondx_torch.cli import probe_underest_e2e as ue
    from yondx_torch.cli import probe_underest_scene as us
    res, rec_s = _k1_run("probe_underest_scene", lambda: us.run(
        us.build_parser().parse_args([])), len(us.CASES))
    res_e, rec_e = _k1_run("probe_underest_e2e", lambda: ue.run(
        ue.build_parser().parse_args([])), 3 * len(ue.CASES))
    _history("underest", "probe_underest_scene: self v_est / v_true "
             + ", ".join(f"{k} {r['ratio']:.3f}" for k, r in res.items())
             + "; probe_underest_e2e (gru32 bf16): it1 - it0, collab K "
             "(true K), rescue " + ", ".join(
                 f"{k} {r['it1'] - r['it0']:+.3f} dB, "
                 f"{r['collab'][0] * ue.SCALE:.2f} "
                 f"({r['true'][0] * ue.SCALE:.2f}), "
                 f"{'fired' if r['fired'] else 'held'}"
                 for k, r in res_e.items()))
    _, _, _, noisy = us.scenes()[0]

    def flat_s(dev, x):
        fit, mad, comb = us.self_estimate(x, dev)
        return _pairs(fit=fit, mad=mad, comb=comb)

    _hold("underest_scene darkfield15", flat_s, "cuda", "cpu", noisy, (),
          _pair_keys("fit", "mad", "comb"))
    _, K, sigma, clean, noisy = ue.scenes()[0]

    def flat_e(eng, x):
        r = ue.scene_row(eng, K, sigma, clean, x)
        return {"noisy": r["noisy"], "it0": r["it0"], "it1": r["it1"],
                "fired": float(r["fired"]),
                **_pairs(self=r["self"], collab=r["collab"])}

    _hold("underest_e2e darkclip_a (fp32)", flat_e,
          ue.build_engine("cuda", torch.float32),
          ue.build_engine("cpu", torch.float32), noisy,
          ("noisy", "it0", "it1"),
          _pair_keys("self", "collab"), ("fired",))
    return {"scene": rec_s, "e2e": rec_e,
            "ratio": {k: r["ratio"] for k, r in res.items()},
            "fired": {k: r["fired"] for k, r in res_e.items()}}


def probe_corr(scenes) -> dict:
    """(e) cli/probe_sigma_corr at its defaults; radial_mid (one crop,
    every corr) card vs CPU, the best corr equal."""
    from yondx_torch.cli import probe_sigma_corr as pc
    from yondx_torch.vst.lut import BiasLUT
    args = pc.build_parser().parse_args([])
    den = pc.build_denoiser(args, "cuda")
    res, rec = _k1_run("probe_sigma_corr", lambda: pc.run(
        args, scenes=scenes, den=den), 0)
    _history("sigma_corr", "probe_sigma_corr: best corr " + ", ".join(
        f"{k} {v:.2f}" for k, v in res["best"].items())
        + f"; median {res['median_best']:.3f}; spread of each scene's "
        "PSNR over the corrs " + ", ".join(
            f"{k} {max(v) - min(v):.3f}" for k, v in res["rows"].items())
        + " dB")
    spec, clean, noisy = _one_crop("v2", "radial_mid")
    lut = BiasLUT()

    def flat(d, x):
        ps = pc.scene_row(d, lut, spec, clean, x, args.corrs)
        return {**{f"psnr@{c}": v for c, v in zip(args.corrs, ps)},
                "best": float(args.corrs[int(np.argmax(ps))])}

    _hold("sigma_corr radial_mid (1 crop)", flat, den,
          pc.build_denoiser(args, "cpu"), noisy,
          [f"psnr@{c}" for c in args.corrs], (), ("best",))
    return {**rec, "best": res["best"], "median_best": res["median_best"]}


def probe_alpha(scenes) -> dict:
    """(f) cli/probe_alpha_boost at its defaults; satdisk_mid (one crop)
    card vs CPU."""
    from yondx_torch.cli import probe_alpha_boost as pa
    from yondx_torch.vst.lut import BiasLUT
    args = pa.build_parser().parse_args([])
    den = pa.build_denoiser(args.model, "cuda")
    res, rec = _k1_run("probe_alpha_boost", lambda: pa.run(
        args, scenes=scenes, den=den), len(args.scenes))
    _history("alpha_boost", "probe_alpha_boost: PSNR over the Wiener "
             "weight, " + "; ".join(
                 f"{k} (wiener {r['psnr']['wiener']:.2f}) " + ", ".join(
                     f"{t} {p - r['psnr']['wiener']:+.2f}"
                     for t, p in r["psnr"].items() if t != "wiener")
                 for k, r in res.items()))
    _, clean, noisy = _one_crop("v2", "satdisk_mid")
    lut = BiasLUT()

    def flat(d, x):
        r = pa.scene_row(d, lut, clean, x)
        return {**{k: r[k] for k in ("q50", "q90", "q99", "frac_hi")},
                **r["psnr"]}

    _hold("alpha_boost satdisk_mid (1 crop)", flat, den,
          pa.build_denoiser(args.model, "cpu"), noisy,
          [t for t, _ in pa.TRANSFORMS], ("q50", "q90", "q99", "frac_hi"))
    return {**rec, "psnr": {k: r["psnr"] for k, r in res.items()}}


def probe_droop(scenes) -> dict:
    """(g) cli/probe_droop at its defaults (radial_mid); zone_mid (one
    crop) card vs CPU: radial_mid's flat-mask collab fit turns on
    rounding (round 0 leaves it ~53 dB clean; ROADMAP section 3)."""
    from yondx_torch.cli import probe_droop as pd
    from yondx_torch.vst.lut import BiasLUT
    args = pd.build_parser().parse_args([])
    den = pd.build_denoiser(args, "cuda")
    res, rec = _k1_run("probe_droop", lambda: pd.run(
        args, scenes=scenes, den=den), 5 * len(args.scenes))
    _history("droop", "probe_droop: " + "; ".join(
        f"{k} it0 {r['it0']:.2f}, collab (fit / MAD / combined) K "
        f"{r['fit'][0] * 959:.2f} / {r['mad'][0] * 959:.2f} / "
        f"{r['comb'][0] * 959:.2f}, it1 - it0 " + ", ".join(
            f"{t} {c['psnr'] - r['it0']:+.2f}" for t, c in r["it1"].items())
        for k, r in res.items()))
    spec, clean, noisy = _one_crop("v1", "zone_mid")
    lut = BiasLUT()

    def flat(d, x):
        r = pd.scene_row(d, lut, spec, clean, x)
        return {"noisy": r["noisy"], "it0": r["it0"],
                **{f"it1_{t}": c["psnr"] for t, c in r["it1"].items()},
                **_pairs(self=r["self"], fit=r["fit"], mad=r["mad"],
                         comb=r["comb"])}

    _hold("droop zone_mid (1 crop)", flat, den,
          pd.build_denoiser(args, "cpu"), noisy,
          ("noisy", "it0", "it1_collab", "it1_true", "it1_self"),
          _pair_keys("self", "fit", "mad", "comb"))
    return {**rec, "it0": {k: r["it0"] for k, r in res.items()}}


def probe_s2d() -> dict:
    """(h) cli/probe_s2d_phase at its defaults (one crop a scene); ramp_mid
    card vs CPU."""
    from yondx_torch.cli import probe_s2d_phase as ps
    from yondx_torch.eval import heldout
    from yondx_torch.vst.lut import BiasLUT
    args = ps.build_parser().parse_args([])
    dens = ps.build_denoisers("cuda")
    crops = {}
    t = time.perf_counter()
    for name in args.scenes:
        spec = next(s for s in heldout.HELDOUT_SCENES if s.name == name)
        crops[(name, 1)] = heldout.build_scene(spec, 1)
    say("phase 21", f"built the s2d probe's {len(crops)} one-crop scenes on "
        f"the host in {time.perf_counter() - t:.2f} s")
    res, rec = _k1_run("probe_s2d_phase", lambda: ps.run(
        args, scenes=crops, dens=dens), 0)
    _history("s2d_phase", "probe_s2d_phase: s2d - flag PSNR, grid share "
             "(flag / s2d), s2d with flag's grid part - s2d: " + "; ".join(
                 f"{k} {r['s2d']['psnr'] - r['flag']['psnr']:+.2f} dB, "
                 f"{r['flag']['grid_share']:.2f} / "
                 f"{r['s2d']['grid_share']:.2f}, "
                 f"{r['s2d_flag_grid'] - r['s2d']['psnr']:+.2f} dB"
                 for k, r in res.items()))
    spec = next(s for s in heldout.HELDOUT_SCENES if s.name == "ramp_mid")
    clean, noisy = crops[("ramp_mid", 1)]
    lut = BiasLUT()

    def flat(d, x):
        r = ps.scene_row(d, lut, spec, clean[0], x)
        return {"noisy": r["noisy"], "s2d_flag_grid": r["s2d_flag_grid"],
                **{f"{t}_{k}": r[t][k] for t in ("flag", "s2d")
                   for k in ("psnr", "low_mse", "grid_mse", "grid_share")}}

    _hold("s2d_phase ramp_mid (1 crop)", flat, dens,
          ps.build_denoisers("cpu"), noisy[0],
          ("noisy", "flag_psnr", "s2d_psnr", "s2d_flag_grid"),
          tuple(f"{t}_{k}" for t in ("flag", "s2d")
                for k in ("low_mse", "grid_mse", "grid_share")))
    return {**rec, "gap_db": {k: r["s2d"]["psnr"] - r["flag"]["psnr"]
                              for k, r in res.items()}}


def probes_phase(scenes, phase20) -> dict:
    """Phase 21: the probes behind the rescue gate, the iteration policy
    and the refine, (a)-(h) (see the module docstring), on phase 9's
    scenes; each part's K1 launches held to what its code implies and
    its seconds printed. TF32 off."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rec, secs = {}, {}
    t0 = time.perf_counter()
    for label, fn in (
            ("a", lambda: probe_floor(scenes, phase20["c"]["rung_ffrac"])),
            ("b", lambda: probe_policy(scenes)),
            ("cd", probe_underest),
            ("e", lambda: probe_corr(scenes)),
            ("f", lambda: probe_alpha(scenes)),
            ("g", lambda: probe_droop(scenes)),
            ("h", probe_s2d)):
        t = time.perf_counter()
        rec[label] = fn()
        secs[label] = time.perf_counter() - t
    rec["seconds"] = {**secs, "phase": time.perf_counter() - t0}
    say("phase 21", f"in {rec['seconds']['phase']:.2f} s: " + ", ".join(
        f"({k}) {v:.2f} s" for k, v in secs.items()))
    return rec


# 22. the one-off benches and trainers --------------------------------------
# what the scripts these CLIs port measured on the TPU: history printed
# beside the card's rows, not targets
ONEOFF_HISTORY = {
    "loader": "docs/STATUS.md:574-577: loader = 0.74% of step time "
              "steady-state at batch 64 (a v5e step of ~0.29 s)",
    "robust": "docs/STATUS.md:274-276: self 9.1 ms / collab 13.5 ms at "
              "2^18 cells (amortised in-graph scan timings)",
    "chroma": "docs/STATUS.md:394-396: R +0.089 / B -0.090 at B/G 2.8 on "
              "the nets before the chroma fine-tune",
    "roofline": "docs/STATUS.md:445-460: whole GuidedResUnet 65.0 ms at "
                "[1,1792,1792,4] bf16, the isolated convs' sum 239 ms, "
                "conv3x3 32->32..256 ~11 ms each",
}
CHROMA_CKPTS = ["checkpoints/Gaussian/Gaussian_GRU_mix_1to50c_norm_best_"
                "model.ckpt",
                "checkpoints/Gaussian/Gaussian_GRU_mix_5to50_norm_best_"
                "model.ckpt"]
# dense bf16 tensor-core peak of the cards in _PEAKS (NVIDIA data sheet,
# at the full power limit)
_BF16_PEAKS = {"H100 80GB HBM3": 989e12}


# where a training runfile writes, relative to the working directory (the
# Gaussian runfiles' fast_ckpt, checkpoint and result_dir, ./logs/) and
# the one-off trainers' default --out
RUNFILE_OUTPUTS = ("checkpoints", "saved_model", "images", "logs", "runs")


def _files(root) -> list:
    """Every file under `root`."""
    return sorted(os.path.join(d, n) for d, _, names in os.walk(root)
                  for n in names)


def _outputs_state() -> dict:
    """path -> (size, mtime_ns) of every file under the repo's
    RUNFILE_OUTPUTS directories."""
    return {p: (st.st_size, st.st_mtime_ns)
            for d in RUNFILE_OUTPUTS for p in _files(_repo(d))
            for st in (os.stat(p),)}


def _sha256(path) -> str:
    import hashlib
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def oneoff_trainers(tmp) -> dict:
    """(a) `train_gru 1` and `train_unet 1` under --out tmp/<name>: one
    epoch of 32 steps of batch 64 over the 2048-crop synthetic set, then
    eval(epoch=-1) at sigma 25 (the CLI's) and 10 and 50 on 64 crops.
    Held: epoch 1 reached, 32 steps, every loss finite."""
    from yondx_torch.cli import train_gru, train_unet
    from yondx_torch.data.datasets import SyntheticSRGBDataset
    n_train, n_eval = (train_gru.SYNTHETIC_LEN[k]
                       for k in ("dst_train", "dst_eval"))
    t = time.perf_counter()
    SyntheticSRGBDataset(length=n_train, size=256, seed=1997)
    SyntheticSRGBDataset(length=n_eval, size=256, seed=2024)
    rec = {"set_s": time.perf_counter() - t}
    say("phase 22", f"(a) the {n_train}-crop training set and the "
        f"{n_eval}-crop eval set through the port's disk cache in "
        f"{rec['set_s']:.2f} s")
    for name, cli in (("train_gru", train_gru), ("train_unet", train_unet)):
        out = os.path.join(tmp, name)
        res, k1 = _k1_run(f"(a) {name} 1 --out {out}",
                          lambda: cli.main(["1", "--out", out]), 0,
                          phase="phase 22")
        tr = res["trainer"]
        losses = [s["loss"] for s in tr.steps]
        n_steps = res["args"]["dst_train"]["synthetic_len"] // \
            res["args"]["hyper"]["batch_size"]
        if tr.epoch != 1 or len(losses) != n_steps or \
                not np.all(np.isfinite(losses)):
            raise AssertionError(f"phase 22 (a) {name}: epoch {tr.epoch}, "
                                 f"{len(losses)} steps, losses {losses}")
        step_ms = 1e3 * float(np.median([s["step_s"] for s in tr.steps[2:]]))
        psnr = {25: res["eval"][0]}
        with contextlib.chdir(out):           # eval logs to ./logs/
            for sigma in (10, 50):
                psnr[sigma] = tr.eval(epoch=-1, sigma=sigma)[0]
        written = [os.path.relpath(p, out) for p in _files(out)]
        arch = res["args"]["arch"]
        say("phase 22", f"(a) {name}: {arch['name']} nf={arch['nf']}, "
            f"{step_ms:.2f} ms/step (median of steps 3-{n_steps}), loss "
            f"{losses[0]:.5f} -> {losses[-1]:.5f}, train PSNR "
            f"{tr.train_psnr.avg:.4f} dB; eval PSNR after one epoch "
            + " / ".join(f"{psnr[s]:.4f}" for s in (10, 25, 50))
            + f" dB at sigma 10 / 25 / 50; files under --out: {written}")
        rec[name] = {**k1, "step_ms": step_ms, "psnr": psnr,
                     "loss": [losses[0], losses[-1]]}
        del tr, res
    return rec


def oneoff_chunked(tmp) -> dict:
    """(b) `train_chunked runfiles/Gaussian/GRU_5to50_norm_mix.yml 10 10`
    under --out tmp/chunked, twice: the first chunk trains epochs 1-10,
    saves `last` at epoch 10, evaluates and says DONE; the second resumes
    at epoch 10 and says DONE without a step. Held: one chunk, rc 0 and
    DONE in each run; 10 epochs logged in the first and none in the
    second; the `last` checkpoint at epoch 10 and the same file after the
    second run. K1 is counted in this process; the chunks run the
    trainer of (a), which launches none."""
    from yondx_torch.cli import train_chunked
    from yondx_torch.io.ckpt import load_checkpoint
    out = os.path.join(tmp, "chunked")
    argv = [TRAIN_RUNFILE, "10", "10", "--out", out]
    last = os.path.join(out, "ckpt",
                        "Gaussian_GRU_mix_5to50_norm_last_model.ckpt")
    rec = {"runs": []}
    for i in range(2):
        res, k1 = _k1_run(f"(b) train_chunked run {i + 1}",
                          lambda: train_chunked.main(argv), 0,
                          phase="phase 22")
        chunks = res["chunks"]
        text = chunks[-1]["text"]
        epochs = len(re.findall(r"Epoch \d+: lr=", text))
        run = {**k1, "chunks": len(chunks), "rc": chunks[-1]["rc"],
               "epochs": epochs, "sha256": _sha256(last)}
        say("phase 22", f"(b) run {i + 1}: {len(chunks)} chunk(s), rc "
            f"{run['rc']}, {epochs} epochs logged, DONE "
            f"{'DONE' in text}, last checkpoint {run['sha256'][:12]}")
        want_epochs = 10 if i == 0 else 0
        if len(chunks) != 1 or run["rc"] != 0 or "DONE" not in text or \
                epochs != want_epochs or \
                ("chunk finished at epoch 10" in text) != (i == 0):
            raise AssertionError(f"phase 22 (b) run {i + 1}: {run}; the "
                                 f"chunk's output:\n{text}")
        rec["runs"].append(run)
    epoch = int(load_checkpoint(last)["epoch"])
    if epoch != 10 or rec["runs"][0]["sha256"] != rec["runs"][1]["sha256"]:
        raise AssertionError(f"phase 22 (b): the last checkpoint is at "
                             f"epoch {epoch} or changed in the second run")
    rec["launches"] = sum(r["launches"] for r in rec["runs"])
    return rec


def oneoff_loader(tmp, step_s) -> dict:
    """(c) bench_loader at its defaults (1024 files, batch 64, 48 steps,
    8 workers) with --step-time phase 10b's gru32 step. Its corpus is
    written from the first 1024 crops of (a)'s 2048-crop set: a crop of
    SyntheticSRGBDataset depends on its index, seed, size and version
    alone, not on the set's length (yondx_torch/data/datasets.py
    `_generate`); three files are held bit-equal to the generator's
    output. Held: exit code 0, the gate (wait under 5%)."""
    from yondx_torch.cli import bench_loader
    from yondx_torch.data.datasets import SyntheticSRGBDataset
    from yondx_torch.cli.train_gru import SYNTHETIC_LEN
    n = bench_loader.build_parser().parse_args([]).n
    root = os.path.join(tmp, "loader")
    d = os.path.join(root, "train")
    os.makedirs(d)
    t = time.perf_counter()
    cached = SyntheticSRGBDataset(length=SYNTHETIC_LEN["dst_train"],
                                  size=256, seed=1997)
    for i in range(n):
        np.save(os.path.join(d, f"crop_{i:05d}.npy"), cached[i])
    copy_s = time.perf_counter() - t
    gen = SyntheticSRGBDataset(length=n, size=256, cache=False,
                               disk_cache=None)
    for i in (0, n // 2, n - 1):
        if not np.array_equal(np.load(os.path.join(d, f"crop_{i:05d}.npy")),
                              gen[i]):
            raise AssertionError(f"phase 22 (c): crop {i} of the cached set "
                                 "is not the generator's")
    res, k1 = _k1_run("(c) bench_loader", lambda: bench_loader.main(
        ["--root", root, "--step-time", repr(step_s)]), 0, phase="phase 22")
    worst = 1e3 * max(res["waits"])
    say("phase 22", f"(c) bench_loader at a {step_s * 1e3:.2f} ms step "
        f"(phase 10b's gru32): wait {res['wait_ms']:.3f} ms/step = "
        f"{res['pct']:.3f}% (gate < 5%), worst single wait {worst:.2f} ms; "
        f"cold epoch {res['n_cold']} batches in {res['cold_s']:.2f} s; "
        f"corpus written from the cache in {copy_s:.2f} s (its check in "
        f"the CLI {res['corpus_s']:.3f} s); TPU history, not a target: "
        f"{ONEOFF_HISTORY['loader']}")
    if res["rc"] != 0:
        raise AssertionError(f"phase 22 (c): the loader waits "
                             f"{res['pct']:.2f}% of the step, over 5%")
    return {**k1, "step_ms": step_s * 1e3, "wait_ms": res["wait_ms"],
            "pct": res["pct"], "worst_ms": worst, "cold_s": res["cold_s"],
            "copy_s": copy_s}


def oneoff_robust() -> dict:
    """(d) bench_robust_overhead: its rows; the MAD self and collab regs
    card against the port's CPU at rtol 1e-3 (the robust NLE's parity
    bound), or within 1e-3 of the variance (beta1 mu + beta2) the CPU's
    pair gives at the frame's mean intensity mu (the fit clamps a
    negative beta1 to 0, and this frame's noise is Gaussian alone);
    hist_two's counts equal to hist_one's, sum_m within 1e-6 relative
    (float64 sums on the card)."""
    from yondx_torch.cli import bench_robust_overhead as bro
    res, k1 = _k1_run("(d) bench_robust_overhead", lambda: bro.main([]), 0,
                      phase="phase 22")
    noisy, clean = bro.make_frame(*bro.FRAME)
    x, dn = torch.from_numpy(noisy), torch.from_numpy(clean)
    cpu = {"self": bro.mad_self_estimate(x),
           "collab": bro.mad_collab_estimate(x, dn)}
    mu = float(noisy.mean())
    for key, pair in cpu.items():
        want = np.array([float(v) for v in pair])
        got = np.array([float(v) for v in res[key]])
        scale = np.array([mu, 1.0])       # each reg's share of variance
        var = float(want @ scale)
        err = np.abs(got - want) * scale
        say("phase 22", f"(d) {key} regs card {got.tolist()} cpu "
            f"{want.tolist()}, variance at mu {mu:.4f}: {var:.4e}")
        if not np.all(err <= np.maximum(1e-3 * np.abs(want) * scale,
                                        1e-3 * var)):
            raise AssertionError(f"phase 22 (d): {key} regs card {got} "
                                 f"against cpu {want}")
    (c2, s2), (c1, s1) = res["hist_two"], res["hist_one"]
    rel = float(np.max(np.abs(s1 - s2) / np.maximum(np.abs(s2), 1e-30)))
    if not np.array_equal(c2, c1.reshape(-1)) or rel > 1e-6:
        raise AssertionError(f"phase 22 (d): the histogram layouts differ "
                             f"(sum_m {rel:.3e} relative)")
    say("phase 22", "(d) ms per op: " + ", ".join(
        f"{k} {v:.4f}" for k, v in res["rows"].items())
        + f"; hist layouts: counts equal, sum_m {rel:.2e} relative; TPU "
        f"history, not a target: {ONEOFF_HISTORY['robust']}")
    return {**k1, "rows": res["rows"], "sum_m_rel": rel}


def oneoff_chroma() -> dict:
    """(e) chroma_probe on the committed 1to50c and 5to50 flagships at
    sigma 5, card against CPU (TF32 off): every bias within 1e-4."""
    from yondx_torch.cli import chroma_probe
    card, k1 = _k1_run("(e) chroma_probe", lambda: chroma_probe.main(
        [*CHROMA_CKPTS, "--sigma", "5"]), 0, phase="phase 22")
    with contextlib.redirect_stdout(io.StringIO()):
        cpu = chroma_probe.main([*CHROMA_CKPTS, "--sigma", "5", "--cpu"])
    err = max(float(np.abs(card[p]["bias"][r] - cpu[p]["bias"][r]).max())
              for p in CHROMA_CKPTS for r in chroma_probe.RATIOS)
    rows = {os.path.basename(p)[:-len("_best_model.ckpt")]: {
        "bias_2.8": card[p]["bias"][2.8].tolist(), "worst": card[p]["worst"]}
        for p in CHROMA_CKPTS}
    say("phase 22", "(e) at B/G 2.8: " + "; ".join(
        f"{k} R {v['bias_2.8'][0]:+.4f} B {v['bias_2.8'][3]:+.4f} (worst "
        f"{v['worst']:.4f})" for k, v in rows.items())
        + f"; card vs CPU max |diff| {err:.2e}; TPU history, not a target: "
        f"{ONEOFF_HISTORY['chroma']}")
    if err > 1e-4:
        raise AssertionError(f"phase 22 (e): biases card vs CPU {err:.3e}")
    return {**k1, "rows": rows, "max_abs_diff": err}


def oneoff_roofline(fp32_peak, bf16_peak) -> dict:
    """(f) unet_roofline at its defaults (1792 x 1792, bf16, reps 10),
    then --dtype f32 (TF32 off), on one input drawn once from numpy's
    default_rng(2) (the times do not depend on the values; the CLI's own
    draw, JAX's normal through core.rng, costs seconds of host time at
    this size and is held at 64 x 64 by the CPU tests). Held: the
    inventory (tags, multiplicities) equal to a CPU run's at 64 x 64 and
    its FLOPs those times (1792 / 64)^2; every time positive and finite;
    the whole net's forward sum at 64 x 64 in f32 card vs CPU within
    rtol 1e-4."""
    from yondx_torch.cli import unet_roofline as ur
    defaults = ur.build_parser().parse_args([])
    x4 = np.random.default_rng(2).standard_normal(
        (1, defaults.H, defaults.W, 4), dtype=np.float32)
    res, rec = {}, {"launches": 0, "seconds": 0.0}
    for dt in ("bf16", "f32"):
        args = ur.build_parser().parse_args(["--dtype", dt])
        res[dt], k1 = _k1_run(f"(f) unet_roofline --dtype {dt}",
                              lambda: ur.run(args, x4), 0, phase="phase 22")
        rec = {k: rec[k] + k1[k] for k in rec}
    small = ["--H", "64", "--W", "64", "--reps", "1", "--dtype", "f32"]
    with contextlib.redirect_stdout(io.StringIO()):
        card64, cpu64 = ur.main(small), ur.main([*small, "--cpu"])
    scale = defaults.H * defaults.W / 64 ** 2
    want = [(r["tag"], r["n"], r["flops"] * scale) for r in cpu64["rows"]]
    for dt, r in res.items():
        got = [(x["tag"], x["n"], x["flops"]) for x in r["rows"]]
        times = [x["ms"] for x in r["rows"] + r["lane"]] + [r["net_ms"]]
        if got != want or not all(np.isfinite(t) and t > 0 for t in times):
            raise AssertionError(f"phase 22 (f) {dt}: inventory {got} "
                                 f"against the CPU's {want}, times {times}")
        peak = bf16_peak if dt == "bf16" else fp32_peak
        say("phase 22", f"(f) {dt}: " + "; ".join(
            f"{x['tag']} x{x['n']} {x['ms']:.3f} ms {x['tflops']:.1f} TF/s "
            f"({100 * x['tflops'] * 1e12 / peak:.1f}%)" for x in r["rows"])
            + f"; isolated sum {r['sum_ms']:.2f} ms, whole net "
            f"{r['net_ms']:.2f} ms ({r['mps']:.1f} MP/s), slack "
            f"{r['slack_pct']:+.1f}%; lane refs " + ", ".join(
                f"32->{x['cout']} {x['ms']:.3f} ms {x['tflops']:.1f} TF/s"
                for x in r["lane"])
            + f" (% of {peak / 1e12:.0f} TF/s, the {dt} peak)")
    rel = abs(card64["net_sum"] - cpu64["net_sum"]) / abs(cpu64["net_sum"])
    say("phase 22", f"(f) whole net at 64 x 64 f32: sum card "
        f"{card64['net_sum']:.6f} cpu {cpu64['net_sum']:.6f} ({rel:.2e} "
        f"relative); TPU history, not a target: "
        f"{ONEOFF_HISTORY['roofline']}")
    if rel > 1e-4:
        raise AssertionError(f"phase 22 (f): the net's sum card vs CPU "
                             f"{rel:.3e} relative")
    return {**rec, **{dt: {k: r[k] for k in ("sum_ms", "net_ms", "mps",
                                               "slack_pct")}
                      | {"rows": {x["tag"]: x["ms"] for x in r["rows"]},
                         "lane": {x["cout"]: x["ms"] for x in r["lane"]}}
                      for dt, r in res.items()}}


def oneoff_phase(step_s, fp32_peak, peak_key) -> dict:
    """Phase 22: the one-off benches and trainers (yondx_torch.cli's
    train_gru, train_unet, train_chunked, bench_loader,
    bench_robust_overhead, chroma_probe, unet_roofline), (a)-(f) (see the
    module docstring); TF32 off. K1 is held to 0 launches around each
    part; no file under the repo's RUNFILE_OUTPUTS directories changes or
    appears (the trainers write under their --out), and every file under
    checkpoints/ keeps its sha256."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ckpts = {p: _sha256(p) for p in _files(_repo("checkpoints"))}
    state = _outputs_state()
    rec, secs = {}, {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for label, fn in (
                ("a", lambda: oneoff_trainers(tmp)),
                ("b", lambda: oneoff_chunked(tmp)),
                ("c", lambda: oneoff_loader(tmp, step_s)),
                ("d", oneoff_robust),
                ("e", oneoff_chroma),
                ("f", lambda: oneoff_roofline(fp32_peak,
                                              _BF16_PEAKS[peak_key]))):
            t = time.perf_counter()
            rec[label] = fn()
            secs[label] = time.perf_counter() - t
    after = _outputs_state()
    changed = sorted(p for p in set(state) | set(after)
                     if state.get(p) != after.get(p))
    moved = sorted(p for p, h in ckpts.items() if _sha256(p) != h)
    if changed or moved:
        raise AssertionError(f"phase 22 wrote under the repo: {changed}; "
                             f"checkpoints changed: {moved}")
    rec["seconds"] = {**secs, "phase": time.perf_counter() - t0}
    say("phase 22", f"in {rec['seconds']['phase']:.2f} s: " + ", ".join(
        f"({k}) {v:.2f} s" for k, v in secs.items()) + "; no file under "
        f"the repo's {'/, '.join(RUNFILE_OUTPUTS)}/ changed, the "
        f"{len(ckpts)} files under checkpoints/ with their sha256")
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
    # K1's error against the plain version in float64 at each timed shape
    err64 = {"a": k1_err64(x_a, k, inner), "w": k1_err64(frame_a, k, inner),
             **{lab[0]: k1_err64(x, k, inner) for lab, x in cases
                if lab[0] in "hi"}}
    for label, tim, plain in (("a", timing, ms_plain),
                              ("w", timing_w, ms_plain_w),
                              *((lab, tim, None)
                                for lab, tim in timing_h.items())):
        say("K1 timing", label + ", cold L2, host enqueue included ("
            + peak_key + " peaks): " + "; ".join(
                f"{f} {ms:.4f} ms, bound {b:.4f} ms by {by} "
                f"({mb / 1e6:.1f} MB), {ms / b:.1f}x"
                for f, (ms, b, by, mb) in tim.items())
            + (f"; plain (self) {plain:.4f} ms" if plain else "")
            + "; max abs err against float64: "
            + fmt_err64(err64[label[0]]))
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
    with _frame_file(noisy) as path:
        profile_run("profile", lambda: fused(rggb, scale),
                    ("child_product", {"frame": path}))
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
    heldout_launches, scenes, pge_mean, cols9 = heldout_gate(out_dir)

    # 10. training (trainer_awgn's AWGNTrainer) ------------------------------
    gru32_step_s = train_phase(fp32, peak_key)

    # 11. noise-estimation training (train_est's PGEstTrainer) -------------
    k19 = est_train_phase(bw, fp32, scenes, pge_mean, out_dir)

    # 12. the 'unetn' denoiser, the est_* block, the host BM3D ---------------
    phase12 = unetn_phase(noisy, clean, scenes, fp32, peak_key, out_dir)

    # 13. the runfiles' eval and test modes (SIDD, ELD, LRID, DND) ---------
    phase13 = eval_phase(out_dir)

    # 14. every option of the fused entry -----------------------------------
    phase14 = options_phase(noisy, clean, bw, fp32)

    # 15. the bias-table builders on the host --------------------------------
    builders_phase()

    # 16. the comparison zoo and the FBI blind-spot denoiser ----------------
    zoo_phase(noisy)

    # 17. one frame's rows over a mesh, the data-parallel trainer ---------
    phase17 = mesh_phase(bw, fp32)
    max_err = max(max_err, *(f["max_abs_err"]
                             for f in phase17["k1"].values()
                             if isinstance(f, dict)))

    # 18. the ISP and the figure tools --------------------------------------
    phase18 = isp_phase(noisy)

    # 19. orbax checkpoints and DND's MATLAB v7.3 files -----------------------
    t = time.perf_counter()
    phase19 = ckpt_phase(noisy, smi)
    say("phase 19", f"in {time.perf_counter() - t:.2f} s")

    # 20. what the product ships: v2 artifacts, sweep, probe, ckpt tools ----
    phase20 = shipped_phase(noisy, scenes, cols9, out_dir)

    # 21. the probes behind the rescue gate, iteration policy and refine ----
    phase21 = probes_phase(scenes, phase20)

    # 22. the one-off benches and trainers -----------------------------------
    phase22 = oneoff_phase(gru32_step_s, fp32, peak_key)

    record = {"kernels": [{
        "name": "nle_moments", "route": "cuda",
        "source": "yondx_torch/csrc/nle_moments.cu",
        "replaces": "yondx/nle/pallas_ops.py:54",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms_k1, "plain_ms": ms_plain, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        # against the plain version in float64, per flavour and map, at
        # each timed shape of phase 3 (a: bands, w: whole planes, h and i:
        # crop stacks)
        "err64": err64,
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
        "phase13": phase13,
        # phase 14: the bench_matrix settings and the product
        # configuration's options on the 3072x4096 frame (3 a frame, 5 at
        # max_iter 2), and K1 at k = 19 and 41 against its plain version
        "phase14": phase14,
        # phase 17: the sharded route at world 1 on the 50.3 MP frame (3
        # a frame on each rank's halo rows: the CLI run and 2 timed
        # frames), K1 against its plain version at the shard's shape
        # [1, 3130, 4096, 4]
        "phase17": phase17,
        # phase 18: the product frame traced through core.profiling (3),
        # the SIDD eval with and without figures (3 a scene)
        "phase18": {"launches": {"trace_frame": phase18["a"]["launches"],
                                 "sidd_figures": phase18["c"]["launches"]},
                    **phase18},
        # phase 19: DND's MATLAB v7.3 fixture through DNDDataset and
        # denoise_dnd (3 a box)
        "phase19": {"launches": {"dnd_fixture": phase19["c"]["launches"]},
                    **phase19},
        # phase 20: the v2 columns (3 a scene, 108 a column), the sweep (3
        # a scene and a rung: 123), the probe (1 a scene: 33),
        # compare_ckpts (3 a scene: 48)
        "phase20": {"launches": {**phase20["ab"]["launches"],
                                 "sweep": phase20["c"]["launches"],
                                 "probe": phase20["d"]["launches"],
                                 "compare_ckpts": phase20["e"]["launches"]},
                    **phase20},
        # phase 21: the probes at their defaults (floor 13, iter_policy 3
        # a scene: 30, underest_scene 4, underest_e2e 3 a scene: 12,
        # sigma_corr 0, alpha_boost 6, droop 5, s2d_phase 0)
        "phase21": {"launches": {
            "probe_floor_discriminator": phase21["a"]["launches"],
            "probe_iter_policy": phase21["b"]["launches"],
            "probe_underest_scene": phase21["cd"]["scene"]["launches"],
            "probe_underest_e2e": phase21["cd"]["e2e"]["launches"],
            "probe_sigma_corr": phase21["e"]["launches"],
            "probe_alpha_boost": phase21["f"]["launches"],
            "probe_droop": phase21["g"]["launches"],
            "probe_s2d_phase": phase21["h"]["launches"]},
            **phase21},
        # phase 22: the one-off benches and trainers (0 in each part: no
        # NLE fit on their paths; (b)'s chunks run (a)'s trainer in
        # processes of their own)
        "phase22": {"launches": {
            "train_gru_unet": sum(phase22["a"][n]["launches"]
                                  for n in ("train_gru", "train_unet")),
            "train_chunked": phase22["b"]["launches"],
            "bench_loader": phase22["c"]["launches"],
            "bench_robust_overhead": phase22["d"]["launches"],
            "chroma_probe": phase22["e"]["launches"],
            "unet_roofline": phase22["f"]["launches"]},
            **phase22}}]}
    say("done", f"all 22 phases in {time.perf_counter() - T0:.2f} s")
    print(json.dumps(record), flush=True)
    return {"ok": True, "device": {"platform": "gpu", "kind": name,
                                   "count": torch.cuda.device_count()}}


if __name__ == "__main__":
    result = main()
    print(json.dumps(result), flush=True)
    sys.exit(0)
