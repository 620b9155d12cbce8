"""UNet conv roofline audit on the card (port of scripts/unet_roofline.py,
same flags).

    python -m yondx_torch.cli.unet_roofline [--H 1792] [--W 1792] [--reps 10] [--dtype bf16|f32] [--cpu]

Times every conv shape of the GuidedResUnet nf=32 forward at the bench
frame's resolution alone — conv_in 4->32; per scale s = 0..3 at
H/2^s with f = 32 * 2^s the four 3x3 f->f convs of its down and up
blocks, the up block's 1x1 2f->f and the stride-2 3x3 f->2f pool; the
bottleneck's two 3x3 512->512 at H/16 — each `F.conv2d` through cuDNN
in the memory format the port's UNets run in (channels_last on the
card), sums them by multiplicity and compares the sum with the whole
net's forward at [1, H, W, 4] (weights flax_init_params(net, 0), the
script's init_params(model, PRNGKey(0), ...); input jax.random.normal
(PRNGKey(2)) through core.rng; guidance 0.02), in bf16 the port's bf16
route (parameters and input in bf16, as bench.py's net). If the sum is
near the whole (no fusion slack) and each conv runs near the rate cuDNN
reaches for its channel count (the four lane references: conv3x3 32->c
at H x W for c = 32..256), the net's time is the conv roofline of this
architecture. Each row prints its ms and TF/s (2 * H' * W' * cin * cout
* k^2 FLOPs) and its multiplicity.

Each time is one warm call, then `--reps` calls between a CUDA event
pair, over reps (the host clock on the CPU); cuDNN's autotuner is on for
the run. TF32 follows the caller's torch.backends settings (printed).
On the GPU unless --cpu.
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.nn.functional as F

from ..core import rng
from ..core.logging import log
from ..models.registry import build_model, flax_init_params
from .probe_common import device_of, guided_arch

NF = 32
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def conv_flops(H, W, cin, cout, k=3):
    return 2.0 * H * W * cin * cout * k * k


def inventory(H, W):
    """The conv shapes of the GuidedResUnet nf=32 forward at [1, H, W, 4]
    -> [(tag, h, w, cin, cout, k, multiplicity, stride)]."""
    widths = [NF, NF * 2, NF * 4, NF * 8]
    rows = [("conv_in 4->32", H, W, 4, 32, 3, 1, 1)]
    for s, c in enumerate(widths):
        h, w = H >> s, W >> s
        rows += [(f"scale{s} 3x3 {c}->{c}", h, w, c, c, 3, 4, 1),
                 (f"scale{s} 1x1 {2*c}->{c}", h, w, 2 * c, c, 1, 1, 1),
                 (f"pool{s} 3x3s2 {c}->{2*c}", h, w, c, 2 * c, 3, 1, 2)]
    rows.append(("bottleneck 3x3 512->512", H >> 4, W >> 4, 512, 512, 3, 2,
                 1))
    return rows


def time_fn(fn, *args, reps=10):
    """Steady-state seconds a call: one warm call, then `reps` calls
    between a CUDA event pair (host clock on the CPU)."""
    dev = args[0].device
    fn(*args)
    if dev.type == "cuda":
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        torch.cuda.synchronize(dev)
        t0.record()
        for _ in range(reps):
            fn(*args)
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) / 1e3 / reps
    t = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    return (time.perf_counter() - t) / reps


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--H", type=int, default=1792)
    ap.add_argument("--W", type=int, default=1792)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--dtype", default="bf16", choices=list(DTYPES))
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU)")
    return ap


def main(argv=None) -> dict:
    return run(build_parser().parse_args(argv))


def run(args, x4=None) -> dict:
    """The audit of parsed arguments; `x4`, the net's input [1, H, W, 4]
    (float32 numpy), is drawn when not given -> {'rows': [{'tag', 'n',
    'flops', 'ms', 'tflops'}], 'sum_ms', 'net_ms', 'mps', 'slack_pct',
    'net_sum', 'lane': [{'cout', 'flops', 'ms', 'tflops'}], 'device',
    'tf32'}."""
    dev = device_of(args.cpu)
    H, W = args.H, args.W
    if x4 is None:
        x4 = rng.normal(rng.PRNGKey(2), (1, H, W, 4))
    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        return _audit(args, dev, torch.from_numpy(x4).to(dev))
    finally:
        torch.backends.cudnn.benchmark = bench


def _audit(args, dev, x4) -> dict:
    dt = DTYPES[args.dtype]
    H, W = args.H, args.W
    fmt = torch.channels_last if dev.type == "cuda" else \
        torch.contiguous_format
    gen = torch.Generator(device=dev).manual_seed(0)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    log(f"{torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}"
        f" {args.dtype}: TF32 in cuDNN / matmul {tf32[0]} / {tf32[1]}")

    def bench_conv(h, w, cin, cout, k, stride=1):
        x = torch.randn((1, cin, h, w), generator=gen, device=dev).to(
            dt).contiguous(memory_format=fmt)
        kern = (torch.randn((cout, cin, k, k), generator=gen, device=dev)
                * 0.02).to(dt).contiguous(memory_format=fmt)
        with torch.no_grad():
            return time_fn(lambda a: F.conv2d(a, kern, stride=stride,
                                              padding=k // 2), x,
                           reps=args.reps)

    rows, total = [], 0.0
    for tag, h, w, cin, cout, k, n, stride in inventory(H, W):
        d = bench_conv(h, w, cin, cout, k, stride)
        fl = conv_flops(h // stride, w // stride, cin, cout, k)
        total += n * d
        rows.append({"tag": tag, "n": n, "flops": fl, "ms": d * 1e3,
                     "tflops": fl / d / 1e12})
        log(f"{tag:26s} {d * 1e3:7.2f} ms  {fl / d / 1e12:5.1f} TF/s  x{n}")
    log(f"sum of isolated convs (inventory, no deconvs/guides): "
        f"{total * 1e3:.1f} ms")

    # the whole net's forward at the same size
    net = build_model(guided_arch())
    net.load_state_dict(flax_init_params(net, 0))
    net = net.to(device=dev, dtype=dt, memory_format=fmt).eval()
    x4 = x4.to(dt)
    t = torch.full((1,), 0.02, dtype=torch.float32, device=dev).to(dt)
    with torch.no_grad():
        dt_net = time_fn(net, x4, t, reps=args.reps)
        net_sum = float(net(x4, t).double().sum())
    mp = H * W * 4 / 1e6   # rggb planes = 4x spatial, bayer MP = H*W*4
    slack = (total - dt_net) / dt_net * 100
    log(f"whole GuidedResUnet fwd @[1,{H},{W},4] ({args.dtype}): "
        f"{dt_net * 1e3:.1f} ms = {mp / dt_net:.1f} MP(bayer)/s")
    log(f"fusion slack vs isolated sum: {slack:+.1f}%")

    # lane references: the same conv at wider output channels
    lane = []
    for c_out in (32, 64, 128, 256):
        d = bench_conv(H, W, 32, c_out, 3)
        fl = conv_flops(H, W, 32, c_out)
        lane.append({"cout": c_out, "flops": fl, "ms": d * 1e3,
                     "tflops": fl / d / 1e12})
        log(f"lane ref: conv3x3 32->{c_out} @{H}x{W}: {d * 1e3:7.2f} ms "
            f"{fl / d / 1e12:5.1f} TF/s")
    return {"rows": rows, "sum_ms": total * 1e3, "net_ms": dt_net * 1e3,
            "mps": mp / dt_net, "slack_pct": slack, "net_sum": net_sum,
            "lane": lane, "device": str(dev), "tf32": tf32}


if __name__ == "__main__":
    main()
