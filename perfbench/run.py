"""Benchmark of yondx_torch's fused blind-denoise entry: one cell, one run.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the cell's cards.

1. Set-up (setup_s, from process start to the first timed call): the
   configuration's net from its committed checkpoint and the entry
   `make_fused_blind_denoiser` with the product keywords; the traffic
   mix's pool of frames, made on the device from the seed; two calls on
   each frame shape the window will see.
2. The window: a closed loop of one stream for `--seconds`; each call
   hands one frame to the entry, fn(rggb [1, h, w, 4], scale), and waits
   for its output. mp_per_s is the Bayer megapixels completed over the
   window's host time; frame_ms_p95 the 95th percentile of the frames'
   latencies, each from its call to its output being complete, timed by
   CUDA events on the device. With --trace 1 the same window runs, then
   two cycles of the pool (at most --seconds) under the profiler, and the
   per-layer metrics are read from the two instead: mfu from the
   untraced window, device_idle_untraced from both, the rest from the
   traced one.
3. After the window: the card's peak memory; the program is freed; the
   plain float32 reference (perfbench/reference) runs on every pool
   frame the window denoised, and check.py compares it with the
   program's last output for that frame. `correct` is that verdict.
4. The last line of standard output is one JSON object; the numbers
   compared, each beside its limit, are the last lines of standard error.

Exits 2 without a result when the cell's cards are missing, 3 when jax,
jaxlib, flax or yondx (the JAX package) is loaded once the window has
closed.
"""
from __future__ import annotations

import os
import time


def _process_age():
    """Seconds since this process started (Linux; 0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        return time.clock_gettime(time.CLOCK_BOOTTIME) \
            - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, AttributeError):
        return 0.0


T_START = time.perf_counter() - _process_age()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "yondx")
CACHE_DIR = ".perfbench_cache"
TRACE_CYCLES = 2


def set_cache_dirs(root):
    """Kernel and build caches at fixed paths inside the checkout (the
    port builds K1 into yondx_torch/_build/ itself)."""
    base = os.path.join(root, CACHE_DIR)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)
        os.makedirs(os.environ[var], exist_ok=True)


def forbidden_modules():
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def set_tf32(flags):
    import torch
    torch.backends.cudnn.allow_tf32 = bool(flags["cudnn"])
    torch.backends.cuda.matmul.allow_tf32 = bool(flags["matmul"])


def build_program(cfg, root, device):
    """(entry, net) of the configuration, as the product builds them."""
    import torch
    from yondx_torch.models.unets import load_model
    from yondx_torch.pipeline.fused import make_fused_blind_denoiser
    from yondx_torch.vst.lut import BiasLUT
    dtype = getattr(torch, cfg["net_dtype"])
    net = load_model(cfg["arch"], os.path.join(root, cfg["checkpoint"]),
                     device=device, dtype=dtype)
    lut = BiasLUT(os.path.join(root, "checkpoints", "bias_lut_2d.npy")).lut
    fn = make_fused_blind_denoiser(
        net, lut, compute_dtype=None if dtype == torch.float32 else dtype,
        device=device, **cfg["fused"])
    return fn, net


def k1_launches():
    from yondx_torch.nle.moments import LAUNCHES
    return LAUNCHES["nle_moments"]


class Window:
    """The closed loop: calls, per-frame latencies, and the last output
    (dn, regs, gate fired) of each pool frame."""

    def __init__(self, fn, pool, order, cuda):
        self.fn, self.pool, self.order, self.cuda = fn, pool, order, cuda
        self.lat_ms, self.kept, self.visits = [], {}, []
        self.mp = 0.0
        self.seconds = 0.0

    def call(self, i):
        import torch
        f = self.pool[i]
        passes = self.fn.stats["second_passes"]
        if self.cuda:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        t0 = time.perf_counter()
        dn, regs = self.fn(f.rggb, f.scale)
        if self.cuda:
            ev1.record()
            torch.cuda.synchronize()
            self.lat_ms.append(ev0.elapsed_time(ev1))
        else:
            self.lat_ms.append((time.perf_counter() - t0) * 1e3)
        fired = self.fn.stats["second_passes"] > passes
        self.kept[i] = (dn, regs, fired)
        self.visits.append((i, fired))
        self.mp += f.mp

    def run(self, seconds, max_frames=None):
        t0 = time.perf_counter()
        deadline = t0 + seconds
        n = 0
        while True:
            self.call(self.order[n % len(self.order)])
            n += 1
            now = time.perf_counter()
            if now >= deadline or (max_frames and n >= max_frames):
                break
        self.seconds = now - t0


def warm(fn, pool, order, cuda):
    """Two calls on the first frame of each shape the window will see."""
    import torch
    seen = set()
    for i in order:
        shape = tuple(pool[i].rggb.shape)
        if shape in seen:
            continue
        seen.add(shape)
        for _ in range(2):
            fn(pool[i].rggb, pool[i].scale)
    if cuda:
        torch.cuda.synchronize()


def net_work(cfg, pool, visits):
    """(operations, least seconds) of the SNR-Net over the visits: every
    pass run, the gate's second pass included (counts.py)."""
    from . import counts
    elem = 2 if cfg["net_dtype"] == "bfloat16" else 4
    peak = cfg["peak_tflops"] * 1e12
    flops = bound = 0.0
    for i, fired in visits:
        _, h, w, _ = pool[i].rggb.shape
        f, per = counts.net_work(cfg["arch"], h, w, elem)
        runs = 2 if fired else 1
        flops += f * runs
        bound += counts.net_bound_s(per, peak) * runs
    return flops, bound


def readings(cell, pool, plain, traced, launches, tr):
    """What the per-layer readers read: the traced window's counts, its
    frozen work counts and the trace's reduction, and the untraced
    window's operations and length."""
    from . import counts
    cfg = cell.config
    flops, bound = net_work(cfg, pool, traced.visits)
    k1_bytes = sum(sum(counts.k1_launch_bytes(*pool[i].rggb.shape[1:3]))
                   for i, _ in traced.visits)
    return {"frames": len(traced.visits), "mp": traced.mp,
            "second_passes": sum(f for _, f in traced.visits),
            "k1_launches": launches,
            "k1_bytes": k1_bytes, "net_flops": flops, "net_bound_s": bound,
            "plain_net_flops": net_work(cfg, pool, plain.visits)[0],
            "plain_window_s": plain.seconds, "plain_mp": plain.mp,
            "peak_flops": cfg["peak_tflops"] * 1e12,
            "hbm_bytes_per_s": counts.HBM_BYTES_PER_S, **tr}


def bf16_round(x):
    import torch
    return x.to(torch.bfloat16).float()


def build_reference(cfg, root, device, control=False):
    """The plain float32 reference of the configuration; with `control`,
    the reference in the configuration's control precision (a net one
    step down: float8 e4m3 for bfloat16, TF32 for float32; every glue map
    rounded to bfloat16). Returns (reference, tf32 flag to run it with)."""
    import torch
    from .reference import nets, vst
    from .reference.fused import Reference
    from .reference.nle import ident
    net = nets.load_net(cfg["arch"], os.path.join(root, cfg["checkpoint"]),
                        device)
    lut, ext = (torch.as_tensor(t, device=device)
                for t in vst.load_tables(root))
    if not control:
        return Reference(net, lut, ext), False
    ctl = cfg["control"]
    nets.set_fp8(net, ctl["net"] == "float8_e4m3")
    glue = bf16_round if ctl["glue"] == "bfloat16" else ident
    return Reference(net, lut, ext, glue), ctl["net"] == "tf32"


def compare(ref, pool, kept, ctl=None):
    """The check's numbers of every kept frame: the program's kept output
    (or, given `ctl` = (reference, tf32), the control's) against `ref`."""
    from . import check
    per = []
    for i in sorted(kept):
        f = pool[i]
        set_tf32({"cudnn": False, "matmul": False})
        r_dn, r_regs, r_fired = ref.run(f.rggb, f.scale)
        if ctl is None:
            dn, regs, fired = kept[i]
        else:
            set_tf32({"cudnn": ctl[1], "matmul": ctl[1]})
            dn, regs, fired = ctl[0].run(f.rggb, f.scale)
            set_tf32({"cudnn": False, "matmul": False})
        per.append(check.frame_numbers(dn, regs, fired, r_dn, r_regs,
                                       r_fired, f.rggb))
    return per


def run(cell, seed, seconds, trace, root, device="cuda", wrap=None,
        t_start=T_START):
    """One run of the cell -> (result dict, checks table). `wrap`, when
    given, wraps the entry (the tests break the timed path with it)."""
    import torch
    from . import check, frames
    cuda = torch.device(device).type == "cuda"
    cfg = cell.config
    set_tf32(cfg["tf32"])
    fn, net = build_program(cfg, root, device)
    if wrap is not None:
        fn = wrap(fn)
    pool, order = frames.make_pool(cell.traffic, seed, device)
    warm(fn, pool, order, cuda)
    # set-up's objects out of the collector's way during the window
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    win = Window(fn, pool, order, cuda)
    win.run(seconds)
    metrics, extra_device, breakdown, traced = {}, {}, None, None
    if trace:
        from .spec import metric_reader
        from .trace import WINDOW_SPAN, Tracer, reduce
        traced = Window(fn, pool, order, cuda)
        launches0 = k1_launches()
        with Tracer() as tracer:
            with torch.profiler.record_function(WINDOW_SPAN):
                traced.run(seconds, TRACE_CYCLES * len(order))
        tr = reduce(tracer.events)
        del tracer
        r = readings(cell, pool, win, traced, k1_launches() - launches0, tr)
        for m in cell.per_layer:
            v = metric_reader(m["name"])(r)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        extra_device = {"busy_s": tr["busy_s"], "window_s": tr["window_s"]}
        breakdown = {"device_ops": [list(x) for x in tr["device_ops"]],
                     "idle_gaps": [list(x) for x in tr["idle_gaps"]]}
        win.kept.update(traced.kept)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    lat = sorted(win.lat_ms)
    p95 = statistics.quantiles(lat, n=20)[18] if len(lat) >= 2 else lat[0]
    print(f"window: {len(lat)} frames in {win.seconds:.3f} s, frame ms "
          f"median {statistics.median(lat):.3f} p95 {p95:.3f}, "
          f"second passes {sum(f for _, f in win.visits)}",
          file=sys.stderr, flush=True)
    if not trace:
        values = {"mp_per_s": win.mp / win.seconds, "frame_ms_p95": p95,
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    kept = win.kept
    del fn, net, win, traced
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    per = compare(build_reference(cfg, root, device)[0], pool, kept)
    print(f"reference: {len(per)} frames in "
          f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr, flush=True)
    limits = cell.limits
    ok, table = check.verdict(check.worst(per), limits)
    result = {"correct": ok, "attempted": len(lat),
              "failed": check.failed_frames(per, limits), "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name() if cuda
                         else "cpu",
                         "count": 1, "memory_peak_bytes": int(peak),
                         **extra_device}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = table
    return result, table


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    root = os.getcwd()
    set_cache_dirs(root)
    import torch
    # one host thread: the host's work is launching the card's; idle
    # worker threads only add to what the shared host spreads
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
    from .spec import load_cell
    cell = load_cell(root, args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, table = run(cell, args.seed, args.seconds, args.trace, root)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, row in table.items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
