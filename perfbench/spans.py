"""The traced window by stage of the fused entry.

yondx_torch's fused entry opens a `yondx.*` span (core/profiling.span, a
torch.profiler record_function range) around each stage of a frame, all
inside one `yondx.frame` span a call. `reduce` attributes the trace's
events to them:

- each device kernel, copy and memset to the innermost `yondx.*` span
  open on the host thread when it was launched (its `correlation` id
  links it to the CUDA runtime or driver call that launched it);
- each launch (`cudaLaunchKernel*`, `cuLaunchKernel*`, `cudaMemcpyAsync`,
  `cudaMemsetAsync`), host sync (`cudaStreamSynchronize`,
  `cudaDeviceSynchronize`, `cudaEventSynchronize`, blocking `cudaMemcpy`)
  and device malloc (`cudaMalloc`) made inside a `yondx.frame` to the
  innermost span open around it; those made between frames to the row
  "between frames";
- the device's idle time inside each frame's interval, from its
  `yondx.frame` span's start to the end of the last device operation it
  launched, to the innermost span open at each gap's midpoint; idle
  outside every frame (inside the harness's window span, when the trace
  has one) to "between frames".

A row is a stage: the span's name without `yondx.` (SPANS). Work under
no stage span, the frame's own included, is "unattributed". A trace with
no `yondx.frame` span reduces to `span_frames` 0, and the readers of
metrics/ that read the reduction return None on it.

    python3 -m perfbench.spans --workload <cell> --seed <n> --seconds <s>

runs a cell's set-up, an untraced window of `--seconds` and a traced one
of two pool cycles as perfbench.run does, and prints the stage table to
standard error and one JSON line (the table, the readers' values, K1's
kernels by stage against its launch counter, the syncs and mallocs by
the aten op around them, the spans' host cost with no profiler) to
standard output.
"""
from __future__ import annotations

import bisect
from collections import Counter, defaultdict

from .trace import DEVICE_CATS, WINDOW_SPAN, classify, load_classes

PREFIX = "yondx."
FRAME = "yondx.frame"
UNATTRIBUTED = "unattributed"
BETWEEN = "between frames"
# every span the fused entry opens -> the row of the stage table its own
# work goes to (the frame's own: no stage)
SPANS = {
    FRAME: UNATTRIBUTED,
    "yondx.prepare": "prepare",
    "yondx.nle.self": "nle.self",
    "yondx.gate.stats": "gate.stats",
    "yondx.denoise": "denoise",
    "yondx.sigma_corr": "sigma_corr",
    "yondx.bias": "bias",
    "yondx.vst": "vst",
    "yondx.net": "net",
    "yondx.refine": "refine",
    "yondx.inverse": "inverse",
    "yondx.nle.collab": "nle.collab",
    "yondx.gate": "gate",
}
ROWS = [r for r in SPANS.values() if r != UNATTRIBUTED] + [UNATTRIBUTED,
                                                           BETWEEN]
HOST_CALL_CATS = ("cuda_runtime", "cuda_driver")
LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel")
LAUNCH_NAMES = ("cudaMemcpyAsync", "cudaMemsetAsync")
SYNC_NAMES = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
MALLOC_NAMES = ("cudaMalloc",)


def call_kind(name):
    """'launch', 'sync', 'malloc' or None for a runtime or driver call."""
    if name.startswith(LAUNCH_PREFIXES) or name in LAUNCH_NAMES:
        return "launch"
    if name in SYNC_NAMES:
        return "sync"
    if name in MALLOC_NAMES:
        return "malloc"
    return None


def row_of(name):
    return SPANS.get(name, name[len(PREFIX):])


class _Thread:
    """The yondx.* spans of one host thread, nested: `at(t)` is the index
    of the innermost one open at t (-1 if none), `frame[i]` the index of
    the yondx.frame span around span i (-1 if none)."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.spans]
        self.parent, self.frame = [], []
        stack = []
        for i, (t0, t1, name) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][1] < t1:
                stack.pop()
            p = stack[-1] if stack else -1
            self.parent.append(p)
            self.frame.append(i if name == FRAME
                              else (self.frame[p] if p >= 0 else -1))
            stack.append(i)

    def at(self, t):
        # the latest span to start at or before t covers t, or else one of
        # its enclosing spans does (spans nest)
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.spans[i][1] < t:
            i = self.parent[i]
        return i


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(events, classes=None):
    """The stage table of a trace's events (a Chrome-trace event list):
    per row, device seconds, idle seconds and counts of launches, syncs,
    mallocs and K1 kernels; the frames' count, their intervals' length
    and the idle inside them."""
    classes = classes or load_classes()
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    threads = defaultdict(list)
    window = None
    for e in xs:
        if e.get("cat") != "user_annotation":
            continue
        t0 = float(e["ts"])
        if e["name"] == WINDOW_SPAN:
            window = (t0, t0 + float(e["dur"]))
        elif e["name"].startswith(PREFIX):
            threads[(e.get("pid"), e.get("tid"))].append(
                (t0, t0 + float(e["dur"]), e["name"]))
    threads = {k: _Thread(v) for k, v in threads.items()}
    frames = [(k, i) for k, th in threads.items()
              for i, s in enumerate(th.spans) if s[2] == FRAME]

    def where(e):
        """(row, frame key) of a host event by its start."""
        th = threads.get((e.get("pid"), e.get("tid")))
        i = th.at(float(e["ts"])) if th else -1
        if i < 0:
            return UNATTRIBUTED, None
        key = (e.get("pid"), e.get("tid"), th.frame[i])
        return row_of(th.spans[i][2]), key if th.frame[i] >= 0 else None

    counts = {k: defaultdict(int) for k in ("launch", "sync", "malloc")}
    by_corr = {}
    calls = sorted((e for e in xs if e.get("cat") in HOST_CALL_CATS),
                   key=lambda e: (e.get("pid"), e.get("tid"),
                                  float(e["ts"]), -float(e["dur"])))
    open_launch = {}
    for e in calls:
        corr = e.get("args", {}).get("correlation")
        if corr is not None and corr not in by_corr:
            by_corr[corr] = e
        kind = call_kind(e["name"])
        if kind is None:
            continue
        thread = (e.get("pid"), e.get("tid"))
        t0 = float(e["ts"])
        if kind == "launch":
            # a driver launch inside a runtime launch is the same launch
            if open_launch.get(thread, -1.0) >= t0:
                continue
            open_launch[thread] = t0 + float(e["dur"])
        row, frame = where(e)
        counts[kind][row if frame is not None else BETWEEN] += 1

    device_s = defaultdict(float)
    k1 = defaultdict(int)
    frame_end = {}
    busy = []
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        launch = by_corr.get(e.get("args", {}).get("correlation"))
        row, frame = where(launch) if launch is not None \
            else (UNATTRIBUTED, None)
        if frame is None and window is not None:
            t0, t1 = max(t0, window[0]), min(t1, window[1])
            if t1 <= t0:
                continue
        busy.append((t0, t1))
        device_s[row] += (t1 - t0) * 1e-6
        name = e["name"] if e["cat"] == "kernel" else e["cat"]
        if classify(name, classes) == "k1":
            k1[row] += 1
        if frame is not None:
            frame_end[frame] = max(frame_end.get(frame, t1), t1)
    busy = _merge(busy)

    intervals = []
    for (pid, tid), i in frames:
        t0, t1, _ = threads[(pid, tid)].spans[i]
        intervals.append((t0, frame_end.get((pid, tid, i), t1), (pid, tid)))
    idle_s = defaultdict(float)
    frame_s = frame_idle = 0.0
    for a, b, thread in intervals:
        frame_s += b - a
        for g0, g1 in _gaps(busy, a, b):
            th = threads[thread]
            i = th.at(0.5 * (g0 + g1))
            idle_s[row_of(th.spans[i][2]) if i >= 0 else UNATTRIBUTED] += \
                (g1 - g0) * 1e-6
            frame_idle += g1 - g0
    if window is not None:
        inside = _merge([(a, b) for a, b, _ in intervals])
        for g0, g1 in _gaps(busy, *window):
            out = g1 - g0 - sum(max(0.0, min(g1, b) - max(g0, a))
                                for a, b in inside)
            idle_s[BETWEEN] += out * 1e-6
    return {"span_frames": len(frames),
            "span_frame_s": frame_s * 1e-6,
            "span_frame_idle_s": frame_idle * 1e-6,
            "span_device_s": dict(device_s),
            "span_idle_s": dict(idle_s),
            "span_launches": dict(counts["launch"]),
            "span_syncs": dict(counts["sync"]),
            "span_mallocs": dict(counts["malloc"]),
            "span_k1": dict(k1)}


def calls_by_op(events, kinds=("sync", "malloc")):
    """Counts of the host calls of `kinds` made inside frames, keyed
    "<kind> <row>: <outermost op> > <innermost op>" by the aten
    operations open around each call (which op synced or allocated)."""
    by_thread = defaultdict(lambda: ([], []))
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        t0 = float(e["ts"])
        item = (t0, t0 + float(e["dur"]), e["name"])
        thread = by_thread[(e.get("pid"), e.get("tid"))]
        if e.get("cat") == "user_annotation" and e["name"].startswith(PREFIX):
            thread[0].append(item)
        elif e.get("cat") == "cpu_op":
            thread[1].append(item)
    threads = {k: (_Thread(v[0]), _Thread(v[1]))
               for k, v in by_thread.items()}
    out = Counter()
    for e in events:
        kind = call_kind(e.get("name", "")) \
            if e.get("cat") in HOST_CALL_CATS else None
        if kind not in kinds \
                or (e.get("pid"), e.get("tid")) not in threads:
            continue
        th, ops = threads[(e.get("pid"), e.get("tid"))]
        t = float(e["ts"])
        i = th.at(t)
        if i < 0 or th.frame[i] < 0:
            continue
        j, chain = ops.at(t), []
        while j >= 0:
            chain.append(ops.spans[j][2])
            j = ops.parent[j]
        where = f"{chain[-1]} > {chain[0]}" if chain else "no op"
        out[f"{kind} {row_of(th.spans[i][2])}: {where}"] += 1
    return dict(out)


def _gaps(busy, a, b):
    """The idle intervals of [a, b] between the merged busy intervals."""
    i = bisect.bisect_right([iv[1] for iv in busy], a)
    t = a
    for s, e in busy[i:]:
        if s >= b:
            break
        if s > t:
            yield t, s
        t = max(t, e)
    if t < b:
        yield t, b


def table(sp):
    """The stage table: device ms, idle ms, launches, syncs and mallocs
    a frame, one row a stage."""
    n = sp["span_frames"]
    head = (f"{'stage':<16}{'device ms':>11}{'idle ms':>10}"
            f"{'launches':>10}{'syncs':>8}{'mallocs':>9}")
    lines = [f"stages, per frame over {n} frames:", head]
    if not n:
        return "\n".join(lines)
    cols = ("span_device_s", "span_idle_s", "span_launches", "span_syncs",
            "span_mallocs")
    for row in ROWS:
        v = [sp[c].get(row, 0) / n for c in cols]
        lines.append(f"{row:<16}{v[0] * 1e3:>11.3f}{v[1] * 1e3:>10.3f}"
                     f"{v[2]:>10.1f}{v[3]:>8.2f}{v[4]:>9.2f}")
    tot = [sum(v for k, v in sp[c].items() if k != BETWEEN) / n
           for c in cols]
    lines.append(f"{'in frames':<16}{tot[0] * 1e3:>11.3f}"
                 f"{tot[1] * 1e3:>10.3f}{tot[2]:>10.1f}{tot[3]:>8.2f}"
                 f"{tot[4]:>9.2f}")
    return "\n".join(lines)


# the per-layer readers of this reduction (metrics/<name>.py)
METRICS = ("net_ms_per_mp", "nle_ms_per_mp", "vst_ms_per_mp",
           "refine_ms_per_mp", "entry_idle", "launches_per_frame",
           "syncs_per_frame", "mallocs_per_frame")


def span_cost_us(n=20000):
    """Host microseconds of one `span` with no profiler running, and of
    the record_function range it skips then (best of three)."""
    import time

    from torch.profiler import record_function
    from yondx_torch.core.profiling import span
    out = []
    for body in (lambda: span("cost"),
                 lambda: record_function(PREFIX + "cost")):
        best = float("inf")
        for _ in range(3):
            t = time.perf_counter()
            for _ in range(n):
                with body():
                    pass
            best = min(best, (time.perf_counter() - t) / n)
        out.append(best * 1e6)
    return tuple(out)


def main(argv=None):
    import json
    import os
    import statistics
    import sys

    import torch

    from . import frames, run
    from .spec import load_cell, metric_reader
    from .trace import Tracer
    from .trace import reduce as trace_reduce
    args = run.parse(argv)
    root = os.getcwd()
    run.set_cache_dirs(root)
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
    cell = load_cell(root, args.workload)
    if not torch.cuda.is_available():
        print(f"{args.workload} needs a CUDA card", file=sys.stderr)
        return 2
    run.set_tf32(cell.config["tf32"])
    fn, _ = run.build_program(cell.config, root, "cuda")
    pool, order = frames.make_pool(cell.traffic, args.seed, "cuda")
    run.warm(fn, pool, order, True)
    cost_us, range_us = span_cost_us()
    plain = run.Window(fn, pool, order, True)
    plain.run(args.seconds)
    traced = run.Window(fn, pool, order, True)
    launches0 = run.k1_launches()
    with Tracer() as tracer:
        with torch.profiler.record_function(WINDOW_SPAN):
            traced.run(args.seconds, run.TRACE_CYCLES * len(order))
    events = tracer.events
    del tracer
    sp = reduce(events)
    n_spans = sum(1 for e in events if e.get("cat") == "user_annotation"
                  and e.get("name", "").startswith(PREFIX))
    launches = run.k1_launches() - launches0
    r = {**run.readings(cell, pool, plain, traced, launches,
                        trace_reduce(events)), **sp}
    values = {m: metric_reader(m)(r) for m in METRICS}
    print(table(sp), file=sys.stderr)
    dev_in = sum(sp["span_device_s"].values())
    spans_a_frame = n_spans / sp["span_frames"] if sp["span_frames"] else 0
    out = {
        "workload": args.workload, "seed": args.seed,
        "card": torch.cuda.get_device_name(),
        "frames": sp["span_frames"], "metrics": values,
        "untraced_frame_ms_median": statistics.median(plain.lat_ms),
        "untraced_mp_per_s": plain.mp / plain.seconds,
        "traced_ms_a_frame": r["window_s"] * 1e3 / len(traced.visits),
        "traced_busy_ms_a_frame": r["busy_s"] * 1e3 / len(traced.visits),
        "unattributed_device_share": sp["span_device_s"].get(
            UNATTRIBUTED, 0.0) / dev_in if dev_in else None,
        "k1_by_stage": sp["span_k1"], "k1_launches": launches,
        "spans_a_frame": spans_a_frame,
        "span_cost_us": cost_us, "record_function_us": range_us,
        "span_cost_us_a_frame": spans_a_frame * cost_us,
        "calls_by_op": calls_by_op(events), **sp,
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
