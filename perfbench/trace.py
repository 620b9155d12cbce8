"""Device trace of the traced window and its reduction.

`Tracer` runs torch.profiler with CPU and CUDA activity around the
window, which the harness marks with the span `perfbench.window`. The
trace is written as Chrome-trace JSON into a temporary directory under
TMPDIR, read back and deleted. `reduce` gives, inside that span:
device time by kernel class (kernel_classes.json: k1, conv, copy, the
rest glue), K1's kernel count, the union of device activity (busy_s),
the span's length (window_s), the device operations that took most
time, and the idle gaps summed by the host operation that was running
at each gap's midpoint.
"""
from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from collections import defaultdict

WINDOW_SPAN = "perfbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
HOST_LOOKBACK = 64
_HERE = os.path.dirname(os.path.abspath(__file__))


def load_classes(path=os.path.join(_HERE, "kernel_classes.json")):
    with open(path) as f:
        spec = json.load(f)
    return [(name, re.compile("|".join(pats), re.IGNORECASE))
            for name, pats in spec.items() if name != "why"]


def classify(name, classes):
    for cls, pat in classes:
        if pat.search(name):
            return cls
    return "glue"


class Tracer:
    """with Tracer() as t: ...; events = t.events (the trace's list)."""

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._torch = torch
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        # a few kernels of the trace's own first: a profile's first
        # events can be lost
        w = torch.zeros(1, device="cuda")
        for _ in range(8):
            w.add_(1)
        torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        self._torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                self.events = json.load(f)["traceEvents"]
        return False


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(events, classes=None, top=10):
    """Per-class device seconds and the window's busy and idle shares."""
    classes = classes or load_classes()
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    spans = [e for e in xs if e.get("name") == WINDOW_SPAN
             and e.get("cat") == "user_annotation"]
    if not spans:
        raise RuntimeError(f"trace holds no {WINDOW_SPAN} span")
    w0 = float(spans[0]["ts"])
    w1 = w0 + float(spans[0]["dur"])
    class_s = defaultdict(float)
    by_name = defaultdict(float)
    k1_events = 0
    dev = []
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e["dur"]), w1)
        if t <= s:
            continue
        name = e["name"] if e["cat"] == "kernel" else e["cat"].replace(
            "gpu_", "")
        cls = classify(name, classes)
        class_s[cls] += (t - s) * 1e-6
        by_name[f"{cls}:{name[:100]}"] += (t - s) * 1e-6
        k1_events += cls == "k1"
        dev.append((s, t))
    busy = _merge(dev)
    host = sorted((float(e["ts"]), float(e["dur"]), e["name"]) for e in xs
                  if e.get("cat") in HOST_CATS
                  and e.get("name") != WINDOW_SPAN)
    starts = [h[0] for h in host]
    gaps = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid)
        # the innermost host operation covering the midpoint: host
        # operations nest, so it starts shortly before it
        inner = [h for h in host[max(0, i - HOST_LOOKBACK):i]
                 if h[0] + h[1] >= mid]
        label = min(inner, key=lambda h: h[1])[2] if inner \
            else "host between operations"
        gaps[label[:100]] += (b - a) * 1e-6
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(t - s for s, t in busy) * 1e-6,
        "class_s": dict(class_s),
        "k1_events": k1_events,
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
        "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:top],
    }
