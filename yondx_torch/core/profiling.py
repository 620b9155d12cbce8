"""Timers and traces (port of yondx/core/profiling.py).

- `fn_timer`: an accumulating wall-clock decorator (a global table,
  `report()`, `reset()`);
- `stage_timer`: a context manager adding seconds to a dict's stage;
- `trace`: a torch.profiler trace of CPU activity, plus CUDA activity on
  the card, written as Chrome-trace JSON into `logdir` (the JAX package
  traces with jax.profiler for TensorBoard).
"""
from __future__ import annotations

import contextlib
import functools
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict

# tiny kernels trace() launches before its block on a CUDA device
WARMUP_KERNELS = 8

fn_time: Dict[str, float] = defaultdict(float)
fn_calls: Dict[str, int] = defaultdict(int)


def fn_timer(fn):
    """Accumulate fn's wall-clock seconds and calls under its qualname."""
    @functools.wraps(fn)
    def wrapper(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            fn_time[fn.__qualname__] += time.perf_counter() - t0
            fn_calls[fn.__qualname__] += 1
    return wrapper


def report() -> str:
    lines = [f"{name}: {fn_time[name]:.3f}s / {fn_calls[name]} calls"
             for name in sorted(fn_time, key=fn_time.get, reverse=True)]
    return "\n".join(lines)


def reset() -> None:
    fn_time.clear()
    fn_calls.clear()


@contextlib.contextmanager
def stage_timer(runtime: dict, stage: str):
    """with stage_timer(rt, 'net'): ... adds the block's seconds to
    rt['net']."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        runtime[stage] = runtime.get(stage, 0.0) + time.perf_counter() - t0


@contextlib.contextmanager
def trace(logdir: str | None = None, device="cuda"):
    """Trace the block with torch.profiler: CPU activity, and CUDA
    activity where `device` is a CUDA device (it raises without a card).
    Writes `trace_<pid>_<time>.json` (Chrome trace, for chrome://tracing
    or Perfetto) into logdir (default: yondx_torch_trace in the temporary
    directory) and yields logdir. On a card the trace also holds
    WARMUP_KERNELS tiny `add_` kernels of its own, before the block."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    logdir = logdir or os.path.join(tempfile.gettempdir(),
                                    "yondx_torch_trace")
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("trace(device='cuda') needs a CUDA card; "
                               "pass device='cpu' to trace the CPU alone")
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    cuda = torch.device(device).type == "cuda"
    with profile(activities=acts) as prof:
        if cuda:
            # a few tiny kernels of the trace's own go first: in a
            # process that had traced and run much before, a session's
            # first two kernels were missing from its trace
            w = torch.zeros(1, device=device)
            for _ in range(WARMUP_KERNELS):
                w.add_(1)
            torch.cuda.synchronize()
        yield logdir
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
