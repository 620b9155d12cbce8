"""Spans and traces (port of yondx/core/profiling.py).

- `span(name)`: a `torch.profiler.record_function` range named
  `yondx.<name>` while a profiler runs, nothing otherwise. The range
  lands in the profiler's Kineto trace on the clock of its kernel, copy
  and CUDA-runtime events, so a reduction of the trace can attribute
  device work to the span open when it was launched (the fused entry's
  stages, pipeline/fused.py). With no profiler running a range still
  costs 8-13 us of host time (measured on an H100 machine's host), the
  check that skips it under 1 us.
- `trace`: a torch.profiler trace of CPU activity, plus CUDA activity on
  the card, written as Chrome-trace JSON into `logdir` (the JAX package
  traces with jax.profiler for TensorBoard). It shows the spans.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch
from torch.profiler import record_function

# tiny kernels trace() launches before its block on a CUDA device
WARMUP_KERNELS = 8
SPAN_PREFIX = "yondx."

_NO_SPAN = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


def span(name: str):
    """with span('net'): ... records the block as `yondx.net` in a
    running profiler's trace, and is a no-op when none runs."""
    if not _profiler_enabled():
        return _NO_SPAN
    return record_function(SPAN_PREFIX + name)


@contextlib.contextmanager
def trace(logdir: str | None = None, device="cuda"):
    """Trace the block with torch.profiler: CPU activity, and CUDA
    activity where `device` is a CUDA device (it raises without a card).
    Writes `trace_<pid>_<time>.json` (Chrome trace, for chrome://tracing
    or Perfetto) into logdir (default: yondx_torch_trace in the temporary
    directory) and yields logdir. On a card the trace also holds
    WARMUP_KERNELS tiny `add_` kernels of its own, before the block."""
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
