"""MKL's vector math (VML) started on one thread, before torch's intra-op
worker threads call it.

On the CPU torch computes sqrt, exp, log, log2, log10, sin, cos, tan,
tanh, asin, acos, atan, erf, erfc, erfinv and trunc of float32 and
float64 tensors through MKL's VML, in chunks of 2048 elements spread over
its intra-op threads. When a process's first such call runs on several
threads at once, a worker thread's chunk can come out of a less accurate
code path: a first sqrt of 32768 elements came back up to 3.2e-4
(relative) off in 27 of 300 fresh processes, the VST's 4096-element sqrt
2.77e-4 off in its second chunk with or without JAX in the process, and
later calls were exact (scripts/torch_thread_check.py). One call on the
calling thread first, of sqrt or of exp, left none of 300 off. `warm()`
makes that call for each of those ops in both dtypes on 16 elements,
which torch runs on the calling thread; importing yondx_torch runs it
once (well under a millisecond).
"""
from __future__ import annotations

import torch

OPS = ("sqrt", "exp", "log", "log2", "log10", "sin", "cos", "tan", "tanh",
       "asin", "acos", "atan", "erf", "erfc", "erfinv", "trunc")
_done = False


def warm() -> None:
    global _done
    if _done:
        return
    for dtype in (torch.float32, torch.float64):
        x = torch.full((16,), 0.5, dtype=dtype)
        for op in OPS:
            getattr(torch, op)(x)
    _done = True
