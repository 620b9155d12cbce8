"""Does torch.profiler's trace name every launch of K1, the port's
ctypes-loaded CUDA kernel?

Builds K1 (yondx_torch/csrc/nle_moments.cu), then records, each inside
its own `yondx_torch.core.profiling.trace`, three K1 launches on a band
view [1, 2, 256, 2048, 4]: (1) straight after the trace starts, (2) after
a torch kernel and a synchronise inside the trace, (3) as (1) again;
and prints for each the K1 kernel events of the Chrome-trace JSON, the
first five kernel names, and the wrapper's launch count; then the same
for chip_smoke.py's product path (the s2dt16 net in bf16) on its
3072x4096 frame, three frames each in its own trace, with each K1
event's start, duration and stream, and the kernel names outside
torch's and cuDNN's. With --mesh the frames run after a world-1 NCCL
group is made (yondx_torch.parallel.make_mesh(1)), as chip_smoke.py's
phase 18 runs after phase 17.

    python3 scripts/torch_trace_probe.py [--mesh]  # needs one CUDA card
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from yondx_torch import cuda_build  # noqa: E402
from yondx_torch.core.profiling import trace  # noqa: E402
from yondx_torch.nle import moments  # noqa: E402
from yondx_torch.pipeline.fused import _take_bands  # noqa: E402


def kernel_events(logdir):
    (name,) = [f for f in os.listdir(logdir) if f.endswith(".json")]
    with open(os.path.join(logdir, name)) as f:
        ev = json.load(f)["traceEvents"]
    return [e for e in ev if e.get("cat") == "kernel"]


def kernels(logdir):
    return [e["name"] for e in kernel_events(logdir)]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True).stdout.strip(), flush=True)
    cuda_build.build(force=True)
    cuda_build.load_library()
    if "--mesh" in sys.argv:
        from yondx_torch.parallel import make_mesh
        make_mesh(1)
    g = torch.Generator(device="cuda").manual_seed(0)
    frame = torch.rand((1, 1536, 2048, 4), generator=g, device="cuda")
    x = _take_bands(frame, 6, 2, 3, 256)
    torch.cuda.synchronize()
    for case in ("first", "after a torch kernel", "first, again"):
        moments.reset_launches()
        with tempfile.TemporaryDirectory() as d:
            with trace(d):
                if case == "after a torch kernel":
                    (frame * 2).sum()
                    torch.cuda.synchronize()
                for texture, mean in ((True, True), (False, True),
                                      (False, False)):
                    moments.nle_moments(x, 29, 19, texture, mean)
            names = kernels(d)
        k1 = sum("nle_moments" in n for n in names)
        print(f"{case}: K1 kernel events {k1} of "
              f"{moments.LAUNCHES['nle_moments']} launches; {len(names)} "
              f"kernel events, the first {[n[:50] for n in names[:5]]}",
              flush=True)
    product_frames()


def product_frames():
    import numpy as np
    from yondx_torch.io.ckpt import find_checkpoint
    from yondx_torch.isp.bayer import bayer2rggb
    from yondx_torch.models.unets import load_guided_s2d
    from yondx_torch.pipeline.fused import make_fused_blind_denoiser
    from yondx_torch.vst.lut import BiasLUT
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cudnn.benchmark = True
    ck = find_checkpoint(os.path.join(repo, "checkpoints", "Gaussian"),
                         "Gaussian_GRUS2DT_mix_1to50c_norm")
    net = load_guided_s2d(ck, device="cuda", dtype=torch.bfloat16)
    fused = make_fused_blind_denoiser(
        net, BiasLUT().lut, compute_dtype=torch.bfloat16, device="cuda",
        guided=True, max_iter=1, refine=True, sigma_corr="adaptive")
    rng = np.random.default_rng(7)
    levels = rng.random((12, 16)) * 0.7 + 0.05
    clean = np.kron(levels, np.ones((256, 256))).astype(np.float32)
    noisy = np.clip((8.74 * rng.poisson(clean * 959.0 / 8.74)
                     + rng.normal(0, 12.81, clean.shape)) / 959.0, 0, 1)
    rggb = bayer2rggb(torch.from_numpy(noisy.astype(np.float32))
                      .cuda())[None]
    fused(rggb, 959.0)
    torch.cuda.synchronize()
    for i in range(3):
        moments.reset_launches()
        with tempfile.TemporaryDirectory() as d:
            with trace(d):
                fused(rggb, 959.0)
            ev = kernel_events(d)
        k1 = [e for e in ev if "nle_moments" in e["name"]]
        print(f"product frame {i}: K1 kernel events {len(k1)} of "
              f"{moments.LAUNCHES['nle_moments']} launches; {len(ev)} "
              f"kernel events, the first "
              f"{[e['name'][:40] for e in ev[:3]]}; K1 events "
              + "; ".join(f"ts {e['ts']} dur {e.get('dur')} stream "
                          f"{e.get('args', {}).get('stream')}"
                          for e in k1), flush=True)
        other = {}
        for e in ev:
            n = e["name"]
            if not any(w in n for w in ("at::native", "cudnn", "xmma",
                                        "cutlass", "gemm", "cub::")):
                other[n[:90]] = other.get(n[:90], 0) + 1
        print(f"product frame {i}: other kernel names {other}", flush=True)


if __name__ == "__main__":
    main()
