"""K1's error on image content, against an exact float64 reference.

Builds the port's K1 (yondx_torch/csrc/nle_moments.cu) twice with plain
nvcc, once with the package's flags and once with `-fmad=false` added
(no fused multiply-adds where the source does not ask for one), and runs
both on the rows that chip_smoke.py's phase 17c holds: the RGGB planes of
make_frame(6144, 8192) (50.3 MP) with k = 29 reflect-101 halo rows,
[1, 3130, 4096, 4], and on uniform data of the same shape. Each map is
held against:
  - float64, the plain version in float64 (yondx_torch/nle/boxfilter.py:
    prefix sums in float64 on per-plane centered data);
  - scan32, the same with its prefix sums in float32, as the plain
    version ran float64 input before this script's finding;
  - direct, float64 box sums by a direct 29-tap (and 19-tap) convolution,
    a reference that shares no code with the other two.
tex is compared as tex^2 (the pre-blurred plane's variance). Prints one
line per map and build, and a JSON summary as the last line.

    python3 scripts/torch_k1_reference.py          # needs one CUDA card
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from yondx_torch import cuda_build  # noqa: E402
from yondx_torch.isp.bayer import bayer2rggb  # noqa: E402
from yondx_torch.nle import boxfilter  # noqa: E402

K, INNER = 29, 19


def make_frame(H, W, seed=7):
    """chip_smoke.py's make_frame (bench.py's): PG noise on 12x16 flat
    levels in [0.05, 0.75), clipped to [0, 1]."""
    rng = np.random.default_rng(seed)
    levels = rng.random((12, 16)) * 0.7 + 0.05
    clean = np.kron(levels, np.ones((H // 12, W // 16))).astype(np.float32)
    K_, sig, scale = 8.74, 12.81, 959.0
    noisy = (K_ * rng.poisson(clean * scale / K_)
             + rng.normal(0, sig, clean.shape)).astype(np.float32) / scale
    return np.clip(noisy, 0, 1)


def build_variant(extra, out_dir):
    lib = os.path.join(out_dir, "libk1.so")
    cmd = [cuda_build.find_nvcc(), *cuda_build.ARCH_FLAGS,
           *cuda_build.CFLAGS, *extra, "-shared",
           *map(str, cuda_build._sources()), "-o", lib]
    res = subprocess.run(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{res.stdout}")
    return cuda_build._bind(ctypes.CDLL(lib))


def k1(lib, x):
    L, h, w, C = x.shape
    outs = [torch.empty_like(x) for _ in range(3)]
    err = lib.yondx_nle_moments(x.data_ptr(), *(o.data_ptr() for o in outs),
                                L, h, w, C, *x.stride(), K, INNER, 1, 1,
                                torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K1 launch failed: cudaError {err}")
    torch.cuda.synchronize()
    return outs


def plain64(x, scan32=False):
    """(mean, var, tex^2) by the plain version in float64; scan32 runs
    its prefix sums in float32."""
    orig = torch.cumsum
    if scan32:
        torch.cumsum = lambda t, dim: orig(t.float(), dim=dim)
    try:
        m, v, t = boxfilter.nle_moments(x.double(), K, INNER)
    finally:
        torch.cumsum = orig
    return m.double(), v.double(), t.double() ** 2


def direct64(x):
    """(mean, var, tex^2) from float64 direct k-tap sums, reflect-101."""
    def box(p, k):                                  # p: [C, H, W] float64
        r = k // 2
        p = F.pad(p[:, None], (r, r, r, r), mode="reflect")
        w = torch.full((1, 1, 1, k), 1.0 / k, dtype=p.dtype, device=p.device)
        p = F.conv2d(p, w)
        return F.conv2d(p, w.transpose(-1, -2))[:, 0]
    p = x[0].permute(2, 0, 1).double()
    c = p.mean(dim=(-2, -1), keepdim=True)
    pc = p - c
    m = box(pc, K)
    v = box(pc * pc, K) - m * m
    t1 = box(pc, INNER)
    tm = box(t1, K)
    t2 = box(t1 * t1, K) - tm * tm
    back = lambda a: a.permute(1, 2, 0)[None]      # noqa: E731
    return back(m + c), back(v), back(t2)


def errors(got, ref):
    out = {}
    for key, g, r in zip(("mean", "var", "tex2"), got, ref):
        d = (g.double() - r).abs()
        at = np.unravel_index(int(d.argmax()), tuple(d.shape))
        out[key] = {"max_abs_err": float(d.max()), "at": [int(i) for i in at],
                    "exact": float(r[at])}
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: this script measures K1 on one")
    name = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], stdout=subprocess.PIPE,
                          text=True).stdout.strip()
    print(name, flush=True)
    t0 = time.perf_counter()
    rggb = bayer2rggb(torch.from_numpy(make_frame(6144, 8192))).cuda()
    xe = torch.cat([rggb[1:K + 1].flip(0), rggb, rggb[-K - 1:-1].flip(0)],
                   0)[None].contiguous()
    g = torch.Generator(device="cuda").manual_seed(xe.shape[1])
    uni = torch.rand(xe.shape, generator=g, device="cuda") * 0.7
    print(f"inputs {tuple(xe.shape)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    summary = {"device": name}
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        libs = {"default": build_variant([], d1),
                "fmad_false": build_variant(["-fmad=false"], d2)}
        for data_name, x in (("content", xe), ("uniform", uni)):
            refs = {"float64": plain64(x), "scan32": plain64(x, True),
                    "direct": direct64(x)}
            res = {"scan32_vs_direct": errors(refs["scan32"],
                                              refs["direct"]),
                   "float64_vs_direct": errors(refs["float64"],
                                               refs["direct"])}
            for lname, lib in libs.items():
                m, v, t = k1(lib, x)
                got = (m, v, t.double() ** 2)
                for rname in ("float64", "scan32", "direct"):
                    res[f"K1_{lname}_vs_{rname}"] = errors(got, refs[rname])
                del m, v, t, got
            for key, e in res.items():
                print(f"{data_name} {key}: " + "; ".join(
                    f"{m} {r['max_abs_err']:.3e} at {tuple(r['at'])} "
                    f"(exact {r['exact']:.4e})" for m, r in e.items()),
                    flush=True)
            summary[data_name] = {k: {m: r["max_abs_err"] for m, r in e.items()}
                                  for k, e in res.items()}
            del refs
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
