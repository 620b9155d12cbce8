"""The fused entry's stage spans (yondx_torch/core/profiling.span in
pipeline/fused.py) under a CPU torch.profiler: one `yondx.frame` a call
with every stage span inside it, the collab round's spans, a second
`yondx.denoise` only when a second pass runs, output and regs bit-equal
with and without the profiler, and the span names those that
perfbench/spans.py attributes. A tiny s2d SNR-Net (nf 8, random weights)
on a small Poisson-Gaussian frame, the product's keywords, fp32."""
import json
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from yondx_torch.models.unets import GuidedResUnetS2D
from yondx_torch.pipeline.fused import make_fused_blind_denoiser
from yondx_torch.vst.lut import BiasLUT
from torch_test_util import _one_torch_thread  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
from perfbench import spans  # noqa: E402

SCALE = 959.0
# the product's keywords (perfbench/configs/s2dt16-bf16.json, fp32 here)
PRODUCT = dict(guided=True, sigma_corr="adaptive", max_iter=1, refine=True,
               k=29, pad_base=32)


@pytest.fixture(scope="module")
def net():
    torch.manual_seed(0)
    return GuidedResUnetS2D({"nf": 8, "res": True, "norm": True,
                             "out_k": 3, "tail_nf": 4}).eval()


@pytest.fixture(scope="module")
def lut():
    return BiasLUT().lut


@pytest.fixture(scope="module")
def frame():
    """RGGB [1, 96, 128, 4] of 4x4 flat levels, Poisson-Gaussian noise
    (K 6, sigma 8 DN at scale 959)."""
    rng = np.random.default_rng(7)
    clean = np.kron(rng.random((4, 4)) * 0.6 + 0.1, np.ones((24, 32)))
    clean = np.repeat(clean[None, :, :, None], 4, axis=3)
    noisy = (6.0 * rng.poisson(clean * SCALE / 6.0)
             + rng.normal(0, 8.0, clean.shape)) / SCALE
    return torch.from_numpy(np.clip(noisy, 0, 1).astype(np.float32))


def _traced(fn, frame, tmp_path, calls=1):
    """(outputs of each call, the Chrome-trace events) of `calls` calls
    under a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        outs = [fn(frame, SCALE) for _ in range(calls)]
    path = os.path.join(str(tmp_path), "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return outs, json.load(f)["traceEvents"]


def _spans(events):
    return sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e["name"].startswith(spans.PREFIX)))


def _names(events):
    return [s[2] for s in _spans(events)]


def test_one_frame_a_call_with_every_stage_inside(net, lut, frame, tmp_path):
    fn = make_fused_blind_denoiser(net, lut, device="cpu", **PRODUCT)
    _, events = _traced(fn, frame, tmp_path, calls=2)
    ss = _spans(events)
    frames = [s for s in ss if s[2] == spans.FRAME]
    assert len(frames) == 2
    for t0, t1, name in ss:
        if name != spans.FRAME:
            assert sum(f[0] <= t0 and t1 <= f[1] for f in frames) == 1, name
    per_frame = [[s[2] for s in ss if f[0] <= s[0] and s[1] <= f[1]]
                 for f in frames]
    assert per_frame[0] == per_frame[1]
    names = per_frame[0]
    for stage in ("yondx.prepare", "yondx.nle.self", "yondx.gate.stats",
                  "yondx.sigma_corr", "yondx.bias", "yondx.vst",
                  "yondx.net", "yondx.refine", "yondx.inverse",
                  "yondx.nle.collab", "yondx.gate"):
        assert stage in names, stage
    # the gate did not fire: one denoise pass, refined and raw inverses
    assert fn.stats["second_passes"] == 0
    assert names.count("yondx.denoise") == 1
    assert names.count("yondx.inverse") == 2
    assert names.count("yondx.vst") == 2
    sp = spans.reduce(events)
    assert sp["span_frames"] == 2


def test_second_denoise_only_when_a_pass_runs(net, lut, frame, tmp_path):
    fn = make_fused_blind_denoiser(net, lut, device="cpu",
                                   **{**PRODUCT, "iter_policy": "avg"})
    _, events = _traced(fn, frame, tmp_path)
    names = _names(events)
    assert fn.stats["second_passes"] == 1
    assert names.count("yondx.denoise") == 2
    assert names.count("yondx.net") == 2
    assert "yondx.gate.stats" not in names
    assert names.count("yondx.nle.collab") == 1


def test_output_bit_equal_with_and_without_the_profiler(net, lut, frame,
                                                        tmp_path):
    for kw in ({}, {"iter_policy": "avg"}):
        fn = make_fused_blind_denoiser(net, lut, device="cpu",
                                       **{**PRODUCT, **kw})
        dn0, regs0 = fn(frame, SCALE)
        (dn1, regs1), = _traced(fn, frame, tmp_path)[0]
        dn2, regs2 = fn(frame, SCALE)
        for dn, regs in ((dn1, regs1), (dn2, regs2)):
            assert torch.equal(dn, dn0)
            assert torch.equal(regs, regs0)


def test_span_names_are_the_reductions_map(net, lut, frame, tmp_path):
    seen = set()
    for kw in ({}, {"iter_policy": "avg"}):
        fn = make_fused_blind_denoiser(net, lut, device="cpu",
                                       **{**PRODUCT, **kw})
        seen |= set(_names(_traced(fn, frame, tmp_path)[1]))
    assert seen == set(spans.SPANS)
