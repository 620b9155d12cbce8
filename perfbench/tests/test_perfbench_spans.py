"""spans.py on a hand-built trace: device work attributed by correlation
to the innermost span open at its launch, launches, syncs and mallocs
counted by name inside and between frames, the idle inside frames by
the span open at each gap's midpoint, and the readers of the reduction,
which read None where the trace holds no `yondx.frame` span."""
import pytest

from perfbench import run, spans
from perfbench.spec import load_cell, metric_reader


def _x(name, cat, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "pid": 7, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _events(frames=True):
    """One frame in a window, times in us: spans, the runtime and driver
    calls inside and between the frame, and the device work they
    launched."""
    ann = [_x("perfbench.window", "user_annotation", 0, 1000)]
    if frames:
        ann += [_x("yondx.frame", "user_annotation", 100, 300),
                _x("yondx.nle.self", "user_annotation", 110, 90),
                _x("yondx.denoise", "user_annotation", 200, 150),
                _x("yondx.net", "user_annotation", 210, 90),
                _x("yondx.gate", "user_annotation", 350, 45)]
    rt, drv = "cuda_runtime", "cuda_driver"
    host = [_x("cudaLaunchKernel", rt, 105, 1, corr=5),      # frame's own
            _x("cudaLaunchKernel", rt, 120, 5, corr=1),      # nle.self
            _x("cudaMalloc", rt, 212, 3),                    # net
            _x("cudaLaunchKernel", rt, 220, 5, corr=2),      # net
            _x("cuLaunchKernel", drv, 221, 2, corr=3),       # the same
            _x("cudaMemcpyAsync", rt, 355, 1, corr=4),       # gate
            _x("cudaStreamSynchronize", rt, 356, 20),        # gate
            _x("cudaMemcpy", rt, 380, 2),                    # gate
            _x("cudaMemsetAsync", rt, 390, 1, corr=8),       # gate
            _x("cudaGetDevice", rt, 391, 1),                 # not counted
            _x("cudaDeviceSynchronize", rt, 450, 10),        # between
            _x("cudaLaunchKernel", rt, 500, 2, corr=6)]      # between
    dev = [_x("elementwise_kernel", "kernel", 106, 4, corr=5, tid=9),
           _x("nle_moments_kernel", "kernel", 130, 20, corr=1, tid=9),
           _x("sm90_xmma_fprop_implicit_gemm", "kernel", 230, 50, corr=2,
              tid=9),
           _x("Memcpy HtoD", "gpu_memcpy", 360, 10, corr=4, tid=9),
           _x("Memset", "gpu_memset", 392, 3, corr=8, tid=9),
           _x("reduce_kernel", "kernel", 510, 10, corr=6, tid=9)]
    return ann + host + dev


def test_attribution_counts_and_idle():
    sp = spans.reduce(_events())
    assert sp["span_frames"] == 1
    dev = {k: round(v * 1e6, 6) for k, v in sp["span_device_s"].items()}
    # the frame's own kernel and the one launched between frames: no stage
    assert dev == {"nle.self": 20.0, "net": 50.0, "gate": 13.0,
                   "unattributed": 14.0}
    assert sp["span_k1"] == {"nle.self": 1}
    # the driver launch inside the runtime launch is the same launch
    assert sp["span_launches"] == {"unattributed": 1, "nle.self": 1,
                                   "net": 1, "gate": 2,
                                   spans.BETWEEN: 1}
    assert sp["span_syncs"] == {"gate": 2, spans.BETWEEN: 1}
    assert sp["span_mallocs"] == {"net": 1}
    # the frame's interval runs to its memset's end, 395: gaps 100-106
    # (the frame's own), 110-130 and 150-230 (nle.self), 280-360 (the
    # denoise span, its net closed) and 370-392 (gate)
    idle = {k: round(v * 1e6, 6) for k, v in sp["span_idle_s"].items()}
    assert idle == {"unattributed": 6.0, "nle.self": 100.0,
                    "denoise": 80.0, "gate": 22.0, spans.BETWEEN: 695.0}
    assert sp["span_frame_s"] == pytest.approx(295e-6)
    assert sp["span_frame_idle_s"] == pytest.approx(208e-6)
    assert "nle.self" in spans.table(sp)


def test_calls_by_the_ops_around_them():
    ops = [_x("aten::to", "cpu_op", 354, 25),
           _x("aten::copy_", "cpu_op", 355, 22),
           _x("aten::empty", "cpu_op", 211, 5)]
    # the sync between frames is left out
    assert spans.calls_by_op(_events() + ops) == {
        "sync gate: aten::to > aten::copy_": 1, "sync gate: no op": 1,
        "malloc net: aten::empty > aten::empty": 1}


def test_readers_of_the_reduction(root):
    from types import SimpleNamespace

    from perfbench import frames
    cell = load_cell(root, "s2dt16.imx686")
    cell.traffic["cameras"][0].update(height=64, width=96, frames=2)
    pool, order = frames.make_pool(cell.traffic, 5, "cpu")
    visits = [(i, False) for i in order * 3]
    mp = sum(pool[i].mp for i, _ in visits)
    plain = SimpleNamespace(visits=visits, mp=mp, seconds=1.0)
    traced = SimpleNamespace(visits=visits[:1], mp=mp / len(visits),
                             seconds=0.5)
    tr = {"window_s": 1e-3, "busy_s": 1e-4, "k1_events": 1,
          "class_s": {"glue": 6e-5, "conv": 5e-5, "k1": 2e-5}}
    base = run.readings(cell, pool, plain, traced, 1, tr)
    r = {**base, **spans.reduce(_events())}
    per_mp = 1e3 / r["mp"]
    want = {"net_ms_per_mp": 50e-6 * per_mp, "nle_ms_per_mp": 20e-6 * per_mp,
            "vst_ms_per_mp": 0.0, "refine_ms_per_mp": 0.0,
            "entry_idle": 100.0 * 208 / 295, "launches_per_frame": 5.0,
            "syncs_per_frame": 2.0, "mallocs_per_frame": 1.0}
    assert set(want) == set(spans.METRICS)
    for name, v in want.items():
        got = metric_reader(name)(r)
        assert isinstance(got, float), name
        assert got == pytest.approx(v, rel=1e-9, abs=1e-12), name
    # no yondx.frame span (a program without the spans), or no reduction
    # merged at all: every reader reads nothing
    for rr in ({**base, **spans.reduce(_events(frames=False))}, base):
        for name in spans.METRICS:
            assert metric_reader(name)(rr) is None, name
