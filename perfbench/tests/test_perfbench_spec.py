"""A configuration, a traffic mix, a cell's limits and a per-layer metric
are added to a copy of the benchmark by adding files and BENCHMARK.json
entries alone;
the harness finds them by name, runs the new cell, and no file that was
there changes."""
import hashlib
import json
import os
import shutil
import time

from perfbench import run
from perfbench.spec import load_cell, metric_reader


def _digests(top):
    out = {}
    for d, _, names in os.walk(top):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, top)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


def test_new_files_are_found_by_name(root, tmp_path):
    here = tmp_path / "perfbench"
    shutil.copytree(os.path.join(root, "perfbench"), here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(root, "BENCHMARK.json"), tmp_path)
    before = _digests(tmp_path)

    with open(here / "configs" / "gru32-fp32.json") as f:
        cfg = json.load(f)
    cfg["name"] = "gru32-fp32-h200"
    cfg["peak_tflops"] = 67.5
    with open(here / "configs" / "gru32-fp32-h200.json", "w") as f:
        json.dump(cfg, f)
    with open(here / "traffic" / "imx686.json") as f:
        mix = json.load(f)
    mix["cameras"][0].update(height=128, width=192, frames=3)
    with open(here / "traffic" / "thumbs.json", "w") as f:
        json.dump(mix, f)
    shutil.copy(here / "limits" / "gru32.imx686.json",
                here / "limits" / "gru32.thumbs.json")
    (here / "metrics" / "frames_seen.py").write_text(
        "def read(r):\n    return float(r['frames'])\n")
    with open(tmp_path / "BENCHMARK.json") as f:
        bench = json.load(f)
    bench["configs"].append({"name": "gru32-fp32-h200", "source": "a test",
                             "file": "perfbench/configs/gru32-fp32-h200.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "gru32.thumbs",
                               "config": "gru32-fp32-h200",
                               "traffic": "thumbs", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "frames_seen", "unit": "frames",
                               "better": "higher", "source": "program_counter",
                               "layer": "a test", "moves": "mp_per_s",
                               "workloads": ["gru32.thumbs"]})
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)

    cell = load_cell(str(tmp_path), "gru32.thumbs", here=str(here))
    assert cell.config["peak_tflops"] == 67.5
    assert cell.traffic["cameras"][0]["height"] == 128
    assert [m["name"] for m in cell.per_layer] == ["frames_seen"]
    assert [m["name"] for m in cell.end_to_end] == ["mp_per_s", "setup_s"]
    assert metric_reader("frames_seen", here=str(here))({"frames": 3}) == 3.0
    res, _ = run.run(cell, 4, 0.01, 0, root, device="cpu",
                     t_start=time.perf_counter())
    assert res["attempted"] >= 1 and set(res["metrics"]) == {"mp_per_s",
                                                             "setup_s"}
    after = _digests(tmp_path)
    changed = {p for p in before if before[p] != after.get(p)}
    assert changed == {"BENCHMARK.json"}


def test_every_reader_reads_the_harness_readings(root):
    """Each per-layer metric of BENCHMARK.json reads a number from what
    run.readings hands the readers (the trace's reduction stood in for by
    fixed times), and a share reads between 0 and 100."""
    from types import SimpleNamespace

    from perfbench import frames
    cell = load_cell(root, "s2dt16.imx686")
    cell.traffic["cameras"][0].update(height=64, width=96, frames=2)
    pool, order = frames.make_pool(cell.traffic, 5, "cpu")
    visits = [(i, False) for i in order * 3]
    mp = sum(pool[i].mp for i, _ in visits)
    plain = SimpleNamespace(visits=visits, mp=mp, seconds=1.0)
    traced = SimpleNamespace(visits=visits[:4], mp=mp * 4 / len(visits),
                             seconds=0.5)
    tr = {"window_s": 0.5, "busy_s": 0.1, "k1_events": 12,
          "class_s": {"glue": 0.06, "conv": 0.03, "k1": 1e-3, "copy": 1e-4}}
    r = run.readings(cell, pool, plain, traced, 12, tr)
    for m in cell.per_layer:
        v = metric_reader(m["name"])(r)
        assert isinstance(v, float), m["name"]
        if m["unit"] == "%":
            assert 0.0 <= v <= 100.0, (m["name"], v)
    assert metric_reader("device_idle")(r) == 80.0
    # 0.1 s busy over 4 of the 6 visits' megapixels: 0.15 s of the 1 s
    assert abs(metric_reader("device_idle_untraced")(r) - 85.0) < 1e-9
