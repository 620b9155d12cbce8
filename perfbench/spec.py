"""Resolution of a cell by name: BENCHMARK.json at the checkout's root
names the cell's configuration, traffic mix and metrics, and each is a
file of its own, found by that name alone:

    configs/<config>.json     the configuration as it is run
    traffic/<traffic>.json    the traffic mix the generator reads
    metrics/<metric>.py       a per-layer metric's reader, read(r)
    limits/<cell>.json        the limits of the cell's check, with the
                              readings they were set from
"""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))


def _load_json(path):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    limits: dict


def _applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root, workload, here=HERE):
    """The cell `workload` of root/BENCHMARK.json with its files read
    from the harness directory `here`."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; one of {sorted(cells)}")
    w = cells[workload]
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=_load_json(os.path.join(here, "configs",
                                       w["config"] + ".json")),
        traffic=_load_json(os.path.join(here, "traffic",
                                        w["traffic"] + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
        limits=_load_json(os.path.join(here, "limits",
                                       workload + ".json"))["limits"])


def metric_reader(name, here=HERE):
    """The `read` function of metrics/<name>.py."""
    path = os.path.join(here, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
