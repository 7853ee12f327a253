"""What ``BENCHMARK.json`` says of one cell, with the files it names.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; each is a file found by its name (``configs/<config>.json``,
``traffic/<traffic>.json``), and each per-layer metric is a reader
module found by its name (``metrics/<metric>.py``). A cell reports the
end-to-end metrics that list it under ``workloads`` or list no cells,
and the per-layer metrics that list it, or list no cells and move an
end-to-end metric the cell reports.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list

    @property
    def name(self) -> str:
        return self.workload["name"]


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def _reports(metric: dict, cell: str, moved=None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return moved is None or metric["moves"] in moved


def cell(name: str, root: str = ROOT) -> Cell:
    spec = benchmark(root)
    found = [w for w in spec["workloads"] if w["name"] == name]
    if not found:
        known = ", ".join(w["name"] for w in spec["workloads"])
        raise KeyError(f"no workload {name!r} (known: {known})")
    w = found[0]
    conf = [c for c in spec["configs"] if c["name"] == w["config"]][0]
    config = _json(os.path.join(root, conf["file"]))
    traffic = _json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _reports(m, name, moved)]
    return Cell(w, config, traffic, e2e, per_layer)


def reader(metric: str):
    """The ``read(trace)`` function of a per-layer metric."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
