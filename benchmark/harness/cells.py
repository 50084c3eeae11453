"""A cell of BENCHMARK.json and the files it names, found by name."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str


@dataclass
class Cell:
    bench_dir: str  # the benchmark's own directory (holds configs/, traffic/, ...)
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    end_to_end: list[Metric] = field(default_factory=list)
    per_layer: list[Metric] = field(default_factory=list)

    @property
    def root(self) -> str:
        """The checkout's root: BENCHMARK.json's directory."""
        return os.path.dirname(self.bench_dir)


def _metric(entry: dict) -> Metric:
    return Metric(entry["name"], entry["unit"])


def load(bench_dir: str, workload: str) -> Cell:
    """The cell `workload` of ``<root>/BENCHMARK.json``, its configuration
    file, its traffic file ``traffic/<traffic>.json`` and the metrics it
    reports: end-to-end ones that list it (or list no cells), per-layer
    ones that list it, or list no cells and move an end-to-end metric it
    reports."""
    root = os.path.dirname(bench_dir)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(bench_dir, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    e2e = [_metric(m) for m in spec["end_to_end"] if m.get("workloads") is None or workload in m["workloads"]]
    names = {m.name for m in e2e}
    layer = [
        _metric(m)
        for m in spec["per_layer"]
        if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)
    ]
    return Cell(bench_dir, workload, int(w["chips"]), w["config"], w["traffic"], config, traffic, e2e, layer)


def load_module(path: str, name: str):
    """Import the file `path` as a module named `name` (a metric's name may
    hold dots, so files are loaded by path, not by import name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(bench_dir: str, name: str):
    """``metrics/<name>.py``'s ``read(run) -> float | None``."""
    return load_module(os.path.join(bench_dir, "metrics", name + ".py"), "bench_metric_" + name.replace(".", "_")).read


def system_module(bench_dir: str, name: str):
    """``systems/<name>.py``: the code that runs one kind of system under test."""
    return load_module(os.path.join(bench_dir, "systems", name + ".py"), "bench_system_" + name)


def circuit_module(bench_dir: str, name: str):
    """``circuits/<name>.py``: one circuit a prover cell proves."""
    return load_module(os.path.join(bench_dir, "circuits", name + ".py"), "bench_circuit_" + name)
