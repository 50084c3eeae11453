"""The harness on the CPU at tiny sizes: cells found by name, the result
line, the generator, and what may not be loaded."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import run as bench_run
from benchmark.harness import traffic
from benchmark.tests import tiny

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny.make_checkout(str(tmp_path_factory.mktemp("bench")))


def test_a_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    """A later PR adds files and entries only: a configuration file, a
    traffic file and a metric reader, none of which the harness knows."""
    root = tiny.make_checkout(str(tmp_path))
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "configs", "kzg_bn254.json")) as f:
        config = json.load(f)
    with open(os.path.join(bench, "configs", "throwaway.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(bench, "traffic", "throwaway_mix.json"), "w") as f:
        json.dump({"loop": "closed", "clients": 1, "pool": 3, "op": "commit", "k": 8, "columns": 1,
                   "basis": "monomial", "min_requests": 2}, f)
    with open(os.path.join(bench, "metrics", "calls_per_s.throwaway.py"), "w") as f:
        f.write("def read(run):\n    return run.attempted / run.window_s\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "throwaway", "source": "tests", "file": "benchmark/configs/throwaway.json",
                            "reduced": [], "why": "tests"})
    spec["workloads"].append({"name": "throwaway.cell", "config": "throwaway", "traffic": "throwaway_mix",
                              "chips": 1, "why": "tests"})
    next(m for m in spec["end_to_end"] if m["name"] == "msm_points_per_s")["workloads"].append("throwaway.cell")
    spec["per_layer"].append({"name": "calls_per_s.throwaway", "unit": "calls/s", "better": "higher",
                              "source": "host_clock", "layer": "commitments", "moves": "msm_points_per_s",
                              "workloads": ["throwaway.cell"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    out = tiny.last_json(tiny.run(root, "throwaway.cell", trace=1))
    assert out["correct"] and out["attempted"] >= 2
    assert set(out["metrics"]) >= {"calls_per_s.throwaway"}
    assert out["metrics"]["calls_per_s.throwaway"]["unit"] == "calls/s"
    e2e = tiny.last_json(tiny.run(root, "throwaway.cell", trace=0))
    assert set(e2e["metrics"]) == {"msm_points_per_s", "setup_s"}


@pytest.mark.parametrize("cell", ["tiny.commit", "tiny.ntt"])
def test_the_last_line(checkout, cell):
    proc = tiny.run(checkout, cell)
    out = tiny.last_json(proc)
    assert list(out)[:5] == RESULT_KEYS and list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == {"setup_s", "msm_points_per_s" if "commit" in cell else "ntt_elems_per_s"}
    assert all(set(v) == {"value", "unit"} for v in out["metrics"].values())
    assert out["device"]["platform"] == "cpu" and out["device"]["count"] == 1
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())
    # the numbers compared are the last lines on standard error, each beside its limit
    tail = proc.stderr.strip().splitlines()[-len(out["checks"]):]
    assert tail == [f"check {k}: {v['value']} (limit {v['limit']})" for k, v in out["checks"].items()]


def test_the_traced_line(checkout):
    out = tiny.last_json(tiny.run(checkout, "tiny.ntt", trace=1))
    assert out["metrics"] == {}  # the CPU gives no device trace: no idle share, no roofline share
    assert out["device"]["window_s"] > 0 and "busy_s" in out["device"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(out)[-1] == "checks"


def test_no_card_no_result(checkout):
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "tiny.ntt", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=checkout, capture_output=True, text=True)
    if proc.returncode == 0:
        pytest.skip("a card is visible here")
    assert proc.stdout == "" and "CUDA device" in proc.stderr


def test_no_program_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    root = tiny.make_checkout(str(tmp_path))
    for name in ("halo2_lib_tpu_torch", "params"):
        os.unlink(os.path.join(root, name))
    proc = tiny.run(root, "tiny.ntt")
    assert proc.returncode != 0 and proc.stdout == ""


class _Event:
    """A stand-in for a profiler event: name, start and end in ns."""

    def __init__(self, name, a, b, device=False, annotation=False, thread=1):
        self._n, self._a, self._b, self._d, self._u, self._t = name, a, b, device, annotation, thread

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a

    def device_type(self):
        import torch

        return torch.autograd.DeviceType.CUDA if self._d else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self._u

    def start_thread_id(self):
        return self._t


def test_the_trace_reduction_by_hand():
    from benchmark.harness import profiling

    ms = 1_000_000
    events = [
        _Event("bench.window", 0, 100 * ms), _Event("bench.create_proof", 0, 40 * ms),
        _Event("aten::mm", 1 * ms, 10 * ms), _Event("k1(int*, long)", 2 * ms, 30 * ms, device=True),
        _Event("bench.create_proof", 0, 40 * ms, device=True, annotation=True),  # not device work
        _Event("bench.witness", 40 * ms, 90 * ms), _Event("k2", 90 * ms, 95 * ms, device=True),
        _Event("k2", 95 * ms + 5000, 100 * ms, device=True),  # a 5 us launch gap
        _Event("elsewhere", 30 * ms, 95 * ms, thread=2),  # another thread: not what the benchmark did
    ]
    tr = profiling.reduce_events(events)
    assert tr.window_s == pytest.approx(0.1)
    assert tr.busy_s == pytest.approx(0.038 - 5e-6)
    assert tr.device_ops == [["k1", pytest.approx(0.028)], ["k2", pytest.approx(0.01 - 5e-6)]]
    gaps = dict(tr.idle_gaps)
    assert gaps["bench.witness"] == pytest.approx(0.05, rel=0.02)
    assert gaps["bench.create_proof"] == pytest.approx(0.011, rel=0.05)
    assert gaps[profiling.SHORT_GAP_NAME] == pytest.approx(5e-6)
    assert "elsewhere" not in gaps


def test_the_request_order():
    t = {"loop": "closed", "clients": 1, "pool": 4}
    gen = traffic.request_order(t, 2**33 + 7)
    seq = [next(gen) for _ in range(400)]
    assert sorted(seq[:4]) == [0, 1, 2, 3]
    assert all(a != b for a, b in zip(seq, seq[1:]))
    again = traffic.request_order(t, 2**33 + 7)
    assert [next(again) for _ in range(400)] == seq
    with pytest.raises(ValueError):
        next(traffic.request_order({"loop": "open", "clients": 1, "pool": 4}, 1))


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "halo2_lib_tpu_torch_fake", sys)
    assert bench_run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "halo2_lib_tpu.fake", sys)
    assert bench_run.loaded_forbidden() == ["halo2_lib_tpu"]


WALK = """
import json, sys
sys.argv = ["run.py"] + {args}
sys.path.insert(0, {root!r})
import runpy
try:
    runpy.run_path({script!r}, run_name="__main__")
except SystemExit as e:
    assert e.code in (0, None), e.code
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_nothing_a_run_loads_is_jax(checkout):
    """A whole run in one process, then every loaded module's top-level name."""
    args = ["--workload", "tiny.ntt", "--seed", "3", "--seconds", "0", "--trace", "0", "--cpu"]
    code = WALK.format(args=args, root=checkout, script=os.path.join(checkout, "benchmark", "run.py"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=checkout, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    names = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "halo2_lib_tpu_torch" in names and "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "halo2_lib_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys, pkgutil, importlib, benchmark.reference as r\n"
            "for m in pkgutil.walk_packages(r.__path__, 'benchmark.reference.'):\n"
            "    importlib.import_module(m.name)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tiny.REPO, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    names = set(eval(proc.stdout.strip()))
    assert "benchmark" in names
    assert not names & {"halo2_lib_tpu_torch", "halo2_lib_tpu", "jax", "jaxlib"}


def test_the_benchmark_reads_no_jax_era_file():
    """bench.py, BENCH_*.json and BASELINE.json measure the JAX package."""
    for dirpath, _, files in os.walk(tiny.BENCH_DIR):
        for name in files:
            if name.endswith((".py", ".json")) and "tests" not in dirpath:
                with open(os.path.join(dirpath, name)) as f:
                    text = f.read()
                for word in ("BENCH_r0", "BASELINE.json", "import jax", "from jax", "halo2_lib_tpu."):
                    assert word not in text, (name, word)


@pytest.mark.cuda
def test_a_cell_on_the_card(card):
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "kzg.ntt_2p22", "--seed",
                           str(2**31 + 11), "--seconds", "2", "--trace", "0"],
                          cwd=tiny.REPO, capture_output=True, text=True, timeout=900)
    out = tiny.last_json(proc)
    assert out["correct"] and out["device"]["platform"] == "gpu"
