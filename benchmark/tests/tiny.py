"""A throwaway checkout for the benchmark's CPU tests: the benchmark's files
copied into a temporary root beside links to the program and its params,
with a BENCHMARK.json of tiny cells whose configuration, traffic and
circuit files are written there too (so they are found by name exactly as
the real ones are)."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH_DIR)

# the golden k=9 circuit of the port's tests (halo2_lib_tpu_torch.utils.testing),
# as a circuit file; its digests are the JAX package's (tests/data/torch_goldens/golden_k9.npz)
GOLDEN_CIRCUIT = '''
import random


def golden_input(cfg):
    return 12345


def witness(cfg, builder, x, rng):
    from halo2_lib_tpu_torch.utils.testing import golden_witness

    golden_witness(builder, x)


def mock_builder(cfg, rng):
    from halo2_lib_tpu_torch.utils.testing import golden_circuit

    return golden_circuit(12345, cfg["k"])


def make_inputs(cfg, seed, count):
    rng = random.Random(seed)
    return [rng.randrange(1, 1 << 19) for _ in range(count)]
'''

GOLDEN_CONFIG = {
    "system": "halo2_prover",
    "circuit": {"name": "golden", "k": 9, "rng_seed": 1},
    "srs_file": "params/kzg_bn254_9.srs",
    "golden": {
        "vk_sha256": "88e243ed5957447b270f8b79e1e5d9c5a7506508bf65dfcd66c971b9679bd5de",
        "proof_sha256": "38f82f76185d9293803d3ab3c16fbfd3326cfbdfdb93371b363c7c0a6952794e",
        "proof_seed": 0,
    },
}

TINY_TRAFFIC = {
    "tiny_prove": {"loop": "closed", "clients": 1, "pool": 3, "min_requests": 2, "check_sample": 1},
    "tiny_commit": {"loop": "closed", "clients": 1, "pool": 2, "op": "commit", "k": 8, "columns": 2,
                    "basis": "lagrange", "min_requests": 3},
    "tiny_commit_monomial": {"loop": "closed", "clients": 1, "pool": 2, "op": "commit", "k": 8, "columns": 1,
                             "basis": "monomial", "min_requests": 2},
    "tiny_ntt": {"loop": "closed", "clients": 1, "pool": 2, "op": "ntt", "log_n": 12, "columns": 1,
                 "min_requests": 2},
}


def make_checkout(tmp: str) -> str:
    """A checkout under `tmp` with the tiny cells; returns its root."""
    root = os.path.join(tmp, "checkout")
    shutil.copytree(BENCH_DIR, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "_out"))
    for name in ("halo2_lib_tpu_torch", "params"):
        os.symlink(os.path.join(REPO, name), os.path.join(root, name))
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "circuits", "golden.py"), "w") as f:
        f.write(GOLDEN_CIRCUIT)
    with open(os.path.join(bench, "configs", "tiny_golden.json"), "w") as f:
        json.dump(GOLDEN_CONFIG, f)
    for name, traffic in TINY_TRAFFIC.items():
        with open(os.path.join(bench, "traffic", name + ".json"), "w") as f:
            json.dump(traffic, f)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "tiny_golden", "source": "tests", "file": "benchmark/configs/tiny_golden.json",
                            "reduced": [], "why": "tests"})
    tiny = [("tiny.prove", "tiny_golden", "tiny_prove", ["proofs_per_s"]),
            ("tiny.commit", "kzg_bn254", "tiny_commit", ["msm_points_per_s"]),
            ("tiny.commit_monomial", "kzg_bn254", "tiny_commit_monomial", ["msm_points_per_s"]),
            ("tiny.ntt", "kzg_bn254", "tiny_ntt", ["ntt_elems_per_s"])]
    for cell, config, traffic, metrics in tiny:
        spec["workloads"].append({"name": cell, "config": config, "traffic": traffic, "chips": 1, "why": "tests"})
        for m in spec["end_to_end"]:
            if m["name"] in metrics:
                m["workloads"].append(cell)
    copies = {"ecdsa_k15.prove": "tiny.prove", "kzg.commit_2p20": "tiny.commit", "kzg.ntt_2p22": "tiny.ntt"}
    for m in spec["per_layer"]:
        m["workloads"] += [copies[w] for w in m["workloads"] if w in copies]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f, indent=1)
    return root


def run(root: str, workload: str, *extra: str, seed: int = 5, seconds: float = 0.0, trace: int = 0,
        timeout: float = 900) -> subprocess.CompletedProcess:
    """`benchmark/run.py --cpu` of `workload` in the checkout `root`."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    cmd = [sys.executable, os.path.join(root, "benchmark", "run.py"), "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace), "--cpu", *extra]
    return subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True, timeout=timeout)


def last_json(proc: subprocess.CompletedProcess) -> dict:
    lines = proc.stdout.strip().splitlines()
    assert proc.returncode == 0 and lines, proc.stderr[-4000:]
    return json.loads(lines[-1])
