"""The prover's self-check of the argument families and the JAX package's
debug and commit switches, on the port, at k=9 on the CPU (the golden
circuit of tests/test_torch_prover.py).

* HALO2_PROVER_SELFCHECK=1 re-checks every argument family on H with host
  ints and prints one ``[prover selfcheck]`` line, without changing the
  proof's bytes (test_torch_selfcheck_faults.py: what it names on a
  tampered witness or a faulty device stage; test_torch_selfcheck2.py:
  level 2).
* HALO2_PROVER_DEBUG=1 prints ``[prover]`` and ``[keygen]`` stage lines.
* HALO2_COMMIT_SIMPLE_MAX is read when backend/kzg.py is imported (at most
  2048, the longest column commit_dbl_add takes).

On the card, chip_smoke.py phase 12 proves a k=12 circuit with each switch
and holds the bytes to the proof without it.
"""

import os
import subprocess
import sys

import pytest
import torch

from halo2_lib_tpu_torch.backend.prover import create_proof
from halo2_lib_tpu_torch.utils.testing import golden_circuit
from torch_golden9 import ROOT, golden, params, pk  # noqa: F401 (module-scoped fixtures)

# One core per test process: the suite runs in parallel workers.
torch.set_num_threads(1)


def test_selfcheck_and_debug_keep_the_golden_bytes(monkeypatch, capsys, params, pk, golden):
    monkeypatch.setenv("HALO2_PROVER_SELFCHECK", "1")
    monkeypatch.setenv("HALO2_PROVER_DEBUG", "1")
    proof = create_proof(params, pk, golden_circuit(), seed=0, device="cpu")
    assert proof == bytes(golden["proof"])
    err = capsys.readouterr().err
    assert "[prover selfcheck] all argument families hold on H\n" in err
    assert "selfcheck2" not in err
    for stage in ("synthesize", "runtime", "advice commits", "lookup permuted",
                  "grand products", "quotient", "evals", "shplonk"):
        assert f"[prover] {stage}: " in err, stage


def test_debug_lines_come_from_tagged_stages_only(monkeypatch, capsys):
    """stage_end prints a stage of an entry point that names itself
    (create_proof "prover", keygen "keygen") under HALO2_PROVER_DEBUG=1 only,
    and returns the next stage's start whenever it measured."""
    from halo2_lib_tpu_torch.utils.device import stage_end

    cpu = torch.device("cpu")
    assert stage_end("commit dispatch", 1.0, cpu, None, "keygen") == 1.0
    monkeypatch.setenv("HALO2_PROVER_DEBUG", "1")
    assert stage_end("permutation cycles", 1.0, cpu, None, "keygen") > 1.0
    assert stage_end("g1_batch_mul", 1.0, cpu, None) == 1.0  # setup: no tag
    timings = {}
    stage_end("quotient", 1.0, cpu, timings, "prover")
    err = capsys.readouterr().err.splitlines()
    assert [ln.split(":")[0] for ln in err] == ["[keygen] permutation cycles", "[prover] quotient"]
    assert list(timings) == ["quotient"]


def test_commit_simple_max_is_read_at_import():
    from halo2_lib_tpu_torch.backend import kzg

    if "HALO2_COMMIT_SIMPLE_MAX" not in os.environ:
        assert kzg.COMMIT_SIMPLE_MAX == 1024  # the JAX package's default
    code = "from halo2_lib_tpu_torch.backend import kzg; print(kzg.COMMIT_SIMPLE_MAX)"
    for value, ok in (("2048", True), ("4096", False)):
        env = dict(os.environ, HALO2_COMMIT_SIMPLE_MAX=value, PYTHONPATH=ROOT)
        out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                             text=True, cwd=ROOT)
        if ok:
            assert out.returncode == 0 and out.stdout.strip() == value, out.stderr
        else:
            # longer columns than commit_dbl_add's lane tree holds: refused
            assert out.returncode != 0 and "at most 2048 points" in out.stderr
