"""The prover's level-2 self-check (HALO2_PROVER_SELFCHECK=2): every runtime
and table column round-trips ext -> coefficients -> Lagrange before the
quotient, at k=9 on the CPU, and the proof keeps the golden bytes."""

import pytest
import torch

from halo2_lib_tpu_torch.backend.prover import create_proof
from halo2_lib_tpu_torch.utils.testing import golden_circuit
from torch_golden9 import golden, params, pk  # noqa: F401 (module-scoped fixtures)

# One core per test process: the suite runs in parallel workers.
torch.set_num_threads(1)


def test_selfcheck2_keeps_the_golden_bytes(monkeypatch, capsys, params, pk, golden):
    monkeypatch.setenv("HALO2_PROVER_SELFCHECK", "2")
    proof = create_proof(params, pk, golden_circuit(), seed=0, device="cpu")
    assert proof == bytes(golden["proof"])
    err = capsys.readouterr().err
    lines = [ln for ln in err.splitlines() if ln.startswith("[prover selfcheck2]")]
    # every column round-trips: only the count is printed, the runtime
    # columns' and the tables'
    ncols = len(pk.vk.perm_columns)
    assert len(lines) == 1 and lines[0].endswith(" columns checked"), lines
    assert int(lines[0].split()[2]) > ncols
    assert "[prover selfcheck]" not in err
