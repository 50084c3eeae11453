"""The golden k=9 circuit's SRS, JAX goldens and JAX proving key on the CPU,
as module-scoped fixtures shared by the prover self-check tests
(test_torch_selfcheck*.py import them)."""

import os

import numpy as np
import pytest

from halo2_lib_tpu_torch.backend.kzg import ParamsKZG
from halo2_lib_tpu_torch.convert import proving_key_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "tests", "data", "torch_goldens")


@pytest.fixture(scope="module")
def params():
    return ParamsKZG.read(os.path.join(ROOT, "params", "kzg_bn254_9.srs"), device="cpu")


@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(GOLDENS, "golden_k9.npz"))


@pytest.fixture(scope="module")
def pk(golden):
    """The JAX golden's proving key, carried across (keygen costs a proof's
    time on one core; tests/test_torch_prover.py holds the port's own)."""
    return proving_key_from_numpy(golden, "cpu")
