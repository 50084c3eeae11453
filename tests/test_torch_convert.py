"""The JAX package's proving key carried across to the port (convert.py):
the port's prover with the converted key must give the JAX golden proof, so
a prover fault shows apart from a keygen fault."""

import os

import numpy as np
import pytest
import torch

from halo2_lib_tpu_torch.backend.kzg import ParamsKZG
from halo2_lib_tpu_torch.backend.prover import create_proof
from halo2_lib_tpu_torch.convert import limbs_from_numpy, limbs_to_numpy, proving_key_from_numpy
from halo2_lib_tpu_torch.utils.testing import golden_circuit

# One core per test process: the suite runs in parallel workers, and a
# thread pool per worker would oversubscribe the host.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "tests", "data", "torch_goldens")


@pytest.fixture(scope="module")
def params():
    return ParamsKZG.read(os.path.join(ROOT, "params", "kzg_bn254_9.srs"), device="cpu")


@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(GOLDENS, "golden_k9.npz"))


def test_proof_with_converted_jax_key(params, golden):
    jpk = proving_key_from_numpy(golden, "cpu")
    assert jpk.vk.to_bytes() == bytes(golden["vk"])
    assert create_proof(params, jpk, golden_circuit(), seed=0, device="cpu") == bytes(golden["proof"])


def test_limbs_conversion_is_identity():
    a = np.random.default_rng(0).integers(0, 1 << 16, size=(3, 16, 5), dtype=np.uint32)
    t = limbs_from_numpy(a, "cpu")
    assert t.dtype == torch.int32
    assert np.array_equal(limbs_to_numpy(t), a)
    with pytest.raises(ValueError):
        limbs_from_numpy(np.array([1 << 16], dtype=np.uint32), "cpu")
