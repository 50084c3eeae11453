"""The port's two k=9 circuits beyond the golden one, held byte for byte
against the JAX package on the CPU: a two-phase circuit (create_proof's
`phase_fns`: an RLC whose phase-1 witnesses fold the phase-0 values with the
challenge squeezed after the phase-0 commitments) and a dynamic-lookup
circuit (memory reads through a BasicDynLookupManager, whose table and key
columns the prover commits after the phase advice).

The JAX side is tests/data/torch_goldens/{multiphase,dynlookup}_k9.npz:
make_goldens.py --phases proved the same circuits with the JAX package on the
committed k=9 SRS at seed 0. One keygen and one prove per circuit.
"""

import os

import numpy as np
import pytest
import torch

from halo2_lib_tpu_torch.backend.keygen import keygen
from halo2_lib_tpu_torch.backend.kzg import ParamsKZG
from halo2_lib_tpu_torch.backend.prover import create_proof
from halo2_lib_tpu_torch.backend.verifier import verify_proof
from halo2_lib_tpu_torch.utils.testing import ram_circuit, rlc_circuit, rlc_prover

# One core per test process: the suite runs in parallel workers, and a
# thread pool per worker would oversubscribe the host.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "tests", "data", "torch_goldens")
CIRCUITS = ("multiphase", "dynlookup")


@pytest.fixture(scope="module")
def params():
    return ParamsKZG.read(os.path.join(ROOT, "params", "kzg_bn254_9.srs"), device="cpu")


@pytest.fixture(scope="module")
def proved(params):
    """{name: (vk, proof bytes)} of the port's keygen and seed-0 proof."""
    out = {}
    with torch.inference_mode():
        builder = rlc_circuit()
        pk = keygen(params, builder, device="cpu")
        pb, phase_fns = rlc_prover(pk, builder.break_points())
        out["multiphase"] = (pk.vk, create_proof(params, pk, pb, seed=0, phase_fns=phase_fns,
                                                 device="cpu"))
        builder = ram_circuit()
        pk = keygen(params, builder, device="cpu")
        out["dynlookup"] = (pk.vk, create_proof(params, pk, builder, seed=0, device="cpu"))
    return out


def _golden(name: str):
    return np.load(os.path.join(GOLDENS, f"{name}_k9.npz"))


@pytest.mark.parametrize("name", CIRCUITS)
def test_vk_bytes_match_jax(proved, name):
    assert proved[name][0].to_bytes() == bytes(_golden(name)["vk"])


@pytest.mark.parametrize("name", CIRCUITS)
def test_proof_bytes_match_jax(proved, name):
    assert proved[name][1] == bytes(_golden(name)["proof"])


@pytest.mark.parametrize("name", CIRCUITS)
def test_proof_verifies_and_a_flipped_byte_fails(params, proved, name):
    vk, proof = proved[name]
    assert verify_proof(params, vk, proof)
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    assert not verify_proof(params, vk, bytes(bad))


def test_circuits_take_their_paths(proved):
    """The RLC key has two advice phases and a challenge pin; the RAM key a
    dynamic-lookup set of two key columns."""
    rlc, ram = proved["multiphase"][0], proved["dynlookup"][0]
    assert len(rlc.num_advice_per_phase) == 2 and rlc.challenge_pins
    assert ram.dyn_key_cols == [2]
