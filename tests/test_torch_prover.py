"""The port's slice as a whole at k=9: keygen -> create_proof -> verify_proof
on the CPU, held byte for byte against the JAX package.

The JAX side comes from tests/data/torch_goldens/ (make_goldens.py ran the
JAX package on the same circuits, SRS and seed): the live JAX prover costs
minutes of XLA compile. A live JAX-against-port run is the slow test at the
end. test_torch_convert.py proves with the JAX key carried across and
test_torch_instances.py proves the instance-column circuit.
"""

import os

import numpy as np
import pytest
import torch

from halo2_lib_tpu_torch.backend.keygen import VerifyingKey, keygen
from halo2_lib_tpu_torch.backend.kzg import ParamsKZG
from halo2_lib_tpu_torch.backend.prover import create_proof
from halo2_lib_tpu_torch.backend.verifier import verify_proof
from halo2_lib_tpu_torch.convert import limbs_to_numpy
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


@pytest.fixture(scope="module")
def pk(params):
    return keygen(params, golden_circuit(), device="cpu")


@pytest.fixture(scope="module")
def proof(params, pk):
    return create_proof(params, pk, golden_circuit(), seed=0, device="cpu")


def test_vk_bytes_match_jax(pk, golden):
    assert pk.vk.to_bytes() == bytes(golden["vk"])


def test_transcript_repr_matches_jax(pk, golden):
    assert pk.vk.transcript_repr() == int.from_bytes(bytes(golden["transcript_repr"]), "little")


def test_sigma_matches_jax(pk, golden):
    assert np.array_equal(limbs_to_numpy(pk.perm_values), golden["perm_values"].astype(np.uint32))


def test_proof_matches_jax(proof, golden):
    assert proof == bytes(golden["proof"])


def test_verify_accepts_and_rejects_a_flipped_byte(params, pk, proof):
    assert verify_proof(params, pk.vk, proof)
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    assert not verify_proof(params, pk.vk, bytes(bad))


def test_vk_from_bytes_round_trip(golden):
    vk = VerifyingKey.from_bytes(bytes(golden["vk"]))
    assert vk.to_bytes() == bytes(golden["vk"])


def test_entry_points_need_a_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        ParamsKZG.read(os.path.join(ROOT, "params", "kzg_bn254_8.srs"))


@pytest.mark.slow
def test_live_jax_against_port(params, proof):
    """The JAX package proves the same circuit now (minutes of XLA compile)."""
    from halo2_lib_tpu.backend.keygen import keygen as jkeygen
    from halo2_lib_tpu.backend.kzg import ParamsKZG as JParams
    from halo2_lib_tpu.backend.prover import create_proof as jprove
    from halo2_lib_tpu.core.cells import Constant, Existing
    from halo2_lib_tpu.gates.circuit import BaseCircuitBuilder, CircuitBuilderStage

    def jcircuit():
        builder = BaseCircuitBuilder.from_stage(CircuitBuilderStage.MOCK).use_k(9)
        builder.set_lookup_bits(8)
        rc = builder.range_chip()
        ctx = builder.main(0)
        x = ctx.load_witness(12345)
        z = rc.gate.add(ctx, Existing(rc.gate.mul(ctx, Existing(x), Existing(x))), Constant(7))
        for _ in range(10):
            z = rc.gate.mul_add(ctx, Existing(z), Existing(x), Constant(3))
        rc.range_check(ctx, z, 240)
        rc.check_less_than(ctx, Existing(x), Constant(1 << 40), 48)
        builder.calculate_params(minimum_rows=9)
        p = builder.config_params
        p.num_advice_per_phase[0] = max(p.num_advice_per_phase[0], 2)
        p.num_lookup_advice_per_phase[0] = max(p.num_lookup_advice_per_phase[0], 1)
        return builder

    jparams = JParams.read(os.path.join(ROOT, "params", "kzg_bn254_9.srs"))
    jpk = jkeygen(jparams, jcircuit())
    assert jprove(jparams, jpk, jcircuit(), seed=0) == proof
