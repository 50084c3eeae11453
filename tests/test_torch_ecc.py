"""The port's ecc layer (halo2_lib_tpu_torch/ecc/) and MockProver against the
JAX package's, on the repo's secp256k1 ECDSA-verify circuit.

Both packages build the bench circuit (bench.py:build_ecdsa_builder; the
port's utils/testing.py:ecdsa_circuit) at k=12, lookup_bits 11 (the shape of
tests/test_ecdsa.py), with their random-point generators reseeded to 0x5EC0
just before: the synthesized circuits must agree exactly (config params,
break points, every advice, lookup and fixed column, the copy constraints).
Each circuit is built once per module.
"""

import random

import pytest
import torch

import bench
from halo2_lib_tpu.ecc import ec as jax_ec
from halo2_lib_tpu_torch.backend.mock import MockProver
from halo2_lib_tpu_torch.ecc import ec as port_ec
from halo2_lib_tpu_torch.utils.curves import SECP256K1
from halo2_lib_tpu_torch.utils.pinning import pinning_of
from halo2_lib_tpu_torch.utils.testing import ecdsa_circuit, ecdsa_inputs, ecdsa_witness

# One core per test process: the suite runs in parallel workers.
torch.set_num_threads(1)

K, LOOKUP_BITS = 12, 11
SEED = 0x5EC0


@pytest.fixture(scope="module")
def port_builder():
    port_ec.DEFAULT_RNG.seed(SEED)
    return ecdsa_circuit(K, LOOKUP_BITS)


@pytest.fixture(scope="module")
def port_circuit(port_builder):
    return port_builder.synthesize()


@pytest.fixture(scope="module")
def jax_builder():
    jax_ec._RNG.seed(SEED)
    return bench.build_ecdsa_builder(K, LOOKUP_BITS)


@pytest.fixture(scope="module")
def jax_circuit(jax_builder):
    return jax_builder.synthesize()


def test_inputs_match_the_bench():
    assert ecdsa_inputs() == bench.ecdsa_test_inputs()


def test_config_params_and_break_points(port_builder, port_circuit, jax_builder, jax_circuit):
    pp, jp = port_builder.config_params, jax_builder.config_params
    assert pp.to_json() == jp.to_json()
    assert pp.num_advice_per_phase[0] > 2 and pp.num_lookup_advice_per_phase[0] > 1
    assert port_builder.break_points() == jax_builder.break_points()


def test_columns_and_copies_match_jax(port_circuit, jax_circuit):
    pc, jc = port_circuit, jax_circuit
    assert len(pc.phases) == len(jc.phases)
    for pph, jph in zip(pc.phases, jc.phases):
        assert pph.columns == jph.columns
        assert pph.selectors == jph.selectors
    assert pc.lookup_cols == jc.lookup_cols
    assert pc.q_lookup_rows == jc.q_lookup_rows
    assert pc.fixed_cols == jc.fixed_cols
    assert pc.copies == jc.copies
    assert pc.instances == jc.instances


def test_pinned_prover_builder_replays_the_witness(port_builder, port_circuit):
    """The bench's prover flow: the pinned PROVER builder, given an explicit
    random.Random(0x5EC0), fills the same advice columns as the MOCK builder
    that drew from the shared default generator after a reseed."""
    pb = pinning_of(port_builder).prover_builder()
    ecdsa_witness(pb, ecdsa_inputs(), random.Random(SEED))
    assert pb.synthesize().phases[0].columns == port_circuit.phases[0].columns


def test_mock_prover_accepts_and_catches_a_prank(port_builder):
    assert not MockProver.run(K, port_builder).verify()
    ctx = port_builder.main(0)
    cell = ctx.get(len(ctx.advice) // 2)
    old = cell.value
    cell.debug_prank(ctx, old + 1)
    try:
        assert MockProver.run(K, port_builder).verify()
    finally:
        cell.debug_prank(ctx, old)


def test_wrong_msghash_gives_bit_zero():
    """tests/test_ecdsa.py:60: a signature over another message verifies to
    0 in the circuit, which MockProver accepts."""
    pub, r, s, msghash = ecdsa_inputs()
    wrong = (pub, r, s, (msghash + 1) % SECP256K1.scalar.p)
    builder = ecdsa_circuit(K, LOOKUP_BITS, rng=random.Random(SEED), inputs=wrong, expect=0)
    assert not MockProver.run(K, builder).verify()
