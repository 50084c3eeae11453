"""The port's pairing gadgets (halo2_lib_tpu_torch/ecc/{fields_ext, pairing,
final_exp}.py) against the JAX package's, on the CPU.

Each case of tests/test_fields_ext.py (Fp2 multiply and divide, Fp12
multiply, Frobenius, cyclotomic square) is built with both packages, step
for step, and must give the same synthesized circuit (config params, break
points, every advice, lookup and fixed column, the copy constraints) and
the host tower-field values. Then the whole BN254 pairing circuit at
configs/bn254/pairing_circuit.config (k=19, lookup_bits 18, 90-bit limbs,
3 limbs; the port's utils/testing.py:pairing_circuit against the same steps
with the JAX eDSL): the same circuit, and the in-circuit value equal to the
host pairing. Each pairing circuit is built once per module.
"""

import random
from importlib import import_module

import pytest
import torch

from halo2_lib_tpu_torch.backend.mock import MockProver
from halo2_lib_tpu_torch.utils import bn254_pairing as host
from halo2_lib_tpu_torch.utils.curves import FQ2_BN254
from halo2_lib_tpu_torch.utils.fields import FQ_BN254
from halo2_lib_tpu_torch.utils.testing import (
    PAIRING_K, PAIRING_LIMB_BITS, PAIRING_LOOKUP_BITS, PAIRING_NUM_LIMBS, pairing_circuit,
    pairing_inputs,
)

# One core per test process: the suite runs in parallel workers.
torch.set_num_threads(1)

PORT, JAX = "halo2_lib_tpu_torch", "halo2_lib_tpu"


def build(pkg, case, k=15, lookup_bits=14, limb_bits=88, num_limbs=3):
    """A MOCK builder of package `pkg` with `case(pkg, ctx, fp_chip)` as its
    witness, sized by calculate_params (tests/test_fields_ext.py:run_circuit)."""
    circuit = import_module(f"{pkg}.gates.circuit")
    FpChip = import_module(f"{pkg}.ecc.fp").FpChip
    fq = import_module(f"{pkg}.utils.fields").FQ_BN254
    builder = circuit.BaseCircuitBuilder.from_stage(circuit.CircuitBuilderStage.MOCK).use_k(k)
    builder.set_lookup_bits(lookup_bits)
    case(pkg, builder.main(0), FpChip(builder.range_chip(), limb_bits, num_limbs, fq))
    builder.calculate_params(minimum_rows=9)
    return builder


def assert_same_circuit(pb, jb):
    assert pb.config_params.to_json() == jb.config_params.to_json()
    pc, jc = pb.synthesize(), jb.synthesize()
    assert pb.break_points() == jb.break_points()
    assert len(pc.phases) == len(jc.phases)
    for pph, jph in zip(pc.phases, jc.phases):
        assert pph.columns == jph.columns
        assert pph.selectors == jph.selectors
    assert pc.lookup_cols == jc.lookup_cols
    assert pc.q_lookup_rows == jc.q_lookup_rows
    assert pc.fixed_cols == jc.fixed_cols
    assert pc.copies == jc.copies
    assert pc.instances == jc.instances


def rand_fq2(rng):
    return (rng.randrange(FQ_BN254.p), rng.randrange(FQ_BN254.p))


def rand_fq12(rng):
    return host.Fq12([rng.randrange(FQ_BN254.p) for _ in range(12)])


def fp2_mul_divide(pkg, ctx, fp_chip):
    rng = random.Random(21)
    a_v, b_v = rand_fq2(rng), rand_fq2(rng)
    chip = import_module(f"{pkg}.ecc.fields_ext").Fp2Chip(fp_chip)
    a = chip.load_private(ctx, list(a_v))
    b = chip.load_private(ctx, list(b_v))
    assert chip.get_assigned_value(chip.mul(ctx, a, b)) == FQ2_BN254.mul(a_v, b_v)
    q = chip.divide_unsafe(ctx, a, b)
    assert chip.get_assigned_value(q) == FQ2_BN254.mul(a_v, FQ2_BN254.inv(b_v))
    assert chip.get_assigned_value(chip.conjugate(ctx, a)) == FQ2_BN254.conjugate(a_v)


def fp12_mul(pkg, ctx, fp_chip):
    rng = random.Random(22)
    a_v, b_v = rand_fq12(rng), rand_fq12(rng)
    chip = import_module(f"{pkg}.ecc.fields_ext").Fp12Chip(fp_chip)
    a = chip.load_private(ctx, chip.fq12_to_coeffs(a_v))
    b = chip.load_private(ctx, chip.fq12_to_coeffs(b_v))
    assert chip.get_fq12_value(chip.mul(ctx, a, b)) == a_v * b_v
    assert chip.get_fq12_value(chip.divide_unsafe(ctx, a, b)) == a_v * b_v.inv()
    assert chip.get_fq12_value(chip.conjugate(ctx, a)) == a_v.conjugate()


def fp12_frobenius(pkg, ctx, fp_chip):
    rng = random.Random(23)
    a_v = rand_fq12(rng)
    chip = import_module(f"{pkg}.ecc.fields_ext").Fp12Chip(fp_chip)
    frobenius_map = import_module(f"{pkg}.ecc.final_exp").frobenius_map
    a = chip.load_private(ctx, chip.fq12_to_coeffs(a_v))
    for power in (1, 2, 3):
        fr = frobenius_map(chip, ctx, a, power)
        assert chip.get_fq12_value(fr) == a_v.pow(host.P**power), f"power {power}"


def cyclotomic_square(pkg, ctx, fp_chip):
    """Compressed squaring of an element of the cyclotomic subgroup equals
    the true square (Karabina Thm 3.2)."""
    rng = random.Random(24)
    g = rand_fq12(rng).pow(host.P**6 - 1).pow(host.P**2 + 1)
    fe = import_module(f"{pkg}.ecc.final_exp")
    chip = import_module(f"{pkg}.ecc.fields_ext").Fp12Chip(fp_chip)
    a = chip.load_private(ctx, chip.fq12_to_coeffs(g))
    sq = fe.cyclotomic_square(chip, ctx, fe.cyclotomic_compress(a))
    assert chip.get_fq12_value(fe.cyclotomic_decompress(chip, ctx, sq)) == g * g


@pytest.mark.parametrize("case", [fp2_mul_divide, fp12_mul, fp12_frobenius, cyclotomic_square])
def test_fields_ext_cases_match_jax(case):
    assert_same_circuit(build(PORT, case), build(JAX, case))


def test_fp2_case_passes_the_port_mock_prover():
    builder = build(PORT, fp2_mul_divide)
    assert not MockProver.run(15, builder).verify()


# --- the whole pairing circuit at the reference's k=19 config ----------------------


def jax_pairing_witness(pkg, ctx, fp_chip):
    """tests/test_pairing.py:33-45 with the JAX eDSL (utils/testing.py's
    pairing_witness, step for step)."""
    P, Q = pairing_inputs()
    chip = import_module(f"{pkg}.ecc.pairing").PairingChip(fp_chip)
    p_a = chip.load_private_g1_unchecked(ctx, P)
    q_a = chip.load_private_g2_unchecked(ctx, Q)
    f = chip.pairing(ctx, q_a, p_a)
    fp12 = import_module(f"{pkg}.ecc.fields_ext").Fp12Chip(fp_chip)
    assert fp12.get_fq12_value(f) == host.pairing(P, Q)


@pytest.fixture(scope="module")
def port_pairing():
    return pairing_circuit()


def test_pairing_inputs_match_the_jax_test():
    """P random, Q = s G2 with s < 2^40, from random.Random(71) as
    tests/test_pairing.py draws them."""
    from halo2_lib_tpu.utils import bn254_pairing as jax_host
    from halo2_lib_tpu.utils.curves import BN254_G1, BN254_G2

    rng = random.Random(71)
    P = BN254_G1.random_point(rng)
    Q = BN254_G2.mul(BN254_G2.g, rng.randrange(1, 1 << 40))
    assert pairing_inputs() == (P, Q)
    assert host.pairing(P, Q) == jax_host.pairing(P, Q)


def test_pairing_circuit_matches_jax(port_pairing):
    """The config's size (k=19, lookup_bits 18) as calculate_params sizes it,
    and the JAX builder's circuit column for column."""
    cp = port_pairing.config_params
    assert (cp.k, cp.lookup_bits) == (PAIRING_K, PAIRING_LOOKUP_BITS)
    assert cp.num_advice_per_phase[0] >= 6 and cp.num_lookup_advice_per_phase[0] >= 1
    jb = build(JAX, jax_pairing_witness, PAIRING_K, PAIRING_LOOKUP_BITS, PAIRING_LIMB_BITS,
               PAIRING_NUM_LIMBS)
    assert_same_circuit(port_pairing, jb)


@pytest.mark.slow
def test_pairing_circuit_passes_the_port_mock_prover(port_pairing):
    assert not MockProver.run(PAIRING_K, port_pairing).verify()
