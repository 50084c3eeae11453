"""Circuits that drive the port end to end (tests and chip_smoke.py).

`tests/data/torch_goldens/make_goldens.py` builds the same circuits with the
JAX package's eDSL (the ECDSA one with `bench.py`'s helpers, which the
functions below follow step for step); the port's proofs of them must be
byte-identical to the goldens that script writes.
"""

from __future__ import annotations

import random

from ..backend.challenges import mock_challenge
from ..core.cells import Constant, Existing
from ..core.dyn_lookup import BasicDynLookupManager
from ..ecc.ec import EccChip
from ..ecc.ecdsa import ecdsa_sign, ecdsa_verify_no_pubkey_check
from ..ecc.fields_ext import Fp12Chip
from ..ecc.fp import FpChip
from ..ecc.pairing import PairingChip
from ..gates.circuit import BaseCircuitBuilder, CircuitBuilderStage
from ..gates.flex_gate import GateChip
from . import bn254_pairing
from .curves import BN254_G1, BN254_G2, SECP256K1
from .fields import FQ_BN254, FR_BN254

GOLDEN_K = 9


def golden_circuit(x_val: int = 12345, k: int = GOLDEN_K) -> BaseCircuitBuilder:
    """Range checks, a mul_add chain and a less-than check, at >= 2 advice
    columns and 1 lookup column (the k=9 prover test circuit)."""
    builder = BaseCircuitBuilder.from_stage(CircuitBuilderStage.MOCK).use_k(k)
    builder.set_lookup_bits(8)
    rc = builder.range_chip()
    gate = rc.gate
    ctx = builder.main(0)
    x = ctx.load_witness(x_val)
    y = gate.mul(ctx, Existing(x), Existing(x))
    z = gate.add(ctx, Existing(y), Constant(7))
    for _ in range(10):
        z = gate.mul_add(ctx, Existing(z), Existing(x), Constant(3))
    rc.range_check(ctx, z, 240)
    rc.check_less_than(ctx, Existing(x), Constant(1 << 40), 48)
    builder.calculate_params(minimum_rows=9)
    p = builder.config_params
    p.num_advice_per_phase[0] = max(p.num_advice_per_phase[0], 2)
    p.num_lookup_advice_per_phase[0] = max(p.num_lookup_advice_per_phase[0], 1)
    return builder


def instance_circuit(xv: int = 1234567, yv: int = 89, k: int = GOLDEN_K):
    """One instance column exposing x and x*y. Returns (builder, instances)."""
    builder = BaseCircuitBuilder.from_stage(CircuitBuilderStage.MOCK).use_k(k)
    builder.set_instance_columns(1)
    gate = GateChip(FR_BN254)
    ctx = builder.main(0)
    x = ctx.load_witness(xv)
    y = ctx.load_witness(yv)
    z = gate.mul(ctx, Existing(x), Existing(y))
    builder.assigned_instances[0].extend([x, z])
    builder.calculate_params(minimum_rows=9)
    builder.config_params.num_advice_per_phase[0] = max(
        builder.config_params.num_advice_per_phase[0], 1
    )
    return builder, [[xv, xv * yv % FR_BN254.p]]


RLC_VALS = [3, 1415926, 535897, 93238462]


def rlc_phase1(builder: BaseCircuitBuilder, gate: GateChip, vals, challenge: int):
    """Phase-1 witnesses of the RLC circuit: pin the challenge
    (`constrain_challenge`), then fold vals by Horner. Returns the fold."""
    ctx1 = builder.main(1)
    ch = ctx1.load_witness(challenge)
    builder.constrain_challenge(ch, 0)
    acc = vals[0]
    for v in vals[1:]:
        acc = gate.mul_add(ctx1, acc, ch, v)
    return acc


def rlc_circuit(k: int = GOLDEN_K) -> BaseCircuitBuilder:
    """A two-phase circuit: phase 0 loads RLC_VALS, phase 1 folds them with
    the phase-0 challenge (here the mock stand-in, as keygen sees it)."""
    builder = BaseCircuitBuilder.from_stage(CircuitBuilderStage.MOCK).use_k(k)
    gate = GateChip(FR_BN254)
    ctx0 = builder.main(0)
    vs = [ctx0.load_witness(v) for v in RLC_VALS]
    rlc_phase1(builder, gate, vs, mock_challenge(0))
    builder.calculate_params(minimum_rows=9)
    return builder


def rlc_prover(pk, break_points):
    """(prover builder, phase_fns) for create_proof of the RLC circuit: the
    phase-0 witnesses, and the closure that adds phase 1 from the challenge
    create_proof squeezes after the phase-0 commitments."""
    pb = BaseCircuitBuilder.prover(pk.config_params, break_points)
    gate = GateChip(FR_BN254)
    ctx0 = pb.main(0)
    vs = [ctx0.load_witness(v) for v in RLC_VALS]

    def phase1(b, chals):
        rlc_phase1(b, gate, vs, chals[0])

    return pb, {1: phase1}


def ram_circuit(k: int = GOLDEN_K) -> BaseCircuitBuilder:
    """Memory reads through a dynamic lookup: a table of 64 (index, value)
    rows and 32 reads of it (key_col=2), at >= 2 advice columns."""
    rng = random.Random(81)
    memory = [rng.randrange(1 << 64) for _ in range(64)]
    reads = [rng.randrange(64) for _ in range(32)]
    builder = BaseCircuitBuilder.from_stage(CircuitBuilderStage.MOCK).use_k(k)
    mgr = BasicDynLookupManager(key_col=2)
    builder.dyn_lookup_manager = mgr
    ctx = builder.main(0)
    for idx, val in enumerate(memory):
        mgr.sets[0].add_table_row((ctx.load_witness(idx), ctx.load_witness(val)))
    for r in reads:
        mgr.sets[0].add_lookup((ctx.load_witness(r), ctx.load_witness(memory[r])))
    builder.calculate_params(minimum_rows=9)
    p = builder.config_params
    p.num_advice_per_phase[0] = max(p.num_advice_per_phase[0], 2)
    return builder


def slice_circuit(k: int = 15, iters: int = 7000, seed: int = 0) -> BaseCircuitBuilder:
    """The column shape of the ECDSA bench circuit at k=15 (lookup_bits =
    k - 1, >= 4 gate-advice columns, 1 lookup-advice column, every column
    at its full 2^k rows), built from range checks and a mul_add chain.

    Each step loads a 56-bit witness, range-checks it (4 lookup limbs of 14
    bits) and folds it into the chain: 15 advice cells and 4 lookup cells.
    """
    rng = random.Random(repr(("slice-circuit", seed)))
    lookup_bits = k - 1
    builder = BaseCircuitBuilder.from_stage(CircuitBuilderStage.MOCK).use_k(k)
    builder.set_lookup_bits(lookup_bits)
    rc = builder.range_chip()
    gate = rc.gate
    ctx = builder.main(0)
    z = ctx.load_witness(rng.randrange(1 << 56))
    for _ in range(iters):
        a = ctx.load_witness(rng.randrange(1 << 56))
        rc.range_check(ctx, a, 4 * lookup_bits)
        z = gate.mul_add(ctx, Existing(z), Existing(a), Constant(3))
    builder.calculate_params(minimum_rows=9)
    return builder


def ecdsa_inputs():
    """(pubkey, r, s, msghash): a secp256k1 signature from fixed seeds (the
    repo's ECDSA bench inputs, bench.py:ecdsa_test_inputs)."""
    rng = random.Random(42)
    n = SECP256K1.scalar
    priv = rng.randrange(1, n.p)
    pub = SECP256K1.mul(SECP256K1.g, priv)
    msghash = rng.randrange(1, n.p)
    nonce = rng.randrange(1, n.p)
    r, s = ecdsa_sign(SECP256K1, priv, msghash, nonce)
    return pub, r, s, msghash


def ecdsa_witness(builder: BaseCircuitBuilder, inputs, rng: random.Random | None = None, expect: int = 1):
    """In-circuit ECDSA verification of `inputs` on a MOCK or PROVER builder
    (88-bit limbs, 3 limbs, windows 4 and 4; bench.py:ecdsa_witness). The
    circuit's random points come from `rng` (ecc/ec.py's shared DEFAULT_RNG
    when None). Asserts the in-circuit bit equals `expect`."""
    pub, r, s, msghash = inputs
    range_chip = builder.range_chip()
    fp_chip = FpChip(range_chip, 88, 3, SECP256K1.base)
    fq_chip = FpChip(range_chip, 88, 3, SECP256K1.scalar)
    chip = EccChip(fp_chip, SECP256K1, rng)
    ctx = builder.main(0)
    pk_pt = chip.load_private(ctx, pub)
    r_a = fq_chip.load_private(ctx, r)
    s_a = fq_chip.load_private(ctx, s)
    m_a = fq_chip.load_private(ctx, msghash)
    out = ecdsa_verify_no_pubkey_check(chip, ctx, pk_pt, r_a, s_a, m_a, 4, 4)
    assert out.val() == expect, f"in-circuit ECDSA bit {out.val()} != {expect}"
    return builder


def ecdsa_circuit(
    k: int = 15, lookup_bits: int = 14, rng: random.Random | None = None, inputs=None, expect: int = 1
) -> BaseCircuitBuilder:
    """The repo's headline circuit: secp256k1 ECDSA verification on a MOCK
    builder, sized by calculate_params (bench.py:build_ecdsa_builder; at
    k=15: 18 advice columns, 3 lookup-advice columns, 1 fixed column)."""
    builder = BaseCircuitBuilder.from_stage(CircuitBuilderStage.MOCK).use_k(k)
    builder.set_lookup_bits(lookup_bits)
    ecdsa_witness(builder, ecdsa_inputs() if inputs is None else inputs, rng, expect)
    builder.calculate_params(minimum_rows=9)
    p = builder.config_params
    p.num_advice_per_phase[0] = max(p.num_advice_per_phase[0], 2)
    p.num_lookup_advice_per_phase[0] = max(p.num_lookup_advice_per_phase[0], 1)
    return builder


# configs/bn254/pairing_circuit.config: degree 19, lookup_bits 18, 90-bit
# limbs, 3 limbs (its column counts are what calculate_params gives)
PAIRING_K, PAIRING_LOOKUP_BITS, PAIRING_LIMB_BITS, PAIRING_NUM_LIMBS = 19, 18, 90, 3


def pairing_inputs(seed: int = 71):
    """(P, Q): P a random G1 point, Q = s G2 with 1 <= s < 2^40, drawn from
    random.Random(seed) (tests/test_pairing.py's inputs at seed 71)."""
    rng = random.Random(seed)
    P = BN254_G1.random_point(rng)
    s = rng.randrange(1, 1 << 40)
    return P, BN254_G2.mul(BN254_G2.g, s)


def pairing_witness(builder: BaseCircuitBuilder, inputs) -> BaseCircuitBuilder:
    """The optimal Ate pairing e(P, Q) in the circuit, on a MOCK or PROVER
    builder (tests/test_pairing.py:33-45): P and Q loaded unchecked,
    PairingChip.pairing (Miller loop and final exponentiation). Asserts the
    in-circuit Fp12 value equals the host pairing."""
    P, Q = inputs
    fp_chip = FpChip(builder.range_chip(), PAIRING_LIMB_BITS, PAIRING_NUM_LIMBS, FQ_BN254)
    chip = PairingChip(fp_chip)
    ctx = builder.main(0)
    p_a = chip.load_private_g1_unchecked(ctx, P)
    q_a = chip.load_private_g2_unchecked(ctx, Q)
    f = chip.pairing(ctx, q_a, p_a)
    got = Fp12Chip(fp_chip).get_fq12_value(f)
    if got != bn254_pairing.pairing(P, Q):
        raise AssertionError("in-circuit pairing != host pairing")
    return builder


def pairing_circuit(stage: CircuitBuilderStage = CircuitBuilderStage.MOCK) -> BaseCircuitBuilder:
    """The BN254 pairing circuit at configs/bn254/pairing_circuit.config on
    pairing_inputs(), sized by calculate_params (7 advice, 1 lookup-advice
    and 1 fixed column, about 3.5M advice cells)."""
    builder = BaseCircuitBuilder.from_stage(stage).use_k(PAIRING_K)
    builder.set_lookup_bits(PAIRING_LOOKUP_BITS)
    pairing_witness(builder, pairing_inputs())
    builder.calculate_params(minimum_rows=9)
    return builder
