"""Test harness and the circuits that drive the port end to end.

`base_test()` is the builder pattern of halo2-base/src/utils/testing.rs:
run a closure against a fresh circuit builder and check it with MockProver,
or take it through keygen, the pinned prover builder, create_proof and
verify_proof (`bench_builder`).

`tests/data/torch_goldens/make_goldens.py` builds the circuits below with the
JAX package's eDSL (the ECDSA one with `bench.py`'s helpers, which the
functions below follow step for step); the port's proofs of them must be
byte-identical to the goldens that script writes.
"""

from __future__ import annotations

import json
import os
import random
import time as _time

from ..backend.challenges import mock_challenge
from ..backend.mock import MockProver
from ..core.cells import Constant, Existing
from ..core.dyn_lookup import BasicDynLookupManager
from ..ecc.ec import EccChip
from ..ecc.ecdsa import ecdsa_sign, ecdsa_verify_no_pubkey_check
from ..ecc.fields_ext import Fp12Chip
from ..ecc.fp import FpChip
from ..ecc.pairing import PairingChip
from ..gates.circuit import BaseCircuitBuilder, CircuitBuilderStage
from ..gates.flex_gate import GateChip
from ..poseidon import PoseidonChip
from ..poseidon.spec import default_spec
from ..safe_types import SafeTypeChip
from . import bn254_pairing
from .curves import BN254_G1, BN254_G2, SECP256K1
from .fields import FQ_BN254, FR_BN254, PrimeField
from .pinning import pinning_of

GOLDEN_K = 9


class BaseTester:
    """halo2-base's BaseTester (utils/testing.rs:105-247): `run`, `run_gate`
    and `run_builder` check a closure's circuit with the host MockProver;
    `bench_builder` proves it on `device` (the CUDA card unless the caller
    asks for another) and keeps the last key and SRS as `pk` and `params`."""

    def __init__(self):
        self.k = 10
        self.lookup_bits: int | None = None
        self.expect_satisfied = True
        self.num_instance_columns = 0
        self.field: PrimeField = FR_BN254
        self.device = None
        self.params = None
        self.pk = None

    def use_k(self, k: int) -> "BaseTester":
        self.k = k
        return self

    def use_lookup_bits(self, lookup_bits: int) -> "BaseTester":
        self.lookup_bits = lookup_bits
        return self

    def use_field(self, field: PrimeField) -> "BaseTester":
        self.field = field
        return self

    def use_device(self, device) -> "BaseTester":
        self.device = device
        return self

    def expect(self, satisfied: bool) -> "BaseTester":
        self.expect_satisfied = satisfied
        return self

    def run(self, f):
        """f(ctx, range_chip) -> optional result; mock-proves the circuit."""
        return self.run_builder(lambda pool, range_chip: f(pool.main(), range_chip))

    def run_gate(self, f):
        """f(ctx, gate_chip) -> optional result."""
        gate = GateChip(self.field)
        return self.run_builder(lambda pool, _range: f(pool.main(), gate))

    def run_builder(self, f):
        builder = BaseCircuitBuilder.from_stage(CircuitBuilderStage.MOCK, self.field).use_k(self.k)
        if self.lookup_bits is not None:
            builder.set_lookup_bits(self.lookup_bits)
        builder.set_instance_columns(self.num_instance_columns)
        range_chip = builder.range_chip() if self.lookup_bits is not None else None
        res = f(builder.pool(0), range_chip)

        builder.calculate_params(minimum_rows=9)
        errors = MockProver.run(self.k, builder).verify()
        if self.expect_satisfied:
            assert not errors, "circuit not satisfied:\n" + "\n".join(errors[:8])
        else:
            assert errors, "expected circuit to fail but it was satisfied"
        return res

    def bench_builder(self, init_input, logic_input, f, timings: dict | None = None) -> bytes:
        """keygen with init_input, then prove and verify with logic_input
        (BaseTester::bench_builder, utils/testing.rs:198-247): the keygen
        builder and calculate_params, the SRS, the pinned prover builder
        re-running f, create_proof, verify_proof. Returns the proof bytes;
        `timings` receives the seconds of each step."""
        from ..backend.keygen import keygen
        from ..backend.kzg import gen_srs
        from ..backend.prover import create_proof
        from ..backend.verifier import verify_proof
        from .device import resolve_device, stage_end

        device = resolve_device(self.device)
        t = _time.time()

        builder = BaseCircuitBuilder.from_stage(CircuitBuilderStage.MOCK, self.field).use_k(self.k)
        if self.lookup_bits is not None:
            builder.set_lookup_bits(self.lookup_bits)
        range_chip = builder.range_chip() if self.lookup_bits is not None else None
        f(builder.pool(0), range_chip, init_input)
        builder.calculate_params(minimum_rows=9)
        # the real prover needs dedicated lookup columns (no q_lookup path)
        p = builder.config_params
        if p.num_advice_per_phase:
            p.num_advice_per_phase[0] = max(p.num_advice_per_phase[0], 2)
        if self.lookup_bits is not None and p.num_lookup_advice_per_phase:
            p.num_lookup_advice_per_phase[0] = max(p.num_lookup_advice_per_phase[0], 1)
        t = stage_end("keygen witness", t, device, timings)
        self.params = gen_srs(self.k, device=device)
        t = stage_end("srs", t, device, timings)
        self.pk = keygen(self.params, builder, device=device)
        t = stage_end("keygen", t, device, timings)
        prover_builder = pinning_of(builder).prover_builder(self.field)
        prover_range = prover_builder.range_chip() if self.lookup_bits is not None else None
        f(prover_builder.pool(0), prover_range, logic_input)
        t = stage_end("prover witness", t, device, timings)
        proof = create_proof(self.params, self.pk, prover_builder, device=device)
        t = stage_end("create_proof", t, device, timings)
        assert verify_proof(self.params, self.pk.vk, proof), "proof verification failed"
        t = stage_end("verify_proof", t, device, timings)
        return proof


def gen_proof(params, pk, builder_or_circuit, instances=None, device=None) -> bytes:
    """Prove with a seeded transcript (utils/testing.rs:54-60)."""
    from ..backend.prover import create_proof

    return create_proof(params, pk, builder_or_circuit, instances, device=device)


def check_proof(params, vk, proof: bytes, instances=None, expect_satisfied: bool = True) -> None:
    """Verify and assert the expected outcome (utils/testing.rs:64-88)."""
    from ..backend.verifier import VerificationError, verify_proof

    try:
        ok = verify_proof(params, vk, proof, instances)
    except (VerificationError, ValueError):
        ok = False
    assert ok == expect_satisfied, (
        "proof verified but expected failure" if ok else "proof failed verification"
    )


def base_test() -> BaseTester:
    return BaseTester()


def golden_circuit(x_val: int = 12345, k: int = GOLDEN_K) -> BaseCircuitBuilder:
    """Range checks, a mul_add chain and a less-than check, at >= 2 advice
    columns and 1 lookup column (the k=9 prover test circuit)."""
    builder = BaseCircuitBuilder.from_stage(CircuitBuilderStage.MOCK).use_k(k)
    builder.set_lookup_bits(8)
    golden_witness(builder, x_val)
    builder.calculate_params(minimum_rows=9)
    p = builder.config_params
    p.num_advice_per_phase[0] = max(p.num_advice_per_phase[0], 2)
    p.num_lookup_advice_per_phase[0] = max(p.num_lookup_advice_per_phase[0], 1)
    return builder


def golden_witness(builder: BaseCircuitBuilder, x_val: int = 12345) -> BaseCircuitBuilder:
    """golden_circuit's witnesses on a MOCK or (pinned) PROVER builder."""
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


# the Poseidon + SafeTypes circuit: a fixed-length hash of 32 bytes, a
# variable-length hash of POSEIDON_VAR_LEN bytes at most, a SafeBool and a
# SafeByte, at k = 9 with 8 lookup bits (the SafeByte range checks)
POSEIDON_K, POSEIDON_LOOKUP_BITS, POSEIDON_VAR_LEN = 9, 8, 8


def poseidon_inputs(seed: int):
    """(32 bytes, POSEIDON_VAR_LEN bytes, their length, a bool, a byte) from
    random.Random(seed); the bytes past the length are zero."""
    rng = random.Random(seed)
    fixed = [rng.randrange(256) for _ in range(32)]
    length = rng.randrange(1, POSEIDON_VAR_LEN + 1)
    var = [rng.randrange(256) for _ in range(length)] + [0] * (POSEIDON_VAR_LEN - length)
    return fixed, var, length, bool(rng.randrange(2)), rng.randrange(256)


def poseidon_logic(pool, range_chip, inputs):
    """bench_builder's closure for the Poseidon + SafeTypes circuit: the
    PoseidonChip's hash_fix_len_bytes and hash_var_len_bytes of the inputs'
    bytes and a SafeBool / SafeByte load. Returns the two hashes' cells."""
    fixed, var, length, flag, byte = inputs
    ctx = pool.main()
    chip = PoseidonChip(ctx, default_spec(), range_chip)
    safe = SafeTypeChip(range_chip)
    fx = safe.raw_to_fix_len_bytes(ctx, [ctx.load_witness(b) for b in fixed])
    h_fix = chip.hash_fix_len_bytes(ctx, fx)
    vb = safe.raw_to_var_len_bytes(ctx, [ctx.load_witness(b) for b in var], ctx.load_witness(length))
    h_var = chip.hash_var_len_bytes(ctx, vb)
    safe.load_bool(ctx, flag)
    safe.load_byte(ctx, byte)
    return h_fix, h_var


def comb_edge_scalars() -> dict[str, int]:
    """Scalars that meet each case of g1_batch_mul's comb (ops/cuda_field.py
    comb_digits; 7-bit windows, digits in (-64, 64]), by name."""
    from ..ops.cuda_field import COMB_HALF, COMB_W, COMB_WINDOWS

    r = FR_BN254.p
    top = COMB_W * (COMB_WINDOWS - 1)  # bit 252, the top window's first
    every = lambda v: sum(v << (COMB_W * j) for j in range(COMB_WINDOWS - 1))  # noqa: E731
    mid = COMB_W * (COMB_WINDOWS // 2)
    rnd = random.Random(0xC0B).randrange(r)
    return {
        "zero": 0,
        "one": 1,
        "two": 2,
        "r - 1": r - 1,
        # window 35 = 127: its digit -1 carries into the top window (2 -> 3)
        "carry into the top window": (2 << top) + (127 << (top - COMB_W)),
        # every window 127: a carry through all of them (2^253 - 1)
        "carry through every window": (1 << 253) - 1,
        # every digit +64, the top one 1
        "every digit +64": every(COMB_HALF) + (1 << top),
        # window 0 = 65, the others 64 with the carry: every digit -63 (the
        # most negative), the top one 2
        "every digit -63": every(COMB_HALF) + 1 + (1 << top),
        # a middle window 0 with no carry in (a digit 0 amid nonzero ones)
        "a digit 0 in the middle": rnd & ~(((1 << (2 * COMB_W)) - 1) << (mid - COMB_W))
        | (5 << (mid - COMB_W)),
        # a middle window 127 with a carry in: d = 128, digit 0, carry out
        "a digit 0 from a carry": (rnd & ~(((1 << (2 * COMB_W)) - 1) << (mid - COMB_W)))
        | (127 << mid) | (100 << (mid - COMB_W)),
        # the one scalar whose top window adds its own entry (the doubling
        # branch): the lower windows sum to 3 * 2^252 - r, the top digit is 3
        "the top entry doubled": 6 * (1 << top) - r,
    }


def old_g1_batch_mul(scalars, Gx, Gy):
    """g1_batch_mul's plain version before the comb, the old reference the
    comb is held to in affine form: per lane, 254 doublings of G from the
    top bit and a mixed add where the bit is 1 (the chains of
    commit_dbl_add_plain with G in every lane) -> Jacobian (X, Y, Z)
    int32[16, n]; the comb's affine points, other triples."""
    import torch

    from ..ops import cuda_field as cf

    n = scalars.shape[1]
    c = cf._consts(cf.FQ, scalars.device)
    x2, y2 = (t.to(torch.int64).expand(16, n) for t in (Gx, Gy))
    return tuple(t.to(torch.int32) for t in cf._chains64(scalars.to(torch.int64), x2, y2, c))


# The reference's MSM benchmark circuit (configs/bn254/msm_circuit.config:
# degree 17, batch 100, window 4, 88-bit limbs x 3, lookup_bits 16; its
# .t.config: degree 13, batch 8, lookup_bits 12), built as
# tests/test_configs.py:run_msm_config builds it.
MSM_CONFIG, MSM_T_CONFIG = "bn254/msm_circuit.config", "bn254/msm_circuit.t.config"
_CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "configs")


def load_config(rel: str) -> dict:
    """A circuit config of the repo's configs/ directory, e.g. MSM_CONFIG."""
    with open(os.path.join(_CONFIG_DIR, rel)) as f:
        return json.load(f)


def msm_inputs(batch: int, seed: int = 91):
    """(points, scalars): `batch` random BN254 G1 points and full-width
    scalars from random.Random(seed) (run_msm_config's inputs)."""
    rng = random.Random(seed)
    pts = [BN254_G1.random_point(rng) for _ in range(batch)]
    return pts, [BN254_G1.random_scalar(rng) for _ in range(batch)]


def msm_witness(builder: BaseCircuitBuilder, cfg: dict, inputs=None, rng: random.Random | None = None):
    """EccChip.variable_base_msm of `inputs` (msm_inputs of the config's
    batch when None) on a MOCK or PROVER builder's pool: the serial MSM up to
    25 points, multi_exp_par above (clump factor = the config's window).
    Random points come from `rng` (ecc/ec.py's DEFAULT_RNG when None).
    Asserts the in-circuit point equals the host MSM."""
    pts, scalars = msm_inputs(cfg["batch_size"]) if inputs is None else inputs
    fp_chip = FpChip(builder.range_chip(), cfg["limb_bits"], cfg["num_limbs"], BN254_G1.base)
    chip = EccChip(fp_chip, BN254_G1, rng)
    pool = builder.pool(0)
    ctx = pool.main()
    assigned = [chip.load_private(ctx, p) for p in pts]
    scs = [[ctx.load_witness(s)] for s in scalars]
    out = chip.variable_base_msm(pool, assigned, scs, max_bits=254, window_bits=cfg["window_bits"])
    got = (fp_chip.get_assigned_value(out.x), fp_chip.get_assigned_value(out.y))
    if got != BN254_G1.msm(pts, scalars):
        raise AssertionError("in-circuit MSM != host MSM")
    return builder


def msm_circuit(cfg: dict, stage: CircuitBuilderStage = CircuitBuilderStage.MOCK,
                rng: random.Random | None = None) -> BaseCircuitBuilder:
    """The MSM circuit of `cfg` (load_config(MSM_CONFIG) or MSM_T_CONFIG) on a
    fresh builder, sized by calculate_params(minimum_rows=9)."""
    builder = BaseCircuitBuilder.from_stage(stage).use_k(cfg["degree"])
    builder.set_lookup_bits(cfg["lookup_bits"])
    msm_witness(builder, cfg, None, rng)
    builder.calculate_params(minimum_rows=9)
    return builder


# Small MSM gadget cases, each at a k and lookup_bits that keep the builder
# to seconds: tests/test_ecc.py's test_msm_small ("serial"),
# test_msm_with_identity_and_cancellation ("identity": its scalars 5, 5, 7
# taken as 8-bit) and test_fixed_base_msm ("fixed"), and multi_exp_par over
# 26 points with 16-bit scalars ("pippenger").
# name -> (k, lookup_bits, input seed, points, max_bits)
MSM_CASES = {
    "serial": (14, 13, 14, 3, 254),
    "identity": (14, 13, 15, 3, 8),
    "pippenger": (14, 13, 19, 26, 16),
    "fixed": (14, 13, 17, 4, 254),
}


def msm_case_inputs(name: str):
    """(points, scalars) of MSM_CASES[name]; None is the point at infinity."""
    _k, _lb, seed, npts, max_bits = MSM_CASES[name]
    rng = random.Random(seed)
    if name == "identity":
        P = BN254_G1.random_point(rng)
        return [P, BN254_G1.neg(P), None], [5, 5, 7]
    pts = [BN254_G1.random_point(rng) for _ in range(npts)]
    if max_bits == 254:
        return pts, [BN254_G1.random_scalar(rng) for _ in range(npts)]
    return pts, [rng.randrange(1 << max_bits) for _ in range(npts)]


def msm_case_witness(builder: BaseCircuitBuilder, name: str, rng: random.Random | None = None):
    """MSM_CASES[name] on a MOCK or PROVER builder's pool: variable_base_msm
    (points loaded with assign_point, so the identity loads as (0, 0)) or,
    for "fixed", fixed_base_msm. Returns the in-circuit result as host ints
    ((0, 0) for the identity) and asserts it equals the host MSM."""
    _k, _lb, _seed, _n, max_bits = MSM_CASES[name]
    pts, scalars = msm_case_inputs(name)
    fp_chip = FpChip(builder.range_chip(), 88, 3, BN254_G1.base)
    chip = EccChip(fp_chip, BN254_G1, rng)
    pool = builder.pool(0)
    ctx = pool.main()
    scs = [[ctx.load_witness(s)] for s in scalars]
    if name == "fixed":
        out = chip.fixed_base_msm(pool, pts, scs, max_scalar_bits_per_cell=max_bits)
    else:
        assigned = [chip.assign_point(ctx, p) for p in pts]
        out = chip.variable_base_msm(pool, assigned, scs, max_bits=max_bits)
    got = (fp_chip.get_assigned_value(out.x), fp_chip.get_assigned_value(out.y))
    want = BN254_G1.msm([p for p in pts if p is not None], [s for p, s in zip(pts, scalars) if p is not None])
    if got != (want if want is not None else (0, 0)):
        raise AssertionError(f"MSM case {name}: in-circuit MSM != host MSM")
    return got


def msm_case_circuit(name: str, rng: random.Random | None = None) -> BaseCircuitBuilder:
    """The MOCK builder of MSM_CASES[name], sized by calculate_params."""
    k, lookup_bits = MSM_CASES[name][:2]
    builder = BaseCircuitBuilder.from_stage(CircuitBuilderStage.MOCK).use_k(k)
    builder.set_lookup_bits(lookup_bits)
    msm_case_witness(builder, name, rng)
    builder.calculate_params(minimum_rows=9)
    return builder


def circuit_digests(circuit) -> dict[str, str]:
    """SHA-256 of each part of a synthesized circuit, column by column (a
    k=17 circuit's columns are too long for one repr): advice columns and
    selectors per phase, lookup-advice and fixed columns, copies, instances."""
    import hashlib

    def digest(seq) -> str:
        h = hashlib.sha256()
        for item in seq:
            h.update(repr(item).encode())
        return h.hexdigest()

    copies = circuit.copies
    return {
        "advice": digest(col for fp in circuit.phases for col in fp.columns),
        "selectors": digest(col for fp in circuit.phases for col in fp.selectors),
        "lookup": digest(col for cols in circuit.lookup_cols for col in cols),
        "fixed": digest(circuit.fixed_cols),
        "copies": digest(copies[i : i + 65536] for i in range(0, len(copies), 65536)),
        "instances": digest(circuit.instances),
        "num_copies": str(len(copies)),
    }
