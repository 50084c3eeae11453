"""secp256k1 ECDSA signature verification, built on the port's eDSL as the
reference's ECDSA bench builds it (halo2-ecc bench_ecdsa: FpChip of
``limb_bits`` x ``num_limbs`` limbs for the base and the scalar field,
``ecdsa_verify_no_pubkey_check`` with fixed-base and variable-base windows
``fixed_window`` / ``var_window``); sized by ``calculate_params`` at 2^k
rows with ``lookup_bits``.

An input is (pubkey, r, s, msghash); ``make_inputs`` draws fresh ones, each
with its own key, message hash and nonce (``reference/ecdsa.py``).
"""

from __future__ import annotations

import random

from benchmark.reference import ecdsa

def golden_input(cfg: dict):
    """The signature the JAX package's digests were made with (the repo's
    ECDSA bench inputs, ``bench.py:ecdsa_test_inputs``)."""
    from halo2_lib_tpu_torch.utils.testing import ecdsa_inputs

    return ecdsa_inputs()


def witness(cfg: dict, builder, inputs, rng: random.Random) -> None:
    from halo2_lib_tpu_torch.ecc.ec import EccChip
    from halo2_lib_tpu_torch.ecc.ecdsa import ecdsa_verify_no_pubkey_check
    from halo2_lib_tpu_torch.ecc.fp import FpChip
    from halo2_lib_tpu_torch.utils.curves import SECP256K1

    pub, r, s, msghash = inputs
    range_chip = builder.range_chip()
    fp_chip = FpChip(range_chip, cfg["limb_bits"], cfg["num_limbs"], SECP256K1.base)
    fq_chip = FpChip(range_chip, cfg["limb_bits"], cfg["num_limbs"], SECP256K1.scalar)
    chip = EccChip(fp_chip, SECP256K1, rng)
    ctx = builder.main(0)
    out = ecdsa_verify_no_pubkey_check(
        chip, ctx, chip.load_private(ctx, pub), fq_chip.load_private(ctx, r),
        fq_chip.load_private(ctx, s), fq_chip.load_private(ctx, msghash),
        cfg["fixed_window"], cfg["var_window"],
    )
    if out.val() != 1:
        raise ValueError(f"in-circuit ECDSA bit {out.val()}, not 1")


def mock_builder(cfg: dict, rng: random.Random):
    """The MOCK builder keygen runs on (bench.py:build_ecdsa_builder)."""
    from halo2_lib_tpu_torch.gates.circuit import BaseCircuitBuilder, CircuitBuilderStage

    builder = BaseCircuitBuilder.from_stage(CircuitBuilderStage.MOCK).use_k(cfg["k"])
    builder.set_lookup_bits(cfg["lookup_bits"])
    witness(cfg, builder, golden_input(cfg), rng)
    builder.calculate_params(minimum_rows=9)
    p = builder.config_params
    p.num_advice_per_phase[0] = max(p.num_advice_per_phase[0], 2)
    p.num_lookup_advice_per_phase[0] = max(p.num_lookup_advice_per_phase[0], 1)
    return builder


def make_inputs(cfg: dict, seed: int, count: int) -> list:
    return ecdsa.signatures(seed, count)
