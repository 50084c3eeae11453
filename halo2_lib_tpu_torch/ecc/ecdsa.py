"""In-circuit ECDSA signature verification (secp256k1-style curves).

Re-implements halo2-ecc/src/ecc/ecdsa.rs:16-105. Only valid when the curve's
coordinate field modulus p is very close to the scalar field modulus n (the
final `r == x1` check skips the mod-n reduction of x1).

The port of ``halo2_lib_tpu/ecc/ecdsa.py``; its random points come from the
EccChip's generator (see ecc/ec.py).
"""

from __future__ import annotations

from ..core.cells import AssignedValue, Existing
from ..core.context import Context
from ..utils.curves import ShortWeierstrass
from . import bigint as bi
from .bigint import FixedOverflowInteger, ProperCrtUint, ProperUint
from .ec import EccChip, scalar_multiply
from .fixed_base import scalar_multiply as fixed_base_scalar_multiply
from .fp import FpChip


def ecdsa_verify_no_pubkey_check(
    chip: EccChip,
    ctx: Context,
    pubkey,
    r: ProperCrtUint,
    s: ProperCrtUint,
    msghash: ProperCrtUint,
    var_window_bits: int = 4,
    fixed_window_bits: int = 4,
) -> AssignedValue:
    """Returns a 0/1 cell: signature valid. Assumes pubkey is on curve, not O."""
    base_chip: FpChip = chip.field_chip
    curve: ShortWeierstrass = chip.curve
    gate = base_chip.gate
    scalar_chip = FpChip(base_chip.range, base_chip.limb_bits, base_chip.num_limbs, curve.scalar)
    n_int = scalar_chip.p
    n_fixed = FixedOverflowInteger.from_int(n_int, scalar_chip.num_limbs, scalar_chip.limb_bits)
    n_assigned = n_fixed.assign(ctx)

    # r, s in [1, n)
    r_valid = scalar_chip.is_soft_nonzero(ctx, r)
    s_valid = scalar_chip.is_soft_nonzero(ctx, s)

    # u1 = m / s, u2 = r / s (mod n)
    u1 = scalar_chip.divide_unsafe(ctx, msghash, s)
    u2 = scalar_chip.divide_unsafe(ctx, r, s)

    # u1 * G (fixed base) and u2 * pubkey (variable base)
    u1_mul = fixed_base_scalar_multiply(
        base_chip, ctx, curve.g, u1.limbs(), base_chip.limb_bits, fixed_window_bits, curve,
        chip.rng,
    )
    u2_mul = scalar_multiply(
        base_chip, ctx, pubkey, u2.limbs(), base_chip.limb_bits, var_window_bits, curve, chip.rng
    )

    # u1*G != -(u2*pubkey): x different or y equal
    x_eq = base_chip.is_equal(ctx, u1_mul.x, u2_mul.x)
    x_neq = gate.not_(ctx, Existing(x_eq))
    y_eq = base_chip.is_equal(ctx, u1_mul.y, u2_mul.y)
    u1g_u2pk_not_neg = gate.or_(ctx, Existing(x_neq), Existing(y_eq))

    # sum (identity-tolerant), then r == x1 (NO mod-n reduction: needs p ≈ n)
    total = chip.sum(ctx, [u1_mul, u2_mul])
    x1 = scalar_chip.enforce_less_than(ctx, total.x)
    equal_check = bi.big_is_equal(gate, ctx, ProperUint(x1.inner.limbs()), ProperUint(r.limbs()))

    u1_small = bi.big_less_than(
        base_chip.range, ctx, ProperUint(u1.limbs()), n_assigned, base_chip.limb_bits, None
    )
    u2_small = bi.big_less_than(
        base_chip.range, ctx, ProperUint(u2.limbs()), n_assigned, base_chip.limb_bits, None
    )

    res = gate.and_(ctx, Existing(r_valid), Existing(s_valid))
    res = gate.and_(ctx, Existing(res), Existing(u1_small))
    res = gate.and_(ctx, Existing(res), Existing(u2_small))
    res = gate.and_(ctx, Existing(res), Existing(u1g_u2pk_not_neg))
    res = gate.and_(ctx, Existing(res), Existing(equal_check))
    return res


# ---------------------------------------------------------------------------
# host-side ECDSA (test-vector generation, mirrors the reference test setup)
# ---------------------------------------------------------------------------

def ecdsa_sign(curve: ShortWeierstrass, privkey: int, msghash: int, k: int) -> tuple[int, int]:
    """Deterministic host signer given nonce k; returns (r, s)."""
    n = curve.scalar
    R = curve.mul(curve.g, k)
    r = R[0] % n.p
    s = n.mul(n.inv(k), (msghash + r * privkey) % n.p)
    return r, s


def ecdsa_verify_host(curve: ShortWeierstrass, pubkey, msghash: int, r: int, s: int) -> bool:
    n = curve.scalar
    if not (0 < r < n.p and 0 < s < n.p):
        return False
    u1 = n.mul(msghash % n.p, n.inv(s))
    u2 = n.mul(r, n.inv(s))
    pt = curve.add(curve.mul(curve.g, u1), curve.mul(pubkey, u2))
    if pt is None:
        return False
    return pt[0] % n.p == r
