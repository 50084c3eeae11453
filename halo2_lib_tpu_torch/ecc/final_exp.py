"""BN254 final exponentiation, in-circuit.

Re-implements halo2-ecc/src/bn254/final_exp.rs: frobenius_map, NAF pow,
cyclotomic compression / decompression / square / pow (Karabina, eprint
2010/542 Thm 3.1-3.2), the BN hard part (eprint 2008/490 §5 vectorial
addition chain), and easy part via conjugate / divide.
"""

from __future__ import annotations

from ..core.cells import Existing
from ..core.context import Context
from ..utils.fields import BN254_X
from ..utils.curves import FQ2_BN254
from .fields_ext import Fp2Chip, Fp12Chip, mul_no_carry_w6
from .pairing import XI_0, frobenius_coeff_c1, naf_digits


def frobenius_map(fp12_chip: Fp12Chip, ctx: Context, a: list, power: int) -> list:
    """a^(p^power) (final_exp.rs:23-71)."""
    assert len(a) == 12
    pow_ = power % 12
    fp_chip = fp12_chip.fp_chip
    fp2_chip = Fp2Chip(fp_chip)
    out_fp2 = []
    frob_base = frobenius_coeff_c1(pow_)
    for i in range(6):
        frob_coeff = FQ2_BN254.pow(frob_base, i)
        a_fp2 = [a[i], a[i + 6]]
        if pow_ % 2 != 0:
            a_fp2 = fp2_chip.conjugate(ctx, a_fp2)
        if frob_coeff == (1, 0):
            out_fp2.append(a_fp2)
        elif frob_coeff[1] == 0:
            frob_fixed = fp_chip.load_constant(ctx, frob_coeff[0])
            nocarry = fp2_chip.fp_mul_no_carry(ctx, a_fp2, frob_fixed)
            out_fp2.append(fp2_chip.carry_mod(ctx, nocarry))
        else:
            frob_fixed = fp2_chip.load_constant(ctx, list(frob_coeff))
            out_fp2.append(fp2_chip.mul(ctx, a_fp2, frob_fixed))
    return [x[0] for x in out_fp2] + [x[1] for x in out_fp2]


def fp12_pow_naf(fp12_chip: Fp12Chip, ctx: Context, a: list, exp: int) -> list:
    """NAF square-and-multiply/divide (final_exp.rs:73-105)."""
    res = a
    is_started = False
    naf = naf_digits(exp)
    for z in reversed(naf):
        if is_started:
            res = fp12_chip.mul(ctx, res, res)
        if z != 0:
            if is_started:
                res = (
                    fp12_chip.mul(ctx, res, a)
                    if z == 1
                    else fp12_chip.divide_unsafe(ctx, res, a)
                )
            else:
                assert z == 1
                is_started = True
    return res


def cyclotomic_compress(a: list) -> list:
    """[g2, g3, g4, g5] (final_exp.rs:115-123)."""
    g2 = [a[1], a[1 + 6]]
    g3 = [a[4], a[4 + 6]]
    g4 = [a[2], a[2 + 6]]
    g5 = [a[5], a[5 + 6]]
    return [g2, g3, g4, g5]


def cyclotomic_decompress(fp12_chip: Fp12Chip, ctx: Context, compression: list) -> list:
    """(final_exp.rs:139-231)"""
    g2, g3, g4, g5 = compression
    fp_chip = fp12_chip.fp_chip
    fp2_chip = Fp2Chip(fp_chip)

    g5_sq = fp2_chip.mul_no_carry(ctx, g5, g5)
    g5_sq_c = mul_no_carry_w6(fp_chip, ctx, g5_sq, XI_0)
    g4_sq = fp2_chip.mul_no_carry(ctx, g4, g4)
    g4_sq_3 = fp2_chip.scalar_mul_no_carry(ctx, g4_sq, 3)
    g3_2 = fp2_chip.scalar_mul_no_carry(ctx, g3, 2)

    g1_num = fp2_chip.add_no_carry(ctx, g5_sq_c, g4_sq_3)
    g1_num = fp2_chip.sub_no_carry(ctx, g1_num, g3_2)
    g2_4 = fp2_chip.scalar_mul_no_carry(ctx, g2, 4)
    g1_1 = fp2_chip.divide_unsafe(ctx, g1_num, g2_4)

    g4_g5 = fp2_chip.mul_no_carry(ctx, g4, g5)
    g1_num0 = fp2_chip.scalar_mul_no_carry(ctx, g4_g5, 2)
    g1_0 = fp2_chip.divide_unsafe(ctx, g1_num0, g3)

    g2_is_zero = fp2_chip.is_zero(ctx, g2)
    g3_is_zero = fp2_chip.is_zero(ctx, g3)
    g4_is_zero = fp2_chip.is_zero(ctx, g4)
    g5_is_zero = fp2_chip.is_zero(ctx, g5)
    gate = fp2_chip.gate
    g23_zero = gate.and_(ctx, Existing(g2_is_zero), Existing(g3_is_zero))
    g45_zero = gate.and_(ctx, Existing(g4_is_zero), Existing(g5_is_zero))
    is_identity = gate.and_(ctx, Existing(g23_zero), Existing(g45_zero))
    zero_fp2 = fp2_chip.load_constant(ctx, [0, 0])
    g1_0 = fp2_chip.select(ctx, zero_fp2, g1_0, is_identity)
    g1 = fp2_chip.select(ctx, g1_0, g1_1, g2_is_zero)

    g1_sq = fp2_chip.mul_no_carry(ctx, g1, g1)
    g1_sq_2 = fp2_chip.scalar_mul_no_carry(ctx, g1_sq, 2)
    g2_g5 = fp2_chip.mul_no_carry(ctx, g2, g5)
    g3_g4 = fp2_chip.mul_no_carry(ctx, g3, g4)
    g3_g4_3 = fp2_chip.scalar_mul_no_carry(ctx, g3_g4, 3)
    temp = fp2_chip.add_no_carry(ctx, g1_sq_2, g2_g5)
    temp = fp2_chip.select(ctx, g1_sq_2, temp, g2_is_zero)
    temp = fp2_chip.sub_no_carry(ctx, temp, g3_g4_3)
    g0 = mul_no_carry_w6(fp_chip, ctx, temp, XI_0)

    # g0 + 1 without an extra carry: bump limb 0 / native / tracked value
    from ..core.cells import Constant

    g0_0 = g0[0]
    g0_0.truncation.limbs[0] = gate.add(ctx, Existing(g0_0.truncation.limbs[0]), Constant(1))
    g0_0.native = gate.add(ctx, Existing(g0_0.native), Constant(1))
    g0_0.truncation.max_limb_bits += 1
    g0_0.value += 1
    g0 = fp2_chip.carry_mod(ctx, g0)

    out = [None] * 12
    fp2s = [g0, g2, g4, g1, g3, g5]
    for idx, g in enumerate(fp2s):
        out[idx] = g[0]
        out[idx + 6] = g[1]
    return out


def cyclotomic_square(fp12_chip: Fp12Chip, ctx: Context, compression: list) -> list:
    """Karabina compressed squaring (final_exp.rs:234-283)."""
    g2, g3, g4, g5 = compression
    fp_chip = fp12_chip.fp_chip
    fp2_chip = Fp2Chip(fp_chip)

    g2_plus_g3 = fp2_chip.add_no_carry(ctx, g2, g3)
    cg3 = mul_no_carry_w6(fp_chip, ctx, g3, XI_0)
    g2_plus_cg3 = fp2_chip.add_no_carry(ctx, g2, cg3)
    a23 = fp2_chip.mul_no_carry(ctx, g2_plus_g3, g2_plus_cg3)

    g4_plus_g5 = fp2_chip.add_no_carry(ctx, g4, g5)
    cg5 = mul_no_carry_w6(fp_chip, ctx, g5, XI_0)
    g4_plus_cg5 = fp2_chip.add_no_carry(ctx, g4, cg5)
    a45 = fp2_chip.mul_no_carry(ctx, g4_plus_g5, g4_plus_cg5)

    b23 = fp2_chip.mul_no_carry(ctx, g2, g3)
    b45 = fp2_chip.mul_no_carry(ctx, g4, g5)
    b45_c = mul_no_carry_w6(fp_chip, ctx, b45, XI_0)

    temp = fp2_chip.scalar_mul_and_add_no_carry(ctx, b45_c, g2, 3)
    h2 = fp2_chip.scalar_mul_no_carry(ctx, temp, 2)

    temp = fp2_chip.add_no_carry(ctx, b45_c, b45)
    temp = fp2_chip.sub_no_carry(ctx, a45, temp)
    temp = fp2_chip.scalar_mul_no_carry(ctx, temp, 3)
    h3 = fp2_chip.scalar_mul_and_add_no_carry(ctx, g3, temp, -2)

    temp = mul_no_carry_w6(fp_chip, ctx, b23, XI_0 + 1)
    temp = fp2_chip.sub_no_carry(ctx, a23, temp)
    temp = fp2_chip.scalar_mul_no_carry(ctx, temp, 3)
    h4 = fp2_chip.scalar_mul_and_add_no_carry(ctx, g4, temp, -2)

    temp = fp2_chip.scalar_mul_and_add_no_carry(ctx, b23, g5, 3)
    h5 = fp2_chip.scalar_mul_no_carry(ctx, temp, 2)

    return [fp2_chip.carry_mod(ctx, h) for h in (h2, h3, h4, h5)]


def cyclotomic_pow(fp12_chip: Fp12Chip, ctx: Context, a: list, exp: int) -> list:
    """(final_exp.rs:286-320)"""
    compression = cyclotomic_compress(a)
    out = None
    is_started = False
    naf = naf_digits(exp)
    for z in reversed(naf):
        if is_started:
            compression = cyclotomic_square(fp12_chip, ctx, compression)
        if z != 0:
            if is_started:
                res = cyclotomic_decompress(fp12_chip, ctx, compression)
                res = (
                    fp12_chip.mul(ctx, res, a)
                    if z == 1
                    else fp12_chip.divide_unsafe(ctx, res, a)
                )
                compression = cyclotomic_compress(res)
                out = res
            else:
                assert z == 1
                is_started = True
    if naf[0] == 0:
        out = cyclotomic_decompress(fp12_chip, ctx, compression)
    return out if out is not None else a


def hard_part_bn(fp12_chip: Fp12Chip, ctx: Context, m: list) -> list:
    """(p^4 - p^2 + 1)/r via eprint 2008/490 §5 (final_exp.rs:323-390)."""
    mp = frobenius_map(fp12_chip, ctx, m, 1)
    mp2 = frobenius_map(fp12_chip, ctx, m, 2)
    mp3 = frobenius_map(fp12_chip, ctx, m, 3)

    mp2_mp3 = fp12_chip.mul(ctx, mp2, mp3)
    y0 = fp12_chip.mul(ctx, mp, mp2_mp3)
    y1 = fp12_chip.conjugate(ctx, m)

    mx = cyclotomic_pow(fp12_chip, ctx, m, BN254_X)
    mxp = frobenius_map(fp12_chip, ctx, mx, 1)
    mx2 = cyclotomic_pow(fp12_chip, ctx, mx, BN254_X)
    mx2p = frobenius_map(fp12_chip, ctx, mx2, 1)
    y2 = frobenius_map(fp12_chip, ctx, mx2, 2)
    y5 = fp12_chip.conjugate(ctx, mx2)
    mx3 = cyclotomic_pow(fp12_chip, ctx, mx2, BN254_X)
    mx3p = frobenius_map(fp12_chip, ctx, mx3, 1)

    y3 = fp12_chip.conjugate(ctx, mxp)
    mx_mx2p = fp12_chip.mul(ctx, mx, mx2p)
    y4 = fp12_chip.conjugate(ctx, mx_mx2p)
    mx3_mx3p = fp12_chip.mul(ctx, mx3, mx3p)
    y6 = fp12_chip.conjugate(ctx, mx3_mx3p)

    T0 = fp12_chip.mul(ctx, y6, y6)
    T0 = fp12_chip.mul(ctx, T0, y4)
    T0 = fp12_chip.mul(ctx, T0, y5)
    T1 = fp12_chip.mul(ctx, y3, y5)
    T1 = fp12_chip.mul(ctx, T1, T0)
    T0 = fp12_chip.mul(ctx, T0, y2)
    T1 = fp12_chip.mul(ctx, T1, T1)
    T1 = fp12_chip.mul(ctx, T1, T0)
    T1 = fp12_chip.mul(ctx, T1, T1)
    T0 = fp12_chip.mul(ctx, T1, y1)
    T1 = fp12_chip.mul(ctx, T1, y0)
    T0 = fp12_chip.mul(ctx, T0, T0)
    T0 = fp12_chip.mul(ctx, T0, T1)
    return T0


def easy_part(fp12_chip: Fp12Chip, ctx: Context, a: list) -> list:
    """a^{(q^6-1)(q^2+1)} (final_exp.rs:393-403)."""
    f1 = fp12_chip.conjugate(ctx, a)
    f2 = fp12_chip.divide_unsafe(ctx, f1, a)
    f3 = frobenius_map(fp12_chip, ctx, f2, 2)
    return fp12_chip.mul(ctx, f3, f2)


def final_exp(fp12_chip: Fp12Chip, ctx: Context, a: list) -> list:
    """a^{(q^12-1)/r} (final_exp.rs:406-414)."""
    f0 = easy_part(fp12_chip, ctx, a)
    return hard_part_bn(fp12_chip, ctx, f0)
