"""In-circuit BN254 optimal Ate pairing.

Re-implements halo2-ecc/src/bn254/pairing.rs: sparse line functions for the
D-twist Psi(x,y) = (w^2 x, w^3 y), sparse Fp12 multiplication with w^6
folding, the (multi) Miller loop over the 6x+2 pseudo-binary encoding with the
final twisted-Frobenius line pair, and the PairingChip facade.

G2 points are EcPoints whose coordinates are Fp2 FieldVectors (lists of two
ProperCrtUints); G1 points are over FpChip.
"""

from __future__ import annotations

from ..core.context import Context
from ..utils.fields import BN254_X, FQ_BN254
from ..utils.curves import FQ2_BN254
from .ec import EcPoint, ec_add_unequal, ec_double
from .fields_ext import Fp2Chip, Fp12Chip, mul_no_carry_w6
from .fp import FpChip

XI_0 = 9


def naf_digits(value: int) -> list[int]:
    """Non-adjacent form, little-endian digits in {-1, 0, 1} (ecc/mod.rs get_naf)."""
    naf = []
    e = value
    while e:
        if e & 1:
            z = 2 - (e % 4)
            naf.append(z)
            e -= z
        else:
            naf.append(0)
        e >>= 1
    assert sum(d << i for i, d in enumerate(naf)) == value
    return naf


# pseudo-binary encoding of the Miller loop count 6x + 2
SIX_U_PLUS_2_NAF = naf_digits(6 * BN254_X + 2)

# FROBENIUS_COEFF_FQ12_C1[1] = (9+u)^((p-1)/6) over Fq2
FROB_COEFF_C1 = FQ2_BN254.pow((9, 1), (FQ_BN254.p - 1) // 6)


def frobenius_coeff_c1(power: int):
    """((9+u)^((p-1)/6))^{sum p^i} — the C1 coefficient for frobenius^power.

    Matches halo2curves FROBENIUS_COEFF_FQ12_C1[power]: (9+u)^((p^power - 1)/6).
    """
    return FQ2_BN254.pow((9, 1), (FQ_BN254.p**power - 1) // 6)


class G2EccChipAdapter:
    """Minimal EC-op adapter over Fp2Chip (the EccChip<F, Fp2Chip> role)."""

    def __init__(self, fp2_chip: Fp2Chip):
        self.field_chip = fp2_chip

    def negate(self, ctx, pt: EcPoint) -> EcPoint:
        return EcPoint(pt.x, self.field_chip.negate(ctx, pt.y))

    def double(self, ctx, pt: EcPoint) -> EcPoint:
        return ec_double(self.field_chip, ctx, pt)

    def add_unequal(self, ctx, a: EcPoint, b: EcPoint, is_strict=False) -> EcPoint:
        return ec_add_unequal(self.field_chip, ctx, a, b, is_strict)


def sparse_line_function_unequal(fp2_chip: Fp2Chip, ctx: Context, Q, P) -> list:
    """line_{Psi(Q0),Psi(Q1)}(P) = out2 w^2 + out3 w^3 + out5 w^5 (pairing.rs:25-54)."""
    (x1, y1), (x2, y2) = (Q[0].x, Q[0].y), (Q[1].x, Q[1].y)
    X, Y = P.x, P.y
    y1_minus_y2 = fp2_chip.sub_no_carry(ctx, y1, y2)
    x2_minus_x1 = fp2_chip.sub_no_carry(ctx, x2, x1)
    x1y2 = fp2_chip.mul_no_carry(ctx, x1, y2)
    x2y1 = fp2_chip.mul_no_carry(ctx, x2, y1)
    out3 = fp2_chip.fp_mul_no_carry(ctx, y1_minus_y2, X)
    out2 = fp2_chip.fp_mul_no_carry(ctx, x2_minus_x1, Y)
    out5 = fp2_chip.sub_no_carry(ctx, x1y2, x2y1)
    res = [None, None, out2, out3, None, out5]
    return [fp2_chip.carry_mod(ctx, c) if c is not None else None for c in res]


def sparse_line_function_equal(fp2_chip: Fp2Chip, ctx: Context, Q: EcPoint, P) -> list:
    """line_{Psi(Q),Psi(Q)}(P) = out0 + out3 w^3 + out4 w^4 (pairing.rs:64-95)."""
    x, y = Q.x, Q.y
    x_sq = fp2_chip.mul(ctx, x, x)
    x_cube = fp2_chip.mul_no_carry(ctx, x_sq, x)
    three_x_cu = fp2_chip.scalar_mul_no_carry(ctx, x_cube, 3)
    y_sq = fp2_chip.mul_no_carry(ctx, y, y)
    two_y_sq = fp2_chip.scalar_mul_no_carry(ctx, y_sq, 2)
    out0_left = fp2_chip.sub_no_carry(ctx, three_x_cu, two_y_sq)
    out0 = mul_no_carry_w6(fp2_chip.fp_chip, ctx, out0_left, XI_0)
    x_sq_px = fp2_chip.fp_mul_no_carry(ctx, x_sq, P.x)
    out4 = fp2_chip.scalar_mul_no_carry(ctx, x_sq_px, -3)
    y_py = fp2_chip.fp_mul_no_carry(ctx, y, P.y)
    out3 = fp2_chip.scalar_mul_no_carry(ctx, y_py, 2)
    res = [out0, None, None, out3, out4, None]
    return [fp2_chip.carry_mod(ctx, c) if c is not None else None for c in res]


def sparse_fp12_multiply(fp2_chip: Fp2Chip, ctx: Context, a: list, b_fp2_coeffs: list) -> list:
    """a (deg-12) times sparse b (6 Option<Fp2>) (pairing.rs:99-158)."""
    assert len(a) == 12 and len(b_fp2_coeffs) == 6
    a_fp2 = [[a[i], a[i + 6]] for i in range(6)]
    prod_2d: list = [None] * 11
    for i in range(6):
        for j in range(6):
            b_j = b_fp2_coeffs[j]
            if b_j is None:
                continue
            ab = fp2_chip.mul_no_carry(ctx, a_fp2[i], b_j)
            if prod_2d[i + j] is None:
                prod_2d[i + j] = ab
            else:
                prod_2d[i + j] = fp2_chip.add_no_carry(ctx, prod_2d[i + j], ab)

    out_fp2 = []
    for i in range(6):
        if i != 5:
            eval_w6 = (
                mul_no_carry_w6(fp2_chip.fp_chip, ctx, prod_2d[i + 6], XI_0)
                if prod_2d[i + 6] is not None
                else None
            )
            if prod_2d[i] is None:
                nocarry = eval_w6
            elif eval_w6 is None:
                nocarry = prod_2d[i]
            else:
                nocarry = fp2_chip.add_no_carry(ctx, prod_2d[i], eval_w6)
        else:
            nocarry = prod_2d[i]
        out_fp2.append(fp2_chip.carry_mod(ctx, nocarry))
    return [c[0] for c in out_fp2] + [c[1] for c in out_fp2]


def fp12_multiply_with_line_unequal(fp2_chip, ctx, g, Q, P):
    line = sparse_line_function_unequal(fp2_chip, ctx, Q, P)
    return sparse_fp12_multiply(fp2_chip, ctx, g, line)


def fp12_multiply_with_line_equal(fp2_chip, ctx, g, Q, P):
    line = sparse_line_function_equal(fp2_chip, ctx, Q, P)
    return sparse_fp12_multiply(fp2_chip, ctx, g, line)


def twisted_frobenius(g2_chip: G2EccChipAdapter, ctx, Q: EcPoint, c2, c3) -> EcPoint:
    """(c2 * conj(x), c3 * conj(y)) (pairing.rs:401-422)."""
    fp2 = g2_chip.field_chip
    frob_x = fp2.conjugate(ctx, Q.x)
    frob_y = fp2.conjugate(ctx, Q.y)
    out_x = fp2.mul(ctx, c2, frob_x)
    out_y = fp2.mul(ctx, c3, frob_y)
    return EcPoint(out_x, out_y)


def neg_twisted_frobenius(g2_chip: G2EccChipAdapter, ctx, Q: EcPoint, c2, c3) -> EcPoint:
    fp2 = g2_chip.field_chip
    frob_x = fp2.conjugate(ctx, Q.x)
    neg_frob_y = fp2.neg_conjugate(ctx, Q.y)
    out_x = fp2.mul(ctx, c2, frob_x)
    out_y = fp2.mul(ctx, c3, neg_frob_y)
    return EcPoint(out_x, out_y)


def _line_to_fp12(fp_chip: FpChip, ctx, sparse_f: list) -> list:
    zero_fp = fp_chip.load_constant(ctx, 0)
    f_coeffs = []
    for coeff in sparse_f:
        f_coeffs.append(coeff[0] if coeff is not None else zero_fp)
    for coeff in sparse_f:
        f_coeffs.append(coeff[1] if coeff is not None else zero_fp)
    return f_coeffs


def multi_miller_loop_bn(
    g2_chip: G2EccChipAdapter,
    ctx: Context,
    pairs: list,
    pseudo_binary_encoding=SIX_U_PLUS_2_NAF,
) -> list:
    """prod_i f_{6x+2}(Q_i, P_i) with Frobenius line pair (pairing.rs:298-392)."""
    fp2_chip = g2_chip.field_chip
    fp_chip = fp2_chip.fp_chip
    i = len(pseudo_binary_encoding) - 1
    while pseudo_binary_encoding[i] == 0:
        i -= 1
    last_index = i
    assert pseudo_binary_encoding[i] == 1

    neg_b = [g2_chip.negate(ctx, b) for (_, b) in pairs]

    sparse_f = sparse_line_function_equal(fp2_chip, ctx, pairs[0][1], pairs[0][0])
    f = _line_to_fp12(fp_chip, ctx, sparse_f)
    for (a, b) in pairs[1:]:
        f = fp12_multiply_with_line_equal(fp2_chip, ctx, f, b, a)

    i -= 1
    r = [b for (_, b) in pairs]
    fp12_chip = Fp12Chip(fp_chip, XI_0)
    while True:
        if i != last_index - 1:
            f = fp12_chip.mul(ctx, f, f)
            for ri, (a, _) in zip(r, pairs):
                f = fp12_multiply_with_line_equal(fp2_chip, ctx, f, ri, a)
        r = [g2_chip.double(ctx, ri) for ri in r]

        digit = pseudo_binary_encoding[i]
        assert -1 <= digit <= 1
        if digit != 0:
            for idx, (a, b) in enumerate(pairs):
                sign_b = b if digit == 1 else neg_b[idx]
                f = fp12_multiply_with_line_unequal(fp2_chip, ctx, f, (r[idx], sign_b), a)
                r[idx] = g2_chip.add_unequal(ctx, r[idx], sign_b, False)
        if i == 0:
            break
        i -= 1

    c1 = FROB_COEFF_C1
    c2_val = FQ2_BN254.mul(c1, c1)
    c3_val = FQ2_BN254.mul(c2_val, c1)
    c2 = fp2_chip.load_constant(ctx, list(c2_val))
    c3 = fp2_chip.load_constant(ctx, list(c3_val))

    for idx, (a, b) in enumerate(pairs):
        b_1 = twisted_frobenius(g2_chip, ctx, b, c2, c3)
        neg_b_2 = neg_twisted_frobenius(g2_chip, ctx, b_1, c2, c3)
        f = fp12_multiply_with_line_unequal(fp2_chip, ctx, f, (r[idx], b_1), a)
        r[idx] = g2_chip.add_unequal(ctx, r[idx], b_1, False)
        f = fp12_multiply_with_line_unequal(fp2_chip, ctx, f, (r[idx], neg_b_2), a)
    return f


def miller_loop_bn(g2_chip, ctx, Q: EcPoint, P: EcPoint) -> list:
    return multi_miller_loop_bn(g2_chip, ctx, [(P, Q)])


class PairingChip:
    """Facade (pairing.rs:448-525)."""

    def __init__(self, fp_chip: FpChip):
        self.fp_chip = fp_chip
        self.fp2_chip = Fp2Chip(fp_chip)
        self.g2_chip = G2EccChipAdapter(self.fp2_chip)

    def load_private_g1_unchecked(self, ctx, point) -> EcPoint:
        return EcPoint(
            self.fp_chip.load_private(ctx, point[0]),
            self.fp_chip.load_private(ctx, point[1]),
        )

    def load_private_g2_unchecked(self, ctx, point) -> EcPoint:
        (x, y) = point
        return EcPoint(
            self.fp2_chip.load_private(ctx, list(x)),
            self.fp2_chip.load_private(ctx, list(y)),
        )

    def miller_loop(self, ctx, Q: EcPoint, P: EcPoint) -> list:
        return miller_loop_bn(self.g2_chip, ctx, Q, P)

    def multi_miller_loop(self, ctx, pairs) -> list:
        return multi_miller_loop_bn(self.g2_chip, ctx, pairs)

    def final_exp(self, ctx, f: list) -> list:
        from .final_exp import final_exp

        return final_exp(Fp12Chip(self.fp_chip, XI_0), ctx, f)

    def pairing(self, ctx, Q: EcPoint, P: EcPoint) -> list:
        f0 = self.miller_loop(ctx, Q, P)
        return self.final_exp(ctx, f0)
