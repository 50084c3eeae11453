"""Extension-field chips: FieldVectorChip, Fp2Chip, Fp12Chip.

Re-implements halo2-ecc/src/fields/{vector,fp2,fp12}.rs. An extension-field
element is a `FieldVector` — a plain list of FpChip field points (coefficient
order for Fp12: `(a_00, ..., a_50, a_01, ..., a_51)` meaning
sum_i (a_i0 + a_i1 u) w^i with u^2 = -1, w^6 = u + XI_0; fp12.rs:17-23).

Host values for Fp2 are (c0, c1) int pairs; for Fp12, 12-int tuples in the
same coefficient order as the circuit representation.
"""

from __future__ import annotations

from ..core.cells import AssignedValue
from ..core.context import Context
from .fp import FpChip, Reduced


class FieldVectorChip:
    """Coordinate-wise lifts of FpChip ops (fields/vector.rs)."""

    def __init__(self, fp_chip: FpChip, degree: int):
        self.fp_chip = fp_chip
        self.degree = degree
        self.gate = fp_chip.gate
        self.range = fp_chip.range
        self.F = fp_chip.F
        self.p = fp_chip.p

    # --- loading -----------------------------------------------------------
    def load_private(self, ctx: Context, coeffs) -> list:
        assert len(coeffs) == self.degree
        return [self.fp_chip.load_private(ctx, c) for c in coeffs]

    def load_constant(self, ctx: Context, coeffs) -> list:
        assert len(coeffs) == self.degree
        return [self.fp_chip.load_constant(ctx, c) for c in coeffs]

    def get_assigned_value(self, x) -> tuple:
        return tuple(self.fp_chip.get_assigned_value(c) for c in x)

    # --- coordinate-wise ops --------------------------------------------------
    def fp_mul_no_carry(self, ctx, a, fp_point) -> list:
        return [self.fp_chip.mul_no_carry(ctx, c, fp_point) for c in a]

    def add_no_carry(self, ctx, a, b) -> list:
        return [self.fp_chip.add_no_carry(ctx, x, y) for x, y in zip(a, b, strict=True)]

    def sub_no_carry(self, ctx, a, b) -> list:
        return [self.fp_chip.sub_no_carry(ctx, x, y) for x, y in zip(a, b, strict=True)]

    def add_constant_no_carry(self, ctx, a, c) -> list:
        assert len(c) == self.degree
        return [self.fp_chip.add_constant_no_carry(ctx, x, cc) for x, cc in zip(a, c)]

    def scalar_mul_no_carry(self, ctx, a, c: int) -> list:
        return [self.fp_chip.scalar_mul_no_carry(ctx, x, c) for x in a]

    def scalar_mul_and_add_no_carry(self, ctx, a, b, c: int) -> list:
        return [
            self.fp_chip.scalar_mul_and_add_no_carry(ctx, x, y, c)
            for x, y in zip(a, b, strict=True)
        ]

    def negate(self, ctx, a) -> list:
        return [self.fp_chip.negate(ctx, x) for x in a]

    def carry_mod(self, ctx, a) -> list:
        return [self.fp_chip.carry_mod(ctx, x) for x in a]

    def check_carry_mod_to_zero(self, ctx, a) -> None:
        for x in a:
            self.fp_chip.check_carry_mod_to_zero(ctx, x)

    def range_check(self, ctx, a, max_bits: int) -> None:
        for x in a:
            self.fp_chip.range_check(ctx, x, max_bits)

    def enforce_less_than(self, ctx, a) -> list:
        return [self.fp_chip.enforce_less_than(ctx, x) for x in a]

    def is_soft_zero(self, ctx, a) -> AssignedValue:
        from ..core.cells import Existing

        prev = None
        for x in a:
            z = self.fp_chip.is_soft_zero(ctx, x)
            prev = z if prev is None else self.gate.and_(ctx, Existing(z), Existing(prev))
        return prev

    def is_soft_nonzero(self, ctx, a) -> AssignedValue:
        from ..core.cells import Existing

        prev = None
        for x in a:
            nz = self.fp_chip.is_soft_nonzero(ctx, x)
            prev = nz if prev is None else self.gate.or_(ctx, Existing(nz), Existing(prev))
        return prev

    def is_zero(self, ctx, a) -> AssignedValue:
        from ..core.cells import Existing

        prev = None
        for x in a:
            z = self.fp_chip.is_zero(ctx, x)
            prev = z if prev is None else self.gate.and_(ctx, Existing(z), Existing(prev))
        return prev

    def is_equal_unenforced(self, ctx, a, b) -> AssignedValue:
        from ..core.cells import Existing

        prev = None
        for x, y in zip(a, b, strict=True):
            e = self.fp_chip.is_equal_unenforced(ctx, x, y)
            prev = e if prev is None else self.gate.and_(ctx, Existing(e), Existing(prev))
        return prev

    def is_equal(self, ctx, a, b) -> AssignedValue:
        ra = self.enforce_less_than(ctx, a)
        rb = self.enforce_less_than(ctx, b)
        return self.is_equal_unenforced(ctx, ra, rb)

    def assert_equal(self, ctx, a, b) -> None:
        for x, y in zip(a, b, strict=True):
            self.fp_chip.assert_equal(ctx, x, y)

    def select(self, ctx, a, b, sel) -> list:
        return [self.fp_chip.select(ctx, x, y, sel) for x, y in zip(a, b, strict=True)]

    def select_by_indicator(self, ctx, a: list, coeffs) -> list:
        return [
            self.fp_chip.select_by_indicator(ctx, [vec[i] for vec in a], coeffs)
            for i in range(self.degree)
        ]


class Fp2Chip(FieldVectorChip):
    """Fp[u]/(u^2 + 1); requires p = 3 mod 4 (fields/fp2.rs)."""

    def __init__(self, fp_chip: FpChip):
        assert fp_chip.p % 4 == 3, "p must be 3 mod 4 for u^2 + 1 irreducible"
        super().__init__(fp_chip, 2)

    def mul_no_carry(self, ctx: Context, a, b) -> list:
        """(a0 b0 - a1 b1) + (a0 b1 + a1 b0) u — 4 mults (fp2.rs:91-114)."""
        fp = self.fp_chip
        ab = [fp.mul_no_carry(ctx, ai, bj) for ai in a for bj in b]
        c0 = fp.sub_no_carry(ctx, ab[0], ab[3])
        c1 = fp.add_no_carry(ctx, ab[1], ab[2])
        return [c0, c1]

    def mul(self, ctx, a, b) -> list:
        return self.carry_mod(ctx, self.mul_no_carry(ctx, a, b))

    def conjugate(self, ctx, a) -> list:
        assert len(a) == 2
        return [a[0], self.fp_chip.negate(ctx, a[1])]

    def neg_conjugate(self, ctx, a) -> list:
        assert len(a) == 2
        return [self.fp_chip.negate(ctx, a[0]), a[1]]

    def divide_unsafe(self, ctx, a, b) -> list:
        """Witness quotient in Fp2, constrain q*b - a = 0 (FieldChip default)."""
        from ..utils.curves import FQ2_BN254

        fq2 = FQ2_BN254
        a_val = self.get_assigned_value(a)
        b_val = self.get_assigned_value(b)
        if b_val == (0, 0):
            q_val = (0, 0)
        else:
            q_val = fq2.mul(a_val, fq2.inv(b_val))
        quot = self.load_private(ctx, list(q_val))
        quot_b = self.mul_no_carry(ctx, quot, b)
        diff = self.sub_no_carry(ctx, quot_b, a)
        self.check_carry_mod_to_zero(ctx, diff)
        return quot

    def neg_divide_unsafe(self, ctx, a, b) -> list:
        from ..utils.curves import FQ2_BN254

        fq2 = FQ2_BN254
        a_val = self.get_assigned_value(a)
        b_val = self.get_assigned_value(b)
        if b_val == (0, 0):
            q_val = (0, 0)
        else:
            q_val = fq2.neg(fq2.mul(a_val, fq2.inv(b_val)))
        quot = self.load_private(ctx, list(q_val))
        quot_b = self.mul_no_carry(ctx, quot, b)
        s = self.add_no_carry(ctx, quot_b, a)
        self.check_carry_mod_to_zero(ctx, s)
        return quot


class Fp12Chip(FieldVectorChip):
    """Fp2[w]/(w^6 - u - XI_0), coefficients interleaved (fields/fp12.rs)."""

    def __init__(self, fp_chip: FpChip, xi_0: int = 9):
        assert fp_chip.p % 4 == 3
        super().__init__(fp_chip, 12)
        self.xi_0 = xi_0

    def fp2_mul_no_carry(self, ctx, fp12_pt, fp2_pt) -> list:
        """(fp12.rs:50-77)"""
        assert len(fp12_pt) == 12 and len(fp2_pt) == 2
        fp = self.fp_chip
        out = []
        for i in range(6):
            c1 = fp.mul_no_carry(ctx, fp12_pt[i], fp2_pt[0])
            c2 = fp.mul_no_carry(ctx, fp12_pt[i + 6], fp2_pt[1])
            out.append(fp.sub_no_carry(ctx, c1, c2))
        for i in range(6):
            c1 = fp.mul_no_carry(ctx, fp12_pt[i + 6], fp2_pt[0])
            c2 = fp.mul_no_carry(ctx, fp12_pt[i], fp2_pt[1])
            out.append(fp.add_no_carry(ctx, c1, c2))
        return out

    def conjugate(self, ctx, a) -> list:
        """sum (-1)^i (a_i + b_i u) w^i (fp12.rs:81-96)."""
        assert len(a) == 12
        return [
            c if i % 2 == 0 else self.fp_chip.negate(ctx, c) for i, c in enumerate(a)
        ]

    def mul_no_carry(self, ctx: Context, a, b) -> list:
        """Degree-12 schoolbook with w^6 = u + XI_0 folding (fp12.rs:139-216)."""
        assert len(a) == 12 and len(b) == 12
        fp = self.fp_chip
        xi = self.xi_0
        a0b0, a0b1, a1b0, a1b1 = [], [], [], []
        for i in range(6):
            for j in range(6):
                c00 = fp.mul_no_carry(ctx, a[i], b[j])
                c01 = fp.mul_no_carry(ctx, a[i], b[j + 6])
                c10 = fp.mul_no_carry(ctx, a[i + 6], b[j])
                c11 = fp.mul_no_carry(ctx, a[i + 6], b[j + 6])
                if i + j < len(a0b0):
                    a0b0[i + j] = fp.add_no_carry(ctx, a0b0[i + j], c00)
                    a0b1[i + j] = fp.add_no_carry(ctx, a0b1[i + j], c01)
                    a1b0[i + j] = fp.add_no_carry(ctx, a1b0[i + j], c10)
                    a1b1[i + j] = fp.add_no_carry(ctx, a1b1[i + j], c11)
                else:
                    a0b0.append(c00)
                    a0b1.append(c01)
                    a1b0.append(c10)
                    a1b1.append(c11)
        sub_ = [fp.sub_no_carry(ctx, a0b0[i], a1b1[i]) for i in range(11)]
        add_ = [fp.add_no_carry(ctx, a0b1[i], a1b0[i]) for i in range(11)]

        out = []
        for i in range(6):
            if i < 5:
                coeff = fp.scalar_mul_and_add_no_carry(ctx, sub_[i + 6], sub_[i], xi)
                coeff = fp.sub_no_carry(ctx, coeff, add_[i + 6])
                out.append(coeff)
            else:
                out.append(sub_[i])
        for i in range(6):
            if i < 5:
                coeff = fp.add_no_carry(ctx, add_[i], sub_[i + 6])
                coeff = fp.scalar_mul_and_add_no_carry(ctx, add_[i + 6], coeff, xi)
                out.append(coeff)
            else:
                out.append(add_[i])
        return out

    def mul(self, ctx, a, b) -> list:
        return self.carry_mod(ctx, self.mul_no_carry(ctx, a, b))

    def divide_unsafe(self, ctx, a, b) -> list:
        """Witness quotient in Fq12, constrain q*b - a = 0 (FieldChip default)."""
        from ..utils.bn254_pairing import Fq12

        a_val = self.get_fq12_value(a)
        b_val = self.get_fq12_value(b)
        if b_val == Fq12.zero():
            q_val = Fq12.zero()
        else:
            q_val = a_val * b_val.inv()
        quot = self.load_private(ctx, self.fq12_to_coeffs(q_val))
        quot_b = self.mul_no_carry(ctx, quot, b)
        diff = self.sub_no_carry(ctx, quot_b, a)
        self.check_carry_mod_to_zero(ctx, diff)
        return quot

    # --- host-value helpers (oracle conversions) ---
    def get_fq12_value(self, x):
        """Chip coefficient order -> utils.bn254_pairing.Fq12."""
        from ..utils.bn254_pairing import Fq12

        vals = self.get_assigned_value(x)
        return Fq12.from_fq2([(vals[i], vals[i + 6]) for i in range(6)])

    @staticmethod
    def fq12_to_coeffs(f) -> list[int]:
        """utils.bn254_pairing.Fq12 -> 12 chip-order coefficients."""
        c2 = f.to_fq2()
        return [c2[i][0] for i in range(6)] + [c2[i][1] for i in range(6)]


def mul_no_carry_w6(fp_chip: FpChip, ctx: Context, a, xi_0: int) -> list:
    """(a0 + a1 u)(XI_0 + u) = (a0 XI_0 - a1) + (a1 XI_0 + a0) u (fp12.rs:102-117)."""
    a0, a1 = a
    a0_xi0 = fp_chip.scalar_mul_no_carry(ctx, a0, xi_0)
    out0 = fp_chip.sub_no_carry(ctx, a0_xi0, a1)
    out1 = fp_chip.scalar_mul_and_add_no_carry(ctx, a1, a0, xi_0)
    return [out0, out1]
