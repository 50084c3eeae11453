"""FpChip: CRT-limb emulated prime field arithmetic.

Re-implements halo2-ecc/src/fields/fp.rs and the FieldChip trait defaults of
fields/mod.rs:188-277 (mul, divide, divide_unsafe, neg_divide_unsafe). A field
element of the emulated field Fp is a `ProperCrtUint`; operations defer carries
and reduce with `carry_mod`/`check_carry_mod_to_zero`.
"""

from __future__ import annotations

from ..core.cells import AssignedValue, Constant, Existing
from ..core.context import Context
from ..gates.range import RangeChip
from ..utils.fields import PrimeField
from ..utils.misc import bit_length, decompose_int, log2_ceil
from . import bigint as bi
from .bigint import (
    CRTInteger,
    FixedCRTInteger,
    ProperCrtUint,
    ProperUint,
)


class Reduced:
    """Wrapper guaranteeing a unique (< p) representation (fp.rs:33-43)."""

    __slots__ = ("inner",)

    def __init__(self, inner: ProperCrtUint):
        self.inner = inner


def _as_crt(x) -> CRTInteger:
    if isinstance(x, ProperCrtUint):
        return x.crt
    if isinstance(x, Reduced):
        return x.inner.crt
    assert isinstance(x, CRTInteger)
    return x


def _as_proper(x) -> ProperCrtUint:
    if isinstance(x, Reduced):
        return x.inner
    assert isinstance(x, ProperCrtUint), f"expected ProperCrtUint, got {type(x)}"
    return x


class FpChip:
    """Emulated-field chip over native field F for emulated prime fp.

    Mirrors FpChip::new (fp.rs:75-121) including the constructor safety
    asserts on the limb configuration.
    """

    def __init__(self, range_chip: RangeChip, limb_bits: int, num_limbs: int, fp: PrimeField):
        assert limb_bits > 0 and num_limbs > 0
        assert 64 <= limb_bits < 128, "limb_bits must be in [64, 128)"
        F = range_chip.F
        assert limb_bits <= F.capacity
        assert limb_bits * num_limbs >= fp.num_bits, "limbs do not cover modulus"
        num_limbs_log2_ceil = log2_ceil(num_limbs)
        assert num_limbs_log2_ceil + 2 * limb_bits <= F.num_bits - 2, "mul budget exceeded"

        self.range = range_chip
        self.gate = range_chip.gate
        self.F = F
        self.fp = fp
        self.limb_bits = limb_bits
        self.num_limbs = num_limbs
        self.num_limbs_bits = bit_length(num_limbs)
        self.num_limbs_log2_ceil = num_limbs_log2_ceil
        self.limb_mask = (1 << limb_bits) - 1
        self.p = fp.p
        self.p_limbs = decompose_int(fp.p, num_limbs, limb_bits)
        self.p_native = fp.p % F.p
        self.native_modulus = F.p
        self.limb_bases = [pow(2, limb_bits * i, F.p) for i in range(num_limbs)]
        self.limb_base_big = 1 << limb_bits

    # --- loading -----------------------------------------------------------
    def load_private(self, ctx: Context, a: int) -> ProperCrtUint:
        """Assign limbs + native eval + range check (fp.rs:187-197)."""
        a = a % self.p
        a_vec = decompose_int(a, self.num_limbs, self.limb_bits)
        limbs = ctx.assign_witnesses(a_vec)
        loaded = ProperUint(limbs).into_crt(ctx, self.gate, a, self.limb_bases, self.limb_bits)
        self.range_check(ctx, loaded, self.fp.num_bits)
        return loaded

    def load_constant(self, ctx: Context, a: int) -> ProperCrtUint:
        return self.load_constant_uint(ctx, a % self.p)

    def load_constant_uint(self, ctx: Context, a: int) -> ProperCrtUint:
        return FixedCRTInteger.from_int(a, self.num_limbs, self.limb_bits).assign(
            ctx, self.limb_bits, self.native_modulus
        )

    def get_assigned_value(self, x) -> int:
        """Canonical value of x in fp (fp.rs:181-183)."""
        return _as_crt(x).value % self.p

    # --- no-carry ring ops ----------------------------------------------------
    def add_no_carry(self, ctx: Context, a, b) -> CRTInteger:
        return bi.crt_add_no_carry(self.gate, ctx, _as_crt(a), _as_crt(b))

    def add_constant_no_carry(self, ctx: Context, a, c: int) -> CRTInteger:
        """a + constant c (fp.rs:216-236)."""
        c = c % self.p
        c_fixed = FixedCRTInteger.from_int(c, self.num_limbs, self.limb_bits)
        a = _as_crt(a)
        gate = self.gate
        limbs = [
            gate.add(ctx, Existing(al), Constant(cl))
            for al, cl in zip(a.truncation.limbs, c_fixed.truncation.limbs)
        ]
        native = gate.add(ctx, Existing(a.native), Constant(c % self.native_modulus))
        trunc = bi.OverflowInteger(limbs, max(a.truncation.max_limb_bits, self.limb_bits) + 1)
        return CRTInteger(trunc, native, a.value + c)

    def sub_no_carry(self, ctx: Context, a, b) -> CRTInteger:
        return bi.crt_sub_no_carry(self.gate, ctx, _as_crt(a), _as_crt(b))

    def scalar_mul_no_carry(self, ctx: Context, a, c: int) -> CRTInteger:
        return bi.crt_scalar_mul_no_carry(self.gate, ctx, _as_crt(a), c)

    def scalar_mul_and_add_no_carry(self, ctx: Context, a, b, c: int) -> CRTInteger:
        return bi.crt_scalar_mul_and_add_no_carry(self.gate, ctx, _as_crt(a), _as_crt(b), c)

    def mul_no_carry(self, ctx: Context, a, b) -> CRTInteger:
        return bi.crt_mul_no_carry(self.gate, ctx, _as_crt(a), _as_crt(b))

    # --- carries ------------------------------------------------------------------
    def carry_mod(self, ctx: Context, a: CRTInteger) -> ProperCrtUint:
        return bi.carry_mod(
            self.range,
            ctx,
            _as_crt(a),
            self.num_limbs_bits,
            self.p,
            self.p_limbs,
            self.p_native,
            self.limb_bits,
            self.limb_bases,
        )

    def check_carry_mod_to_zero(self, ctx: Context, a: CRTInteger) -> None:
        bi.check_carry_mod_to_zero(
            self.range,
            ctx,
            _as_crt(a),
            self.num_limbs_bits,
            self.p,
            self.p_limbs,
            self.p_native,
            self.limb_bits,
            self.limb_bases,
        )

    # --- range / comparisons ----------------------------------------------------------
    def range_check(self, ctx: Context, a, max_bits: int) -> None:
        """Range check limbs to cover max_bits total (fp.rs:332-352)."""
        n = self.limb_bits
        a = _as_proper(a)
        remaining = max_bits
        assert a.crt.value.bit_length() <= max_bits
        for cell in a.limbs():
            bits = min(n, remaining)
            remaining -= bits
            self.range.range_check(ctx, cell, bits)

    def enforce_less_than_p(self, ctx: Context, a: ProperCrtUint) -> None:
        """Borrow chain a < p (fp.rs:123-142)."""
        gate = self.gate
        borrow = None
        for p_limb, a_limb in zip(self.p_limbs, _as_proper(a).limbs()):
            if borrow is None:
                lt = self.range.is_less_than(ctx, Existing(a_limb), Constant(p_limb), self.limb_bits)
            else:
                plus_borrow = gate.add(ctx, Constant(p_limb), Existing(borrow))
                lt = self.range.is_less_than(
                    ctx, Existing(a_limb), Existing(plus_borrow), self.limb_bits
                )
            borrow = lt
        gate.assert_is_const(ctx, borrow, 1)

    def enforce_less_than(self, ctx: Context, a) -> Reduced:
        a = _as_proper(a)
        self.enforce_less_than_p(ctx, a)
        return Reduced(a)

    def is_soft_zero(self, ctx: Context, a) -> AssignedValue:
        return bi.big_is_zero(self.gate, ctx, _as_proper(a).truncation)

    def is_soft_nonzero(self, ctx: Context, a) -> AssignedValue:
        """1 iff 0 < a < p as integers (fp.rs:373-391)."""
        a = _as_proper(a)
        gate = self.gate
        is_zero = bi.big_is_zero(gate, ctx, a.truncation)
        is_nonzero = gate.not_(ctx, Existing(is_zero))
        p_loaded = self.load_constant_uint(ctx, self.p)
        _, underflow = bi.crt_sub(self.range, ctx, a, p_loaded, self.limb_bits)
        is_underflow_zero = gate.is_zero(ctx, underflow)
        no_underflow = gate.not_(ctx, Existing(is_underflow_zero))
        return gate.and_(ctx, Existing(is_nonzero), Existing(no_underflow))

    def is_zero(self, ctx: Context, a) -> AssignedValue:
        a = _as_proper(a)
        self.enforce_less_than_p(ctx, a)
        return bi.big_is_zero(self.gate, ctx, a.truncation)

    def is_equal_unenforced(self, ctx: Context, a: Reduced, b: Reduced) -> AssignedValue:
        return bi.big_is_equal(
            self.gate, ctx, ProperUint(a.inner.limbs()), ProperUint(b.inner.limbs())
        )

    def is_equal(self, ctx: Context, a, b) -> AssignedValue:
        ra = self.enforce_less_than(ctx, a)
        rb = self.enforce_less_than(ctx, b)
        return self.is_equal_unenforced(ctx, ra, rb)

    def assert_equal(self, ctx: Context, a, b) -> None:
        a, b = _as_proper(a), _as_proper(b)
        assert len(a.limbs()) == self.num_limbs and len(b.limbs()) == self.num_limbs
        for la, lb in zip(a.limbs(), b.limbs()):
            ctx.constrain_equal(la, lb)
        self.enforce_less_than_p(ctx, a)
        self.enforce_less_than_p(ctx, b)

    # --- field ops (FieldChip defaults, fields/mod.rs:188-277) -------------------------
    def mul(self, ctx: Context, a, b) -> ProperCrtUint:
        return self.carry_mod(ctx, self.mul_no_carry(ctx, a, b))

    def negate(self, ctx: Context, a) -> ProperCrtUint:
        """p - a if a != 0 else 0 (fp.rs:252-266)."""
        a = _as_proper(a)
        p_loaded = self.load_constant_uint(ctx, self.p)
        out_or_p, underflow = bi.crt_sub(self.range, ctx, p_loaded, a, self.limb_bits)
        self.gate.assert_is_const(ctx, underflow, 0)
        a_is_zero = bi.big_is_zero(self.gate, ctx, a.truncation)
        return ProperCrtUint(bi.crt_select(self.gate, ctx, a.crt, out_or_p, a_is_zero))

    def divide(self, ctx: Context, a, b) -> ProperCrtUint:
        b = _as_proper(b)
        b_is_zero = self.is_zero(ctx, b)
        self.gate.assert_is_const(ctx, b_is_zero, 0)
        return self.divide_unsafe(ctx, a, b)

    def divide_unsafe(self, ctx: Context, a, b) -> ProperCrtUint:
        """Witness quotient, constrain quot*b - a ≡ 0 (fields/mod.rs:217-238)."""
        a, b = _as_crt(a), _as_crt(b)
        a_val = self.get_assigned_value(a)
        b_val = self.get_assigned_value(b)
        b_inv = self.fp.inv(b_val) if b_val != 0 else 0
        quot_val = a_val * b_inv % self.p
        quot = self.load_private(ctx, quot_val)
        quot_b = self.mul_no_carry(ctx, quot, b)
        constraint = self.sub_no_carry(ctx, quot_b, a)
        self.check_carry_mod_to_zero(ctx, constraint)
        return quot

    def neg_divide(self, ctx: Context, a, b) -> ProperCrtUint:
        b = _as_proper(b)
        b_is_zero = self.is_zero(ctx, b)
        self.gate.assert_is_const(ctx, b_is_zero, 0)
        return self.neg_divide_unsafe(ctx, a, b)

    def neg_divide_unsafe(self, ctx: Context, a, b) -> ProperCrtUint:
        """quot = -a/b; constrain quot*b + a ≡ 0 (fields/mod.rs:256-277)."""
        a, b = _as_crt(a), _as_crt(b)
        a_val = self.get_assigned_value(a)
        b_val = self.get_assigned_value(b)
        b_inv = self.fp.inv(b_val) if b_val != 0 else 0
        quot_val = (-a_val * b_inv) % self.p
        quot = self.load_private(ctx, quot_val)
        quot_b = self.mul_no_carry(ctx, quot, b)
        constraint = self.add_no_carry(ctx, quot_b, a)
        self.check_carry_mod_to_zero(ctx, constraint)
        return quot

    # --- Selectable -------------------------------------------------------------------
    def select(self, ctx: Context, a, b, sel: AssignedValue):
        out = bi.crt_select(self.gate, ctx, _as_crt(a), _as_crt(b), sel)
        if isinstance(a, ProperCrtUint) and isinstance(b, ProperCrtUint):
            return ProperCrtUint(out)
        return out

    def select_by_indicator(self, ctx: Context, a: list, coeffs: list[AssignedValue]):
        """(bigint/select_by_indicator.rs:28-70)"""
        assert len(a) == len(coeffs)
        gate = self.gate
        crts = [_as_crt(x) for x in a]
        k = len(crts[0].truncation.limbs)
        out_limbs = [
            gate.select_by_indicator(
                ctx, [Existing(x.truncation.limbs[i]) for x in crts], coeffs
            )
            for i in range(k)
        ]
        max_limb_bits = max(x.truncation.max_limb_bits for x in crts)
        out_trunc = bi.OverflowInteger(out_limbs, max_limb_bits)
        if len(crts) > k:
            out_native = gate.inner_product(
                ctx,
                [Existing(l) for l in out_limbs],
                [Constant(c) for c in self.limb_bases[:k]],
            )
        else:
            out_native = gate.select_by_indicator(
                ctx, [Existing(x.native) for x in crts], coeffs
            )
        out_val = 0
        for x, c in zip(crts, coeffs):
            if c.val() != 0:
                out_val = x.value
        out = CRTInteger(out_trunc, out_native, out_val)
        if all(isinstance(x, (ProperCrtUint, Reduced)) for x in a):
            return ProperCrtUint(out)
        return out
