"""RangeChip: lookup-decomposition range checks.

Mirrors halo2-base/src/gates/range/mod.rs:174-688. Range checks decompose a
value into `ceil(bits / lookup_bits)` limbs via one inner_product against
cached limb bases; each limb is queued into the LookupAnyManager for the fixed
table `[0, 2^lookup_bits)`.
"""

from __future__ import annotations

from ..core.cells import AssignedValue, Constant, Existing, Witness, as_qcell, qcell_value
from ..core.context import Context
from ..core.lookups import LookupAnyManager
from ..native import get_emitter
from ..utils.misc import bit_length, decompose_fe_to_u64_limbs
from .flex_gate import MAX_PHASE, GateChip


def _assert_div_mod_no_wrap(field, b: int, a_num_bits: int) -> None:
    """range/mod.rs:27-38 — guard that b*quot + rem cannot wrap the native field."""
    assert b != 0
    assert a_num_bits <= field.capacity
    assert b < field.p
    div_bound = (1 << a_num_bits) // b + 1
    max_div = div_bound - 1
    max_lhs = b * max_div + (b - 1)
    assert max_lhs < field.p


class RangeChip:
    def __init__(self, lookup_bits: int, lookup_manager: list[LookupAnyManager], field):
        assert len(lookup_manager) == MAX_PHASE
        self.gate = GateChip(field)
        self.F = field
        self.lookup_bits = lookup_bits
        self.lookup_manager = lookup_manager
        # powers of 2^lookup_bits as Constant cells (range/mod.rs:476-489)
        limb_base = pow(2, lookup_bits, field.p)
        num_bases = field.capacity // lookup_bits
        self.limb_bases = [Constant(1), Constant(limb_base)]
        running = limb_base
        for _ in range(2, num_bases + 1):
            running = field.mul(running, limb_base)
            self.limb_bases.append(Constant(running))

    def _add_cell_to_lookup(self, ctx: Context, a: AssignedValue) -> None:
        self.lookup_manager[ctx.phase].add_lookup(ctx.tag(), (a,))

    def _range_check(self, ctx: Context, a: AssignedValue, range_bits: int) -> AssignedValue:
        """Decompose + lookup each limb; returns last (highest) limb (range/mod.rs:512-564)."""
        if range_bits == 0:
            self.gate.assert_is_const(ctx, a, 0)
            return a
        lb = self.lookup_bits
        num_limbs = -(-range_bits // lb)
        rem_bits = range_bits % lb
        assert len(self.limb_bases) >= num_limbs

        if num_limbs == 1:
            self._add_cell_to_lookup(ctx, a)
            last_limb = a
        else:
            last_limb = None
            em = get_emitter(self.F.p)
            if em is not None:
                # one C call: decompose + inner-product region + a == acc
                # copy + lookup rows (the witness-gen hot path)
                lm = self.lookup_manager[ctx.phase]
                rows_list = lm.cells_to_lookup.setdefault(ctx.tag(), [])
                last_limb = em.range_check(
                    ctx, a, self.limb_bases[:num_limbs], num_limbs, lb, rows_list
                )
            if last_limb is None:
                limbs = decompose_fe_to_u64_limbs(a.val(), num_limbs, lb)
                row_offset = len(ctx.advice)
                acc = self.gate.inner_product(
                    ctx, [Witness(x) for x in limbs], self.limb_bases[:num_limbs]
                )
                ctx.constrain_equal(a, acc)
                # limb cells at offsets 0, 1, 4, ..., 1+3i (limb_bases[0]==1 opt)
                get = ctx.get
                rows = [(get(row_offset),)]
                rows.extend(
                    (get(row_offset + 1 + 3 * i),) for i in range(num_limbs - 1)
                )
                self.lookup_manager[ctx.phase].add_lookups(ctx.tag(), rows)
                last_limb = ctx.get(row_offset + 1 + 3 * (num_limbs - 2))

        if rem_bits == 1:
            self.gate.assert_bit(ctx, last_limb)
        elif rem_bits > 1:
            mult = self.gate.pow_of_two[lb - rem_bits]
            check = self.gate.mul(ctx, last_limb, Constant(mult))
            self._add_cell_to_lookup(ctx, check)
        return last_limb

    def range_check(self, ctx: Context, a: AssignedValue, range_bits: int) -> None:
        self._range_check(ctx, a, range_bits)

    def check_less_than(self, ctx: Context, a, b, num_bits: int) -> None:
        """a < b via shifted subtraction (range/mod.rs:604-635)."""
        assert num_bits < self.F.capacity
        a, b = as_qcell(a), as_qcell(b)
        F = self.F
        pot = self.gate.pow_of_two[num_bits]
        shift_a = F.add(pot, qcell_value(a))
        cells = [
            Witness(F.sub(shift_a, qcell_value(b))),
            b,
            Constant(1),
            Witness(shift_a),
            Constant(F.neg(pot)),
            Constant(1),
            a,
        ]
        ctx.assign_region(cells, [0, 3])
        check_cell = ctx.get(-7)
        self.range_check(ctx, check_cell, num_bits)

    def check_less_than_safe(self, ctx: Context, a: AssignedValue, b: int) -> None:
        range_bits = -(-bit_length(b) // self.lookup_bits) * self.lookup_bits
        self.range_check(ctx, a, range_bits)
        self.check_less_than(ctx, Existing(a), Constant(b % self.F.p), range_bits)

    def check_big_less_than_safe(self, ctx: Context, a: AssignedValue, b: int) -> None:
        range_bits = -(-b.bit_length() // self.lookup_bits) * self.lookup_bits
        self.range_check(ctx, a, range_bits)
        self.check_less_than(ctx, Existing(a), Constant(b % self.F.p), range_bits)

    def is_less_than(self, ctx: Context, a, b, num_bits: int) -> AssignedValue:
        """Returns bit a < b (range/mod.rs:646-687)."""
        a, b = as_qcell(a), as_qcell(b)
        F = self.F
        lb = self.lookup_bits
        k = -(-num_bits // lb)
        padded_bits = k * lb
        assert padded_bits + lb <= F.capacity, "num_bits too large for is_less_than"
        pow_padded = self.gate.pow_of_two[padded_bits]
        shift_a = F.add(pow_padded, qcell_value(a))
        shifted = F.sub(shift_a, qcell_value(b))
        ctx.assign_region(
            [
                Witness(shifted),
                b,
                Constant(1),
                Witness(shift_a),
                Constant(F.neg(pow_padded)),
                Constant(1),
                a,
            ],
            [0, 3],
        )
        shifted_cell = ctx.get(-7)
        last_limb = self._range_check(ctx, shifted_cell, padded_bits + lb)
        return self.gate.is_zero(ctx, last_limb)

    def is_less_than_safe(self, ctx: Context, a: AssignedValue, b: int) -> AssignedValue:
        range_bits = -(-bit_length(b) // self.lookup_bits) * self.lookup_bits
        self.range_check(ctx, a, range_bits)
        return self.is_less_than(ctx, Existing(a), Constant(b % self.F.p), range_bits)

    def is_big_less_than_safe(self, ctx: Context, a: AssignedValue, b: int) -> AssignedValue:
        range_bits = -(-b.bit_length() // self.lookup_bits) * self.lookup_bits
        self.range_check(ctx, a, range_bits)
        return self.is_less_than(ctx, Existing(a), Constant(b % self.F.p), range_bits)

    def div_mod(self, ctx: Context, a, b: int, a_num_bits: int):
        """(div, rem) with constant divisor b (range/mod.rs:303-331)."""
        a = as_qcell(a)
        F = self.F
        _assert_div_mod_no_wrap(F, b, a_num_bits)
        a_val = qcell_value(a)
        div, rem = divmod(a_val, b)
        ctx.assign_region([Witness(rem % F.p), Constant(b % F.p), Witness(div % F.p), a], [0])
        rem_c = ctx.get(-4)
        div_c = ctx.get(-2)
        self.check_big_less_than_safe(ctx, div_c, (1 << a_num_bits) // b + 1)
        self.check_big_less_than_safe(ctx, rem_c, b)
        return div_c, rem_c

    def div_mod_var(self, ctx: Context, a, b, a_num_bits: int, b_num_bits: int):
        """(div, rem) with variable divisor (range/mod.rs:355-419)."""
        F = self.F
        assert a_num_bits <= F.capacity
        assert 0 < b_num_bits <= F.capacity
        x = 1 << b_num_bits
        assert x * (x - 1) < F.p
        if a_num_bits > b_num_bits:
            max_b = x - 1
            max_div_hi = (1 << (a_num_bits - b_num_bits)) - 1
            max_bcr0_hi = 1 << (a_num_bits - b_num_bits)
            assert max_b * max_div_hi + max_bcr0_hi < F.p

        a, b = as_qcell(a), as_qcell(b)
        ctx.assign_cell(b)
        b_cell = ctx.get(-1)
        self.range_check(ctx, b_cell, b_num_bits)
        a_val = qcell_value(a)
        b_val = b_cell.val()
        assert b_val != 0
        div, rem = divmod(a_val, b_val)
        div_hi, div_lo = divmod(div, x)
        x_fe = self.gate.pow_of_two[b_num_bits]
        ctx.assign_region(
            [
                Witness(div_lo % F.p),
                Witness(div_hi % F.p),
                Constant(x_fe),
                Witness(div % F.p),
                Witness(rem % F.p),
            ],
            [0],
        )
        div_lo_c, div_hi_c, div_c, rem_c = (ctx.get(i) for i in (-5, -4, -2, -1))
        self.range_check(ctx, div_lo_c, b_num_bits)
        if a_num_bits <= b_num_bits:
            self.gate.assert_is_const(ctx, div_hi_c, 0)
        else:
            self.range_check(ctx, div_hi_c, a_num_bits - b_num_bits)

        bcr0 = self.gate.mul_add(ctx, Existing(b_cell), Existing(div_lo_c), Existing(rem_c))
        bcr0_hi, bcr0_lo = self.div_mod(ctx, Existing(bcr0), x, a_num_bits)
        bcr_hi = self.gate.mul_add(ctx, Existing(b_cell), Existing(div_hi_c), Existing(bcr0_hi))

        a_hi, a_lo = self.div_mod(ctx, a, x, a_num_bits)
        ctx.constrain_equal(bcr_hi, a_hi)
        ctx.constrain_equal(bcr0_lo, a_lo)

        self.range_check(ctx, rem_c, b_num_bits)
        self.check_less_than(ctx, Existing(rem_c), Existing(b_cell), b_num_bits)
        return div_c, rem_c

    def get_last_bit(self, ctx: Context, a: AssignedValue, limb_bits: int) -> AssignedValue:
        """LSB of a, assuming a already range checked to limb_bits (range/mod.rs:426-444)."""
        F = self.F
        a_val = a.val()
        bit_v = a_val & 1
        h_v = a_val >> 1
        ctx.assign_region([Witness(bit_v), Witness(h_v), Constant(2), Existing(a)], [0])
        half = ctx.get(-3)
        bit = ctx.get(-4)
        self.range_check(ctx, half, limb_bits - 1)
        self.gate.assert_bit(ctx, bit)
        return bit
