"""GateChip: the complete vertical-gate op library.

Every op emits the exact same cell pattern as the reference
(halo2-base/src/gates/flex_gate/mod.rs:148-1266) so witness tables match the
Rust implementation cell-for-cell. The single custom gate is
``q * (a + b*c - d) = 0`` over 4 consecutive rows of one advice column.

All values are ints in [0, p) for the chip's native field `F`.
"""

from __future__ import annotations

from ..core.cells import (
    AssignedValue,
    Constant,
    Existing,
    QCell,
    Rational,
    Witness,
    WitnessFraction,
    as_qcell,
    qcell_value,
    _CONSTANT,
)
from ..core.context import Context
from ..native import get_emitter
from ..utils.fields import PrimeField
from ..utils.misc import decompose_fe_to_u64_limbs

MAX_PHASE = 3


class GateChip:
    """Arithmetic/logic ops compiled to vertical-gate cell patterns."""

    def __init__(self, field: PrimeField):
        self.F = field
        p = field.p
        # 2^i mod p for i in 0..NUM_BITS (flex_gate/mod.rs:916-929)
        self.pow_of_two = [pow(2, i, p) for i in range(field.num_bits)]

    # --- basic arithmetic ---------------------------------------------------
    def add(self, ctx: Context, a, b) -> AssignedValue:
        """| a | b | 1 | a + b | (flex_gate/mod.rs:158-168)"""
        a, b = as_qcell(a), as_qcell(b)
        out = self.F.add(qcell_value(a), qcell_value(b))
        return ctx.assign_region_last([a, b, Constant(1), Witness(out)], [0])

    def inc(self, ctx: Context, a) -> AssignedValue:
        return self.add(ctx, a, Constant(1))

    def sub(self, ctx: Context, a, b) -> AssignedValue:
        """| a - b | b | 1 | a | (flex_gate/mod.rs:184-196)"""
        a, b = as_qcell(a), as_qcell(b)
        out = self.F.sub(qcell_value(a), qcell_value(b))
        ctx.assign_region([Witness(out), b, Constant(1), a], [0])
        return ctx.get(-4)

    def dec(self, ctx: Context, a) -> AssignedValue:
        return self.sub(ctx, a, Constant(1))

    def sub_mul(self, ctx: Context, a, b, c) -> AssignedValue:
        """| a - b*c | b | c | a | (flex_gate/mod.rs:213-226)"""
        a, b, c = as_qcell(a), as_qcell(b), as_qcell(c)
        F = self.F
        out = F.sub(qcell_value(a), F.mul(qcell_value(b), qcell_value(c)))
        ctx.assign_region_last([Witness(out), b, c, a], [0])
        return ctx.get(-4)

    def neg(self, ctx: Context, a) -> AssignedValue:
        """| a | -a | 1 | 0 | (flex_gate/mod.rs:233-238)"""
        a = as_qcell(a)
        out = self.F.neg(qcell_value(a))
        ctx.assign_region([a, Witness(out), Constant(1), Constant(0)], [0])
        return ctx.get(-3)

    def mul(self, ctx: Context, a, b) -> AssignedValue:
        """| 0 | a | b | a*b | (flex_gate/mod.rs:246-256)"""
        a, b = as_qcell(a), as_qcell(b)
        out = self.F.mul(qcell_value(a), qcell_value(b))
        return ctx.assign_region_last([Constant(0), a, b, Witness(out)], [0])

    def mul_add(self, ctx: Context, a, b, c) -> AssignedValue:
        """| c | a | b | a*b + c | (flex_gate/mod.rs:265-277)"""
        a, b, c = as_qcell(a), as_qcell(b), as_qcell(c)
        F = self.F
        out = F.add(F.mul(qcell_value(a), qcell_value(b)), qcell_value(c))
        return ctx.assign_region_last([c, a, b, Witness(out)], [0])

    def mul_not(self, ctx: Context, a, b) -> AssignedValue:
        """| (1-a)*b | a | b | b | (flex_gate/mod.rs:285-296)"""
        a, b = as_qcell(a), as_qcell(b)
        F = self.F
        out = F.mul(F.sub(1, qcell_value(a)), qcell_value(b))
        ctx.assign_region_smart([Witness(out), a, b, b], [0], [(2, 3)], [])
        return ctx.get(-4)

    def assert_bit(self, ctx: Context, x: AssignedValue) -> None:
        """| 0 | x | x | x | (flex_gate/mod.rs:303-305)"""
        ctx.assign_region([Constant(0), Existing(x), Existing(x), Existing(x)], [0])

    def div_unsafe(self, ctx: Context, a, b) -> AssignedValue:
        """| 0 | a/b | b | a |; assumes b != 0 (flex_gate/mod.rs:315-328)"""
        a, b = as_qcell(a), as_qcell(b)
        F = self.F
        c = F.mul(F.inv(qcell_value(b)), qcell_value(a))
        ctx.assign_region([Constant(0), Witness(c), b, a], [0])
        return ctx.get(-3)

    def assert_is_const(self, ctx: Context, a: AssignedValue, constant: int) -> None:
        if not ctx.witness_gen_only:
            ctx.copy_manager.constant_equalities.append((constant % self.F.p, a.cell))

    # --- inner products -----------------------------------------------------
    def _inner_product_simple(self, ctx: Context, a: list[QCell], b: list[QCell]) -> bool:
        """Running-sum inner product; saves 3 cells when b[0] == Constant(1).

        (flex_gate/mod.rs:940-978)
        """
        assert len(a) == len(b)
        F = self.F
        em = get_emitter(F.p)
        if em is not None:
            r = em.inner_product(ctx, a, b)
            if r >= 0:
                return bool(r)
        b_starts_with_one = bool(b) and b[0].kind == _CONSTANT and b[0].val == 1
        cells: list[QCell] = []
        if b_starts_with_one:
            start_a = a[0]
            cells.append(start_a)
            s = qcell_value(start_a)
            rest = zip(a[1:], b[1:])
        else:
            cells.append(Constant(0))
            s = 0
            rest = zip(a, b)
        for qa, qb in rest:
            s = F.add(s, F.mul(qcell_value(qa), qcell_value(qb)))
            cells.append(qa)
            cells.append(qb)
            cells.append(Witness(s))
        if ctx.witness_gen_only:
            ctx.assign_region(cells, [])
        else:
            n_gates = len(cells) // 3
            ctx.assign_region(cells, [3 * i for i in range(n_gates)])
        return b_starts_with_one

    def inner_product(self, ctx: Context, a, b) -> AssignedValue:
        a = [as_qcell(x) for x in a]
        b = [as_qcell(x) for x in b]
        self._inner_product_simple(ctx, a, b)
        return ctx.last()

    def inner_product_left_last(self, ctx: Context, a, b):
        """(inner product, last assigned element of a) (flex_gate/mod.rs:1017-1041)"""
        a = [as_qcell(x) for x in a]
        b = [as_qcell(x) for x in b]
        n = len(a)
        row_offset = len(ctx.advice)
        b_starts_with_one = self._inner_product_simple(ctx, a, b)
        if b_starts_with_one:
            if n == 1:
                a_last = ctx.get(row_offset)
            else:
                a_last = ctx.get(row_offset + 1 + 3 * (n - 2))
        else:
            a_last = ctx.get(row_offset + 1 + 3 * (n - 1))
        return ctx.last(), a_last

    def inner_product_left(self, ctx: Context, a, b):
        """(inner product, all assigned elements of a) (flex_gate/mod.rs:1054-1081)"""
        a = [as_qcell(x) for x in a]
        b = [as_qcell(x) for x in b]
        n = len(a)
        row_offset = len(ctx.advice)
        b_starts_with_one = self._inner_product_simple(ctx, a, b)
        a_assigned = []
        for i in range(n):
            if b_starts_with_one:
                idx = row_offset if i == 0 else row_offset + 1 + 3 * (i - 1)
            else:
                idx = row_offset + 1 + 3 * i
            a_assigned.append(ctx.get(idx))
        return ctx.last(), a_assigned

    def inner_product_with_sums(self, ctx: Context, a, b):
        """Iterator of running sums (flex_gate/mod.rs:1091-1108)"""
        a = [as_qcell(x) for x in a]
        b = [as_qcell(x) for x in b]
        row_offset = len(ctx.advice)
        b_starts_with_one = self._inner_product_simple(ctx, a, b)
        end = len(ctx.advice)
        if b_starts_with_one:
            return [ctx.get(i) for i in range(row_offset, end, 3)]
        return [ctx.get(i) for i in range(row_offset, end, 3)][1:]

    # --- sums ----------------------------------------------------------------
    def sum(self, ctx: Context, a) -> AssignedValue:
        """Chained | .. | a_i | 1 | sum_i | gates (flex_gate/mod.rs:412-435)"""
        a = [as_qcell(x) for x in a]
        if not a:
            return ctx.load_zero()
        if len(a) == 1:
            return ctx.assign_region_last([a[0]], [])
        F = self.F
        s = qcell_value(a[0])
        cells = [a[0]]
        for q in a[1:]:
            s = F.add(s, qcell_value(q))
            cells.extend([q, Constant(1), Witness(s)])
        return ctx.assign_region_last(cells, [3 * i for i in range(len(a) - 1)])

    def partial_sums(self, ctx: Context, a) -> list[AssignedValue]:
        """All running sums (flex_gate/mod.rs:442-470)"""
        a = [as_qcell(x) for x in a]
        if not a:
            return [ctx.load_zero()]
        if len(a) == 1:
            return [ctx.assign_region_last([a[0]], [])]
        F = self.F
        s = qcell_value(a[0])
        cells = [a[0]]
        for q in a[1:]:
            s = F.add(s, qcell_value(q))
            cells.extend([q, Constant(1), Witness(s)])
        n = len(a) - 1
        ctx.assign_region(cells, [3 * i for i in range(n)])
        return [ctx.get(-1 - 3 * i) for i in range(n, -1, -1)]

    def accumulated_product(self, ctx: Context, a, b) -> list[AssignedValue]:
        """x_{i+1} = a_{i+1} * x_i + b_{i+1} (flex_gate/mod.rs:483-505)"""
        a = [as_qcell(x) for x in a]
        b = [as_qcell(x) for x in b]
        if not b:
            return []
        out = [ctx.assign_region_last([b[0]], [])]
        for qa, qb in zip(a, b[1:]):
            out.append(self.mul_add(ctx, Existing(out[-1]), qa, qb))
        return out

    def sum_products_with_coeff_and_var(self, ctx: Context, values, var) -> AssignedValue:
        """var + sum coeff*(a*b) (flex_gate/mod.rs:1115-1135)"""
        a_list = [as_qcell(var)]
        b_list = [Constant(1)]
        for c, va, vb in values:
            c = c % self.F.p
            if c == 1:
                a_list.append(as_qcell(va))
                b_list.append(as_qcell(vb))
            elif c != 0:
                prod = self.mul(ctx, va, vb)
                a_list.append(Existing(prod))
                b_list.append(Constant(c))
        return self.inner_product(ctx, a_list, b_list)

    # --- boolean ops ----------------------------------------------------------
    def or_(self, ctx: Context, a, b) -> AssignedValue:
        """| 1-b | 1 | b | 1 | b | a | 1-b | out | (flex_gate/mod.rs:525-547)"""
        a, b = as_qcell(a), as_qcell(b)
        F = self.F
        av, bv = qcell_value(a), qcell_value(b)
        not_b = F.sub(1, bv)
        out = F.sub(F.add(av, bv), F.mul(av, bv))
        cells = [
            Witness(not_b),
            Constant(1),
            b,
            Constant(1),
            b,
            a,
            Witness(not_b),
            Witness(out),
        ]
        ctx.assign_region_smart(cells, [0, 4], [(0, 6), (2, 4)], [])
        return ctx.last()

    def and_(self, ctx: Context, a, b) -> AssignedValue:
        return self.mul(ctx, a, b)

    def not_(self, ctx: Context, a) -> AssignedValue:
        return self.sub(ctx, Constant(1), a)

    def select(self, ctx: Context, a, b, sel) -> AssignedValue:
        """| a-b | 1 | b | a | b | sel | a-b | out | (flex_gate/mod.rs:1144-1170)"""
        a, b, sel = as_qcell(a), as_qcell(b), as_qcell(sel)
        F = self.F
        av, bv, sv = qcell_value(a), qcell_value(b), qcell_value(sel)
        diff = F.sub(av, bv)
        out = F.add(F.mul(diff, sv), bv)
        cells = [Witness(diff), Constant(1), b, a, b, sel, Witness(diff), Witness(out)]
        ctx.assign_region_smart(cells, [0, 4], [(0, 6), (2, 4)], [])
        return ctx.last()

    def or_and(self, ctx: Context, a, b, c) -> AssignedValue:
        """a || (b && c) (flex_gate/mod.rs:1179-1208)"""
        a, b, c = as_qcell(a), as_qcell(b), as_qcell(c)
        F = self.F
        av, bv, cv = qcell_value(a), qcell_value(b), qcell_value(c)
        bc = F.mul(bv, cv)
        not_bc = F.sub(1, bc)
        not_a = F.sub(av, 1)
        out = F.sub(F.add(bc, av), F.mul(bc, av))
        cells = [
            Witness(not_bc),
            b,
            c,
            Constant(1),
            Witness(not_a),
            Witness(not_bc),
            Witness(out),
            Witness(not_a),
            Constant(1),
            Constant(1),
            a,
        ]
        ctx.assign_region_smart(cells, [0, 3, 7], [(4, 7), (0, 5)], [])
        return ctx.get(-5)

    # --- indicators -------------------------------------------------------------
    def bits_to_indicator(self, ctx: Context, bits: list[AssignedValue]) -> list[AssignedValue]:
        """One-hot vector of length 2^k from k little-endian bits (flex_gate/mod.rs:609-656)"""
        k = len(bits)
        assert k > 0
        F = self.F
        last = bits[k - 1]
        ctx.assign_region(
            [Witness(F.sub(1, last.val())), Existing(last), Constant(1), Constant(1)],
            [0],
        )
        inv_last_bit, last_bit = ctx.get(-4), ctx.get(-3)
        indicator = [inv_last_bit, last_bit]
        offset = 0
        for idx in range(1, k):
            bit = bits[k - 1 - idx]
            for old_idx in range(1 << idx):
                prev = indicator[offset + old_idx]
                inv_prod = F.mul(F.sub(1, bit.val()), prev.val())
                ctx.assign_region(
                    [Witness(inv_prod), Existing(prev), Existing(bit), Existing(prev)],
                    [0],
                )
                indicator.append(ctx.get(-4))
                indicator.append(self.mul(ctx, Existing(prev), Existing(bit)))
            offset += 1 << idx
        return indicator[(1 << k) - 2 :]

    def idx_to_indicator(self, ctx: Context, idx, length: int) -> list[AssignedValue]:
        """indicator[i] = (i == idx) (flex_gate/mod.rs:664-700)"""
        idx = as_qcell(idx)
        out = []
        for i in range(length):
            if i == 0:
                # unrolled is_zero so a Witness idx becomes Existing afterwards
                x = qcell_value(idx)
                if x == 0:
                    is_zero, inv = 1, Rational(1, 1)
                else:
                    is_zero, inv = 0, Rational(1, x)
                cells = [
                    Witness(is_zero),
                    idx,
                    QCell(2, inv),  # WitnessFraction
                    Constant(1),
                    Constant(0),
                    idx,
                    Witness(is_zero),
                    Constant(0),
                ]
                ctx.assign_region_smart(cells, [0, 4], [(0, 6), (1, 5)], [])
                idx = Existing(ctx.get(-3))
                out.append(ctx.get(-2))
            else:
                out.append(self.is_equal(ctx, idx, Constant(i % self.F.p)))
        return out

    def select_by_indicator(self, ctx: Context, a, indicator) -> AssignedValue:
        """<a, indicator> assuming one-hot indicator (flex_gate/mod.rs:709-730)"""
        a = [as_qcell(x) for x in a]
        indicator = list(indicator)
        F = self.F
        s = 0
        cells = [Constant(0)]
        for qa, ind in zip(a, indicator):
            if ind.val() != 0:
                s = qcell_value(qa)
            cells.extend([qa, Existing(ind), Witness(s)])
        return ctx.assign_region_last(cells, [3 * i for i in range(len(a))])

    def select_from_idx(self, ctx: Context, cells, idx) -> AssignedValue:
        cells = [as_qcell(x) for x in cells]
        ind = self.idx_to_indicator(ctx, idx, len(cells))
        return self.select_by_indicator(ctx, cells, ind)

    def select_array_by_indicator(self, ctx: Context, array2d, indicator) -> list[AssignedValue]:
        return [
            self.select_by_indicator(ctx, [row[j] for row in array2d], indicator)
            for j in range(len(array2d[0]))
        ]

    # --- equality / zero tests ----------------------------------------------------
    def is_zero(self, ctx: Context, a: AssignedValue) -> AssignedValue:
        """| out | a | inv | 1 | 0 | a | out | 0 | (flex_gate/mod.rs:789-809)"""
        x = a.val()
        if x == 0:
            is_zero, inv = 1, Rational(1, 1)
        else:
            is_zero, inv = 0, Rational(1, x)
        cells = [
            Witness(is_zero),
            Existing(a),
            QCell(2, inv),
            Constant(1),
            Constant(0),
            Existing(a),
            Witness(is_zero),
            Constant(0),
        ]
        ctx.assign_region_smart(cells, [0, 4], [(0, 6)], [])
        return ctx.get(-2)

    def is_equal(self, ctx: Context, a, b) -> AssignedValue:
        diff = self.sub(ctx, a, b)
        return self.is_zero(ctx, diff)

    # --- bit decomposition / pow ----------------------------------------------------
    def num_to_bits(self, ctx: Context, a: AssignedValue, range_bits: int) -> list[AssignedValue]:
        """LE bits of a (flex_gate/mod.rs:1215-1241)"""
        assert range_bits > 0
        bits = decompose_fe_to_u64_limbs(a.val(), range_bits, 1)
        row_offset = len(ctx.advice)
        acc = self.inner_product(
            ctx,
            [Witness(x) for x in bits],
            [Constant(c) for c in self.pow_of_two[:range_bits]],
        )
        ctx.constrain_equal(a, acc)
        bit_cells = [ctx.get(row_offset)]
        for i in range(1, range_bits):
            bit_cells.append(ctx.get(row_offset + 1 + 3 * (i - 1)))
        for bc in bit_cells:
            self.assert_bit(ctx, bc)
        return bit_cells

    def pow_var(self, ctx: Context, a: AssignedValue, exp: AssignedValue, max_bits: int) -> AssignedValue:
        """Square-and-multiply a^exp (flex_gate/mod.rs:1246-1265)"""
        exp_bits = self.num_to_bits(ctx, exp, max_bits)
        acc = ctx.load_constant(1)
        for i, bit in enumerate(reversed(exp_bits)):
            if i > 0:
                acc = self.mul(ctx, acc, acc)
            m = self.mul(ctx, acc, a)
            acc = self.select(ctx, m, acc, bit)
        return acc

    def lagrange_and_eval(self, ctx: Context, coords, x: AssignedValue):
        """Lagrange-interpolate coords and evaluate at x (flex_gate/mod.rs:860-898)"""
        assert coords
        z = self.sub(ctx, Existing(x), Existing(coords[0][0]))
        for cx, _ in coords[1:]:
            sub = self.sub(ctx, Existing(x), Existing(cx))
            z = self.mul(ctx, Existing(z), Existing(sub))
        eval_acc = None
        for i in range(len(coords)):
            denom = self.sub(ctx, Existing(x), Existing(coords[i][0]))
            for j in range(len(coords)):
                if i == j:
                    continue
                sub = self.sub(ctx, coords[i][0], coords[j][0])
                denom = self.mul(ctx, denom, sub)
            is_zero = self.is_zero(ctx, denom)
            self.assert_is_const(ctx, is_zero, 0)
            quot = self.div_unsafe(ctx, coords[i][1], denom)
            eval_acc = quot if eval_acc is None else self.add(ctx, eval_acc, quot)
        out = self.mul(ctx, eval_acc, z)
        return out, z
