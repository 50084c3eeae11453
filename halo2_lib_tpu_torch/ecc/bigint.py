"""Non-native big-integer arithmetic on CRT limbs.

Re-implements the behavior of halo2-ecc/src/bigint/ (see SURVEY.md §2.7):
`OverflowInteger` (limbs with tracked max bits), `ProperUint` (canonical
limbs), `CRTInteger` (truncation limbs + native residue + tracked signed int
value — the dual-modulus CRT trick), and the op modules, most importantly
`carry_mod` / `check_carry_mod_to_zero` / `check_carry_to_zero`
(bigint/carry_mod.rs:29-191, check_carry_to_zero.rs:27-86).

Witness values are exact Python ints; limbs of *signed* values are embedded in
the native field as `p - |limb|`. Cell layouts follow the reference exactly —
including the negative gate offsets that overlap the carry_mod gate with the
preceding inner-product gate — so witness tables match the Rust ones.
"""

from __future__ import annotations

from ..core.cells import AssignedValue, Constant, Existing, Witness
from ..core.context import Context
from ..gates.flex_gate import GateChip
from ..gates.range import RangeChip
from ..utils.misc import bit_length, decompose_int, log2_ceil


def decompose_signed(e: int, num_limbs: int, bit_len: int, p: int) -> list[int]:
    """Signed limb decomposition embedded into F (utils/mod.rs:290-296)."""
    if e < 0:
        return [(p - l) % p for l in decompose_int(-e, num_limbs, bit_len)]
    return decompose_int(e, num_limbs, bit_len)


def fe_to_signed(v: int, p: int) -> int:
    """Interpret a field element as a signed int in (-p/2, p/2]."""
    return v - p if v > p // 2 else v


class OverflowInteger:
    """Limbs with tracked `max_limb_bits` (bigint/mod.rs:37-75)."""

    __slots__ = ("limbs", "max_limb_bits")

    def __init__(self, limbs: list[AssignedValue], max_limb_bits: int):
        self.limbs = limbs
        self.max_limb_bits = max_limb_bits

    def to_int(self, limb_bits: int, p: int) -> int:
        acc = 0
        for l in reversed(self.limbs):
            acc = (acc << limb_bits) + fe_to_signed(l.val(), p)
        return acc

    @staticmethod
    def evaluate_native(ctx: Context, gate: GateChip, limbs, limb_bases: list[int]) -> AssignedValue:
        """sum_i limbs[i] * limb_bases[i] in native F (bigint/mod.rs:66-75)."""
        limbs = list(limbs)
        return gate.inner_product(ctx, limbs, [Constant(c) for c in limb_bases[: len(limbs)]])


class ProperUint:
    """Canonical limbs, each in [0, 2^limb_bits) (bigint/mod.rs:84-112)."""

    __slots__ = ("limbs",)

    def __init__(self, limbs: list[AssignedValue]):
        self.limbs = limbs

    def into_overflow(self, limb_bits: int) -> OverflowInteger:
        return OverflowInteger(list(self.limbs), limb_bits)

    def into_crt(self, ctx, gate: GateChip, value: int, limb_bases, limb_bits: int) -> "ProperCrtUint":
        native = gate.inner_product(
            ctx, list(self.limbs), [Constant(c) for c in limb_bases[: len(self.limbs)]]
        )
        return ProperCrtUint(CRTInteger(self.into_overflow(limb_bits), native, value))


class CRTInteger:
    """Truncation limbs + native residue + tracked signed value (bigint/mod.rs:167-209)."""

    __slots__ = ("truncation", "native", "value")

    def __init__(self, truncation: OverflowInteger, native: AssignedValue, value: int):
        self.truncation = truncation
        self.native = native
        self.value = value  # signed python int

    def limbs(self) -> list[AssignedValue]:
        return self.truncation.limbs


class ProperCrtUint:
    """CRTInteger whose value is a canonical uint in [0, 2^t) (bigint/mod.rs:220-265)."""

    __slots__ = ("crt",)

    def __init__(self, crt: CRTInteger):
        self.crt = crt

    def limbs(self) -> list[AssignedValue]:
        return self.crt.limbs()

    @property
    def truncation(self) -> OverflowInteger:
        return self.crt.truncation

    @property
    def native(self) -> AssignedValue:
        return self.crt.native

    @property
    def value(self) -> int:
        assert self.crt.value >= 0
        return self.crt.value

    def as_crt(self) -> CRTInteger:
        return self.crt


class FixedOverflowInteger:
    """Constant limbs (bigint/mod.rs:116-164)."""

    __slots__ = ("limbs",)

    def __init__(self, limbs: list[int]):
        self.limbs = limbs

    @staticmethod
    def from_int(value: int, num_limbs: int, limb_bits: int) -> "FixedOverflowInteger":
        assert value >= 0
        return FixedOverflowInteger(decompose_int(value, num_limbs, limb_bits))

    def assign(self, ctx: Context) -> ProperUint:
        return ProperUint([ctx.load_constant(l) for l in self.limbs])


class FixedCRTInteger:
    """Constant CRT integer (bigint/mod.rs:267-306)."""

    __slots__ = ("truncation", "value")

    def __init__(self, truncation: FixedOverflowInteger, value: int):
        self.truncation = truncation
        self.value = value

    @staticmethod
    def from_int(value: int, num_limbs: int, limb_bits: int) -> "FixedCRTInteger":
        return FixedCRTInteger(FixedOverflowInteger.from_int(value, num_limbs, limb_bits), value)

    def assign(self, ctx: Context, limb_bits: int, native_modulus: int) -> ProperCrtUint:
        trunc = self.truncation.assign(ctx).into_overflow(limb_bits)
        native = ctx.load_constant(self.value % native_modulus)
        return ProperCrtUint(CRTInteger(trunc, native, self.value))


# ---------------------------------------------------------------------------
# limb-wise ops (each mirrors one bigint/*.rs module)
# ---------------------------------------------------------------------------

def add_no_carry(gate: GateChip, ctx: Context, a: OverflowInteger, b: OverflowInteger) -> OverflowInteger:
    """Limb-wise add, max_limb_bits + 1 (bigint/add_no_carry.rs)."""
    out_limbs = [gate.add(ctx, Existing(x), Existing(y)) for x, y in zip(a.limbs, b.limbs)]
    return OverflowInteger(out_limbs, max(a.max_limb_bits, b.max_limb_bits) + 1)


def crt_add_no_carry(gate: GateChip, ctx: Context, a: CRTInteger, b: CRTInteger) -> CRTInteger:
    trunc = add_no_carry(gate, ctx, a.truncation, b.truncation)
    native = gate.add(ctx, Existing(a.native), Existing(b.native))
    return CRTInteger(trunc, native, a.value + b.value)


def sub_no_carry(gate: GateChip, ctx: Context, a: OverflowInteger, b: OverflowInteger) -> OverflowInteger:
    """Limb-wise sub (bigint/sub_no_carry.rs)."""
    out_limbs = [gate.sub(ctx, Existing(x), Existing(y)) for x, y in zip(a.limbs, b.limbs)]
    return OverflowInteger(out_limbs, max(a.max_limb_bits, b.max_limb_bits) + 1)


def crt_sub_no_carry(gate: GateChip, ctx: Context, a: CRTInteger, b: CRTInteger) -> CRTInteger:
    trunc = sub_no_carry(gate, ctx, a.truncation, b.truncation)
    native = gate.sub(ctx, Existing(a.native), Existing(b.native))
    return CRTInteger(trunc, native, a.value - b.value)


def mul_no_carry(gate: GateChip, ctx: Context, a: OverflowInteger, b: OverflowInteger, num_limbs_log2_ceil: int) -> OverflowInteger:
    """Schoolbook limb convolution via inner_product (bigint/mul_no_carry.rs:4-49)."""
    k_a, k_b = len(a.limbs), len(b.limbs)
    assert k_a == k_b, "mul_no_carry requires equal limb counts"
    k_out = k_a + k_b - 1
    assert num_limbs_log2_ceil + a.max_limb_bits + b.max_limb_bits <= gate.F.num_bits - 2
    out_limbs = []
    for i in range(k_out):
        lo, hi = max(0, i - k_a + 1), min(i + 1, k_a)
        ip_a = [Existing(a.limbs[j]) for j in range(lo, hi)]
        ip_b = [Existing(b.limbs[i - j]) for j in range(lo, hi)]
        out_limbs.append(gate.inner_product(ctx, ip_a, ip_b))
    return OverflowInteger(out_limbs, num_limbs_log2_ceil + a.max_limb_bits + b.max_limb_bits)


def crt_mul_no_carry(gate: GateChip, ctx: Context, a: CRTInteger, b: CRTInteger) -> CRTInteger:
    k = len(a.truncation.limbs)
    trunc_full = mul_no_carry(gate, ctx, a.truncation, b.truncation, log2_ceil(k))
    # truncate to k limbs (mul_no_carry::truncate keeps only first k)
    trunc = OverflowInteger(trunc_full.limbs[:k], trunc_full.max_limb_bits)
    native = gate.mul(ctx, Existing(a.native), Existing(b.native))
    return CRTInteger(trunc, native, a.value * b.value)


def _mul_no_carry_truncate(gate: GateChip, ctx: Context, a: OverflowInteger, b: OverflowInteger, k_bits: int) -> OverflowInteger:
    """Only the first k limb convolutions (mul_no_carry::truncate)."""
    k = len(a.limbs)
    out_limbs = []
    for i in range(k):
        hi = min(i + 1, k)
        ip_a = [Existing(a.limbs[j]) for j in range(hi)]
        ip_b = [Existing(b.limbs[i - j]) for j in range(hi)]
        out_limbs.append(gate.inner_product(ctx, ip_a, ip_b))
    return OverflowInteger(out_limbs, k_bits + a.max_limb_bits + b.max_limb_bits)


def scalar_mul_no_carry(gate: GateChip, ctx: Context, a: OverflowInteger, c: int) -> OverflowInteger:
    """a * c for small signed int c (bigint/scalar_mul_no_carry.rs)."""
    F = gate.F
    c_f = c % F.p
    out_limbs = [gate.mul(ctx, Existing(l), Constant(c_f)) for l in a.limbs]
    return OverflowInteger(out_limbs, a.max_limb_bits + bit_length(abs(c)))


def crt_scalar_mul_no_carry(gate: GateChip, ctx: Context, a: CRTInteger, c: int) -> CRTInteger:
    trunc = scalar_mul_no_carry(gate, ctx, a.truncation, c)
    native = gate.mul(ctx, Existing(a.native), Constant(c % gate.F.p))
    return CRTInteger(trunc, native, a.value * c)


def scalar_mul_and_add_no_carry(
    gate: GateChip, ctx: Context, a: OverflowInteger, b: OverflowInteger, c: int
) -> OverflowInteger:
    """a * c + b in one gate per limb (bigint/scalar_mul_and_add_no_carry.rs:11-58)."""
    F = gate.F
    c_f = c % F.p
    out_limbs = [
        gate.mul_add(ctx, Existing(x), Constant(c_f), Existing(y))
        for x, y in zip(a.limbs, b.limbs)
    ]
    return OverflowInteger(
        out_limbs, max(a.max_limb_bits + bit_length(abs(c)), b.max_limb_bits) + 1
    )


def crt_scalar_mul_and_add_no_carry(gate: GateChip, ctx: Context, a: CRTInteger, b: CRTInteger, c: int) -> CRTInteger:
    trunc = scalar_mul_and_add_no_carry(gate, ctx, a.truncation, b.truncation, c)
    native = gate.mul_add(ctx, Existing(a.native), Constant(c % gate.F.p), Existing(b.native))
    return CRTInteger(trunc, native, a.value * c + b.value)


def big_sub(range_chip: RangeChip, ctx: Context, a: ProperUint, b: ProperUint, limb_bits: int):
    """Borrow-chain subtraction; returns (a - b as OverflowInteger, underflow bit).

    Per-limb layout (bigint/sub.rs:13-61):
    | a | lt | 2^n | a + lt*2^n | -1 | bottom | a + lt*2^n - bottom | gates at 0, 3
    where `lt = a < bottom`, `bottom = b + borrow_in`.
    """
    gate = range_chip.gate
    F = gate.F
    limb_base = gate.pow_of_two[limb_bits]
    out_limbs = []
    borrow: AssignedValue | None = None
    for a_limb, b_limb in zip(a.limbs, b.limbs):
        if borrow is None:
            lt = range_chip.is_less_than(ctx, Existing(a_limb), Existing(b_limb), limb_bits)
            bottom = b_limb
        else:
            bottom = gate.add(ctx, Existing(b_limb), Existing(borrow))
            lt = range_chip.is_less_than(ctx, Existing(a_limb), Existing(bottom), limb_bits + 1)
        a_with_borrow = F.add(F.mul(limb_base, lt.val()), a_limb.val())
        out_val = F.sub(a_with_borrow, bottom.val())
        out_limb = ctx.assign_region_last(
            [
                Existing(a_limb),
                Existing(lt),
                Constant(limb_base),
                Witness(a_with_borrow),
                Constant(F.p - 1),
                Existing(bottom),
                Witness(out_val),
            ],
            [0, 3],
        )
        out_limbs.append(out_limb)
        borrow = lt
    return OverflowInteger(out_limbs, limb_bits), borrow


def crt_sub(range_chip: RangeChip, ctx: Context, a: ProperCrtUint, b: ProperCrtUint, limb_bits: int):
    """(a - b, underflow) over proper CRT ints (bigint/sub.rs:66-85)."""
    gate = range_chip.gate
    out_native = gate.sub(ctx, Existing(a.native), Existing(b.native))
    out_trunc, underflow = big_sub(
        range_chip, ctx, ProperUint(a.limbs()), ProperUint(b.limbs()), limb_bits
    )
    return CRTInteger(out_trunc, out_native, a.crt.value - b.crt.value), underflow


def big_is_zero(gate: GateChip, ctx: Context, a: OverflowInteger) -> AssignedValue:
    """positive-variant: sum limbs then is_zero (bigint/big_is_zero.rs:17-33).

    Assumes limbs are non-negative with max_limb_bits small enough that the sum
    doesn't overflow.
    """
    total = gate.sum(ctx, [Existing(l) for l in a.limbs])
    return gate.is_zero(ctx, total)


def big_is_equal(gate: GateChip, ctx: Context, a: ProperUint, b: ProperUint) -> AssignedValue:
    """AND over limb-wise is_equal (bigint/big_is_equal.rs:5-29)."""
    assert len(a.limbs) == len(b.limbs) and a.limbs
    eq = gate.is_equal(ctx, Existing(a.limbs[0]), Existing(b.limbs[0]))
    for x, y in zip(a.limbs[1:], b.limbs[1:]):
        eq_i = gate.is_equal(ctx, Existing(x), Existing(y))
        eq = gate.and_(ctx, Existing(eq), Existing(eq_i))
    return eq


def big_less_than(range_chip: RangeChip, ctx: Context, a: ProperUint, b: ProperUint, limb_bits: int, limb_base: int) -> AssignedValue:
    """a < b via subtraction underflow (bigint/big_less_than.rs:4-17)."""
    _, underflow = big_sub(range_chip, ctx, a, b, limb_bits)
    return underflow


def select(gate: GateChip, ctx: Context, a: OverflowInteger, b: OverflowInteger, sel: AssignedValue) -> OverflowInteger:
    out_limbs = [gate.select(ctx, Existing(x), Existing(y), Existing(sel)) for x, y in zip(a.limbs, b.limbs)]
    return OverflowInteger(out_limbs, max(a.max_limb_bits, b.max_limb_bits))


def crt_select(gate: GateChip, ctx: Context, a: CRTInteger, b: CRTInteger, sel: AssignedValue) -> CRTInteger:
    trunc = select(gate, ctx, a.truncation, b.truncation, sel)
    native = gate.select(ctx, Existing(a.native), Existing(b.native), Existing(sel))
    value = a.value if sel.val() else b.value
    return CRTInteger(trunc, native, value)


def select_by_indicator(gate: GateChip, ctx: Context, ints: list[OverflowInteger], coeffs: list[AssignedValue]) -> OverflowInteger:
    k = len(ints[0].limbs)
    out_limbs = [
        gate.select_by_indicator(ctx, [Existing(x.limbs[i]) for x in ints], coeffs)
        for i in range(k)
    ]
    return OverflowInteger(out_limbs, max(x.max_limb_bits for x in ints))


def crt_select_by_indicator(gate: GateChip, ctx: Context, ints: list[CRTInteger], coeffs: list[AssignedValue]) -> CRTInteger:
    trunc = select_by_indicator(gate, ctx, [x.truncation for x in ints], coeffs)
    native = gate.select_by_indicator(ctx, [Existing(x.native) for x in ints], coeffs)
    value = 0
    for x, c in zip(ints, coeffs):
        if c.val():
            value = x.value
    return CRTInteger(trunc, native, value)


def negative(gate: GateChip, ctx: Context, a: OverflowInteger) -> OverflowInteger:
    out_limbs = [gate.neg(ctx, Existing(l)) for l in a.limbs]
    return OverflowInteger(out_limbs, a.max_limb_bits)


# ---------------------------------------------------------------------------
# carry chain
# ---------------------------------------------------------------------------

def check_carry_to_zero(range_chip: RangeChip, ctx: Context, a: OverflowInteger, limb_bits: int) -> None:
    """Witness per-limb carries, constrain a_i + c_{i-1} = c_i * 2^n, range check
    shifted carries (bigint/check_carry_to_zero.rs:27-86)."""
    gate = range_chip.gate
    F = gate.F
    p = F.p
    k = len(a.limbs)
    limb_base = gate.pow_of_two[limb_bits]

    # compute signed carries on host
    carries: list[int] = []
    for l in a.limbs:
        a_val = fe_to_signed(l.val(), p)
        prev = carries[-1] if carries else 0
        num = a_val + prev
        # exact when the constraint is satisfiable; floor division otherwise
        # (witness is then wrong and the gate check fails, as in the reference
        # where this is only a debug assertion)
        carries.append(num >> limb_bits)

    EPSILON = 1
    range_bits = a.max_limb_bits - limb_bits + EPSILON
    lb = range_chip.lookup_bits
    range_bits = ((range_bits + lb) // lb) * lb - 1
    shift_val = gate.pow_of_two[range_bits]

    previous = None
    for a_limb, carry in zip(a.limbs, carries):
        neg_carry_val = (-carry) % p
        ctx.assign_region(
            [
                Existing(a_limb),
                Witness(neg_carry_val),
                Constant(limb_base),
                Existing(previous) if previous is not None else Constant(0),
            ],
            [0],
        )
        neg_carry = ctx.get(-3)
        shifted_carry = gate.add(ctx, Existing(neg_carry), Constant(shift_val))
        range_chip.range_check(ctx, shifted_carry, range_bits + 1)
        previous = neg_carry


def carry_mod(
    range_chip: RangeChip,
    ctx: Context,
    a: CRTInteger,
    k_bits: int,
    modulus: int,
    mod_vec: list[int],
    mod_native: int,
    limb_bits: int,
    limb_bases: list[int],
) -> ProperCrtUint:
    """out = a mod modulus, fully constrained (bigint/carry_mod.rs:29-191)."""
    gate = range_chip.gate
    F = gate.F
    p = F.p
    n = limb_bits
    k = len(a.truncation.limbs)
    trunc_len = n * k

    assert abs(a.value).bit_length() <= n * k - 1 + F.num_bits - 2

    quot_max_bits = trunc_len - 1 + F.num_bits - 1 - modulus.bit_length()
    assert quot_max_bits < trunc_len
    quot_last_limb_bits = quot_max_bits - n * (k - 1)
    out_max_bits = modulus.bit_length()
    out_last_limb_bits = out_max_bits - n * (k - 1)

    # witnesses: Python divmod floors like num_integer::div_mod_floor
    quot_val, out_val = divmod(a.value, modulus)
    assert 0 <= out_val < (1 << (n * k))
    assert abs(quot_val) < (1 << quot_max_bits)

    out_vec = decompose_signed(out_val, k, n, p)
    quot_vec = decompose_signed(quot_val, k, n, p)
    assert len(mod_vec) == k

    quot_assigned: list[AssignedValue] = []
    out_assigned: list[AssignedValue] = []
    check_assigned: list[AssignedValue] = []

    for i in range(k):
        a_limb = a.truncation.limbs[i]
        # prod_i = sum_{j<=i} quot_j * mod_{i-j}, assigning quot_vec[i] on the fly
        ip_a = [Existing(q) for q in quot_assigned] + [Witness(quot_vec[i])]
        ip_b = [Constant(mod_vec[j]) for j in range(i, -1, -1)]
        prod, new_quot_cell = gate.inner_product_left_last(ctx, ip_a, ip_b)

        # | prod | -1 | a | prod - a | 1 | out | prod - a + out | with gates at -1, 2
        temp1 = F.sub(prod.val(), a_limb.val())
        check_val = F.add(temp1, out_vec[i])
        ctx.assign_region(
            [
                Constant(p - 1),
                Existing(a_limb),
                Witness(temp1),
                Constant(1),
                Witness(out_vec[i]),
                Witness(check_val),
            ],
            [-1, 2],
        )
        check_cell = ctx.last()
        out_cell = ctx.get(-2)
        quot_assigned.append(new_quot_cell)
        out_assigned.append(out_cell)
        check_assigned.append(check_cell)

    # range check out limbs
    for idx, out_cell in enumerate(out_assigned):
        bits = out_last_limb_bits if idx == k - 1 else n
        range_chip.range_check(ctx, out_cell, bits)

    # shifted range check quot limbs in [-2^bits, 2^bits)
    for idx, quot_cell in enumerate(quot_assigned):
        bits = quot_last_limb_bits if idx == k - 1 else n
        limb_base = gate.pow_of_two[bits] if idx == k - 1 else limb_bases[1] % p
        quot_shift = gate.add(ctx, Existing(quot_cell), Constant(limb_base))
        range_chip.range_check(ctx, quot_shift, bits + 1)

    check_int = OverflowInteger(
        check_assigned,
        max(max(limb_bits, a.truncation.max_limb_bits) + 1, 2 * n + k_bits),
    )
    check_carry_to_zero(range_chip, ctx, check_int, limb_bits)

    quot_native = gate.inner_product(
        ctx, [Existing(q) for q in quot_assigned], [Constant(c % p) for c in limb_bases[:k]]
    )
    out_native = gate.inner_product(
        ctx, [Existing(o) for o in out_assigned], [Constant(c % p) for c in limb_bases[:k]]
    )
    # | out_native | mod_native | quot_native | a.native | via negative offset -1
    ctx.assign_region(
        [Constant(mod_native), Existing(quot_native), Existing(a.native)],
        [-1],
    )

    return ProperCrtUint(
        CRTInteger(ProperUint(out_assigned).into_overflow(limb_bits), out_native, out_val)
    )


def check_carry_mod_to_zero(
    range_chip: RangeChip,
    ctx: Context,
    a: CRTInteger,
    k_bits: int,
    modulus: int,
    mod_vec: list[int],
    mod_native: int,
    limb_bits: int,
    limb_bases: list[int],
) -> None:
    """Constrain a ≡ 0 mod modulus (bigint/check_carry_mod_to_zero.rs:16-125)."""
    gate = range_chip.gate
    F = gate.F
    p = F.p
    n = limb_bits
    k = len(a.truncation.limbs)
    trunc_len = n * k

    assert abs(a.value).bit_length() <= n * k - 1 + F.num_bits - 2
    quot_max_bits = trunc_len - 1 + F.num_bits - 1 - modulus.bit_length()
    assert quot_max_bits < trunc_len
    quot_last_limb_bits = quot_max_bits - n * (k - 1)

    quot_val, out_val = divmod(a.value, modulus)
    # out_val == 0 when satisfiable; otherwise the constraints fail in the
    # prover (reference uses debug_assert_eq!, check_carry_mod_to_zero.rs:48)
    assert abs(quot_val) < (1 << quot_max_bits)

    quot_vec = decompose_signed(quot_val, k, n, p)
    assert modulus < (1 << (n * k))

    quot_assigned: list[AssignedValue] = []
    check_assigned: list[AssignedValue] = []
    for i in range(k):
        a_limb = a.truncation.limbs[i]
        ip_a = [Existing(q) for q in quot_assigned] + [Witness(quot_vec[i])]
        ip_b = [Constant(mod_vec[j]) for j in range(i, -1, -1)]
        prod, new_quot_cell = gate.inner_product_left_last(ctx, ip_a, ip_b)
        # | prod | -1 | a | prod - a | gate at -1
        check_val = F.sub(prod.val(), a_limb.val())
        ctx.assign_region([Constant(p - 1), Existing(a_limb), Witness(check_val)], [-1])
        check_cell = ctx.last()
        quot_assigned.append(new_quot_cell)
        check_assigned.append(check_cell)

    for idx, quot_cell in enumerate(quot_assigned):
        bits = quot_last_limb_bits if idx == k - 1 else n
        limb_base = gate.pow_of_two[bits] if idx == k - 1 else limb_bases[1] % p
        quot_shift = gate.add(ctx, Existing(quot_cell), Constant(limb_base))
        range_chip.range_check(ctx, quot_shift, bits + 1)

    check_int = OverflowInteger(
        check_assigned, max(a.truncation.max_limb_bits, 2 * n + k_bits)
    )
    check_carry_to_zero(range_chip, ctx, check_int, limb_bits)

    quot_native = gate.inner_product(
        ctx, [Existing(q) for q in quot_assigned], [Constant(c % p) for c in limb_bases[:k]]
    )
    # | 0 | mod_native | quot_native | a.native |
    ctx.assign_region(
        [Constant(0), Constant(mod_native), Existing(quot_native), Existing(a.native)],
        [0],
    )
