"""In-circuit elliptic-curve operations over an emulated field chip.

Re-implements halo2-ecc/src/ecc/mod.rs: affine short-Weierstrass (a=0) ops —
ec_add_unequal / ec_sub_unequal / ec_sub_strict / ec_double /
ec_double_and_add_unequal / selects / check_is_on_curve / scalar_multiply /
multi_scalar_multiply (Simultaneous 2^w-ary with the halo2wrong random
accumulator trick) — and the EccChip wrapper (ecc/mod.rs:815-1204).

`chip` below is an FpChip (or any chip with the same FieldChip interface, e.g.
Fp2Chip for G2 points). Random points use a seeded PRNG for reproducibility
(the reference draws from OS entropy; only witness values differ, the layout
is identical — SURVEY.md §7 "Hard parts").

The port of ``halo2_lib_tpu/ecc/ec.py``. The generator is explicit here:
every function that draws takes ``rng`` (``EccChip`` holds one and passes it
down). Without one they draw from ``DEFAULT_RNG``, one ``random.Random(0x5EC0)``
shared by the whole process as the JAX module shares its ``_RNG``: the same
circuits built in the same order in a fresh process get the same witness
values (and so the same proof bytes) in both packages.
"""

from __future__ import annotations

import random

from ..core.cells import AssignedValue, Existing
from ..core.context import Context
from ..utils.curves import ShortWeierstrass
from .fp import Reduced

DEFAULT_RNG = random.Random(0x5EC0)


def _rng(rng: random.Random | None) -> random.Random:
    return DEFAULT_RNG if rng is None else rng


class EcPoint:
    """Affine point; coordinates are FieldPoints of the field chip."""

    __slots__ = ("x", "y")

    def __init__(self, x, y):
        self.x = x
        self.y = y


class StrictEcPoint:
    """Point whose x is a Reduced field point (safe equality tests)."""

    __slots__ = ("x", "y")

    def __init__(self, x: Reduced, y):
        self.x = x
        self.y = y

    def to_ec_point(self) -> EcPoint:
        return EcPoint(self.x.inner, self.y)


def _as_point(pt) -> EcPoint:
    if isinstance(pt, StrictEcPoint):
        return pt.to_ec_point()
    return pt


def _check_points_are_unequal(chip, ctx, P, Q, do_check: bool):
    """(ecc/mod.rs:186-208)"""
    if do_check:
        xs = []
        for pt in (P, Q):
            if isinstance(pt, StrictEcPoint):
                xs.append(pt.x)
            else:
                xs.append(chip.enforce_less_than(ctx, pt.x))
        x_is_equal = chip.is_equal_unenforced(ctx, xs[0], xs[1])
        chip.gate.assert_is_const(ctx, x_is_equal, 0)
    return _as_point(P), _as_point(Q)


def ec_add_unequal(chip, ctx: Context, P, Q, is_strict: bool = False) -> EcPoint:
    """lambda = (y2-y1)/(x2-x1); assumes P.x != Q.x (ecc/mod.rs:153-179)."""
    P, Q = _check_points_are_unequal(chip, ctx, P, Q, is_strict)
    dx = chip.sub_no_carry(ctx, Q.x, P.x)
    dy = chip.sub_no_carry(ctx, Q.y, P.y)
    lam = chip.divide_unsafe(ctx, dy, dx)
    lam_sq = chip.mul_no_carry(ctx, lam, lam)
    lam_sq_minus_px = chip.sub_no_carry(ctx, lam_sq, P.x)
    x3_no_carry = chip.sub_no_carry(ctx, lam_sq_minus_px, Q.x)
    x3 = chip.carry_mod(ctx, x3_no_carry)
    dx13 = chip.sub_no_carry(ctx, P.x, x3)
    lam_dx13 = chip.mul_no_carry(ctx, lam, dx13)
    y3_no_carry = chip.sub_no_carry(ctx, lam_dx13, P.y)
    y3 = chip.carry_mod(ctx, y3_no_carry)
    return EcPoint(x3, y3)


def ec_sub_unequal(chip, ctx: Context, P, Q, is_strict: bool = False) -> EcPoint:
    """P - Q via lambda = -(y2+y1)/(x2-x1) (ecc/mod.rs:219-246)."""
    P, Q = _check_points_are_unequal(chip, ctx, P, Q, is_strict)
    dx = chip.sub_no_carry(ctx, Q.x, P.x)
    sy = chip.add_no_carry(ctx, Q.y, P.y)
    lam = chip.neg_divide_unsafe(ctx, sy, dx)
    lam_sq = chip.mul_no_carry(ctx, lam, lam)
    lam_sq_minus_px = chip.sub_no_carry(ctx, lam_sq, P.x)
    x3_no_carry = chip.sub_no_carry(ctx, lam_sq_minus_px, Q.x)
    x3 = chip.carry_mod(ctx, x3_no_carry)
    dx13 = chip.sub_no_carry(ctx, P.x, x3)
    lam_dx13 = chip.mul_no_carry(ctx, lam, dx13)
    y3_no_carry = chip.sub_no_carry(ctx, lam_dx13, P.y)
    y3 = chip.carry_mod(ctx, y3_no_carry)
    return EcPoint(x3, y3)


def ec_sub_strict(chip, ctx: Context, P, Q, rng: random.Random | None = None) -> EcPoint:
    """Constrains P != -Q, allows P == Q -> output (0,0) (ecc/mod.rs:253-285)."""
    P, Q = _as_point(P), _as_point(Q)
    gate = chip.gate
    x_is_eq = chip.is_equal(ctx, P.x, Q.x)
    y_is_eq = chip.is_equal(ctx, P.y, Q.y)
    is_identity = gate.and_(ctx, Existing(x_is_eq), Existing(y_is_eq))
    ctx.constrain_equal(x_is_eq, is_identity)

    rng = _rng(rng)
    rand_x = chip.load_private(ctx, rng.randrange(chip.p))
    rand_y = chip.load_private(ctx, rng.randrange(chip.p))
    P = ec_select(chip, ctx, EcPoint(rand_x, rand_y), P, is_identity)
    out = ec_sub_unequal(chip, ctx, P, Q, False)
    zero = chip.load_constant(ctx, 0)
    return ec_select(chip, ctx, EcPoint(zero, zero), out, is_identity)


def ec_double(chip, ctx: Context, P) -> EcPoint:
    """lambda = 3x^2/(2y) (ecc/mod.rs:302-327)."""
    P = _as_point(P)
    two_y = chip.scalar_mul_no_carry(ctx, P.y, 2)
    three_x = chip.scalar_mul_no_carry(ctx, P.x, 3)
    three_x_sq = chip.mul_no_carry(ctx, three_x, P.x)
    lam = chip.divide_unsafe(ctx, three_x_sq, two_y)
    lam_sq = chip.mul_no_carry(ctx, lam, lam)
    two_x = chip.scalar_mul_no_carry(ctx, P.x, 2)
    x3_no_carry = chip.sub_no_carry(ctx, lam_sq, two_x)
    x3 = chip.carry_mod(ctx, x3_no_carry)
    dx = chip.sub_no_carry(ctx, P.x, x3)
    lam_dx = chip.mul_no_carry(ctx, lam, dx)
    y3_no_carry = chip.sub_no_carry(ctx, lam_dx, P.y)
    y3 = chip.carry_mod(ctx, y3_no_carry)
    return EcPoint(x3, y3)


def ec_double_and_add_unequal(chip, ctx: Context, P, Q, is_strict: bool = False) -> EcPoint:
    """2P + Q skipping intermediate y (ecc/mod.rs:341-400)."""
    x_0 = None
    if is_strict:
        xs = []
        for pt in (P, Q):
            if isinstance(pt, StrictEcPoint):
                xs.append(pt.x)
            else:
                xs.append(chip.enforce_less_than(ctx, pt.x))
        x_is_equal = chip.is_equal_unenforced(ctx, xs[0], xs[1])
        chip.gate.assert_is_const(ctx, x_is_equal, 0)
        x_0 = xs[0]
    P, Q = _as_point(P), _as_point(Q)

    dx = chip.sub_no_carry(ctx, Q.x, P.x)
    dy = chip.sub_no_carry(ctx, Q.y, P.y)
    lam0 = chip.divide_unsafe(ctx, dy, dx)
    lam0_sq = chip.mul_no_carry(ctx, lam0, lam0)
    lam0_sq_minus_x0 = chip.sub_no_carry(ctx, lam0_sq, P.x)
    x2_no_carry = chip.sub_no_carry(ctx, lam0_sq_minus_x0, Q.x)
    x2 = chip.carry_mod(ctx, x2_no_carry)
    if is_strict:
        x2_red = chip.enforce_less_than(ctx, x2)
        x_is_equal = chip.is_equal_unenforced(ctx, x_0, x2_red)
        chip.gate.assert_is_const(ctx, x_is_equal, 0)
    two_y0 = chip.scalar_mul_no_carry(ctx, P.y, 2)
    x2_minus_x0 = chip.sub_no_carry(ctx, x2, P.x)
    lam1_minus_lam0 = chip.divide_unsafe(ctx, two_y0, x2_minus_x0)
    lam1_no_carry = chip.add_no_carry(ctx, lam0, lam1_minus_lam0)

    lam1_sq_nc = chip.mul_no_carry(ctx, lam1_no_carry, lam1_no_carry)
    lam1_sq_minus_x0 = chip.sub_no_carry(ctx, lam1_sq_nc, P.x)
    x_res_no_carry = chip.sub_no_carry(ctx, lam1_sq_minus_x0, x2)
    x_res = chip.carry_mod(ctx, x_res_no_carry)
    x_res_minus_x0 = chip.sub_no_carry(ctx, x_res, P.x)
    lam1_x_res_minus_x0 = chip.mul_no_carry(ctx, lam1_no_carry, x_res_minus_x0)
    y_res_no_carry = chip.sub_no_carry(ctx, lam1_x_res_minus_x0, P.y)
    y_res = chip.carry_mod(ctx, y_res_no_carry)
    return EcPoint(x_res, y_res)


def ec_select(chip, ctx: Context, P: EcPoint, Q: EcPoint, sel: AssignedValue) -> EcPoint:
    """sel ? P : Q (ecc/mod.rs:402-417)."""
    return EcPoint(chip.select(ctx, P.x, Q.x, sel), chip.select(ctx, P.y, Q.y, sel))


def ec_select_by_indicator(chip, ctx: Context, points, coeffs) -> EcPoint:
    points = [_as_point(p) for p in points]
    x = chip.select_by_indicator(ctx, [p.x for p in points], coeffs)
    y = chip.select_by_indicator(ctx, [p.y for p in points], coeffs)
    return EcPoint(x, y)


def ec_select_from_bits(chip, ctx: Context, points, sel) -> EcPoint:
    w = len(sel)
    assert 1 << w == len(points)
    coeffs = chip.gate.bits_to_indicator(ctx, sel)
    return ec_select_by_indicator(chip, ctx, points, coeffs)


def strict_ec_select_from_bits(chip, ctx: Context, points: list[StrictEcPoint], sel) -> StrictEcPoint:
    w = len(sel)
    assert 1 << w == len(points)
    coeffs = chip.gate.bits_to_indicator(ctx, sel)
    x = chip.select_by_indicator(ctx, [p.x.inner for p in points], coeffs)
    y = chip.select_by_indicator(ctx, [p.y for p in points], coeffs)
    return StrictEcPoint(Reduced(x), y)


def check_is_on_curve(chip, ctx: Context, P: EcPoint, b: int) -> None:
    """y^2 = x^3 + b (ecc/mod.rs:589-602)."""
    lhs = chip.mul_no_carry(ctx, P.y, P.y)
    rhs = chip.mul(ctx, P.x, P.x)
    rhs = chip.mul_no_carry(ctx, rhs, P.x)
    rhs = chip.add_constant_no_carry(ctx, rhs, b)
    diff = chip.sub_no_carry(ctx, lhs, rhs)
    chip.check_carry_mod_to_zero(ctx, diff)


def load_random_point(
    chip, ctx: Context, curve: ShortWeierstrass, rng: random.Random | None = None
) -> EcPoint:
    """Load a generic curve point as witness + on-curve check (ecc/mod.rs:604-620)."""
    x, y = curve.random_point(_rng(rng))
    pt = EcPoint(chip.load_private(ctx, x), chip.load_private(ctx, y))
    check_is_on_curve(chip, ctx, pt, curve.b)
    return pt


def into_strict_point(chip, ctx: Context, pt: EcPoint) -> StrictEcPoint:
    return StrictEcPoint(chip.enforce_less_than(ctx, pt.x), pt.y)


def multi_scalar_multiply(
    chip,
    ctx: Context,
    points: list[EcPoint],
    scalars: list[list[AssignedValue]],
    max_bits: int,
    window_bits: int,
    curve: ShortWeierstrass,
    rng: random.Random | None = None,
) -> EcPoint:
    """Simultaneous 2^w-ary MSM with random accumulator (ecc/mod.rs:651-762)."""
    k = len(points)
    assert k == len(scalars) and k > 0
    gate = chip.gate
    F = gate.F
    scalar_len = len(scalars[0])
    total_bits = max_bits * scalar_len
    num_windows = -(-total_bits // window_bits)
    rounded_bitlen = num_windows * window_bits

    zero_cell = ctx.load_zero()
    rounded_bits: list[AssignedValue] = []
    for scalar in scalars:
        assert len(scalar) == scalar_len
        for chunk in scalar:
            rounded_bits.extend(gate.num_to_bits(ctx, chunk, max_bits))
        rounded_bits.extend([zero_cell] * (rounded_bitlen - total_bits))

    base = load_random_point(chip, ctx, curve, rng)
    rand_start_vec = [base]
    for _ in range(1, k + window_bits):
        rand_start_vec.append(ec_double(chip, ctx, rand_start_vec[-1]))

    cache_size = 1 << window_bits
    cached_points: list[StrictEcPoint] = []
    for idx, point in enumerate(points):
        is_infinity = chip.is_zero(ctx, point.y)
        neg_mult_rand_start = ec_sub_unequal(
            chip, ctx, rand_start_vec[idx], rand_start_vec[idx + window_bits], True
        )
        point_strict = into_strict_point(chip, ctx, point)
        prev = into_strict_point(chip, ctx, neg_mult_rand_start)
        cached_points.append(prev)
        for _ in range(cache_size - 1):
            prev = cached_points[-1]
            new_point = ec_add_unequal(chip, ctx, prev, point_strict, True)
            new_point = ec_select(chip, ctx, prev.to_ec_point(), new_point, is_infinity)
            cached_points.append(into_strict_point(chip, ctx, new_point))

    start_point = ec_sub_unequal(chip, ctx, rand_start_vec[k], rand_start_vec[0], True)
    curr_point = start_point

    for idx in range(num_windows):
        for _ in range(window_bits):
            curr_point = ec_double(chip, ctx, curr_point)
        for i in range(k):
            cache = cached_points[i * cache_size : (i + 1) * cache_size]
            bits = rounded_bits[
                i * rounded_bitlen
                + rounded_bitlen
                - window_bits * (idx + 1) : i * rounded_bitlen
                + rounded_bitlen
                - window_bits * idx
            ]
            add_point = ec_select_from_bits(chip, ctx, cache, bits)
            curr_point = ec_add_unequal(chip, ctx, curr_point, add_point, True)
    return ec_sub_strict(chip, ctx, curr_point, start_point, rng)


def scalar_multiply(chip, ctx, P: EcPoint, scalar, max_bits, window_bits, curve, rng=None) -> EcPoint:
    """(ecc/mod.rs:488-503)"""
    assert scalar and window_bits != 0
    assert max_bits <= chip.F.num_bits
    return multi_scalar_multiply(chip, ctx, [P], [scalar], max_bits, window_bits, curve, rng)


class EccChip:
    """Chip wrapper (ecc/mod.rs:815-1204). `curve` is the host curve descriptor;
    `rng` the generator of its random points (DEFAULT_RNG when None)."""

    def __init__(self, field_chip, curve: ShortWeierstrass, rng: random.Random | None = None):
        self.field_chip = field_chip
        self.curve = curve
        self.rng = _rng(rng)

    @property
    def gate(self):
        return self.field_chip.gate

    def load_private(self, ctx: Context, xy: tuple[int, int]) -> EcPoint:
        pt = self.load_private_unchecked(ctx, xy)
        self.assert_is_on_curve(ctx, pt)
        return pt

    def load_private_unchecked(self, ctx: Context, xy: tuple[int, int]) -> EcPoint:
        return EcPoint(
            self.field_chip.load_private(ctx, xy[0]), self.field_chip.load_private(ctx, xy[1])
        )

    def assign_point(self, ctx: Context, g) -> EcPoint:
        """Witness point constrained to be on curve or (0,0) (ecc/mod.rs:857-868)."""
        xy = (0, 0) if g is None else g
        pt = self.load_private_unchecked(ctx, xy)
        ok = self.is_on_curve_or_infinity(ctx, pt)
        self.field_chip.gate.assert_is_const(ctx, ok, 1)
        return pt

    def assign_constant_point(self, ctx: Context, g) -> EcPoint:
        xy = (0, 0) if g is None else g
        return EcPoint(
            self.field_chip.load_constant(ctx, xy[0]), self.field_chip.load_constant(ctx, xy[1])
        )

    def load_random_point(self, ctx: Context) -> EcPoint:
        return load_random_point(self.field_chip, ctx, self.curve, self.rng)

    def assert_is_on_curve(self, ctx: Context, P: EcPoint) -> None:
        check_is_on_curve(self.field_chip, ctx, P, self.curve.b)

    def is_on_curve_or_infinity(self, ctx: Context, P: EcPoint) -> AssignedValue:
        """(ecc/mod.rs:906-928)"""
        chip = self.field_chip
        lhs = chip.mul_no_carry(ctx, P.y, P.y)
        rhs = chip.mul(ctx, P.x, P.x)
        rhs = chip.mul_no_carry(ctx, rhs, P.x)
        rhs = chip.add_constant_no_carry(ctx, rhs, self.curve.b)
        diff = chip.sub_no_carry(ctx, lhs, rhs)
        diff = chip.carry_mod(ctx, diff)
        is_on_curve = chip.is_zero(ctx, diff)
        x_is_zero = chip.is_zero(ctx, P.x)
        y_is_zero = chip.is_zero(ctx, P.y)
        return chip.gate.or_and(
            ctx, Existing(is_on_curve), Existing(x_is_zero), Existing(y_is_zero)
        )

    def negate(self, ctx: Context, P: EcPoint) -> EcPoint:
        return EcPoint(P.x, self.field_chip.negate(ctx, P.y))

    def add_unequal(self, ctx, P, Q, is_strict: bool = False) -> EcPoint:
        return ec_add_unequal(self.field_chip, ctx, P, Q, is_strict)

    def sub_unequal(self, ctx, P, Q, is_strict: bool = False) -> EcPoint:
        return ec_sub_unequal(self.field_chip, ctx, P, Q, is_strict)

    def double(self, ctx, P) -> EcPoint:
        return ec_double(self.field_chip, ctx, P)

    def is_equal(self, ctx, P: EcPoint, Q: EcPoint) -> AssignedValue:
        x_is_equal = self.field_chip.is_equal(ctx, P.x, Q.x)
        y_is_equal = self.field_chip.is_equal(ctx, P.y, Q.y)
        return self.field_chip.gate.and_(ctx, Existing(x_is_equal), Existing(y_is_equal))

    def assert_equal(self, ctx, P: EcPoint, Q: EcPoint) -> None:
        self.field_chip.assert_equal(ctx, P.x, Q.x)
        self.field_chip.assert_equal(ctx, P.y, Q.y)

    def select(self, ctx, P: EcPoint, Q: EcPoint, cond: AssignedValue) -> EcPoint:
        return ec_select(self.field_chip, ctx, P, Q, cond)

    def sum(self, ctx, points) -> EcPoint:
        """Identity-tolerant sum with random accumulator (ecc/mod.rs:1001-1020)."""
        chip = self.field_chip
        rand_point = self.load_random_point(ctx)
        rand_point = into_strict_point(chip, ctx, rand_point)
        acc = rand_point
        for point in points:
            is_infinity = chip.is_zero(ctx, point.y)
            s = self.add_unequal(ctx, acc, point, True)
            s = ec_select(chip, ctx, acc.to_ec_point(), s, is_infinity)
            acc = into_strict_point(chip, ctx, s)
        return ec_sub_strict(chip, ctx, acc.to_ec_point(), rand_point.to_ec_point(), self.rng)

    def scalar_mult(self, ctx, P: EcPoint, scalar, max_bits, window_bits=4) -> EcPoint:
        return scalar_multiply(
            self.field_chip, ctx, P, scalar, max_bits, window_bits, self.curve, self.rng
        )

    def variable_base_msm(self, builder, P, scalars, max_bits, window_bits=4) -> EcPoint:
        """<=25 points: serial MSM; more: Pippenger (ecc/mod.rs:1054-1112)."""
        if len(P) <= 25:
            return multi_scalar_multiply(
                self.field_chip, builder.main(), P, scalars, max_bits, window_bits, self.curve,
                self.rng,
            )
        from .pippenger import multi_exp_par

        return multi_exp_par(
            self.field_chip, builder, P, scalars, max_bits, window_bits, self.curve, self.rng
        )

    def fixed_base_scalar_mult(self, ctx, point, scalar, max_bits, window_bits=4) -> EcPoint:
        from .fixed_base import scalar_multiply as fb_scalar_multiply

        return fb_scalar_multiply(
            self.field_chip, ctx, point, scalar, max_bits, window_bits, self.curve, self.rng
        )

    def fixed_base_msm(self, builder, points, scalars, max_scalar_bits_per_cell, clump_factor=4) -> EcPoint:
        from .fixed_base import msm_par

        return msm_par(
            self, builder, points, scalars, max_scalar_bits_per_cell, clump_factor
        )
