"""Fixed-base scalar multiplication / MSM with out-of-circuit table precompute.

Re-implements halo2-ecc/src/ecc/fixed_base.rs: window tables of the constant
base point are computed out-of-circuit (host exact arithmetic stands in for the
reference's Jacobian + batch_normalize precompute, fixed_base.rs:47-70) and
loaded as constants; `msm_par` fans per-point scalar muls out over fresh
Contexts via `parallelize_core` (fixed_base.rs:139-218).

The port of ``halo2_lib_tpu/ecc/fixed_base.py``; random points come from the
explicit `rng` (see ecc/ec.py).
"""

from __future__ import annotations

from ..core.cells import Existing
from ..core.context import Context
from ..gates.threads import SinglePhaseCoreManager, parallelize_core
from ..utils.curves import Point, ShortWeierstrass
from .ec import (
    EcPoint,
    ec_add_unequal,
    ec_select,
    ec_select_from_bits,
    ec_sub_strict,
    load_random_point,
)


def _window_table(curve: ShortWeierstrass, point: Point, num_windows: int, window_bits: int, total_bits: int) -> list[Point]:
    """cached[i * 2^w + j] = [j * 2^(i*w)] * point, EXCEPT index j=0 stores the
    increment as a dummy to avoid divide-by-0 (fixed_base.rs:47-66)."""
    cached: list[Point] = []
    increment = point
    for i in range(num_windows):
        curr = increment
        size = 1 << min(window_bits, total_bits - i * window_bits)
        cache_vec = [increment]
        for _ in range(1, size):
            prev = curr
            curr = curve.add(curr, increment)
            cache_vec.append(prev)
        increment = curr
        cached.extend(cache_vec)
    return cached


def scalar_multiply(chip, ctx: Context, point: Point, scalar, max_bits: int, window_bits: int, curve: ShortWeierstrass, rng=None) -> EcPoint:
    """[scalar] * constant point (fixed_base.rs:23-105)."""
    if point is None:
        zero = chip.load_constant(ctx, 0)
        return EcPoint(zero, zero)
    assert scalar
    assert max_bits <= chip.F.num_bits
    gate = chip.gate

    total_bits = max_bits * len(scalar)
    num_windows = -(-total_bits // window_bits)

    cached_affine = _window_table(curve, point, num_windows, window_bits, total_bits)
    cached_points = [
        EcPoint(chip.load_constant(ctx, pt[0]), chip.load_constant(ctx, pt[1]))
        for pt in cached_affine
    ]

    bits = []
    for chunk in scalar:
        bits.extend(gate.num_to_bits(ctx, chunk, max_bits))

    cache_windows = [
        cached_points[i : i + (1 << window_bits)]
        for i in range(0, len(cached_points), 1 << window_bits)
    ]
    bit_windows = [bits[i : i + window_bits] for i in range(0, len(bits), window_bits)]

    any_point = load_random_point(chip, ctx, curve, rng)
    curr_point = any_point
    for cached_window, bit_window in zip(reversed(cache_windows), reversed(bit_windows)):
        bit_sum = gate.sum(ctx, [Existing(b) for b in bit_window])
        is_zero_window = gate.is_zero(ctx, bit_sum)
        add_point = ec_select_from_bits(chip, ctx, cached_window, bit_window)
        s = ec_add_unequal(chip, ctx, curr_point, add_point, True)
        curr_point = ec_select(chip, ctx, curr_point, s, is_zero_window)
    return ec_sub_strict(chip, ctx, curr_point, any_point, rng)


def msm_par(
    ecc_chip,
    builder: SinglePhaseCoreManager,
    points: list[Point],
    scalars,
    max_scalar_bits_per_cell: int,
    window_bits: int,
) -> EcPoint:
    """Batched fixed-base MSM (fixed_base.rs:139-218)."""
    chip = ecc_chip.field_chip
    curve = ecc_chip.curve
    rng = ecc_chip.rng
    gate = chip.gate
    ctx = builder.main()
    if not points:
        return ecc_chip.assign_constant_point(ctx, None)
    assert max_scalar_bits_per_cell <= chip.F.num_bits
    assert len(points) == len(scalars)
    scalar_len = len(scalars[0])
    total_bits = max_scalar_bits_per_cell * scalar_len
    num_windows = -(-total_bits // window_bits)

    cached_affine: list[Point] = []
    for point in points:
        cached_affine.extend(_window_table(curve, point, num_windows, window_bits, total_bits))

    any_point = load_random_point(chip, ctx, curve, rng)

    per_point = len(cached_affine) // len(points)
    chunks = [
        (cached_affine[i * per_point : (i + 1) * per_point], scalars[i])
        for i in range(len(points))
    ]

    def work(ctx: Context, item):
        cached, scalar = item
        cached_points = [ecc_chip.assign_constant_point(ctx, pt) for pt in cached]
        cache_windows = [
            cached_points[i : i + (1 << window_bits)]
            for i in range(0, len(cached_points), 1 << window_bits)
        ]
        assert len(scalar) == scalar_len
        bits = []
        for chunk in scalar:
            bits.extend(gate.num_to_bits(ctx, chunk, max_scalar_bits_per_cell))
        bit_windows = [bits[i : i + window_bits] for i in range(0, len(bits), window_bits)]
        curr_point = any_point
        for cached_window, bit_window in zip(reversed(cache_windows), reversed(bit_windows)):
            bit_sum = gate.sum(ctx, [Existing(b) for b in bit_window])
            is_zero_window = gate.is_zero(ctx, bit_sum)
            add_point = ec_select_from_bits(chip, ctx, cached_window, bit_window)
            s = ec_add_unequal(chip, ctx, curr_point, add_point, True)
            curr_point = ec_select(chip, ctx, curr_point, s, is_zero_window)
        return curr_point

    scalar_mults = parallelize_core(builder, chunks, work)

    ctx = builder.main()
    any_point2 = load_random_point(chip, ctx, curve, rng)
    acc = any_point2
    for point in scalar_mults:
        new_acc = ec_add_unequal(chip, ctx, acc, point, True)
        acc = ecc_chip.sub_unequal(ctx, new_acc, any_point, True)
    return ec_sub_strict(chip, ctx, acc, any_point2, rng)
