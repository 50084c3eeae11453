"""Parallel variable-base MSM (witness-generation Pippenger-style clumping).

Re-implements halo2-ecc/src/ecc/pippenger.rs:219-339 (`multi_exp_par`):
scalars are decomposed to bits single-threaded; per-clump bucket tables
{any_point + subset sums} are built via `parallelize_core`; per-bit selects and
cross-round accumulation run per-Context; final double-and-add over bit
positions and removal of the any-point offset are serial.

The port of ``halo2_lib_tpu/ecc/pippenger.py``; random points come from the
explicit `rng` (see ecc/ec.py).
"""

from __future__ import annotations

from ..core.cells import Existing
from ..core.context import Context
from ..gates.threads import SinglePhaseCoreManager, parallelize_core
from ..utils.curves import ShortWeierstrass
from .ec import (
    EcPoint,
    ec_add_unequal,
    ec_double,
    ec_select,
    ec_sub_strict,
    ec_sub_unequal,
    into_strict_point,
    load_random_point,
    strict_ec_select_from_bits,
)


def multi_exp_par(
    chip,
    builder: SinglePhaseCoreManager,
    points: list[EcPoint],
    scalars,
    max_scalar_bits_per_cell: int,
    clump_factor: int,
    curve: ShortWeierstrass,
    rng=None,
) -> EcPoint:
    assert len(points) == len(scalars)
    gate = chip.gate
    scalar_bits = max_scalar_bits_per_cell * len(scalars[0])
    # bool_scalars: scalar_bits x len(points)
    bool_scalars: list[list] = [[] for _ in range(scalar_bits)]

    ctx = builder.main()
    for scalar in scalars:
        for ci, chunk in enumerate(scalar):
            bits = gate.num_to_bits(ctx, chunk, max_scalar_bits_per_cell)
            for bi, bit in enumerate(bits):
                bool_scalars[ci * max_scalar_bits_per_cell + bi].append(bit)

    c = clump_factor
    num_rounds = -(-len(points) // c)
    any_base = load_random_point(chip, ctx, curve, rng)
    any_points = [any_base]
    for _ in range(1, num_rounds):
        any_points.append(ec_double(chip, ctx, any_points[-1]))

    clumps = [
        (round_idx, points[round_idx * c : (round_idx + 1) * c], any_points[round_idx])
        for round_idx in range(num_rounds)
    ]

    def clump_work(ctx: Context, item):
        round_idx, points_clump, any_point = item
        bucket = [into_strict_point(chip, ctx, any_point)]
        for i, point in enumerate(points_clump):
            is_infinity = chip.is_zero(ctx, point.y)
            point_strict = into_strict_point(chip, ctx, point)
            for j in range(1 << i):
                new_point = ec_add_unequal(chip, ctx, bucket[j], point_strict, True)
                new_point = ec_select(chip, ctx, bucket[j].to_ec_point(), new_point, is_infinity)
                bucket.append(into_strict_point(chip, ctx, new_point))
        return [
            strict_ec_select_from_bits(
                chip, ctx, bucket, bits[round_idx * c : round_idx * c + len(points_clump)]
            )
            for bits in bool_scalars
        ]

    multi_prods = parallelize_core(builder, clumps, clump_work)

    def agg_work(ctx: Context, i: int):
        acc = multi_prods[0][i]
        for multi_prod in multi_prods[1:]:
            acc_pt = ec_add_unequal(chip, ctx, acc, multi_prod[i], True)
            acc = into_strict_point(chip, ctx, acc_pt)
        return acc

    agg = parallelize_core(builder, list(range(scalar_bits)), agg_work)

    ctx = builder.main()
    any_point = ec_double(chip, ctx, any_points[-1])
    any_point = ec_sub_unequal(chip, ctx, any_point, any_points[0], True)

    summ = agg[-1].to_ec_point()
    any_sum = any_point
    for g in reversed(agg[:-1]):
        any_sum = ec_double(chip, ctx, any_sum)
        summ = ec_double(chip, ctx, summ)
        summ = ec_add_unequal(chip, ctx, summ, g, True)

    any_sum = ec_double(chip, ctx, any_sum)
    any_sum = ec_sub_unequal(chip, ctx, any_sum, any_point, True)
    return ec_sub_strict(chip, ctx, summ, any_sum, rng)
