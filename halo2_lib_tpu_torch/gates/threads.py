"""Thread managers: virtual columns → physical column tensors.

Mirrors halo2-base/src/gates/flex_gate/threads/: `SinglePhaseCoreManager`
(owns the virtual Contexts of one challenge phase and flattens them into
physical columns with break points), `MultiPhaseCoreManager`, and
`parallelize_core`.

The TPU twist: `flatten` produces dense per-column value/selector arrays — a
tensor-ready layout the device MockProver and prover consume directly. Witness
generation itself stays exact host big-int; the flatten step batch-inverts all
deferred `Rational` fractions at once (halo2's `Assigned` batch inversion).
"""

from __future__ import annotations

from bisect import bisect_left as _bisect_left
from dataclasses import dataclass, field as dc_field

from ..core.cells import Rational
from ..core.context import Context
from ..core.copy_constraints import CopyConstraintManager

GATE_ROTATIONS = 4  # the vertical gate reads rotations 0..=3

_PHASE_TYPE_IDS = (
    "halo2-base:SinglePhaseCoreManager:FirstPhase",
    "halo2-base:SinglePhaseCoreManager:SecondPhase",
    "halo2-base:SinglePhaseCoreManager:ThirdPhase",
)


def batch_evaluate(values: list, field) -> list[int]:
    """Resolve Assigned entries (ints or Rationals) with one batch inversion.

    Montgomery's trick: invert the product of all denominators once, then
    unroll — same optimization halo2 applies to `Assigned` columns.
    """
    p = field.p
    fracs = [(i, v) for i, v in enumerate(values) if type(v) is Rational]
    out = [v if type(v) is int else 0 for v in values]
    if not fracs:
        return out
    dens = [v.den % p for _, v in fracs]
    # prefix products
    prefix = [1] * (len(dens) + 1)
    for i, d in enumerate(dens):
        prefix[i + 1] = prefix[i] * d % p
    inv_all = field.inv(prefix[-1])
    for i in range(len(dens) - 1, -1, -1):
        inv_i = prefix[i] * inv_all % p
        inv_all = inv_all * dens[i] % p
        idx, frac = fracs[i]
        out[idx] = frac.num % p * inv_i % p
    return out


class PositionMap:
    """Arithmetic virtual-cell -> physical-(phase, column, row) map.

    Replaces the per-cell dict the flatten step used to build: a phase's cell
    position is fully determined by its context's start offset in the value
    stream plus a bisect over the (tiny) break-point list. Non-phase cells
    (e.g. external raw cells) fall back to an explicit dict.
    """

    __slots__ = ("phases", "extra")

    def __init__(self, extra: dict | None = None):
        self.phases: dict[str, tuple[int, dict[int, int], list[int]]] = {}
        self.extra: dict = extra or {}

    def add_phase(
        self, type_id: str, phase: int, starts: dict[int, int], bps_stream: list[int]
    ) -> None:
        self.phases[type_id] = (phase, starts, bps_stream)

    def __getitem__(self, cell):
        ph = self.phases.get(cell.type_id)
        if ph is None:
            return self.extra[cell]
        phase, starts, bps = ph
        s = starts[cell.context_id] + cell.offset
        c = _bisect_left(bps, s)
        return (phase, c, s - (bps[c - 1] if c else 0))

    def translate_pairs(self, pairs, tag_left, tag_right, out):
        """Append ((tag_left, *pos(l)), (tag_right, *pos(r))) for each (l, r).

        The batch version of two __getitem__ calls per pair — one tight loop
        with the phase tables cached in locals (synthesize's hot loop: ~431k
        copy pairs for the k=15 ECDSA circuit)."""
        phases = self.phases
        extra = self.extra
        append = out.append
        for left, right in pairs:
            ph = phases.get(left[0])
            if ph is None:
                lp, lc, lr = extra[left]
            else:
                lp, starts, bps = ph
                s = starts[left[1]] + left[2]
                c = _bisect_left(bps, s)
                lc, lr = c, s - (bps[c - 1] if c else 0)
            ph = phases.get(right[0])
            if ph is None:
                rp, rc, rr = extra[right]
            else:
                rp, starts, bps = ph
                s = starts[right[1]] + right[2]
                c = _bisect_left(bps, s)
                rc, rr = c, s - (bps[c - 1] if c else 0)
            append(((tag_left, lp, lc, lr), (tag_right, rp, rc, rr)))

    def get(self, cell, default=None):
        try:
            return self[cell]
        except KeyError:
            return default

    def __setitem__(self, cell, pos):
        self.extra[cell] = pos

    def __contains__(self, cell):
        return cell.type_id in self.phases or cell in self.extra

    def clear(self) -> None:
        self.phases.clear()
        self.extra.clear()


@dataclass
class FlattenedPhase:
    """Physical assignment of one phase: dense columns + selectors + break points."""

    columns: list[list[int]] = dc_field(default_factory=list)  # values per column
    selectors: list[list[bool]] = dc_field(default_factory=list)
    break_points: list[int] = dc_field(default_factory=list)
    # equality constraints between physical cells introduced by column breaks
    physical_equalities: list[tuple[tuple[int, int], tuple[int, int]]] = dc_field(
        default_factory=list
    )


class SinglePhaseCoreManager:
    """Manager for the virtual Contexts of one challenge phase (single_phase.rs)."""

    def __init__(self, witness_gen_only: bool, copy_manager: CopyConstraintManager, field, phase: int = 0):
        self.threads: list[Context] = []
        self.copy_manager = copy_manager
        self.witness_gen_only = witness_gen_only
        self.use_unknown = False
        self.phase = phase
        self.field = field
        self.break_points: list[int] | None = None

    def type_of(self) -> str:
        return _PHASE_TYPE_IDS[self.phase]

    def main(self) -> Context:
        if not self.threads:
            return self.new_thread()
        return self.threads[-1]

    def thread_count(self) -> int:
        return len(self.threads)

    def new_context(self, context_id: int) -> Context:
        return Context(
            self.witness_gen_only, self.phase, self.type_of(), context_id, self.copy_manager, self.field
        )

    def new_thread(self) -> Context:
        ctx = self.new_context(self.thread_count())
        self.threads.append(ctx)
        return ctx

    def total_advice(self) -> int:
        return sum(len(ctx.advice) for ctx in self.threads)

    def clear(self) -> None:
        self.threads = []
        self.copy_manager.clear()

    # --- flattening ---------------------------------------------------------
    def flatten_with_constraints(self, num_columns: int, max_rows: int) -> FlattenedPhase:
        """Stream all Contexts into physical columns, computing break points.

        Port of `assign_with_constraints::<F, 4>` (single_phase.rs:193-263):
        cells go top-to-bottom then left-to-right; when a live gate would cross
        `max_rows` (or we hit the second-to-last usable row) we break to the
        next column and duplicate the boundary cell with an equality constraint.

        Vectorized: instead of a per-cell Python loop + a 10^6-entry dict of
        cell positions, the contexts are concatenated into one value/selector
        stream, the O(num_columns) break positions are found by probing the
        3 candidate rows at each column end, columns become stream SLICES, and
        cell->physical lookups are served arithmetically by a PositionMap
        (position = context start + offset, column by bisect on break points).
        """
        out = FlattenedPhase()
        stream_vals: list[int] = []
        stream_sel: list[bool] = []
        starts: dict[int, int] = {}
        ctx_bounds: list[int] = []
        type_id = self.type_of()
        for ctx in self.threads:
            if not ctx.advice:
                continue
            assert len(ctx.selector) == len(ctx.advice)
            assert ctx.type_id == type_id
            starts[ctx.context_id] = len(stream_vals)
            ctx_bounds.append(len(stream_vals))
            stream_vals.extend(batch_evaluate(ctx.advice, self.field))
            stream_sel.extend(ctx.selector)
        total = len(stream_vals)

        # break stream positions: first in-column row r with
        # (sel[r] and r + 4 > max_rows) or r >= max_rows - 1
        import bisect

        bps_stream: list[int] = []
        col_start = 0
        while True:
            cand = None
            for r in range(max_rows - GATE_ROTATIONS + 1, max_rows - 1):
                s = col_start + r
                if s < total and stream_sel[s]:
                    cand = s
                    break
            if cand is None:
                s = col_start + max_rows - 1
                if s < total:
                    cand = s
            if cand is None:
                break
            # sanity: no overlapping gate within the last ROTATIONS-1 rows
            # (same guard as the reference: only checked when the break cell
            # is at in-context index >= ROTATIONS - 2)
            ci = bisect.bisect_right(ctx_bounds, cand) - 1
            i = cand - ctx_bounds[ci]
            if i + 2 >= GATE_ROTATIONS:
                for delta in range(1, GATE_ROTATIONS - 1):
                    assert not stream_sel[cand - delta] or cand - delta < ctx_bounds[ci], (
                        f"unsupported gate overlap at column break (delta={delta})"
                    )
            bps_stream.append(cand)
            out.break_points.append(cand - col_start)
            col_start = cand

        ncols_used = len(bps_stream) + (1 if total else 0)
        if ncols_used > num_columns:
            raise ValueError(
                f"NOT ENOUGH ADVICE COLUMNS ({num_columns}); max usable rows {max_rows}"
            )
        # columns are stream slices, boundary cells duplicated
        prev = 0
        for j, bp in enumerate(bps_stream):
            col_vals = stream_vals[prev : bp + 1]
            col_sel = stream_sel[prev : bp + 1]
            col_sel[-1] = False  # selector moves to row 0 of the NEXT column
            out.columns.append(col_vals)
            out.selectors.append(col_sel)
            out.physical_equalities.append(((j, bp - prev), (j + 1, 0)))
            prev = bp
        if total:
            out.columns.append(stream_vals[prev:])
            out.selectors.append(stream_sel[prev:])
        else:
            out.columns.append([])
            out.selectors.append([])

        # install the arithmetic position map for this phase
        pm = self.copy_manager.assigned_advices
        if not isinstance(pm, PositionMap):
            pm = PositionMap(dict(pm) if pm else {})
            self.copy_manager.assigned_advices = pm
        pm.add_phase(type_id, self.phase, starts, bps_stream)

        if self.break_points is not None:
            assert self.break_points == out.break_points, "break points don't match"
        else:
            self.break_points = out.break_points
        return out

    def flatten_witnesses(self, num_columns: int, break_points: list[int]) -> FlattenedPhase:
        """Prover path: replay a pinned break-point schedule (single_phase.rs:273-312)."""
        out = FlattenedPhase(break_points=list(break_points))
        if num_columns == 0:
            assert self.total_advice() == 0, "phase has advice but no columns"
            return out
        bps = iter(break_points)
        bp = next(bps, None)
        col_vals: list[int] = []
        out.columns.append(col_vals)
        row_offset = 0
        for ctx in self.threads:
            values = batch_evaluate(ctx.advice, self.field)
            for value in values:
                col_vals.append(value)
                if bp == row_offset:
                    bp = next(bps, None)
                    row_offset = 0
                    col_vals = []
                    out.columns.append(col_vals)
                    col_vals.append(value)
                row_offset += 1
        return out


class MultiPhaseCoreManager:
    """One SinglePhaseCoreManager per challenge phase (multi_phase.rs)."""

    def __init__(self, witness_gen_only: bool, field):
        self.copy_manager = CopyConstraintManager()
        self.field = field
        self.witness_gen_only = witness_gen_only
        self.use_unknown = False
        self.phase_manager = [SinglePhaseCoreManager(witness_gen_only, self.copy_manager, field, 0)]

    def main(self, phase: int) -> Context:
        self.touch(phase)
        return self.phase_manager[phase].main()

    def new_thread(self, phase: int) -> Context:
        self.touch(phase)
        return self.phase_manager[phase].new_thread()

    def in_phase(self, phase: int) -> SinglePhaseCoreManager:
        return self.phase_manager[phase]

    def touch(self, phase: int) -> None:
        while len(self.phase_manager) <= phase:
            pm = SinglePhaseCoreManager(
                self.witness_gen_only, self.copy_manager, self.field, len(self.phase_manager)
            )
            self.phase_manager.append(pm)

    def clear(self) -> None:
        for pm in self.phase_manager:
            pm.clear()
        self.copy_manager.clear()

    def statistics(self):
        total_advice_per_phase = [pm.total_advice() for pm in self.phase_manager]
        total_fixed = self.copy_manager.num_distinct_constants()
        return total_advice_per_phase, total_fixed

    def calculate_params(self, k: int, minimum_rows: int | None = None):
        """ceil(total cells / usable rows) columns per phase (multi_phase.rs:443-465)."""
        max_rows = (1 << k) - (minimum_rows or 0)
        total_advice_per_phase, total_fixed = self.statistics()
        num_advice_per_phase = [-(-c // max_rows) for c in total_advice_per_phase]
        num_fixed = (total_fixed + (1 << k) - 1) >> k
        return {"k": k, "num_advice_per_phase": num_advice_per_phase, "num_fixed": num_fixed}


def parallelize_core(builder: SinglePhaseCoreManager, inputs: list, f) -> list:
    """Run `f(ctx, input)` on a fresh Context per input, appended in fixed order.

    Port of threads/parallelize.rs:8-29. The reference uses rayon; here inputs
    are processed in deterministic order (the circuit layout is identical either
    way — that's the whole point of the pre-allocated context ids). Heavy data
    parallelism in this library lives on the TPU device side instead.
    """
    thread_count = builder.thread_count()
    ctxs = [builder.new_context(thread_count + i) for i in range(len(inputs))]
    outputs = [f(ctx, inp) for ctx, inp in zip(ctxs, inputs)]
    builder.threads.extend(ctxs)
    return outputs
