"""BaseCircuitBuilder: the user-facing circuit driver.

Mirrors halo2-base/src/gates/circuit/{mod,builder}.rs. `synthesize` flattens
all virtual regions into a `PhysicalCircuit` — the dense tensor form consumed
by the MockProver and the KZG proving backend.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from enum import Enum

from ..core.cells import AssignedValue
from ..core.context import Context
from ..core.copy_constraints import CopyConstraintManager
from ..core.lookups import LookupAnyManager
from ..utils.fields import FR_BN254, PrimeField
from .flex_gate import MAX_PHASE
from .range import RangeChip
from .threads import FlattenedPhase, MultiPhaseCoreManager, SinglePhaseCoreManager

# Rows reserved at the bottom of every column for ZK blinding (the reference
# gets this from ConstraintSystem::minimum_rows(); its tests pass Some(9)).
DEFAULT_MINIMUM_ROWS = 9


class CircuitBuilderStage(Enum):
    KEYGEN = "keygen"
    PROVER = "prover"
    MOCK = "mock"

    def witness_gen_only(self) -> bool:
        return self is CircuitBuilderStage.PROVER


@dataclass
class BaseCircuitParams:
    """Serializable circuit shape (circuit/mod.rs:22-49)."""

    k: int = 0
    num_advice_per_phase: list[int] = dc_field(default_factory=list)
    num_fixed: int = 0
    num_lookup_advice_per_phase: list[int] = dc_field(default_factory=list)
    lookup_bits: int | None = None
    num_instance_columns: int = 0

    def to_json(self) -> dict:
        return {
            "k": self.k,
            "num_advice_per_phase": self.num_advice_per_phase,
            "num_fixed": self.num_fixed,
            "num_lookup_advice_per_phase": self.num_lookup_advice_per_phase,
            "lookup_bits": self.lookup_bits,
            "num_instance_columns": self.num_instance_columns,
        }

    @staticmethod
    def from_json(d: dict) -> "BaseCircuitParams":
        return BaseCircuitParams(**d)


@dataclass
class PhysicalCircuit:
    """Dense physical table: the output of synthesize, input to mock/prove.

    Columns are per-phase gate advice columns, then per-phase lookup advice
    columns, then fixed columns. Copy constraints are resolved to physical
    (column-class, col, row) triples.
    """

    params: BaseCircuitParams
    field: PrimeField
    usable_rows: int
    # per phase: FlattenedPhase
    phases: list[FlattenedPhase]
    # per phase: lookup advice columns, each a list of values
    lookup_cols: list[list[list[int]]]
    # single-advice-column special case: rows of gate column 0 with q_lookup on
    q_lookup_rows: list[set[int]]
    # fixed column values
    fixed_cols: list[list[int]]
    # copy constraints as physical pairs: cells are ("advice"|"lookup"|"fixed"|"instance", phase_or_0, col, row)
    copies: list[tuple[tuple, tuple]]
    # instance values per column
    instances: list[list[int]]
    witness_gen_only: bool = False
    # resolved dynamic lookups (core/dyn_lookup.py), checked by MockProver
    dyn_lookups: list = dc_field(default_factory=list)
    # challenge pin cells: (challenge index, phase, col, row) — the advice cell
    # constrained to equal the phase challenge (builder.constrain_challenge)
    challenge_pins: list = dc_field(default_factory=list)
    # dynamic-lookup column sets (core/dyn_lookup.py resolve_columns): per set,
    # dedicated key/table advice columns + fixed is_enabled toggles
    dyn_sets: list = dc_field(default_factory=list)

    def num_rows(self) -> int:
        return 1 << self.params.k


class BaseCircuitBuilder:
    """Collection of virtual region managers assigning into one circuit.

    (circuit/builder.rs:968-1299)
    """

    def __init__(self, witness_gen_only: bool = False, field: PrimeField = FR_BN254):
        self.field = field
        self.core = MultiPhaseCoreManager(witness_gen_only, field)
        self.lookup_manager = [
            LookupAnyManager(1, witness_gen_only, self.core.copy_manager) for _ in range(MAX_PHASE)
        ]
        self.config_params = BaseCircuitParams()
        self.assigned_instances: list[list[AssignedValue]] = []
        # optional BasicDynLookupManager (core/dyn_lookup.py)
        self.dyn_lookup_manager = None
        # challenge pins: challenge index c -> canonical AssignedValue that the
        # proof system constrains to equal the phase-c challenge (see
        # constrain_challenge)
        self.challenge_pins: dict[int, AssignedValue] = {}

    def deep_clone(self) -> "BaseCircuitBuilder":
        """Full clone with a freshly shared copy manager (circuit/
        builder.rs:116-124): mutating the clone leaves self untouched.
        Python's deepcopy memo preserves the internal sharing (the core and
        every lookup manager reference the SAME cloned CopyConstraintManager,
        mirroring the Arc<Mutex<_>> re-wiring in the reference)."""
        import copy

        return copy.deepcopy(self)

    # --- constructors --------------------------------------------------------
    @staticmethod
    def from_stage(stage: CircuitBuilderStage, field: PrimeField = FR_BN254) -> "BaseCircuitBuilder":
        b = BaseCircuitBuilder(stage.witness_gen_only(), field)
        b.core.use_unknown = stage is CircuitBuilderStage.KEYGEN
        return b

    @staticmethod
    def prover(
        config_params: BaseCircuitParams,
        break_points: list[list[int]],
        field: PrimeField = FR_BN254,
    ) -> "BaseCircuitBuilder":
        b = BaseCircuitBuilder(True, field)
        b.set_params(config_params)
        b.set_break_points(break_points)
        return b

    # --- setters ---------------------------------------------------------------
    def set_lookup_bits(self, lookup_bits: int):
        self.config_params.lookup_bits = lookup_bits

    def use_lookup_bits(self, lookup_bits: int):
        self.set_lookup_bits(lookup_bits)
        return self

    def set_k(self, k: int):
        self.config_params.k = k

    def use_k(self, k: int):
        self.set_k(k)
        return self

    def set_instance_columns(self, n: int):
        self.config_params.num_instance_columns = n
        while len(self.assigned_instances) < n:
            self.assigned_instances.append([])
        assert len(self.assigned_instances) == n

    def use_instance_columns(self, n: int):
        self.set_instance_columns(n)
        return self

    def set_params(self, params: BaseCircuitParams):
        self.set_instance_columns(params.num_instance_columns)
        self.config_params = params

    def use_params(self, params: BaseCircuitParams):
        self.set_params(params)
        return self

    def break_points(self) -> list[list[int]]:
        out = []
        for pm in self.core.phase_manager:
            assert pm.break_points is not None, "break points not set"
            out.append(list(pm.break_points))
        return out

    def set_break_points(self, break_points: list[list[int]]):
        if not break_points:
            return
        self.core.touch(len(break_points) - 1)
        for pm, bp in zip(self.core.phase_manager, break_points):
            pm.break_points = list(bp)

    def use_break_points(self, break_points: list[list[int]]):
        self.set_break_points(break_points)
        return self

    def witness_gen_only(self) -> bool:
        return self.core.witness_gen_only

    def clear(self):
        self.core.clear()
        for lm in self.lookup_manager:
            lm.clear()
        for col in self.assigned_instances:
            col.clear()

    # --- thread access -----------------------------------------------------------
    def main(self, phase: int = 0) -> Context:
        return self.core.main(phase)

    def pool(self, phase: int = 0) -> SinglePhaseCoreManager:
        self.core.touch(phase)
        return self.core.phase_manager[phase]

    def new_thread(self, phase: int = 0) -> Context:
        return self.core.new_thread(phase)

    def lookup_bits(self) -> int | None:
        return self.config_params.lookup_bits

    def constrain_challenge(self, av: AssignedValue, c: int, ctx: Context | None = None):
        """Constrain `av` to equal phase challenge c (usable in phases > c).

        The backend pins ONE canonical cell per challenge with a fixed
        selector column and the constraint `q_chal * (a - challenge) = 0`
        (the vertical gate itself has no challenge term — the reference gets
        challenge expressions from halo2-axiom's `Expression::Challenge`);
        further uses are copy-constrained to the canonical cell. In
        Mock/Keygen stages pass witnesses computed from
        `backend.challenges.mock_challenge(c)`; in real proving, from the
        values handed to the `phase_fns` closures (backend/prover.py).
        """
        canon = self.challenge_pins.get(c)
        if canon is None:
            self.challenge_pins[c] = av
        else:
            cm = self.core.copy_manager
            if av.cell is not None and canon.cell is not None:
                cm.advice_equalities.append((canon.cell, av.cell))

    def range_chip(self) -> RangeChip:
        assert self.config_params.lookup_bits is not None, "lookup bits not set"
        return RangeChip(self.config_params.lookup_bits, self.lookup_manager, self.field)

    def statistics(self):
        total_advice_per_phase, total_fixed = self.core.statistics()
        total_lookup_per_phase = [lm.total_rows() for lm in self.lookup_manager]
        return {
            "total_advice_per_phase": total_advice_per_phase,
            "total_fixed": total_fixed,
            "total_lookup_advice_per_phase": total_lookup_per_phase,
        }

    def calculate_params(self, minimum_rows: int | None = None) -> BaseCircuitParams:
        """Auto-size columns from cell counts (builder.rs:1182-1209)."""
        k = self.config_params.k
        assert k != 0, "k must be set"
        max_rows = (1 << k) - (minimum_rows or 0)
        gate_params = self.core.calculate_params(k, minimum_rows)
        total_lookup = [lm.total_rows() for lm in self.lookup_manager]
        num_lookup_advice_per_phase = [-(-c // max_rows) for c in total_lookup]
        self.config_params = BaseCircuitParams(
            k=k,
            num_advice_per_phase=gate_params["num_advice_per_phase"],
            num_fixed=gate_params["num_fixed"],
            num_lookup_advice_per_phase=num_lookup_advice_per_phase,
            lookup_bits=self.config_params.lookup_bits,
            num_instance_columns=self.config_params.num_instance_columns,
        )
        return self.config_params

    # --- synthesize ---------------------------------------------------------------
    def synthesize(self, minimum_rows: int = DEFAULT_MINIMUM_ROWS) -> PhysicalCircuit:
        """Flatten all virtual regions into the physical table.

        Port of `Circuit::synthesize` (circuit/mod.rs:852-891): phase-0 gate
        columns, then lookup columns, then constants + copy constraints.
        """
        params = self.config_params
        k = params.k
        assert k > 0, "k must be set"
        usable_rows = (1 << k) - minimum_rows
        F = self.field
        wg_only = self.witness_gen_only()

        num_phases = len(params.num_advice_per_phase)
        self.core.touch(max(num_phases - 1, 0))

        phases: list[FlattenedPhase] = []
        for phase in range(max(num_phases, len(self.core.phase_manager))):
            pm = self.core.phase_manager[phase] if phase < len(self.core.phase_manager) else None
            ncols = params.num_advice_per_phase[phase] if phase < num_phases else 0
            if pm is None or (ncols == 0 and pm.total_advice() == 0):
                phases.append(FlattenedPhase())
                continue
            if wg_only:
                assert pm.break_points is not None, "break points not set for prover"
                phases.append(pm.flatten_witnesses(ncols, pm.break_points))
            else:
                phases.append(pm.flatten_with_constraints(ncols, usable_rows))

        # --- lookup advice columns (builder.rs:1249-1298) ---
        lookup_cols: list[list[list[int]]] = []
        q_lookup_rows: list[set[int]] = []
        copies: list[tuple[tuple, tuple]] = []
        cm = self.core.copy_manager
        for phase in range(MAX_PHASE):
            lm = self.lookup_manager[phase]
            nlookup = (
                params.num_lookup_advice_per_phase[phase]
                if phase < len(params.num_lookup_advice_per_phase)
                else 0
            )
            rows: set[int] = set()
            cols: list[list[int]] = []
            if lm.total_rows() > 0:
                assert params.lookup_bits is not None, "lookups queued but no lookup_bits"
                num_advice = params.num_advice_per_phase[phase] if phase < num_phases else 0
                if phase == 0 and num_advice == 1 and nlookup != 0:
                    # single-column special case: q_lookup selector on the main column
                    if not wg_only:
                        for (cell_tuple) in lm.iter_rows():
                            av = cell_tuple[0]
                            src_phase, col, row = cm.assigned_advices[av.cell]
                            assert row < usable_rows, "range lookup on unusable row"
                            assert col == 0 and src_phase == 0, "lookup column does not match"
                            rows.add(row)
                else:
                    assert nlookup > 0, "range lookups require lookup advice columns"
                    total = lm.total_rows()
                    assert -(-total // nlookup) <= usable_rows, "lookups exceed usable rows"
                    cols = [[] for _ in range(nlookup)]
                    for i, cell_tuple in enumerate(lm.iter_rows()):
                        av = cell_tuple[0]
                        c, r = i % nlookup, i // nlookup
                        from ..core.cells import assigned_to_int

                        cols[c].append(assigned_to_int(av.value, F))
                        if not wg_only:
                            sp, sc, sr = cm.assigned_advices[av.cell]
                            copies.append(
                                (("advice", sp, sc, sr), ("lookup", phase, c, r))
                            )
                lm.assigned = True
            else:
                cols = [[] for _ in range(nlookup)]
            lookup_cols.append(cols)
            q_lookup_rows.append(rows)

        # --- constants to fixed columns + copy constraints (copy_constraints.rs:129-173)
        fixed_cols: list[list[int]] = [[] for _ in range(params.num_fixed)]
        if not wg_only:
            cm.constant_equalities.sort()  # (constant, cell) tuples sort natively
            fixed_positions: dict[int, tuple[int, int]] = {}
            fc, fo = 0, 0
            nfixed = params.num_fixed
            for c, _cell in cm.constant_equalities:
                if c not in fixed_positions:
                    assert nfixed > 0, "constants used but num_fixed == 0"
                    while len(fixed_cols[fc]) < fo:
                        fixed_cols[fc].append(0)
                    fixed_cols[fc].append(c)
                    fixed_positions[c] = (fc, fo)
                    fc += 1
                    if fc >= nfixed:
                        fc = 0
                        fo += 1
            cm.assigned_constants = fixed_positions

            cm.advice_equalities.sort()
            if hasattr(cm.assigned_advices, "translate_pairs"):
                cm.assigned_advices.translate_pairs(
                    cm.advice_equalities, "advice", "advice", copies
                )
            else:  # plain-dict map (no phase was flattened arithmetically)
                for left, right in cm.advice_equalities:
                    lp, lc, lr = cm.assigned_advices[left]
                    rp, rc, rr = cm.assigned_advices[right]
                    copies.append((("advice", lp, lc, lr), ("advice", rp, rc, rr)))
            for c, cell in cm.constant_equalities:
                f = fixed_positions[c]
                ap, ac, ar = cm.assigned_advices[cell]
                copies.append((("fixed", 0, f[0], f[1]), ("advice", ap, ac, ar)))
            # physical equalities from column breaks
            for phase, fp in enumerate(phases):
                for (c1, r1), (c2, r2) in fp.physical_equalities:
                    copies.append((("advice", phase, c1, r1), ("advice", phase, c2, r2)))
            cm.assigned = True
            cm.assigned_constants = {}

        # --- instances ---
        instances: list[list[int]] = []
        from ..core.cells import assigned_to_int

        for col_idx, col in enumerate(self.assigned_instances):
            vals = [assigned_to_int(av.value, F) for av in col]
            instances.append(vals)
            if not wg_only:
                for i, av in enumerate(col):
                    sp, sc, sr = cm.assigned_advices[av.cell]
                    copies.append(
                        (("advice", sp, sc, sr), ("instance", 0, col_idx, i))
                    )

        dyn_lookups = (
            self.dyn_lookup_manager.resolve(F) if self.dyn_lookup_manager is not None else []
        )
        # dedicated dynamic-lookup columns + copy constraints (real prover)
        dyn_sets = (
            self.dyn_lookup_manager.resolve_columns(F, wg_only)
            if self.dyn_lookup_manager is not None
            else []
        )
        flat = 0
        for s in dyn_sets:
            kc = s["key_col"]
            if not wg_only:
                for c, r, cell in s["key_copies"]:
                    sp, sc, sr = cm.assigned_advices[cell]
                    copies.append((("dynadv", 0, flat + c, r), ("advice", sp, sc, sr)))
                for c, r, cell in s["table_copies"]:
                    sp, sc, sr = cm.assigned_advices[cell]
                    copies.append((("dynadv", 0, flat + kc + c, r), ("advice", sp, sc, sr)))
            flat += 2 * kc

        challenge_pins: list[tuple[int, int, int, int]] = []
        if not wg_only:
            for c in sorted(self.challenge_pins):
                av = self.challenge_pins[c]
                pp, pc, pr = cm.assigned_advices[av.cell]
                assert pp > c, (
                    f"challenge {c} is only usable in phases > {c}, pinned in phase {pp}"
                )
                challenge_pins.append((c, pp, pc, pr))

        return PhysicalCircuit(
            params=params,
            field=F,
            usable_rows=usable_rows,
            phases=phases,
            lookup_cols=lookup_cols,
            q_lookup_rows=q_lookup_rows,
            fixed_cols=fixed_cols,
            copies=copies,
            instances=instances,
            witness_gen_only=wg_only,
            dyn_lookups=dyn_lookups,
            challenge_pins=challenge_pins,
            dyn_sets=dyn_sets,
        )


# Backwards-compatible alias matching the reference naming
RangeCircuitBuilder = BaseCircuitBuilder
