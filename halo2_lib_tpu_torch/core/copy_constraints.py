"""Global copy-constraint manager.

Mirrors halo2-base/src/virtual_region/copy_constraints.rs: collects equality
constraints between virtual advice cells and between constants and advice
cells; at flatten time assigns deduped constants to fixed columns
(left-to-right, top-to-bottom) and resolves virtual cells to physical cells.

Sorting rules replicate the reference exactly (copy_constraints.rs:135-158):
constants sorted by (value, cell), advice equalities sorted lexicographically —
so the permutation argument cycles are built in the same order and keygen is
bit-reproducible.
"""

from __future__ import annotations

from .cells import AssignedValue, ContextCell

EXTERNAL_CELL_TYPE_ID = "halo2-base:External Raw Halo2 Cell"


class CopyConstraintManager:
    """Shared (per-builder) manager for all copy constraints."""

    __slots__ = (
        "advice_equalities",
        "constant_equalities",
        "external_cell_count",
        "assigned_advices",
        "assigned_constants",
        "assigned",
    )

    def __init__(self):
        self.advice_equalities: list[tuple[ContextCell, ContextCell]] = []
        self.constant_equalities: list[tuple[int, ContextCell]] = []
        self.external_cell_count = 0
        # virtual ContextCell -> physical (column_global_index, row) after flatten
        self.assigned_advices: dict[ContextCell, tuple[int, int]] = {}
        # constant value -> physical fixed cell
        self.assigned_constants: dict[int, tuple[int, int]] = {}
        self.assigned = False

    def num_distinct_constants(self) -> int:
        return len({c for c, _ in self.constant_equalities})

    def mock_external_assigned(self, v: int) -> AssignedValue:
        """Simulate loading an external raw halo2 cell (copy_constraints.rs:79-96)."""
        cell = ContextCell(EXTERNAL_CELL_TYPE_ID, 0, self.external_cell_count)
        self.external_cell_count += 1
        return AssignedValue(v, cell)

    def clear(self) -> None:
        self.advice_equalities.clear()
        self.constant_equalities.clear()
        self.assigned_advices.clear()
        self.assigned_constants.clear()
        self.external_cell_count = 0
        self.assigned = False
