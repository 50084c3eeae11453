"""Lookup-argument cell manager.

Mirrors halo2-base/src/virtual_region/lookups.rs: cells queued for a lookup
argument are tagged by the (type_id, context_id) of the Context that produced
them; buckets iterate in sorted tag order (BTreeMap semantics) so the physical
layout is deterministic regardless of witness-gen parallelism.
"""

from __future__ import annotations

from .cells import AssignedValue

ContextTag = tuple  # (type_id: str, context_id: int)


class LookupAnyManager:
    """Manager for ADVICE_COLS-wide lookup rows (lookups.rs:46-157)."""

    __slots__ = ("advice_cols", "cells_to_lookup", "copy_manager", "witness_gen_only", "assigned")

    def __init__(self, advice_cols: int, witness_gen_only: bool, copy_manager):
        self.advice_cols = advice_cols
        # tag -> list of tuples of AssignedValue, length advice_cols
        self.cells_to_lookup: dict[ContextTag, list[tuple[AssignedValue, ...]]] = {}
        self.copy_manager = copy_manager
        self.witness_gen_only = witness_gen_only
        self.assigned = False

    def add_lookup(self, tag: ContextTag, cells: tuple[AssignedValue, ...]) -> None:
        self.cells_to_lookup.setdefault(tag, []).append(cells)

    def add_lookups(self, tag: ContextTag, rows: list[tuple[AssignedValue, ...]]) -> None:
        """Bulk append (one dict probe for a whole gadget's lookup cells —
        range_check queues one row per limb; the per-call overhead was a
        measurable slice of witness generation)."""
        self.cells_to_lookup.setdefault(tag, []).extend(rows)

    def iter_rows(self):
        """All queued rows in deterministic (sorted-tag, insertion) order."""
        for tag in sorted(self.cells_to_lookup.keys()):
            yield from self.cells_to_lookup[tag]

    def total_rows(self) -> int:
        return sum(len(v) for v in self.cells_to_lookup.values())

    def num_advice_chunks(self, usable_rows: int) -> int:
        total = self.total_rows()
        return -(-total // usable_rows)

    def clear(self) -> None:
        self.cells_to_lookup.clear()
        self.copy_manager.clear()
        self.assigned = False

    def deep_clone(self, copy_manager) -> "LookupAnyManager":
        lm = LookupAnyManager(self.advice_cols, self.witness_gen_only, copy_manager)
        lm.cells_to_lookup = {k: list(v) for k, v in self.cells_to_lookup.items()}
        return lm
