"""Dynamic (advice-vs-advice) lookup tables — RAM out of lookups.

Role of halo2-base's `BasicDynLookupConfig<KEY_COL>`
(virtual_region/lookups/basic.rs): verify that `(key, enabled)` tuples appear
in a dynamically assigned table with `table_is_enabled` toggles. Disabled rows
pair the all-zero key with `enabled = 0`, which must exist in the table
(basic.rs:34-37).

Virtual-region design: keys and table rows are collected as virtual tuples
during witness generation; `synthesize` resolves them into DEDICATED dynamic
advice columns (+ fixed `is_enabled` toggles) with copy constraints back to
the gadget cells (basic.rs's `constrain_virtual_equals_external`), and the
real prover runs a theta-compressed multi-column halo2 lookup argument per
set (backend/protocol.py `lookup_instances`). The MockProver additionally
checks multiset membership directly on the resolved values.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

from .cells import AssignedValue, assigned_to_int


@dataclass
class DynLookupSet:
    """One set of to-lookup columns + the shared table (KEY_COL wide)."""

    key_col: int
    # (key tuple, enabled) — enabled is an AssignedValue or int constant
    keys: list = dc_field(default_factory=list)
    table: list = dc_field(default_factory=list)

    def add_lookup(self, key: tuple, enabled=1) -> None:
        assert len(key) == self.key_col
        self.keys.append((tuple(key), enabled))

    def add_table_row(self, row: tuple, enabled=1) -> None:
        assert len(row) == self.key_col
        self.table.append((tuple(row), enabled))


class BasicDynLookupManager:
    """Manager for KEY_COL-wide dynamic lookups (basic.rs:40-199)."""

    def __init__(self, key_col: int, num_lu_sets: int = 1):
        self.key_col = key_col
        self.sets = [DynLookupSet(key_col) for _ in range(num_lu_sets)]

    def resolve(self, field) -> list[dict]:
        """Evaluate to int tuples for the PhysicalCircuit."""
        def val(x):
            if isinstance(x, AssignedValue):
                return assigned_to_int(x.value, field)
            return int(x) % field.p

        out = []
        for s in self.sets:
            keys = [tuple(val(k) for k in key) + (val(en),) for key, en in s.keys]
            table = {tuple(val(k) for k in row) + (val(en),) for row, en in s.table}
            # the all-zero disabled key is always legal (basic.rs:34-37)
            table.add(tuple([0] * self.key_col + [0]))
            out.append({"keys": keys, "table": table})
        return out

    def resolve_columns(self, field, wg_only: bool) -> list[dict]:
        """Column form for the real prover: per set, dedicated advice columns
        (key columns + table columns), fixed is_enabled toggles, and copy
        constraints pinning each advice cell to the originating gadget cell
        (reference: raw_assign_advice + constrain_virtual_equals_external,
        basic.rs:87-199).

        `enabled` flags become FIXED column values and therefore must be int
        constants (the reference's key_is_enabled/table_is_enabled are Fixed
        columns assigned by the circuit, not witnesses).
        """

        def val(x):
            if isinstance(x, AssignedValue):
                return assigned_to_int(x.value, field)
            return int(x) % field.p

        out = []
        for s in self.sets:
            kc = s.key_col
            key_cols = [[] for _ in range(kc)]
            key_en: list[int] = []
            key_copies: list[tuple[int, int, object]] = []  # (col, row, ContextCell)
            for r, (key, en) in enumerate(s.keys):
                assert not isinstance(en, AssignedValue), (
                    "dyn-lookup `enabled` must be a fixed int constant "
                    "(it maps to a Fixed column)"
                )
                key_en.append(int(en) % field.p)
                for c, k in enumerate(key):
                    key_cols[c].append(val(k))
                    if not wg_only and isinstance(k, AssignedValue) and k.cell is not None:
                        key_copies.append((c, r, k.cell))
            tbl_cols = [[] for _ in range(kc)]
            tbl_en: list[int] = []
            tbl_copies: list[tuple[int, int, object]] = []
            for r, (row, en) in enumerate(s.table):
                assert not isinstance(en, AssignedValue), (
                    "dyn-lookup table `enabled` must be a fixed int constant"
                )
                tbl_en.append(int(en) % field.p)
                for c, k in enumerate(row):
                    tbl_cols[c].append(val(k))
                    if not wg_only and isinstance(k, AssignedValue) and k.cell is not None:
                        tbl_copies.append((c, r, k.cell))
            out.append(
                {
                    "key_col": kc,
                    "key_cols": key_cols,
                    "key_en": key_en,
                    "key_copies": key_copies,
                    "table_cols": tbl_cols,
                    "table_en": tbl_en,
                    "table_copies": tbl_copies,
                }
            )
        return out


def check_dyn_lookups(resolved: list[dict]) -> list[str]:
    """MockProver membership check."""
    errors = []
    for si, s in enumerate(resolved):
        table = s["table"]
        for i, key in enumerate(s["keys"]):
            if key not in table:
                errors.append(f"dyn lookup set {si} row {i}: key {key} not in table")
                if len(errors) > 16:
                    return errors
    return errors
