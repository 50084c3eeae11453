"""A Context is one virtual advice column (one "thread" of the execution trace).

Mirrors halo2-base/src/lib.rs:157-475. The advice list plus parallel selector
list IS the witness tensor for this thread; flattening into the physical
PlonKish table happens later in `gates.threads` (a pure reshape + gather).
"""

from __future__ import annotations

import random

from .cells import (
    AssignedValue,
    ContextCell,
    QCell,
    as_qcell,
    _EXISTING,
    _WITNESS,
    _WITNESS_FRACTION,
    _CONSTANT,
)
from ..native import get_region_mod
from .copy_constraints import CopyConstraintManager

_tnew = tuple.__new__


class Context:
    __slots__ = (
        "witness_gen_only",
        "phase",
        "type_id",
        "context_id",
        "advice",
        "zero_cell",
        "selector",
        "copy_manager",
        "field",
    )

    def __init__(
        self,
        witness_gen_only: bool,
        phase: int,
        type_id: str,
        context_id: int,
        copy_manager: CopyConstraintManager,
        field,
    ):
        self.witness_gen_only = witness_gen_only
        self.phase = phase
        self.type_id = type_id
        self.context_id = context_id
        self.advice: list = []  # int or Rational entries
        self.zero_cell: AssignedValue | None = None
        self.selector: list[bool] = []
        self.copy_manager = copy_manager
        self.field = field

    def id(self) -> int:
        return self.context_id

    def tag(self):
        return (self.type_id, self.context_id)

    def _latest_cell(self) -> ContextCell:
        # tuple.__new__ skips the generated namedtuple __new__ (hot path)
        return _tnew(ContextCell, (self.type_id, self.context_id, len(self.advice) - 1))

    # --- core assignment ---------------------------------------------------
    def assign_cell(self, input) -> None:
        """Push one QuantumCell (lib.rs:231-268)."""
        q = as_qcell(input)
        k = q.kind
        if k == _EXISTING:
            acell = q.val
            self.advice.append(acell.value)
            if not self.witness_gen_only:
                self.copy_manager.advice_equalities.append((self._latest_cell(), acell.cell))
        elif k == _WITNESS:
            self.advice.append(q.val)
        elif k == _WITNESS_FRACTION:
            self.advice.append(q.val)  # Rational, resolved at flatten time
        else:  # _CONSTANT
            self.advice.append(q.val)
            if not self.witness_gen_only:
                self.copy_manager.constant_equalities.append((q.val, self._latest_cell()))

    def last(self) -> AssignedValue | None:
        if not self.advice:
            return None
        cell = None if self.witness_gen_only else self._latest_cell()
        return AssignedValue(self.advice[-1], cell)

    def get(self, offset: int) -> AssignedValue:
        """Fetch cell at offset (negative = from end), lib.rs:276-293."""
        if offset < 0:
            offset += len(self.advice)
        assert 0 <= offset < len(self.advice)
        cell = None if self.witness_gen_only else _tnew(
            ContextCell, (self.type_id, self.context_id, offset)
        )
        return AssignedValue(self.advice[offset], cell)

    def constrain_equal(self, a: AssignedValue, b: AssignedValue) -> None:
        if not self.witness_gen_only:
            self.copy_manager.advice_equalities.append((a.cell, b.cell))

    def assign_region(self, inputs, gate_offsets) -> None:
        """Push cells and enable the vertical gate at relative offsets (lib.rs:310-335)."""
        nat = get_region_mod()
        if nat is not None and type(inputs) is list and type(gate_offsets) is list:
            if nat.emit_region(self, inputs, gate_offsets) >= 0:
                return
        if self.witness_gen_only:
            for input in inputs:
                self.assign_cell(input)
            return
        row_offset = len(self.advice)
        for input in inputs:
            self.assign_cell(input)
        sel = self.selector
        need = len(self.advice) - len(sel)
        if need > 0:
            sel.extend([False] * need)
        for offset in gate_offsets:
            sel[row_offset + offset] = True

    def assign_region_last(self, inputs, gate_offsets) -> AssignedValue:
        self.assign_region(inputs, gate_offsets)
        return self.last()

    def assign_region_smart(self, inputs, gate_offsets, equality_offsets, external_equality) -> None:
        """assign_region + relative equality constraints (lib.rs:364-414)."""
        row_offset = len(self.advice)
        self.assign_region(inputs, gate_offsets)
        if not self.witness_gen_only:
            adv_eq = self.copy_manager.advice_equalities
            tid, cid = self.type_id, self.context_id
            for off1, off2 in equality_offsets:
                adv_eq.append(
                    (
                        _tnew(ContextCell, (tid, cid, row_offset + off1)),
                        _tnew(ContextCell, (tid, cid, row_offset + off2)),
                    )
                )
            for cell, offset in external_equality:
                adv_eq.append((cell, _tnew(ContextCell, (tid, cid, row_offset + offset))))

    def assign_witnesses(self, witnesses) -> list[AssignedValue]:
        row_offset = len(self.advice)
        from .cells import Witness

        self.assign_region([Witness(int(w)) for w in witnesses], [])
        wg = self.witness_gen_only
        tid, cid = self.type_id, self.context_id
        out = []
        for i, v in enumerate(self.advice[row_offset:]):
            cell = None if wg else _tnew(ContextCell, (tid, cid, row_offset + i))
            out.append(AssignedValue(v, cell))
        return out

    def load_witness(self, witness: int) -> AssignedValue:
        from .cells import Witness

        self.assign_cell(Witness(int(witness)))
        if not self.witness_gen_only and len(self.selector) < len(self.advice):
            self.selector.extend([False] * (len(self.advice) - len(self.selector)))
        return self.last()

    def load_constant(self, c: int) -> AssignedValue:
        from .cells import Constant

        self.assign_cell(Constant(int(c)))
        if not self.witness_gen_only and len(self.selector) < len(self.advice):
            self.selector.extend([False] * (len(self.advice) - len(self.selector)))
        return self.last()

    def load_constants(self, cs) -> list[AssignedValue]:
        return [self.load_constant(c) for c in cs]

    def load_zero(self) -> AssignedValue:
        if self.zero_cell is not None:
            return self.zero_cell
        z = self.load_constant(0)
        self.zero_cell = z
        return z

    def debug_assert_false(self) -> None:
        """Constraint that always fails — a MockProver breakpoint (lib.rs:469-474)."""
        rng = random.Random()
        r1 = self.load_witness(self.field.random(rng))
        r2 = self.load_witness(self.field.random(rng))
        self.constrain_equal(r1, r2)
