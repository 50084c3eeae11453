"""Virtual-cell primitives of the eDSL.

Mirrors halo2-base/src/lib.rs:51-150: `QuantumCell` (the 4 ways a value enters
an advice column), `ContextCell` (virtual pointer), `AssignedValue` (value +
optional pointer), and the `Assigned` rational type used for deferred batch
inversion (`WitnessFraction`).

Values are Python ints in [0, p) for the circuit's native field; `Rational`
defers an inversion until the virtual column is flattened (where we batch
invert all denominators at once — same optimization halo2's `Assigned` enables).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union


class Rational:
    """Deferred fraction num/den in the native field (halo2 `Assigned::Rational`)."""

    __slots__ = ("num", "den")

    def __init__(self, num: int, den: int):
        self.num = num
        self.den = den

    def evaluate(self, field) -> int:
        if self.den == 1:
            return self.num % field.p
        return self.num * field.inv(self.den) % field.p

    def __repr__(self):
        return f"Rational({self.num}/{self.den})"

    def __eq__(self, other):
        if type(other) is Rational:
            return self.num == other.num and self.den == other.den
        return NotImplemented

    def __hash__(self):
        return hash((self.num, self.den))


AssignedInt = Union[int, Rational]


def assigned_to_int(v: AssignedInt, field) -> int:
    """Evaluate an Assigned value to a canonical int (lazy fractions resolved)."""
    if type(v) is int:
        return v
    return v.evaluate(field)


class ContextCell(NamedTuple):
    """Pointer to a cell at `offset` in the virtual advice column of a Context.

    Reference: halo2-base/src/lib.rs:96-116. Tuple ordering matches the Rust
    derive(Ord) field order so copy-constraint sorting is identical.
    """

    type_id: str
    context_id: int
    offset: int


class AssignedValue:
    """Value + optional virtual-cell pointer (halo2-base/src/lib.rs:120-150).

    `cell is None` in witness-gen-only mode (the production prover path).
    """

    __slots__ = ("value", "cell")

    def __init__(self, value: AssignedInt, cell: Optional[ContextCell]):
        self.value = value
        self.cell = cell

    def val(self) -> int:
        """The trivially-known int value; raises on unevaluated fractions."""
        v = self.value
        if type(v) is int:
            return v
        raise ValueError("AssignedValue holds an unevaluated Rational")

    def debug_prank(self, ctx, prank_value: int) -> None:
        """Overwrite the witness in `ctx` for negative tests (lib.rs:141-146)."""
        ctx.advice[self.cell.offset] = prank_value

    def __repr__(self):
        return f"AssignedValue({self.value}, {self.cell})"


# --- QuantumCell ------------------------------------------------------------
_EXISTING = 0
_WITNESS = 1
_WITNESS_FRACTION = 2
_CONSTANT = 3


class QCell:
    """Tagged union standing in for the reference's `QuantumCell` enum."""

    __slots__ = ("kind", "val")

    def __init__(self, kind: int, val):
        self.kind = kind
        self.val = val

    def __repr__(self):
        names = ("Existing", "Witness", "WitnessFraction", "Constant")
        return f"{names[self.kind]}({self.val})"


def Existing(av: AssignedValue) -> QCell:
    return QCell(_EXISTING, av)


def Witness(v: int) -> QCell:
    return QCell(_WITNESS, v)


def WitnessFraction(num: int, den: int) -> QCell:
    return QCell(_WITNESS_FRACTION, Rational(num, den))


def Constant(v: int) -> QCell:
    return QCell(_CONSTANT, v)


def as_qcell(x) -> QCell:
    """`impl Into<QuantumCell>`: AssignedValue coerces to Existing."""
    t = type(x)
    if t is QCell:
        return x
    if t is AssignedValue:
        return QCell(_EXISTING, x)
    raise TypeError(f"cannot convert {x!r} to QuantumCell (wrap ints in Witness/Constant)")


def qcell_value(q: QCell) -> int:
    """QuantumCell::value() — panics on WitnessFraction (lib.rs:78-88)."""
    k = q.kind
    if k == _EXISTING:
        return q.val.val()
    if k == _WITNESS or k == _CONSTANT:
        return q.val
    raise ValueError("Trying to get value of a fraction before batch inversion")
