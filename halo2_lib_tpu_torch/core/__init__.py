from .cells import (
    Rational,
    ContextCell,
    AssignedValue,
    QCell,
    Existing,
    Witness,
    WitnessFraction,
    Constant,
    as_qcell,
    qcell_value,
    assigned_to_int,
)
from .copy_constraints import CopyConstraintManager, EXTERNAL_CELL_TYPE_ID
from .lookups import LookupAnyManager
from .context import Context

__all__ = [
    "Rational",
    "ContextCell",
    "AssignedValue",
    "QCell",
    "Existing",
    "Witness",
    "WitnessFraction",
    "Constant",
    "as_qcell",
    "qcell_value",
    "assigned_to_int",
    "CopyConstraintManager",
    "EXTERNAL_CELL_TYPE_ID",
    "LookupAnyManager",
    "Context",
]
