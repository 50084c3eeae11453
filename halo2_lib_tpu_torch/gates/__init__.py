from .flex_gate import GateChip
from .range import RangeChip
from .threads import SinglePhaseCoreManager, MultiPhaseCoreManager, parallelize_core

__all__ = [
    "GateChip",
    "RangeChip",
    "SinglePhaseCoreManager",
    "MultiPhaseCoreManager",
    "parallelize_core",
]
