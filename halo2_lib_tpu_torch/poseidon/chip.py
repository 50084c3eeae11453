"""PoseidonChip: byte-oriented Poseidon hashing over SafeTypes.

Mirrors `halo2-base/src/poseidon/mod.rs:15-114`: `PoseidonChip` owns a
`PoseidonHasher` with in-circuit constants plus a `RangeChip`, and the
`PoseidonInstructions` surface hashes the SafeType byte containers
(`VarLenBytes` / `VarLenBytesVec` / `FixLenBytes`) by feeding their byte
cells to the fixed/var-length array hashers.
"""

from __future__ import annotations

from ..core.cells import AssignedValue
from ..core.context import Context
from ..gates.range import RangeChip
from ..safe_types import FixLenBytes, VarLenBytes
from .hasher import PoseidonHasher
from .spec import OptimizedPoseidonSpec


class PoseidonChip:
    """Poseidon hash chip over SafeType byte arrays (poseidon/mod.rs:15-31).

    Construction initializes the hasher's round constants as circuit
    constants (`PoseidonHasher::initialize_consts`).
    """

    def __init__(self, ctx: Context, spec: OptimizedPoseidonSpec, range_chip: RangeChip):
        self.range_chip = range_chip
        self.hasher = PoseidonHasher(spec)
        self.hasher.initialize_consts(ctx, range_chip.gate)

    # --- PoseidonInstructions (poseidon/mod.rs:34-62) ----------------------
    def hash_var_len_bytes(self, ctx: Context, inputs: VarLenBytes) -> AssignedValue:
        """Hash of a right-padded variable-length byte array (mod.rs:66-81)."""
        return self.hasher.hash_var_len_array(
            ctx,
            self.range_chip,
            [b.value for b in inputs.bytes],
            inputs.length,
        )

    def hash_var_len_bytes_vec(self, ctx: Context, inputs: VarLenBytes) -> AssignedValue:
        """Vec variant (mod.rs:83-99); the Python runtime shape is identical."""
        return self.hash_var_len_bytes(ctx, inputs)

    def hash_fix_len_bytes(self, ctx: Context, inputs: FixLenBytes) -> AssignedValue:
        """Hash of a fixed-length byte array (mod.rs:101-113)."""
        return self.hasher.hash_fix_len_array(
            ctx,
            self.range_chip.gate,
            [b.value for b in inputs.bytes],
        )

    hash_fix_len_bytes_vec = hash_fix_len_bytes
