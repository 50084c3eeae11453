"""Poseidon hash gadget (halo2-base/src/poseidon equivalent)."""

from .chip import PoseidonChip
from .hasher import PoseidonHasher, PoseidonSponge
from .spec import OptimizedPoseidonSpec

__all__ = ["PoseidonChip", "PoseidonHasher", "PoseidonSponge", "OptimizedPoseidonSpec"]
