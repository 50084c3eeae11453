"""Challenge-phase helpers.

halo2 exposes phase challenges (FirstPhase/SecondPhase/ThirdPhase,
reference flex_gate/mod.rs:63-67) squeezed from the transcript between
per-phase advice commitments; witnesses of phase t+1 may depend on the
phase-t challenge (RLC gadgets). The real values come from
`create_proof(..., phase_fns=...)` (backend/prover.py); Mock/Keygen runs use
the deterministic stand-ins below — the circuit layout must not depend on the
challenge VALUE, only the witnesses do, so any fixed value works for
constraint checking as long as the same value is fed to the same closure
(halo2's MockProver likewise fabricates challenge values).
"""

from __future__ import annotations

import hashlib

from ..utils.fields import FR_BN254


def mock_challenge(t: int) -> int:
    """Deterministic Fr stand-in for the phase-t challenge in mock/keygen runs."""
    h = hashlib.blake2b(f"halo2_lib_tpu mock challenge {t}".encode(), digest_size=64)
    return int.from_bytes(h.digest(), "little") % FR_BN254.p


def mock_challenges(num_phases: int) -> list[int]:
    """Challenges for phases 0..num_phases-2 (one per phase transition)."""
    return [mock_challenge(t) for t in range(max(num_phases - 1, 0))]
