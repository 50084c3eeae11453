"""The verifying key as the reference reads it: parsed from the bytes the
program's ``VerifyingKey.to_bytes`` writes, with halo2's transcript
representation rebuilt from them.

A frozen copy of ``ColumnRef``, the constants and ``VerifyingKey`` of
``halo2_lib_tpu_torch/backend/keygen.py`` (less the key generation and the
writer), so that the reference verifier shares no code with the program.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field as dc_field

from .fields import FR_BN254

BLINDING_FACTORS = 8
CS_DEGREE = 4
PERM_CHUNK = CS_DEGREE - 2  # halo2: chunk = degree - 2

# delta: generator of the "extended" coset labels (halo2curves Fr::DELTA = g^{2^S})
DELTA = pow(FR_BN254.generator, 1 << FR_BN254.s, FR_BN254.p)


@dataclass
class ColumnRef:
    """A permutation-participating column: kind in {advice, lookup, fixed, instance}.

    `index` is the flat PHASE-MAJOR index within the kind (all phase-0 advice
    columns, then phase-1, ...); `phase` is kept for physical-cell resolution.
    """

    kind: str
    index: int
    phase: int = 0

    def key(self):
        return (self.kind, self.index)


@dataclass
class VerifyingKey:
    k: int
    params_n: int
    num_advice: int  # total gate-advice columns over all phases
    num_lookup: int  # total lookup-advice columns over all phases
    num_fixed: int
    num_instance: int
    lookup_bits: int | None
    uses_q_lookup: bool
    selector_commitments: list
    fixed_commitments: list
    table_commitment: object | None
    q_lookup_commitment: object | None
    permutation_commitments: list
    perm_columns: list[ColumnRef] = dc_field(default_factory=list)
    # per-phase column counts; advice of phase t commits before the phase-t
    # challenge squeeze (halo2 challenge phases, flex_gate/mod.rs:63-67)
    num_advice_per_phase: list[int] = dc_field(default_factory=list)
    num_lookup_per_phase: list[int] = dc_field(default_factory=list)
    # challenge pins: (challenge index, flat advice col, row). The constraint
    # L_row(X) * (a_col(X) - challenge) = 0 is STRUCTURAL — like halo2's
    # Challenge API, the challenge is a symbol in the constraint system and
    # no extra fixed column or commitment exists for it; the verifier
    # computes L_row(x) in closed form (flex_gate/mod.rs:63-67 challenge
    # usage; virtual_region/tests/lookups/memory.rs).
    challenge_pins: list = dc_field(default_factory=list)
    # dynamic lookups: KEY_COL per set; per set two fixed is_enabled columns
    # (key_en, table_en) committed in dynen order [set0 key, set0 table, ...]
    dyn_key_cols: list = dc_field(default_factory=list)
    dynen_commitments: list = dc_field(default_factory=list)

    def num_phases(self) -> int:
        return max(len(self.num_advice_per_phase), 1)

    @staticmethod
    def from_bytes(data: bytes) -> "VerifyingKey":
        """Inverse of to_bytes (carries a JAX-made key across, convert.py)."""
        magic = b"halo2_lib_tpu_vk_v3"
        assert data[: len(magic)] == magic, "not a vk byte string"
        off = len(magic)

        def take(nb, signed=False):
            nonlocal off
            v = int.from_bytes(data[off : off + nb], "little", signed=signed)
            off += nb
            return v

        k, params_n, na, nl, nf, ni, lb, uq, ncols = (take(8, True) for _ in range(9))
        na_p = [take(4) for _ in range(take(4))]
        nl_p = [take(4) for _ in range(take(4))]
        cols = []
        for _ in range(ncols):
            end = data.index(b"\x00", off)
            kind = data[off:end].decode()
            off = end + 1
            cols.append(ColumnRef(kind, take(4), take(4)))
        pins = [(take(4), take(4), take(4)) for _ in range(take(4))]
        dyn_key_cols = [take(4) for _ in range(take(4))]

        def pt():
            x, y = take(32), take(32)
            return None if x == 0 and y == 0 else (x, y)

        groups = [[pt() for _ in range(take(4))] for _ in range(5)]
        assert off == len(data), "trailing bytes after the vk"
        return VerifyingKey(
            k=k,
            params_n=params_n,
            num_advice=na,
            num_lookup=nl,
            num_fixed=nf,
            num_instance=ni,
            lookup_bits=None if lb == -1 else lb,
            uses_q_lookup=bool(uq),
            selector_commitments=groups[0],
            fixed_commitments=groups[1],
            table_commitment=groups[2][0],
            q_lookup_commitment=groups[2][1],
            permutation_commitments=groups[3],
            perm_columns=cols,
            num_advice_per_phase=na_p,
            num_lookup_per_phase=nl_p,
            challenge_pins=pins,
            dyn_key_cols=dyn_key_cols,
            dynen_commitments=groups[4],
        )

    def pinned_debug(self) -> str:
        """`format!("{:?}", vk.pinned())` — the Rust Debug rendering of the
        pinned verification key (pinned.py), rebuilt from this vk."""
        from .pinned import pinned_debug_string
        from .protocol import quotient_pieces

        omega = FR_BN254.nth_root_of_unity(self.k)
        j = quotient_pieces(self)
        extended_k = self.k + max((j - 1).bit_length(), 1)
        return pinned_debug_string(self, omega, extended_k)

    def transcript_repr(self) -> int:
        """The vk as an Fr scalar, absorbed at transcript init — halo2's
        `VerifyingKey::transcript_repr` exactly: blake2b-512 with
        personalization "Halo2-Verify-Key" over the u64-LE length-prefixed
        Rust-Debug string of the pinned verification key, reduced via
        from_uniform_bytes (keygen.rs). The Debug string reconstruction
        lives in pinned.py."""
        s = self.pinned_debug().encode()
        h = hashlib.blake2b(person=b"Halo2-Verify-Key")
        h.update(len(s).to_bytes(8, "little"))
        h.update(s)
        return int.from_bytes(h.digest(), "little") % FR_BN254.p
