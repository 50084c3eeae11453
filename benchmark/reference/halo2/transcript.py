"""Blake2b Fiat-Shamir transcript (prover writer + verifier reader).

Plays the role of halo2-axiom's `Blake2bWrite`/`Blake2bRead` with
`Challenge255` (SURVEY.md §2.9). Same construction: a running Blake2b-512
state with personalization "Halo2-Transcript", domain-prefix bytes
0 = challenge / 1 = point / 2 = scalar, challenges squeezed as the 64-byte
digest of the current state reduced into Fr (Challenge255 semantics), scalars
as 32-byte little-endian, and G1 points as 32-byte COMPRESSED encodings:
little-endian x with the sign of y (parity) in the top bit of the last byte,
identity = all zeros (x = 0 is off-curve for y^2 = x^3 + 3, so the sentinel
is unambiguous). Deserialization rejects non-canonical x and off-curve
points, mirroring halo2curves' checked deserialization.
"""

from __future__ import annotations

import hashlib

from .fields import FR_BN254, FQ_BN254

_PERSONAL = b"Halo2-Transcript"
_PREFIX_CHALLENGE = b"\x00"
_PREFIX_POINT = b"\x01"
_PREFIX_SCALAR = b"\x02"


def _point_bytes(pt) -> bytes:
    """Compressed G1: 32 bytes, x LE, y-parity in bit 255; identity = zeros."""
    if pt is None:
        return b"\x00" * 32
    raw = bytearray(pt[0].to_bytes(32, "little"))
    if pt[1] & 1:
        raw[31] |= 0x80
    return bytes(raw)


def _point_from_bytes(raw: bytes):
    """Decompress + validate; raises on non-canonical or off-curve input."""
    if raw == b"\x00" * 32:
        return None
    q = FQ_BN254.p
    sign = (raw[31] >> 7) & 1
    x = int.from_bytes(raw[:31] + bytes([raw[31] & 0x7F]), "little")
    if x >= q:
        raise ValueError("transcript: non-canonical point coordinate")
    rhs = (x * x * x + 3) % q
    y = pow(rhs, (q + 1) // 4, q)  # q ≡ 3 (mod 4)
    if y * y % q != rhs:
        raise ValueError("transcript: point not on curve")
    if (y & 1) != sign:
        y = q - y
    return (x, y)


class Blake2bWrite:
    """Prover transcript: absorbs messages, accumulates the proof bytes."""

    def __init__(self):
        self._state = hashlib.blake2b(person=_PERSONAL)
        self._proof = bytearray()

    # --- absorb without writing (for instance/vk commitments) ---
    def common_point(self, pt) -> None:
        self._state.update(_PREFIX_POINT + _point_bytes(pt))

    def common_scalar(self, s: int) -> None:
        self._state.update(_PREFIX_SCALAR + int(s % FR_BN254.p).to_bytes(32, "little"))

    def common_bytes(self, b: bytes) -> None:
        self._state.update(b)

    # --- absorb + write into proof ---
    def write_point(self, pt) -> None:
        self.common_point(pt)
        self._proof += _point_bytes(pt)

    def write_scalar(self, s: int) -> None:
        self.common_scalar(s)
        self._proof += int(s % FR_BN254.p).to_bytes(32, "little")

    def squeeze_challenge(self) -> int:
        """Challenge255-style squeeze: 64 uniform bytes -> Fr."""
        self._state.update(_PREFIX_CHALLENGE)
        digest = self._state.copy().digest()  # 64 bytes
        self._state.update(digest)
        return int.from_bytes(digest, "little") % FR_BN254.p

    def finalize(self) -> bytes:
        return bytes(self._proof)


class Blake2bRead:
    """Verifier transcript: reads the proof stream, re-deriving challenges."""

    def __init__(self, proof: bytes):
        self._state = hashlib.blake2b(person=_PERSONAL)
        self._proof = proof
        self._pos = 0

    def common_point(self, pt) -> None:
        self._state.update(_PREFIX_POINT + _point_bytes(pt))

    def common_scalar(self, s: int) -> None:
        self._state.update(_PREFIX_SCALAR + int(s % FR_BN254.p).to_bytes(32, "little"))

    def common_bytes(self, b: bytes) -> None:
        self._state.update(b)

    def read_point(self):
        """Read a compressed G1 point; REJECTS non-canonical coordinates and
        off-curve points (halo2curves deserialization always curve-checks;
        accepting arbitrary bytes here would let a prover smuggle invalid
        group elements into the pairing check)."""
        raw = self._proof[self._pos : self._pos + 32]
        if len(raw) < 32:
            raise ValueError("transcript: unexpected end of proof")
        self._pos += 32
        pt = _point_from_bytes(raw)
        self.common_point(pt)
        return pt

    def read_scalar(self) -> int:
        raw = self._proof[self._pos : self._pos + 32]
        if len(raw) < 32:
            raise ValueError("transcript: unexpected end of proof")
        self._pos += 32
        s = int.from_bytes(raw, "little") % FR_BN254.p
        self.common_scalar(s)
        return s

    def squeeze_challenge(self) -> int:
        self._state.update(_PREFIX_CHALLENGE)
        digest = self._state.copy().digest()
        self._state.update(digest)
        return int.from_bytes(digest, "little") % FR_BN254.p

    def at_end(self) -> bool:
        return self._pos == len(self._proof)
