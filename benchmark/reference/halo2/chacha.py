"""ChaCha20 keystream RNG — byte-compatible with Rust's `rand_chacha`.

The reference generates its KZG SRS from `ChaCha20Rng::from_seed([0u8; 32])`
(halo2-base `src/utils/mod.rs:441`, `testing.rs:38-49`). To let
a cross-check against a Rust-generated SRS succeed, `tau` must come from the
same RNG stream. `rand_chacha`'s `ChaCha20Rng::from_seed(seed)` produces the
raw ChaCha20 keystream for key = seed, 64-bit block counter starting at 0 and
96-bit nonce/stream = 0, emitting each 64-byte block's words little-endian —
i.e. exactly the RFC 8439 keystream with the IETF 32-bit counter replaced by
rand_chacha's 64-bit counter (identical for the first 2^32 blocks).

Validated against the RFC 8439 §2.3.2 block-function test vector
(tests/test_chacha.py).
"""

from __future__ import annotations

import struct


def _rotl(x: int, r: int) -> int:
    x &= 0xFFFFFFFF
    return ((x << r) | (x >> (32 - r))) & 0xFFFFFFFF


def _quarter(state: list[int], a: int, b: int, c: int, d: int) -> None:
    state[a] = (state[a] + state[b]) & 0xFFFFFFFF
    state[d] = _rotl(state[d] ^ state[a], 16)
    state[c] = (state[c] + state[d]) & 0xFFFFFFFF
    state[b] = _rotl(state[b] ^ state[c], 12)
    state[a] = (state[a] + state[b]) & 0xFFFFFFFF
    state[d] = _rotl(state[d] ^ state[a], 8)
    state[c] = (state[c] + state[d]) & 0xFFFFFFFF
    state[b] = _rotl(state[b] ^ state[c], 7)


_SIGMA = struct.unpack("<4I", b"expand 32-byte k")


def chacha20_block(key: bytes, counter: int, nonce: bytes) -> bytes:
    """One 64-byte ChaCha20 block (RFC 8439 block function; 32-bit counter)."""
    assert len(key) == 32 and len(nonce) == 12
    state = list(_SIGMA) + list(struct.unpack("<8I", key)) + [counter & 0xFFFFFFFF] + list(
        struct.unpack("<3I", nonce)
    )
    ws = list(state)
    for _ in range(10):
        _quarter(ws, 0, 4, 8, 12)
        _quarter(ws, 1, 5, 9, 13)
        _quarter(ws, 2, 6, 10, 14)
        _quarter(ws, 3, 7, 11, 15)
        _quarter(ws, 0, 5, 10, 15)
        _quarter(ws, 1, 6, 11, 12)
        _quarter(ws, 2, 7, 8, 13)
        _quarter(ws, 3, 4, 9, 14)
    return struct.pack("<16I", *((w + s) & 0xFFFFFFFF for w, s in zip(ws, state)))


def _block64(key: bytes, counter64: int) -> bytes:
    """rand_chacha layout: 64-bit counter occupying state words 12-13, the
    96-bit IETF nonce reduced to 64 bits of stream id in words 14-15 (zero)."""
    lo = counter64 & 0xFFFFFFFF
    hi = (counter64 >> 32) & 0xFFFFFFFF
    nonce = struct.pack("<3I", hi, 0, 0)
    return chacha20_block(key, lo, nonce)


class ChaCha20Rng:
    """`rand_chacha::ChaCha20Rng` twin: fill_bytes streams the keystream."""

    def __init__(self, seed: bytes = b"\x00" * 32):
        assert len(seed) == 32
        self.key = bytes(seed)
        self.counter = 0
        self._buf = b""

    def fill_bytes(self, n: int) -> bytes:
        while len(self._buf) < n:
            self._buf += _block64(self.key, self.counter)
            self.counter += 1
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def next_u32(self) -> int:
        return int.from_bytes(self.fill_bytes(4), "little")

    def next_u64(self) -> int:
        return int.from_bytes(self.fill_bytes(8), "little")


def fr_random(rng: ChaCha20Rng, p: int) -> int:
    """`ff::Field::random`: 64 uniform bytes -> little-endian int mod p
    (halo2curves Fr's `FromUniformBytes<64>`)."""
    return int.from_bytes(rng.fill_bytes(64), "little") % p


def reference_srs_tau(k: int | None = None) -> int:
    """tau drawn exactly as `ParamsKZG::<Bn256>::setup(k, ChaCha20Rng::from_seed(Default))`
    draws it (one Fr::random from the zero seed; independent of k)."""
    from .fields import FR_BN254

    return fr_random(ChaCha20Rng(), FR_BN254.p)
