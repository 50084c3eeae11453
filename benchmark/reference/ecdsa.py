"""secp256k1 ECDSA keys and signatures for the benchmark's requests.

Each signature has its own key, message hash and nonce, drawn from a
generator seeded by the run's seed; the same seed gives the same pool.
"""

from __future__ import annotations

import random

from .halo2.curves import SECP256K1


def sign(priv: int, msghash: int, nonce: int) -> tuple[int, int]:
    n = SECP256K1.scalar.p
    r = SECP256K1.mul(SECP256K1.g, nonce)[0] % n
    s = pow(nonce, -1, n) * (msghash + r * priv) % n
    return r, s


def verify(pub, msghash: int, r: int, s: int) -> bool:
    n = SECP256K1.scalar.p
    if not (0 < r < n and 0 < s < n):
        return False
    si = pow(s, -1, n)
    pt = SECP256K1.add(SECP256K1.mul(SECP256K1.g, msghash * si % n), SECP256K1.mul(pub, r * si % n))
    return pt is not None and pt[0] % n == r


def signatures(seed: int, count: int) -> list[tuple]:
    """`count` (pubkey, r, s, msghash) tuples drawn from `seed`."""
    rng = random.Random(f"ecdsa-requests:{seed}")
    n = SECP256K1.scalar.p
    out = []
    while len(out) < count:
        priv, msghash, nonce = (rng.randrange(1, n) for _ in range(3))
        r, s = sign(priv, msghash, nonce)
        if r and s:
            out.append((SECP256K1.mul(SECP256K1.g, priv), r, s, msghash))
    return out
