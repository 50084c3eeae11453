"""Exact dot products of 16-bit limb tensors with weights, mod a prime.

A limb tensor holds an element as sixteen 16-bit limbs, low first, along
one axis (the layout the program's tensors use); ``limb_dot`` multiplies
limb by limb in float64, where every product and every partial sum of at
most 2^20 of them stays below 2^53 and so is exact, and assembles the
512-bit result from the 16 x 16 partial sums with Python ints.
"""

from __future__ import annotations

import numpy as np

LIMBS = 16
LIMB_BITS = 16
CHUNK = 1 << 20  # 2^20 products of 16-bit limbs sum to less than 2^52


def limbs_to_ints(limbs: np.ndarray) -> list[int]:
    """[..., 16] limbs (any integer dtype, each below 2^16) -> Python ints."""
    raw = np.ascontiguousarray(limbs.reshape(-1, LIMBS).astype("<u2")).tobytes()
    return [int.from_bytes(raw[i : i + 32], "little") for i in range(0, len(raw), 32)]


def limb_dot(x_limbs: np.ndarray, w_limbs: np.ndarray, p: int) -> list[int]:
    """sum_i x_i w_i mod p for each row of x.

    x_limbs: [C, 16, m] limbs (each below 2^16) of C vectors of m elements;
    w_limbs: [m, 16] float64 limbs of the weights. Returns C ints."""
    C, L, m = x_limbs.shape
    assert L == LIMBS and w_limbs.shape == (m, LIMBS)
    acc = np.zeros((C, LIMBS, LIMBS), dtype=np.int64)
    for lo in range(0, m, CHUNK):
        hi = min(m, lo + CHUNK)
        xs = x_limbs[:, :, lo:hi].astype(np.float64)
        acc += np.matmul(xs, w_limbs[lo:hi]).astype(np.int64)
    out = []
    for c in range(C):
        total = 0
        for a in range(LIMBS):
            for b in range(LIMBS):
                total += int(acc[c, a, b]) << (LIMB_BITS * (a + b))
        out.append(total % p)
    return out
