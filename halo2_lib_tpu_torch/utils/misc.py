"""Limb decomposition and bit utilities.

Mirrors the semantics of halo2-base/src/utils/mod.rs:155-171 (`decompose`,
`decompose_fe_to_u64_limbs`, `bit_length`, `log2_ceil`). Values are Python ints.
"""

from __future__ import annotations


def bit_length(x: int) -> int:
    """Number of bits needed to represent x (reference: utils/mod.rs `bit_length`)."""
    return max(1, int(x).bit_length()) if x else 1


def log2_ceil(x: int) -> int:
    assert x > 0
    return (x - 1).bit_length()


def decompose_int(e: int, number_of_limbs: int, bit_len: int) -> list[int]:
    """Little-endian base-2^bit_len limbs of e, padded/truncated to number_of_limbs.

    Matches `decompose_biguint` / `decompose_u64_digits_to_limbs` in the
    reference (utils/mod.rs): limb i = (e >> (i*bit_len)) & (2^bit_len - 1).
    """
    mask = (1 << bit_len) - 1
    out = []
    for _ in range(number_of_limbs):
        out.append(e & mask)
        e >>= bit_len  # progressive shift: each step shrinks the bignum
    return out


def decompose_fe(value: int, number_of_limbs: int, bit_len: int) -> list[int]:
    """Decompose a field element (canonical int value) into limbs."""
    return decompose_int(value, number_of_limbs, bit_len)


def decompose_fe_to_u64_limbs(value: int, number_of_limbs: int, bit_len: int) -> list[int]:
    """Same as decompose_fe but asserts bit_len <= 64 like the reference."""
    assert bit_len <= 64
    return decompose_int(value, number_of_limbs, bit_len)


def compose_int(limbs: list[int], bit_len: int) -> int:
    """Inverse of decompose_int."""
    acc = 0
    for i, l in enumerate(limbs):
        acc |= int(l) << (i * bit_len)
    return acc
