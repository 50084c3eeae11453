"""The work a call needs, counted from its shapes.

Field products are products in a 254-bit prime field (bn254's Fq for curve
arithmetic, Fr for transforms); squarings count as products. Bytes are
each input read once and each output written once, at 32 bytes a field
element and 64 an affine point, whatever layout the program keeps.

Curve additions follow the Explicit-Formulas Database
(https://hyperelliptic.org/EFD/g1p/auto-shortw-jacobian-0.html, a = 0):
madd-2007-bl, a Jacobian point plus an affine one, 7M + 4S; add-2007-bl,
two Jacobian points, 11M + 5S; dbl-2009-l, 2M + 5S.
"""

from __future__ import annotations

from dataclasses import dataclass

from .peaks import HBM_BYTES_PER_S, INT_MULS_PER_FIELD_PRODUCT, INT_MULS_PER_S

SCALAR_BITS = 254
FIELD_BYTES = 32
AFFINE_BYTES = 64

MIXED_ADD_PRODUCTS = 7 + 4
FULL_ADD_PRODUCTS = 11 + 5
DOUBLE_PRODUCTS = 2 + 5


@dataclass(frozen=True)
class Work:
    products: int
    bytes: int

    def __add__(self, other: "Work") -> "Work":
        return Work(self.products + other.products, self.bytes + other.bytes)

    def __mul__(self, times: int) -> "Work":
        return Work(self.products * times, self.bytes * times)


def pippenger_window(m: int) -> int:
    """The window c of the reference Pippenger: the one that minimises
    ceil(254 / c) * (m + 2^(c + 1)) additions (the smallest such c)."""
    return min(range(1, 32), key=lambda c: (-(-SCALAR_BITS // c) * (m + (1 << (c + 1))), c))


def msm_work(columns: int, points: int) -> Work:
    """C MSMs of m points against one set of m affine bases. Per column and
    window: m mixed additions into the buckets, 2^(c+1) Jacobian additions
    to sum the buckets by running sums; then 254 doublings and one
    addition a window to combine the windows. Bytes: the bases once, every
    scalar, every result point."""
    c = pippenger_window(points)
    windows = -(-SCALAR_BITS // c)
    per_column = (windows * (points * MIXED_ADD_PRODUCTS + (1 << (c + 1)) * FULL_ADD_PRODUCTS)
                  + SCALAR_BITS * DOUBLE_PRODUCTS + windows * FULL_ADD_PRODUCTS)
    nbytes = points * AFFINE_BYTES + columns * points * FIELD_BYTES + columns * AFFINE_BYTES
    return Work(columns * per_column, nbytes)


def ntt_work(columns: int, log_n: int) -> Work:
    """C transforms of n = 2^log_n points, forward or inverse: (n / 2)
    log2 n butterfly products a column (the inverse's 1/n folds into its
    twiddles); every element read once and written once."""
    n = 1 << log_n
    return Work(columns * (n // 2) * log_n, 2 * columns * n * FIELD_BYTES)


def roofline_s(work: Work) -> float:
    """The least time the card could take for `work`: products at the
    integer multiply rate or bytes at the memory bandwidth, the larger."""
    return max(work.products * INT_MULS_PER_FIELD_PRODUCT / INT_MULS_PER_S,
               work.bytes / HBM_BYTES_PER_S)


def bound_by(work: Work) -> str:
    """Which of the two rates bounds `work`: "products" or "bytes"."""
    compute = work.products * INT_MULS_PER_FIELD_PRODUCT / INT_MULS_PER_S
    return "products" if compute >= work.bytes / HBM_BYTES_PER_S else "bytes"
