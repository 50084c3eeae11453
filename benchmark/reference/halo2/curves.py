"""Host-side exact elliptic-curve arithmetic (short Weierstrass y^2 = x^3 + b).

Plays the role of `halo2curves-axiom`'s curve implementations for witness
generation and test oracles: bn254 G1/G2 and secp256k1. Points are affine
tuples of canonical ints; `None` is the point at infinity. G2 coordinates are
Fq2 elements represented as pairs (c0, c1) with u^2 = -1.
"""

from __future__ import annotations

import random

from .fields import (
    BN254_B,
    BN254_G1_GENERATOR,
    BN254_G2_GENERATOR,
    FQ_BN254,
    FP_SECP256K1,
    FQ_SECP256K1,
    FR_BN254,
    SECP_B,
    SECP_G,
    PrimeField,
)

Point = tuple[int, int] | None


class ShortWeierstrass:
    """y^2 = x^3 + b over `base` with scalar field `scalar` and generator `g`."""

    def __init__(self, base: PrimeField, scalar: PrimeField, b: int, g: tuple[int, int], name: str):
        self.base = base
        self.scalar = scalar
        self.b = b
        self.g = g
        self.name = name

    def is_on_curve(self, pt: Point) -> bool:
        if pt is None:
            return True
        x, y = pt
        F = self.base
        return F.sub(F.mul(y, y), F.add(F.mul(F.mul(x, x), x), self.b)) == 0

    def neg(self, pt: Point) -> Point:
        if pt is None:
            return None
        x, y = pt
        return (x, self.base.neg(y))

    def add(self, p: Point, q: Point) -> Point:
        if p is None:
            return q
        if q is None:
            return p
        F = self.base
        x1, y1 = p
        x2, y2 = q
        if x1 == x2:
            if (y1 + y2) % F.p == 0:
                return None
            lam = F.div(F.mul(3, F.mul(x1, x1)), F.mul(2, y1))
        else:
            lam = F.div(F.sub(y2, y1), F.sub(x2, x1))
        x3 = F.sub(F.sub(F.mul(lam, lam), x1), x2)
        y3 = F.sub(F.mul(lam, F.sub(x1, x3)), y1)
        return (x3, y3)

    def double(self, p: Point) -> Point:
        return self.add(p, p)

    def mul(self, p: Point, k: int) -> Point:
        k %= self.scalar.p
        acc: Point = None
        add = p
        while k:
            if k & 1:
                acc = self.add(acc, add)
            add = self.add(add, add)
            k >>= 1
        return acc

    def msm(self, points: list[Point], scalars: list[int]) -> Point:
        acc: Point = None
        for p, s in zip(points, scalars):
            acc = self.add(acc, self.mul(p, s))
        return acc

    def random_point(self, rng: random.Random) -> tuple[int, int]:
        """Uniform-ish point via try-and-increment on a random x."""
        F = self.base
        while True:
            x = rng.randrange(F.p)
            y2 = F.add(F.mul(F.mul(x, x), x), self.b)
            y = F.sqrt(y2)
            if y is not None:
                if rng.randrange(2):
                    y = F.neg(y)
                return (x, y)

    def random_scalar(self, rng: random.Random) -> int:
        return rng.randrange(self.scalar.p)


BN254_G1 = ShortWeierstrass(FQ_BN254, FR_BN254, BN254_B, BN254_G1_GENERATOR, "bn254::G1")
SECP256K1 = ShortWeierstrass(FP_SECP256K1, FQ_SECP256K1, SECP_B, SECP_G, "secp256k1")


# ---------------------------------------------------------------------------
# Fq2 and bn254 G2 (for pairing inputs and [tau]G2 in the KZG SRS)
# ---------------------------------------------------------------------------

class Fq2:
    """Fq[u]/(u^2 + 1) arithmetic on (c0, c1) pairs of canonical ints."""

    def __init__(self, base: PrimeField):
        self.F = base
        self.zero = (0, 0)
        self.one = (1, 0)

    def add(self, a, b):
        F = self.F
        return (F.add(a[0], b[0]), F.add(a[1], b[1]))

    def sub(self, a, b):
        F = self.F
        return (F.sub(a[0], b[0]), F.sub(a[1], b[1]))

    def neg(self, a):
        F = self.F
        return (F.neg(a[0]), F.neg(a[1]))

    def mul(self, a, b):
        F = self.F
        t0 = F.mul(a[0], b[0])
        t1 = F.mul(a[1], b[1])
        # (a0 b0 - a1 b1, a0 b1 + a1 b0)
        c0 = F.sub(t0, t1)
        c1 = F.sub(F.sub(F.mul(F.add(a[0], a[1]), F.add(b[0], b[1])), t0), t1)
        return (c0, c1)

    def square(self, a):
        return self.mul(a, a)

    def scalar_mul(self, a, k: int):
        F = self.F
        k = k % F.p
        return (F.mul(a[0], k), F.mul(a[1], k))

    def inv(self, a):
        F = self.F
        norm = F.add(F.mul(a[0], a[0]), F.mul(a[1], a[1]))
        ninv = F.inv(norm)
        return (F.mul(a[0], ninv), F.neg(F.mul(a[1], ninv)))

    def conjugate(self, a):
        return (a[0], self.F.neg(a[1]))

    def is_zero(self, a) -> bool:
        return a == (0, 0)

    def pow(self, a, e: int):
        acc = self.one
        base = a
        while e:
            if e & 1:
                acc = self.mul(acc, base)
            base = self.mul(base, base)
            e >>= 1
        return acc


FQ2_BN254 = Fq2(FQ_BN254)

# b coefficient of the D-twist curve E': y^2 = x^3 + b/(9+u) over Fq2
BN254_G2_B = FQ2_BN254.mul((BN254_B, 0), FQ2_BN254.inv((9, 1)))


class G2Curve:
    """bn254 G2: y^2 = x^3 + 3/(9+u) over Fq2. Points are ((x0,x1),(y0,y1)) or None."""

    def __init__(self):
        self.fq2 = FQ2_BN254
        self.b = BN254_G2_B
        self.g = BN254_G2_GENERATOR
        self.scalar = FR_BN254

    def is_on_curve(self, pt) -> bool:
        if pt is None:
            return True
        x, y = pt
        f = self.fq2
        return f.sub(f.square(y), f.add(f.mul(f.square(x), x), self.b)) == (0, 0)

    def neg(self, pt):
        if pt is None:
            return None
        return (pt[0], self.fq2.neg(pt[1]))

    def add(self, p, q):
        if p is None:
            return q
        if q is None:
            return p
        f = self.fq2
        x1, y1 = p
        x2, y2 = q
        if x1 == x2:
            if f.add(y1, y2) == (0, 0):
                return None
            lam = f.mul(f.scalar_mul(f.square(x1), 3), f.inv(f.scalar_mul(y1, 2)))
        else:
            lam = f.mul(f.sub(y2, y1), f.inv(f.sub(x2, x1)))
        x3 = f.sub(f.sub(f.square(lam), x1), x2)
        y3 = f.sub(f.mul(lam, f.sub(x1, x3)), y1)
        return (x3, y3)

    def mul(self, p, k: int):
        k %= self.scalar.p
        acc = None
        add = p
        while k:
            if k & 1:
                acc = self.add(acc, add)
            add = self.add(add, add)
            k >>= 1
        return acc


BN254_G2 = G2Curve()
