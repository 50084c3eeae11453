"""Host-side BN254 optimal-Ate pairing (exact big-int arithmetic).

Plays the role of halo2curves' `bn256::pairing` for (a) the KZG verifier's
final pairing check and (b) the ground-truth oracle for the in-circuit
PairingChip (halo2-ecc/src/bn254/pairing.rs). Fq12 is represented as the
polynomial ring Fq[w]/(w^12 - 18 w^6 + 82), which is Fq2[w]/(w^6 - (9+u))
with u = w^6 - 9 — the same tower as the reference, flattened.
"""

from __future__ import annotations

from .fields import BN254_FQ_MODULUS, BN254_FR_MODULUS, BN254_X

P = BN254_FQ_MODULUS
R = BN254_FR_MODULUS

# w^12 = 18 w^6 - 82  (since (w^6 - 9)^2 = -1)
_MOD_COEFFS = (82, 0, 0, 0, 0, 0, -18, 0, 0, 0, 0, 0)

# optimal ate loop count: 6x + 2
ATE_LOOP_COUNT = 6 * BN254_X + 2


class Fq12:
    """Element of Fq[w]/(w^12 - 18w^6 + 82); coeffs little-endian, len 12."""

    __slots__ = ("c",)

    def __init__(self, coeffs):
        assert len(coeffs) == 12
        self.c = tuple(x % P for x in coeffs)

    @staticmethod
    def one() -> "Fq12":
        return Fq12((1,) + (0,) * 11)

    @staticmethod
    def zero() -> "Fq12":
        return Fq12((0,) * 12)

    @staticmethod
    def from_fq2(coeffs2: list[tuple[int, int]]) -> "Fq12":
        """From 6 Fq2 coefficients c_i of sum c_i w^i with u = w^6 - 9:
        c0 + c1*u -> (c0 - 9*c1) + c1 * w^6."""
        out = [0] * 12
        for i, (a0, a1) in enumerate(coeffs2):
            out[i] = (out[i] + a0 - 9 * a1) % P
            out[i + 6] = (out[i + 6] + a1) % P
        return Fq12(out)

    def to_fq2(self) -> list[tuple[int, int]]:
        """Inverse of from_fq2: 6 Fq2 coeffs (c0, c1) with w^i and w^(i+6)=u·w^i+9·w^i."""
        return [((self.c[i] + 9 * self.c[i + 6]) % P, self.c[i + 6]) for i in range(6)]

    def __eq__(self, other):
        return self.c == other.c

    def __add__(self, other):
        return Fq12([a + b for a, b in zip(self.c, other.c)])

    def __sub__(self, other):
        return Fq12([a - b for a, b in zip(self.c, other.c)])

    def __neg__(self):
        return Fq12([-a for a in self.c])

    def scalar_mul(self, k: int) -> "Fq12":
        return Fq12([a * k for a in self.c])

    def __mul__(self, other):
        b = [0] * 23
        sc, oc = self.c, other.c
        for i in range(12):
            si = sc[i]
            if si:
                for j in range(12):
                    b[i + j] += si * oc[j]
        for exp in range(22, 11, -1):
            top = b[exp] % P
            if top:
                b[exp - 6] += top * 18
                b[exp - 12] -= top * 82
            b[exp] = 0
        return Fq12(b[:12])

    def square(self) -> "Fq12":
        return self * self

    def inv(self) -> "Fq12":
        """Extended Euclid over the polynomial ring."""
        lm, hm = [1] + [0] * 12, [0] * 13
        low = list(self.c) + [0]
        high = [-c for c in _MOD_COEFFS] + [1]  # monic modulus poly: w^12 - 18w^6 + 82 -> stored as its coeffs
        # high = modulus polynomial coefficients (deg 12)
        high = [82, 0, 0, 0, 0, 0, -18, 0, 0, 0, 0, 0, 1]

        def deg(p):
            d = len(p) - 1
            while d and p[d] % P == 0:
                d -= 1
            return d

        def poly_rounded_div(a, b):
            dega, degb = deg(a), deg(b)
            temp = [x for x in a]
            o = [0] * len(a)
            for i in range(dega - degb, -1, -1):
                o[i] += temp[degb + i] * pow(b[degb], -1, P)
                for c in range(degb + 1):
                    temp[c + i] -= o[c]
            return [x % P for x in o[: deg(o) + 1]]

        while deg(low):
            r = poly_rounded_div(high, low)
            r += [0] * (13 - len(r))
            nm = [x for x in hm]
            new = [x for x in high]
            for i in range(13):
                for j in range(13 - i):
                    nm[i + j] -= lm[i] * r[j]
                    new[i + j] -= low[i] * r[j]
            nm = [x % P for x in nm]
            new = [x % P for x in new]
            lm, low, hm, high = nm, new, lm, low
        inv_low0 = pow(low[0], -1, P)
        return Fq12([c * inv_low0 for c in lm[:12]])

    def pow(self, e: int) -> "Fq12":
        result = Fq12.one()
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def frobenius(self) -> "Fq12":
        """x -> x^p."""
        return self.pow(P)  # slow fallback; fine for host oracle use

    def conjugate(self) -> "Fq12":
        """Negate odd w^6-degree parts in the Fq6[w]/(w^2 - v) view = x^(p^6)."""
        c2 = self.to_fq2()
        out = []
        for i, coef in enumerate(c2):
            # in Fq12 = Fq6 + Fq6*w, conjugation negates the odd-w part: w^1, w^3, w^5
            out.append(((-coef[0]) % P, (-coef[1]) % P) if i % 2 == 1 else coef)
        return Fq12.from_fq2(out)


# the Fq12 element w (generator of the tower over Fq2)
W = Fq12((0, 1) + (0,) * 10)
W2 = W * W
W3 = W2 * W


def _fq2_list_mul(a, b):
    """Fq2 multiply on (c0, c1) pairs, u^2 = -1."""
    t0 = a[0] * b[0] % P
    t1 = a[1] * b[1] % P
    c0 = (t0 - t1) % P
    c1 = ((a[0] + a[1]) * (b[0] + b[1]) - t0 - t1) % P
    return (c0, c1)


def untwist(pt):
    """G2 point over Fq2 -> point over Fq12 on the untwisted curve y^2 = x^3 + 3.

    D-twist Psi(x, y) = (x * w^2, y * w^3) composed with the u = w^6 - 9
    embedding (same mapping as the reference's `Psi`, bn254/pairing.rs:20-23).
    """
    if pt is None:
        return None
    (x0, x1), (y0, y1) = pt
    nx = Fq12.from_fq2([(x0, x1), (0, 0), (0, 0), (0, 0), (0, 0), (0, 0)])
    ny = Fq12.from_fq2([(y0, y1), (0, 0), (0, 0), (0, 0), (0, 0), (0, 0)])
    return (nx * W2, ny * W3)


def cast_g1(pt):
    """G1 point (ints) -> Fq12 coordinates."""
    if pt is None:
        return None
    x, y = pt
    return (Fq12((x,) + (0,) * 11), Fq12((y,) + (0,) * 11))


def _line_func(p1, p2, t):
    """Evaluate the line through p1, p2 at t (all over Fq12)."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1.c != x2.c:
        m = (y2 - y1) * (x2 - x1).inv()
        return m * (xt - x1) - (yt - y1)
    elif y1.c == y2.c:
        m = x1.square().scalar_mul(3) * y1.scalar_mul(2).inv()
        return m * (xt - x1) - (yt - y1)
    else:
        return xt - x1


def _ec_double_fq12(pt):
    x, y = pt
    m = x.square().scalar_mul(3) * y.scalar_mul(2).inv()
    nx = m.square() - x.scalar_mul(2)
    ny = -(m * nx) + m * x - y
    return (nx, ny)


def _ec_add_fq12(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1.c == x2.c and y1.c == y2.c:
        return _ec_double_fq12(p1)
    if x1.c == x2.c:
        return None
    m = (y2 - y1) * (x2 - x1).inv()
    nx = m.square() - x1 - x2
    ny = -(m * nx) + m * x1 - y1
    return (nx, ny)


def miller_loop(Q, Pt) -> Fq12:
    """Optimal ate Miller loop: Q untwisted G2 over Fq12, Pt cast G1.

    Loop over bits of 6x+2 plus the two Frobenius line corrections
    (cf. multi_miller_loop in halo2curves / pairing.rs:298-392).
    """
    if Q is None or Pt is None:
        return Fq12.one()
    Rpt = Q
    f = Fq12.one()
    # iterate MSB-first (skip leading 1)
    bits = bin(ATE_LOOP_COUNT)[2:]
    for bit in bits[1:]:
        f = f.square() * _line_func(Rpt, Rpt, Pt)
        Rpt = _ec_double_fq12(Rpt)
        if bit == "1":
            f = f * _line_func(Rpt, Q, Pt)
            Rpt = _ec_add_fq12(Rpt, Q)
    # Frobenius corrections: Q1 = pi_p(Q), nQ2 = -pi_p^2(Q)
    Q1 = (Q[0].pow(P), Q[1].pow(P))
    nQ2 = (Q1[0].pow(P), -(Q1[1].pow(P)))
    f = f * _line_func(Rpt, Q1, Pt)
    Rpt = _ec_add_fq12(Rpt, Q1)
    f = f * _line_func(Rpt, nQ2, Pt)
    return f


def final_exponentiation(f: Fq12) -> Fq12:
    """f^((p^12 - 1) / r)."""
    return f.pow((P**12 - 1) // R)


def pairing(g1_pt, g2_pt) -> Fq12:
    """e(P, Q) for P in G1 (int pair), Q in G2 (Fq2-pair pair)."""
    return final_exponentiation(miller_loop(untwist(g2_pt), cast_g1(g1_pt)))


def multi_miller_loop(pairs) -> Fq12:
    """Product of miller loops for (G1, G2) pairs (before final exp)."""
    f = Fq12.one()
    for g1_pt, g2_pt in pairs:
        if g1_pt is None or g2_pt is None:
            continue
        f = f * miller_loop(untwist(g2_pt), cast_g1(g1_pt))
    return f


def pairing_check(pairs) -> bool:
    """prod e(P_i, Q_i) == 1."""
    return final_exponentiation(multi_miller_loop(pairs)) == Fq12.one()
