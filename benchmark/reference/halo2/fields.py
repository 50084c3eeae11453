"""Prime-field descriptors (host side, exact big-int arithmetic).

Equivalent of the reference's ``ScalarField``/``BigPrimeField`` traits
(halo2-base/src/utils/mod.rs:19-84): a field is described by its modulus plus
cached constants (2-adicity, multiplicative generator, root of unity). Values
are plain Python ints in ``[0, p)``; arithmetic goes through the descriptor.

The TPU (device) representation of the same fields — 16x16-bit limb tensors in
Montgomery form — lives in ``halo2_lib_tpu_torch.ops.limbs``; this module is the
host-side source of truth both for witness generation and for test oracles.
"""

from __future__ import annotations

from functools import lru_cache


class PrimeField:
    """Descriptor for a prime field GF(p). All element values are ints in [0, p)."""

    __slots__ = ("p", "name", "num_bits", "capacity", "s", "generator", "_root_of_unity")

    def __init__(self, p: int, name: str, generator: int | None = None):
        self.p = p
        self.name = name
        self.num_bits = p.bit_length()
        # Max bits for an element guaranteed to be < p (ScalarField::CAPACITY).
        self.capacity = self.num_bits - 1
        # 2-adicity: largest s with 2^s | p - 1.
        s = 0
        t = p - 1
        while t % 2 == 0:
            s += 1
            t //= 2
        self.s = s
        self.generator = generator
        self._root_of_unity = None

    # --- arithmetic -------------------------------------------------------
    def add(self, a: int, b: int) -> int:
        c = a + b
        return c - self.p if c >= self.p else c

    def sub(self, a: int, b: int) -> int:
        c = a - b
        return c + self.p if c < 0 else c

    def neg(self, a: int) -> int:
        return (self.p - a) if a else 0

    def mul(self, a: int, b: int) -> int:
        return a * b % self.p

    def square(self, a: int) -> int:
        return a * a % self.p

    def inv(self, a: int) -> int:
        if a == 0:
            raise ZeroDivisionError(f"inverse of 0 in {self.name}")
        return pow(a, -1, self.p)

    def div(self, a: int, b: int) -> int:
        return a * self.inv(b) % self.p

    def pow(self, a: int, e: int) -> int:
        return pow(a, e, self.p)

    def from_int(self, x: int) -> int:
        return x % self.p

    def sqrt(self, a: int) -> int | None:
        """Tonelli-Shanks square root; returns None if `a` is a non-residue."""
        p = self.p
        if a == 0:
            return 0
        if pow(a, (p - 1) // 2, p) != 1:
            return None
        if p % 4 == 3:
            return pow(a, (p + 1) // 4, p)
        # general Tonelli-Shanks
        s, q = self.s, (p - 1) >> self.s
        z = 2
        while pow(z, (p - 1) // 2, p) != p - 1:
            z += 1
        m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
        while t != 1:
            i, t2 = 0, t
            while t2 != 1:
                t2 = t2 * t2 % p
                i += 1
            b = pow(c, 1 << (m - i - 1), p)
            m, c = i, b * b % p
            t, r = t * c % p, r * b % p
        return r

    # --- constants --------------------------------------------------------
    def root_of_unity(self) -> int:
        """Primitive 2^s-th root of unity (for the NTT domain)."""
        if self._root_of_unity is None:
            assert self.generator is not None, f"{self.name}: no generator configured"
            self._root_of_unity = pow(self.generator, (self.p - 1) >> self.s, self.p)
        return self._root_of_unity

    @lru_cache(maxsize=64)
    def nth_root_of_unity(self, log_n: int) -> int:
        """Primitive 2^log_n-th root of unity."""
        assert log_n <= self.s, f"{self.name}: 2^{log_n} does not divide p-1"
        return pow(self.root_of_unity(), 1 << (self.s - log_n), self.p)

    # --- serialization (matches halo2curves: LE bytes of canonical value) --
    def to_bytes(self, a: int, length: int | None = None) -> bytes:
        n = length or (self.num_bits + 7) // 8
        return int(a).to_bytes(n, "little")

    def from_bytes(self, b: bytes) -> int:
        return int.from_bytes(b, "little") % self.p

    def random(self, rng) -> int:
        """Uniform element from a python `random.Random`-like rng."""
        return rng.randrange(self.p)

    def __repr__(self):
        return f"PrimeField({self.name})"

    def __hash__(self):
        return hash((self.p, self.name))

    def __eq__(self, other):
        return isinstance(other, PrimeField) and self.p == other.p


# ---------------------------------------------------------------------------
# BN254 (alt_bn128). Matches halo2curves-axiom `bn256` module.
# Fq = base field (coordinates of G1), Fr = scalar field (circuit native field).
# ---------------------------------------------------------------------------
BN254_FQ_MODULUS = 21888242871839275222246405745257275088696311157297823662689037894645226208583
BN254_FR_MODULUS = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# Multiplicative generators as in halo2curves: Fr::GENERATOR = 7, Fq::GENERATOR = 3.
FR_BN254 = PrimeField(BN254_FR_MODULUS, "bn254::Fr", generator=7)
FQ_BN254 = PrimeField(BN254_FQ_MODULUS, "bn254::Fq", generator=3)

# BN254 curve: y^2 = x^3 + 3 over Fq; G2 over Fq2 = Fq[u]/(u^2+1), b2 = 3/(9+u).
BN254_B = 3
BN254_G1_GENERATOR = (1, 2)
# Fq2 non-residue used for Fq12 tower: w^6 = 9 + u  (XI_0 = 9).
FQ2_NONRESIDUE = (9, 1)
# BN curve parameter x (a.k.a. BN_X / SIX_U_PLUS_2 comes from this).
BN254_X = 4965661367192848881

# G2 generator (halo2curves bn256 G2 generator), coordinates in Fq2 = (c0, c1).
BN254_G2_GENERATOR = (
    (
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    (
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)

# ---------------------------------------------------------------------------
# secp256k1. Fp = base field, Fq = scalar field (ECDSA group order n).
# ---------------------------------------------------------------------------
SECP_P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
SECP_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141

FP_SECP256K1 = PrimeField(SECP_P, "secp256k1::Fp", generator=3)
FQ_SECP256K1 = PrimeField(SECP_N, "secp256k1::Fq", generator=7)

SECP_B = 7
SECP_G = (
    0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
    0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
)
