"""Poseidon primitives: Grain LFSR constant generation, Cauchy MDS, and the
native (host, unoptimized) permutation used as the test oracle.

Plays the role of the external `poseidon-primitives` crate the reference pulls
in (halo2-base/Cargo.toml:31): generates round constants and the MDS matrix
for Poseidon-128 with x^5 sbox. The Grain construction follows the Poseidon
reference implementation (GKRRS19 Appendix F / zcash halo2_gadgets grain.rs):
80-bit LFSR seeded from (field tag, sbox tag, n, t, R_F, R_P), 160 discarded
bits, self-shrinking output, field elements sampled MSB-first with rejection.
"""

from __future__ import annotations

from functools import lru_cache

from ..utils.fields import FR_BN254, PrimeField

STATE_BITS = 80


class Grain:
    def __init__(self, field: PrimeField, t: int, r_f: int, r_p: int):
        self.field = field
        self.n_bits = field.num_bits
        state = [False] * STATE_BITS

        def set_bits(offset: int, length: int, value: int):
            for i in range(length):
                state[offset + length - 1 - i] = bool((value >> i) & 1)

        set_bits(0, 2, 1)  # prime-order field tag
        set_bits(2, 4, 0)  # x^alpha sbox tag
        set_bits(6, 12, self.n_bits)
        set_bits(18, 12, t)
        set_bits(30, 10, r_f)
        set_bits(40, 10, r_p)
        for i in range(50, STATE_BITS):
            state[i] = True
        self.state = state
        self.cursor = 0
        # discard first 160 bits
        for _ in range(160):
            self._raw_bit()

    def _raw_bit(self) -> bool:
        s = self.state
        i = self.cursor
        new = (
            s[(i + 62) % STATE_BITS]
            ^ s[(i + 51) % STATE_BITS]
            ^ s[(i + 38) % STATE_BITS]
            ^ s[(i + 23) % STATE_BITS]
            ^ s[(i + 13) % STATE_BITS]
            ^ s[i]
        )
        s[i] = new
        self.cursor = (i + 1) % STATE_BITS
        return new

    def next_bit(self) -> bool:
        """Self-shrinking: evaluate raw bits in pairs."""
        while True:
            b1 = self._raw_bit()
            b2 = self._raw_bit()
            if b1:
                return b2

    def next_field_element(self) -> int:
        """MSB-first n-bit sample with rejection."""
        while True:
            v = 0
            for _ in range(self.n_bits):
                v = (v << 1) | int(self.next_bit())
            if v < self.field.p:
                return v

    def next_field_element_without_rejection(self) -> int:
        v = 0
        for _ in range(self.n_bits):
            v = (v << 1) | int(self.next_bit())
        return v % self.field.p


@lru_cache(maxsize=8)
def generate_constants(field: PrimeField, t: int, r_f: int, r_p: int):
    """(round_constants [r_f+r_p][t], mds [t][t], mds_inv [t][t])."""
    p = field.p
    grain = Grain(field, t, r_f, r_p)
    round_constants = [
        [grain.next_field_element() for _ in range(t)] for _ in range(r_f + r_p)
    ]
    # Cauchy MDS from fresh samples: mds[i][j] = 1/(x_i + y_j)
    xs = [grain.next_field_element_without_rejection() for _ in range(t)]
    ys = [grain.next_field_element_without_rejection() for _ in range(t)]
    mds = [[pow((xs[i] + ys[j]) % p, -1, p) for j in range(t)] for i in range(t)]
    mds_inv = _mat_inv(mds, p)
    return round_constants, mds, mds_inv


def _mat_inv(m: list[list[int]], p: int) -> list[list[int]]:
    t = len(m)
    aug = [[m[i][j] % p for j in range(t)] + [1 if i == j else 0 for j in range(t)] for i in range(t)]
    for col in range(t):
        piv = next(r for r in range(col, t) if aug[r][col] % p != 0)
        aug[col], aug[piv] = aug[piv], aug[col]
        inv = pow(aug[col][col], -1, p)
        aug[col] = [x * inv % p for x in aug[col]]
        for r in range(t):
            if r != col and aug[r][col]:
                f = aug[r][col]
                aug[r] = [(a - f * b) % p for a, b in zip(aug[r], aug[col])]
    return [row[t:] for row in aug]


def mat_mul_vec(m, v, p):
    return [sum(m[i][j] * v[j] for j in range(len(v))) % p for i in range(len(m))]


class PoseidonNative:
    """Host reference Poseidon permutation/hasher (unoptimized form).

    The oracle for the in-circuit hasher — same role as `pse-poseidon` in the
    reference's compatibility tests (poseidon/hasher/tests/compatibility.rs).
    """

    def __init__(self, field: PrimeField = FR_BN254, t: int = 3, rate: int = 2, r_f: int = 8, r_p: int = 57):
        self.field = field
        self.t = t
        self.rate = rate
        self.r_f = r_f
        self.r_p = r_p
        self.round_constants, self.mds, _ = generate_constants(field, t, r_f, r_p)

    def permutation(self, state: list[int]) -> list[int]:
        p = self.field.p
        assert len(state) == self.t
        s = list(state)
        half = self.r_f // 2
        rc = iter(self.round_constants)
        for _ in range(half):
            c = next(rc)
            s = [(x + cc) % p for x, cc in zip(s, c)]
            s = [pow(x, 5, p) for x in s]
            s = mat_mul_vec(self.mds, s, p)
        for _ in range(self.r_p):
            c = next(rc)
            s = [(x + cc) % p for x, cc in zip(s, c)]
            s[0] = pow(s[0], 5, p)
            s = mat_mul_vec(self.mds, s, p)
        for _ in range(half):
            c = next(rc)
            s = [(x + cc) % p for x, cc in zip(s, c)]
            s = [pow(x, 5, p) for x in s]
            s = mat_mul_vec(self.mds, s, p)
        return s

    def hash_fixed(self, inputs: list[int]) -> int:
        """Fixed-length sponge hash with 1||0* padding, capacity 2^64."""
        p = self.field.p
        state = [0] * self.t
        state[0] = 1 << 64
        chunks = [inputs[i : i + self.rate] for i in range(0, len(inputs), self.rate)]
        if not chunks or len(chunks[-1]) == self.rate:
            chunks.append([])
        for chunk in chunks:
            add = [0] * self.t
            for i, v in enumerate(chunk):
                add[i + 1] = v
            if len(chunk) < self.rate:
                add[len(chunk) + 1] = 1  # 1||0* padding
            state = [(s + a) % p for s, a in zip(state, add)]
            state = self.permutation(state)
        return state[1]

    def hash_var(self, inputs: list[int]) -> int:
        """Variable-length hash matching hash_var_len_array's chunking."""
        return self.hash_fixed(inputs)
