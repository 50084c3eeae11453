"""Optimized Poseidon spec: sparse-MDS form of Grassi et al. Supp. B.

Re-implements halo2-base/src/poseidon/hasher/{spec,mds}.rs: from the plain
(round constants, MDS) of primitives.py, compute optimized start/partial/end
constants (spec.rs:108-157) and the sparse matrix factorization
(mds.rs factorise, spec.rs:159-176).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

from ..utils.fields import FR_BN254, PrimeField
from .primitives import generate_constants, mat_mul_vec, _mat_inv


@dataclass
class SparseMDSMatrix:
    row: list[int]  # length T
    col_hat: list[int]  # length RATE


def _mat_mul(a, b, p):
    t = len(a)
    return [[sum(a[i][k] * b[k][j] for k in range(t)) % p for j in range(t)] for i in range(t)]


def _transpose(m):
    t = len(m)
    return [[m[j][i] for j in range(t)] for i in range(t)]


def _identity(t):
    return [[1 if i == j else 0 for j in range(t)] for i in range(t)]


def _factorise(m, p):
    """M = M' * M'' with sparse M'' (mds.rs:factorise)."""
    t = len(m)
    rate = t - 1
    w = [m[i][0] for i in range(1, t)]
    m_hat = [[m[i + 1][j + 1] for j in range(rate)] for i in range(rate)]
    m_hat_inv = _mat_inv(m_hat, p)
    w_hat = mat_mul_vec(m_hat_inv, w, p)
    # m_prime = [[1 | 0], [0 | m_hat]]
    m_prime = _identity(t)
    for i in range(rate):
        for j in range(rate):
            m_prime[i + 1][j + 1] = m_hat[i][j]
    # m_prime_prime = [[m00 | m_0j], [w_hat | I]]
    m_pp = _identity(t)
    m_pp[0] = list(m[0])
    for i in range(rate):
        m_pp[i + 1][0] = w_hat[i]
    row = [m_pp[i][0] for i in range(t)]
    col_hat = m_pp[0][1:]
    return m_prime, SparseMDSMatrix(row=row, col_hat=col_hat)


class OptimizedPoseidonSpec:
    """(spec.rs:57-176)"""

    def __init__(self, field: PrimeField = FR_BN254, t: int = 3, rate: int = 2, r_f: int = 8, r_p: int = 57):
        assert rate == t - 1
        self.field = field
        self.t = t
        self.rate = rate
        self.r_f = r_f
        self.r_p = r_p
        p = field.p
        round_constants, mds, mds_inv = generate_constants(field, t, r_f, r_p)
        self.mds = mds

        # optimized constants (spec.rs:108-157)
        r_f_half = r_f // 2
        constants_start = [list(round_constants[0])]
        for r in range(1, r_f_half):
            constants_start.append(mat_mul_vec(mds_inv, round_constants[r], p))
        acc = list(round_constants[r_f_half + r_p])
        constants_partial = [0] * r_p
        for i in range(r_p - 1, -1, -1):
            tmp = mat_mul_vec(mds_inv, acc, p)
            constants_partial[i] = tmp[0]
            tmp[0] = 0
            consts = round_constants[r_f_half + i]
            acc = [(tv + cv) % p for tv, cv in zip(tmp, consts)]
        constants_start.append(mat_mul_vec(mds_inv, acc, p))
        constants_end = []
        for r in range(r_f_half + r_p + 1, r_f + r_p):
            constants_end.append(mat_mul_vec(mds_inv, round_constants[r], p))
        self.constants_start = constants_start
        self.constants_partial = constants_partial
        self.constants_end = constants_end

        # sparse matrices (spec.rs:159-176)
        mds_t = _transpose(mds)
        acc_m = [row[:] for row in mds_t]
        sparse = []
        for _ in range(r_p):
            m_prime, m_pp = _factorise(acc_m, p)
            acc_m = _mat_mul(mds_t, m_prime, p)
            sparse.append(m_pp)
        sparse.reverse()
        self.sparse_matrices = sparse
        self.pre_sparse_mds = _transpose(acc_m)


@lru_cache(maxsize=4)
def default_spec(t: int = 3, rate: int = 2, r_f: int = 8, r_p: int = 57) -> OptimizedPoseidonSpec:
    return OptimizedPoseidonSpec(FR_BN254, t, rate, r_f, r_p)
