"""Reference KZG commitments over bn254, from the SRS's secret.

The program commits against an SRS it made (or read) and derived bases
from. The reference needs neither: the SRS is halo2's reference setup,
whose tau is public (``halo2.chacha.reference_srs_tau``: one
``Fr::random`` from ``ChaCha20Rng::from_seed([0; 32])``), so the
commitment to a column s against the Lagrange bases L_i(tau) G is
(sum_i s_i L_i(tau)) G, and against the monomial bases tau^i G it is
(sum_i s_i tau^i) G. One dot product and one scalar multiplication a
column; a wrong base, a wrong scalar or a wrong sum anywhere changes it.
"""

from __future__ import annotations

import numpy as np

from . import fr_vec
from .fr_torch import FrTorch
from .halo2.chacha import reference_srs_tau
from .halo2.curves import BN254_G1, BN254_G2
from .halo2.fields import FR_BN254

R_MONT = 1 << 256  # the program's Montgomery radix


def basis_weights(k: int, lagrange: bool, device="cpu") -> np.ndarray:
    """float64 [n, 16] limbs of the n = 2^k basis scalars: L_i(tau) = w^i
    (tau^n - 1) / (n (tau - w^i)) for the Lagrange basis, tau^i for the
    monomial one."""
    F = FrTorch(device)
    p = FR_BN254.p
    tau = reference_srs_tau()
    n = 1 << k
    if not lagrange:
        return F.canonical_limbs(F.powers(tau, n))
    w = F.powers(FR_BN254.nth_root_of_unity(k), n)
    inv = F.batch_inverse(F.sub(F.const(tau), w))
    scale = (pow(tau, n, p) - 1) * pow(n, -1, p) % p
    return F.canonical_limbs(F.mul(F.mul(w, inv), F.const(scale)))


class Committer:
    """Commitments of Montgomery-form columns against one basis."""

    def __init__(self, k: int, lagrange: bool, device="cpu"):
        self.p = FR_BN254.p
        self.weights = basis_weights(k, lagrange, device)
        self.r_inv = pow(R_MONT, -1, self.p)

    def commit(self, columns_mont: np.ndarray) -> list:
        """[C, 16, m] limbs of Montgomery scalars (x R mod r) -> C affine
        points (None for the identity)."""
        m = columns_mont.shape[-1]
        sums = fr_vec.limb_dot(columns_mont, self.weights[:m], self.p)
        return [BN254_G1.mul(BN254_G1.g, s * self.r_inv % self.p) for s in sums]


def verifier_g2() -> tuple:
    """(g2, tau g2) of the reference SRS, worked out from tau."""
    return BN254_G2.g, BN254_G2.mul(BN254_G2.g, reference_srs_tau())


def packed_points(rows: np.ndarray) -> list:
    """[C, 33] int32 rows of the program's commit output (canonical x
    limbs | y limbs | identity flag) -> affine points (None = identity)."""
    rows = np.asarray(rows).reshape(-1, 33)
    xs = fr_vec.limbs_to_ints(rows[:, :16])
    ys = fr_vec.limbs_to_ints(rows[:, 16:32])
    return [None if flag else (x, y) for x, y, flag in zip(xs, ys, rows[:, 32])]
