"""Reference check of number-theoretic transforms over bn254 Fr.

A forward transform of x is y_j = sum_i x_i w^(i j), w the primitive n-th
root of unity of halo2's Fr (its ROOT_OF_UNITY raised to 2^(28 - log n)).
Instead of transforming again, the reference tests the identity that any
correct y satisfies, weighted by the powers of a random z:

    sum_j z^j y_j  =  sum_i x_i (z^n - 1) / (z w^i - 1)        (mod r)

A y that differs from the transform anywhere fails it except with
probability below n / r. The transform is linear, so the identity holds on
the program's Montgomery representations (x R, y R) as they are. The
inverse transform is checked the same way against the input it should give
back: sum_j z^j x'_j = sum_j z^j x_j.
"""

from __future__ import annotations

import numpy as np

from . import fr_vec
from .fr_torch import FrTorch
from .halo2.fields import FR_BN254


class TransformCheck:
    def __init__(self, log_n: int, z: int, device="cpu"):
        F = FrTorch(device)
        p = FR_BN254.p
        n = 1 << log_n
        self.p = p
        w = F.powers(FR_BN254.nth_root_of_unity(log_n), n)
        zp = F.powers(z, n)
        self.out_weights = F.canonical_limbs(zp)
        inv = F.batch_inverse(F.sub(F.mul(w, F.const(z)), F.const(1)))
        self.in_weights = F.canonical_limbs(F.mul(inv, F.const((pow(z, n, p) - 1) % p)))

    def _dot(self, limbs: np.ndarray, weights: np.ndarray) -> list[int]:
        return fr_vec.limb_dot(limbs.reshape(-1, fr_vec.LIMBS, limbs.shape[-1]), weights, self.p)

    def forward_mismatches(self, x: np.ndarray, y: np.ndarray) -> int:
        """Columns of y ([C, 16, n] limbs) that are not the forward
        transform of x's."""
        lhs = self._dot(y, self.out_weights)
        rhs = self._dot(x, self.in_weights)
        return sum(a != b for a, b in zip(lhs, rhs))

    def inverse_mismatches(self, x: np.ndarray, x_back: np.ndarray) -> int:
        """Columns of x_back that are not x (mod r)."""
        return sum(a != b for a, b in zip(self._dot(x_back, self.out_weights), self._dot(x, self.out_weights)))
