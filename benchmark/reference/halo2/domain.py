"""The evaluation domain's host quantities that the verifier needs: the n-th
root of unity of bn254 Fr and Lagrange basis values at a point (the host
half of ``halo2_lib_tpu_torch/backend/poly.py``'s ``Domain``, copied)."""

from __future__ import annotations

from .fields import FR_BN254


class HostDomain:
    def __init__(self, k: int):
        self.k = k
        self.n = 1 << k
        self.F = FR_BN254
        self.omega = FR_BN254.nth_root_of_unity(k)

    def lagrange_evals_host(self, indices: list[int], x: int) -> dict[int, int]:
        """L_i(x) = (w^i / n) * (x^n - 1) / (x - w^i) for the given rows."""
        p = self.F.p
        zh = (pow(x, self.n, p) - 1) % p
        n_inv = pow(self.n, -1, p)
        out = {}
        for i in indices:
            wi = pow(self.omega, i, p)
            out[i] = wi * n_inv % p * zh % p * pow((x - wi) % p, -1, p) % p
        return out
