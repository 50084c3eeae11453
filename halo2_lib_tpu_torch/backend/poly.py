"""Polynomial domain for the PlonKish prover over bn254 Fr.

The port of ``halo2_lib_tpu/backend/poly.py`` (halo2's EvaluationDomain):
coefficient <-> Lagrange conversion, extended-coset evaluation for the
quotient, vanishing-polynomial division, element-wise device math and the
Lagrange-basis host helpers. Methods that take a tensor run on its device;
those that make one take `device` (the CUDA card unless the caller asks
for another).

``domain(k)`` is cached by k and holds host constants only, so the verifier
and the protocol's host helpers never build device tables; the NTTs and
device tables are built on first use, once per device.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..ops.limbs import N_LIMBS, DeviceField, ints_to_limbs_T, limbs_to_ints, to_device
from ..ops.ntt import CosetNTT, new_ntt, pows_host
from ..utils.device import resolve_device
from ..utils.fields import FR_BN254

# coset shift of the extended domain (the multiplicative generator)
COSET_SHIFT = 7
# extension factor: quotient degree < (cs_degree - 1) * n with cs_degree = 4
EXT_FACTOR = 4


@lru_cache(maxsize=16)
def _domain(k: int, ext_factor: int) -> "Domain":
    return Domain(k, ext_factor)


def domain(k: int, ext_factor: int = EXT_FACTOR) -> "Domain":
    return _domain(k, ext_factor)


class Domain:
    def __init__(self, k: int, ext_factor: int = EXT_FACTOR):
        assert ext_factor & (ext_factor - 1) == 0 and ext_factor >= 2
        self.k = k
        self.n = 1 << k
        self.ext_factor = ext_factor
        self.F = FR_BN254
        self.df = DeviceField(FR_BN254)
        self.k_ext = k + (ext_factor.bit_length() - 1)
        self.n_ext = 1 << self.k_ext
        p = self.F.p
        self.omega = self.F.nth_root_of_unity(k)
        self.omega_inv = pow(self.omega, p - 2, p)
        # 1 / Z_H on the extended coset: Z_H(g w_ext^i) = g^n w_ext^(n i) - 1,
        # a pattern of period ext_factor
        g_n = pow(COSET_SHIFT, self.n, p)
        w_ext_n = pow(self.F.nth_root_of_unity(self.k_ext), self.n, p)
        vals = []
        cur = g_n
        for _ in range(ext_factor):
            vals.append((cur - 1) % p)
            cur = cur * w_ext_n % p
        self._zh_inv_vals = [pow(v, -1, p) for v in vals]
        self._dev: dict = {}

    def _tables(self, device) -> dict:
        device = torch.device(device)
        key = str(device)
        t = self._dev.get(key)
        if t is None:
            t = self._dev[key] = {}
        return t

    # --- device tables (built once per device) --------------------------------------
    def ntt(self, device):
        t = self._tables(device)
        if "ntt" not in t:
            t["ntt"] = new_ntt(self.df, self.k, device)
        return t["ntt"]

    def coset_ntt(self, device):
        t = self._tables(device)
        if "coset" not in t:
            t["coset"] = CosetNTT(self.df, self.k_ext, COSET_SHIFT, device)
        return t["coset"]

    def zh_inv_ext(self, device) -> torch.Tensor:
        t = self._tables(device)
        if "zh_inv" not in t:
            full = [self._zh_inv_vals[i % self.ext_factor] for i in range(self.n_ext)]
            t["zh_inv"] = self.pack(full, device)
        return t["zh_inv"]

    def omega_pows_dev(self, device) -> torch.Tensor:
        """[16, n] Montgomery values of the domain points w^i."""
        t = self._tables(device)
        if "omega" not in t:
            t["omega"] = pows_host(self.df, self.omega, self.n, device)
        return t["omega"]

    # --- packing -------------------------------------------------------------------------
    def pack(self, values: list[int], device) -> torch.Tensor:
        """ints -> Montgomery limb-major [16, len] on `device`."""
        p = self.F.p
        return to_device(ints_to_limbs_T([(int(v) << 256) % p for v in values]), device)

    def unpack(self, arr: torch.Tensor) -> list[int]:
        p = self.F.p
        rinv = pow(1 << 256, -1, p)
        a = arr.detach().cpu().numpy()
        a = np.moveaxis(a.reshape(-1, N_LIMBS, a.shape[-1]), 1, 2).reshape(-1, N_LIMBS)
        return [(v * rinv) % p for v in limbs_to_ints(a)]

    # --- conversions ------------------------------------------------------------------------
    def lagrange_to_coeff(self, evals: torch.Tensor) -> torch.Tensor:
        """Values on H -> coefficients (the inverse NTT)."""
        return self.ntt(evals.device).inverse(evals)

    def coeff_to_lagrange(self, coeffs: torch.Tensor) -> torch.Tensor:
        return self.ntt(coeffs.device).forward(coeffs)

    def coeff_to_extended(self, coeffs: torch.Tensor) -> torch.Tensor:
        """Coefficients (at most n_ext of them) -> values on the coset
        g * H_ext: zero-padded to n_ext, then the coset NTT."""
        padded = torch.nn.functional.pad(coeffs, (0, self.n_ext - coeffs.shape[-1]))
        return self.coset_ntt(coeffs.device).forward(padded)

    def extended_to_coeff(self, evals: torch.Tensor) -> torch.Tensor:
        return self.coset_ntt(evals.device).inverse(evals)

    def divide_by_vanishing(self, ext_evals: torch.Tensor) -> torch.Tensor:
        """Values on the extended coset times 1/Z_H (exact where Z_H divides)."""
        return self.df.mont_mul(ext_evals, self.zh_inv_ext(ext_evals.device))

    # --- device element-wise math --------------------------------------------------------
    def mul(self, a, b):
        return self.df.mont_mul(a, b)

    def add(self, a, b):
        return self.df.add(a, b)

    def sub(self, a, b):
        return self.df.sub(a, b)

    def rotate_ext(self, ext_evals: torch.Tensor, rotation: int) -> torch.Tensor:
        """Rotation by w^rotation on H: a roll by ext_factor * rotation lanes
        of the extended coset."""
        return torch.roll(ext_evals, -self.ext_factor * rotation, dims=-1)

    def const_ext(self, c: int, device=None) -> torch.Tensor:
        """The constant c broadcast over the extended domain."""
        return self.pack([c], resolve_device(device)).expand(N_LIMBS, self.n_ext)

    def const_h(self, c: int, device=None) -> torch.Tensor:
        """The constant c broadcast over H."""
        return self.pack([c], resolve_device(device)).expand(N_LIMBS, self.n)

    # --- device scans and powers -----------------------------------------------------------
    def prefix_prod(self, x: torch.Tensor) -> torch.Tensor:
        """Inclusive Montgomery prefix product along the lane axis."""
        return self.df.prefix_prod(x)

    def pows_of(self, x_mont: torch.Tensor, m: int) -> torch.Tensor:
        """[16, m] powers 1, x, ..., x^(m-1) of a Montgomery scalar [16, 1]:
        a prefix product (log2 m mont_mul launches)."""
        x = x_mont.reshape(N_LIMBS, 1)
        one = self.df.one_mont_like(x)
        stacked = torch.cat([one, x.expand(N_LIMBS, m - 1)], dim=1)
        return self.df.prefix_prod(stacked)

    def pows_dev(self, x: int, m: int, device=None) -> torch.Tensor:
        """[16, m] powers 1, x, ..., x^(m-1) of the int x."""
        return self.pows_of(self.pack([x], resolve_device(device)), m)

    def eval_many_at(self, coeff_stack: torch.Tensor, x: int) -> list[int]:
        """A stack of coefficient polynomials [m, 16, n] evaluated at the int
        x: the products by x's powers (one mont_mul launch), then a
        log-depth sum over the lane axis (field_add launches). Host ints."""
        xp = self.pows_dev(x, coeff_stack.shape[-1], coeff_stack.device)
        s = self.df.mont_mul(coeff_stack, xp[None])
        while s.shape[-1] > 1:
            half = s.shape[-1] // 2
            red = self.df.add(s[..., :half], s[..., half : 2 * half])
            if s.shape[-1] % 2:
                red = torch.cat([self.df.add(red[..., :1], s[..., -1:]), red[..., 1:]], dim=-1)
            s = red
        return self.unpack(s)

    # --- host scalar helpers -------------------------------------------------------------
    def eval_coeffs_host(self, coeffs: list[int], x: int) -> int:
        """Horner evaluation with exact ints."""
        p = self.F.p
        acc = 0
        for c in reversed(coeffs):
            acc = (acc * x + c) % p
        return acc

    def lagrange_evals_host(self, indices: list[int], x: int) -> dict[int, int]:
        """L_i(x) = (w^i / n) * (x^n - 1) / (x - w^i) for the given rows."""
        p = self.F.p
        xn = pow(x, self.n, p)
        zh = (xn - 1) % p
        n_inv = pow(self.n, -1, p)
        out = {}
        for i in indices:
            wi = pow(self.omega, i, p)
            out[i] = wi * n_inv % p * zh % p * pow((x - wi) % p, -1, p) % p
        return out

    def l0_host(self, x: int) -> int:
        return self.lagrange_evals_host([0], x)[0]
