"""The digit-plane DFT NTT (``MxuNTT``) over bn254 Fr.

The port of ``halo2_lib_tpu/ops/ntt_mxu.py``: the transform as exact matrix
products, by the four-step split n = N1 * N2 (k1 = ceil(log n / 2), so both
factors are at most 256 up to 2^16 points):

    A[k1, c] = sum_r W_N1[k1, r] X[r, c]           (stage 1, contract r)
    B[k1, c] = A[k1, c] * w^(k1 * c)               (the twiddle)
    out[k1 + N1 * k2] = sum_c W_N2[k2, c] B[k1, c]  (stage 2, contract c)

Field elements do not fit a matrix unit, so each 256-bit value is split into
32 8-bit digits, the DFT matrix W (canonical) into 32 digit planes, and a
stage sums the 32 x 32 digit-pair products into 63 columns of weight
2^(8t) and reduces them mod p: the pair products on the integer tensor
cores (u8 x u8 -> s32, exact: every column sum stays below 2^29), the fold
mod p in the kernel, and the diagonals in the loads and stores: the forward
coset's shift powers (``pre``) in stage 1's load, the twiddle in stage 1's
store, and the inverse's 1/n or an inverse coset's ``post`` in stage 2's
store. On the card a base transform of 2^6..2^11 points is one ``dft_ntt``
launch (ops/cuda_field.py, csrc/dft_kernels.cu: both stages in shared
memory, no transpose); a larger one two ``dft_stage`` launches with a torch
transpose between them. Above 2^16 points one outer four-step level runs
over two sub-transforms, with its twiddle (and any diagonal) as mont_mul
launches.

Layout as ``ops/ntt.py``'s NTT: limb-major Montgomery ``int32[..., 16, n]``,
natural order in and out, canonical outputs, the same API (``forward(x,
pre=None)``, ``inverse(x, post=None)``, ``inverse_post``, ``forward_cols``,
``inverse_cols``), so ``CosetNTT``, ``backend/poly.py`` and ``ShardedNTT``
take it unchanged; ``new_ntt`` picks it on a CUDA device for 2^6..2^11
points, as the JAX package's ``new_ntt`` picks its MXU NTT on the TPU.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import cuda_field as cf
from .limbs import N_LIMBS, DeviceField, to_device
from .ntt import dispatch_cols, pows_host

# sizes up to 2^BASE_MAX_LOG are one two-stage transform; above, one outer
# four-step level over two of them (ntt_mxu.py:206-215)
BASE_MAX_LOG = 16


@lru_cache(maxsize=None)
def dft_planes_np(p: int, root: int, R: int) -> np.ndarray:
    """uint8[32, R, R] digit planes of the DFT matrix W[k, r] = root^(k r)
    mod p (canonical)."""
    pow_tab = [1] * R
    for i in range(1, R):
        pow_tab[i] = pow_tab[i - 1] * root % p
    e = (np.arange(R, dtype=np.int64)[:, None] * np.arange(R, dtype=np.int64)[None, :]) % R
    W = np.array(pow_tab, dtype=object)[e]  # [R(k), R(r)]
    d = cf.digits_of(W, cf.DFT_DIGITS)  # [R, R, 32]
    return np.ascontiguousarray(d.transpose(2, 0, 1))


class MxuNTT:
    """NTT/INTT of size 2^log_n over Fr by digit-plane DFT stages, on
    limb-major [..., 16, n] tensors on `device`: one dft_ntt launch a call
    for 2^6..2^11 points, two dft_stage launches up to 2^16."""

    CHUNK = None  # forward_cols/inverse_cols: every column in one call

    def __init__(self, df: DeviceField, log_n: int, device):
        field = df.field
        assert 1 <= log_n <= field.s, f"field 2-adicity {field.s} < log_n {log_n}"
        self.df = df
        self.device = torch.device(device)
        self.log_n = log_n
        self.n = 1 << log_n
        p = field.p
        w = field.nth_root_of_unity(log_n)
        self.omega = w
        self.omega_inv = pow(w, p - 2, p)
        self.n_inv = pow(self.n, p - 2, p)
        self.n_inv_mont = df.pack(self.n_inv, device=self.device)
        if log_n <= BASE_MAX_LOG:
            self.k1 = (log_n + 1) // 2
            self.sub = None
        else:
            self.k1 = log_n // 2
            self.sub = (MxuNTT(df, self.k1, device), MxuNTT(df, log_n - self.k1, device))
        self.k2 = log_n - self.k1
        self._consts = {fwd: self._build(fwd) for fwd in (True, False)}

    def _build(self, forward: bool) -> tuple:
        """(twiddle [16, N1, N2] = w^(k1 c), and for a base transform the
        digit planes of its two DFT matrices) of one direction."""
        p = self.df.p_int
        w = self.omega if forward else self.omega_inv
        N1, N2 = 1 << self.k1, 1 << self.k2
        pows = pows_host(self.df, w, self.n)  # numpy [16, n]
        ij = (np.arange(N1, dtype=np.int64)[:, None] * np.arange(N2, dtype=np.int64)[None, :]) % self.n
        tw = to_device(np.ascontiguousarray(pows[:, ij.reshape(-1)]).reshape(N_LIMBS, N1, N2),
                       self.device)
        if self.sub is not None:
            return (tw,)
        w1 = torch.from_numpy(dft_planes_np(p, pow(w, N2, p), N1)).to(self.device)
        w2 = torch.from_numpy(dft_planes_np(p, pow(w, N1, p), N2)).to(self.device)
        return tw, w1, w2

    def _transform(self, x: torch.Tensor, forward: bool, pre=None, post=None) -> torch.Tensor:
        """[L, 16, n] -> [L, 16, n], natural order both ways; pre [16, n] is
        multiplied in first, post ([16, n] or [16, 1]) last."""
        df, fid = self.df, self.df.fid
        L = x.shape[0]
        N1, N2 = 1 << self.k1, 1 << self.k2
        if self.sub is None:
            tw, w1, w2 = self._consts[forward]
            if N2 >= 8 and self.n <= cf.DFT_NTT_MAX_N:  # 2^6..2^11: one launch
                return cf.dft_ntt(fid, x, w1, w2, tw, pre, post)
            return cf.dft_two_stages(cf.dft_stage, fid, x, w1, w2, tw, pre, post)
        # the outer four-step level over two base transforms (ntt_mxu.py:277-289)
        sub1, sub2 = self.sub
        (tw,) = self._consts[forward]
        if pre is not None:
            x = df._mont_mul(x, pre)
        Xt = x.reshape(L, N_LIMBS, N1, N2).permute(0, 3, 1, 2).reshape(L * N2, N_LIMBS, N1)
        A = sub1._transform(Xt, forward).reshape(L, N2, N_LIMBS, N1).permute(0, 2, 3, 1)
        B = df._mont_mul(A.reshape(L, N_LIMBS, self.n), tw.reshape(N_LIMBS, self.n))
        Bt = B.reshape(L, N_LIMBS, N1, N2).permute(0, 2, 1, 3).reshape(L * N1, N_LIMBS, N2)
        O = sub2._transform(Bt, forward).reshape(L, N1, N_LIMBS, N2).permute(0, 2, 3, 1)
        O = O.reshape(L, N_LIMBS, self.n)
        return O if post is None else df._mont_mul(O, post)

    def _apply(self, x: torch.Tensor, forward: bool, pre=None, post=None) -> torch.Tensor:
        lead = tuple(x.shape[:-2])
        y = self._transform(x.reshape(-1, N_LIMBS, self.n), forward, pre, post)
        return y.reshape(lead + (N_LIMBS, self.n))

    def forward(self, coeffs: torch.Tensor, pre: torch.Tensor | None = None) -> torch.Tensor:
        """Evaluations at w^i (natural order) from coefficients, each first
        multiplied by the diagonal `pre` [16, n] when it is given."""
        return self._apply(coeffs, True, pre=pre)

    def inverse(self, evals: torch.Tensor, post: torch.Tensor | None = None) -> torch.Tensor:
        """Coefficients from evaluations, scaled by 1/n, or by the diagonal
        `post` when it is given (an `inverse_post` table, which holds the
        1/n)."""
        return self._apply(evals, False, post=self.n_inv_mont if post is None else post)

    def inverse_post(self, root: int) -> torch.Tensor:
        """The [16, n] diagonal root^i for `inverse(post=...)`, with the 1/n
        this transform applies in the same product."""
        return pows_host(self.df, root, self.n, self.device, scale=self.n_inv)

    def forward_cols(self, x: torch.Tensor) -> torch.Tensor:
        """[C, 16, n] -> [C, 16, n], CHUNK columns per call (all of them when
        CHUNK is None)."""
        return dispatch_cols(x, self.CHUNK, self.forward)

    def inverse_cols(self, x: torch.Tensor) -> torch.Tensor:
        return dispatch_cols(x, self.CHUNK, self.inverse)
