"""NTTs over bn254 Fr: radix-2 Stockham, and four-step for large domains.

The port of ``halo2_lib_tpu/ops/ntt.py`` and ``ops/ntt4.py``: coefficient
<-> evaluation conversion and extended-coset evaluation for the quotient.
Input and output are natural order, Montgomery form, limb-major
``int32[..., 16, n]``; leading batch dims transform together.

``NTT`` (n < 2^12): Stockham DIF needs no bit reversal. Each of the log n
stages pairs the two contiguous halves of the lane axis, (a + b, (a - b) *
w), and interleaves the results at block granularity s. One ``ntt_small``
launch runs every stage of every column of a call (the JAX package runs a
``lax.fori_loop`` of butterfly kernels), with the diagonal scalings folded
into its load and store: the inverse's 1/n, and a coset's shift powers.
Above 2^11 points (only HALO2_NO_FOURSTEP_NTT=1 sends them here) ``NTT``
runs the JAX package's stage loop, one ``ntt_butterfly`` launch a stage
(``ntt_stages``).

``FourStepNTT`` (n >= 2^12): n = A1 * ... * Ak, ascending factors of at most
128. Level l runs every stage of its length-Al sub-transforms in one
``colntt`` launch, with the four-step diagonal twiddle fused, and torch
transposes move the data between levels.

``new_ntt`` picks, as the JAX package does on the TPU: ``FourStepNTT`` from
2^12 points up (unless HALO2_NO_FOURSTEP_NTT=1), the digit-plane DFT
(``ops/ntt_mxu.py`` ``MxuNTT``) from 2^6 points on a CUDA device (unless
HALO2_NO_MXU_NTT=1), ``NTT`` otherwise.
"""

from __future__ import annotations

import os

import torch

from . import cuda_field as cf
from .limbs import N_LIMBS, DeviceField, ints_to_limbs_T, to_device

# Columns per dispatch of FourStepNTT's forward_cols/inverse_cols: bounds the
# temporaries between its levels (no compile cache to share, unlike the JAX
# package's chunks). NTT needs none: its one launch keeps every column in
# shared memory. FourStepNTT takes fewer from 2^21 points, where the base
# level's one colntt call (every column's lanes side by side) would pass the
# kernel's 32-bit offsets (63 columns at 2^21).
NTT_CHUNK = 64


def pows_host(df: DeviceField, root: int, m: int, device=None, scale: int = 1):
    """[16, m] Montgomery powers scale * (1, root, ..., root^(m-1)), computed
    with exact host ints; device=None returns the numpy limbs."""
    p = df.p_int
    r = df.R
    out = [0] * m
    cur = scale % p
    for i in range(m):
        out[i] = cur * r % p
        cur = cur * root % p
    arr = ints_to_limbs_T(out)
    return arr if device is None else to_device(arr, device)


def pows_device(df: DeviceField, root: int, m: int, device) -> torch.Tensor:
    """[16, m] Montgomery powers 1, root, ..., root^(m-1) built on `device`
    by doubling: ceil(log2 m) Montgomery-multiply launches, the same values
    as pows_host."""
    p = df.p_int
    out = df.pack([1], device=device)
    step = root
    while out.shape[-1] < m:
        out = torch.cat([out, df._mont_mul(out, df.pack([step], device=device))], dim=-1)
        step = step * step % p
    return out[:, :m].contiguous()


def pows_host_ints(p: int, root: int, m: int) -> list[int]:
    """Canonical host power chain [1, root, ..., root^(m-1)] mod p."""
    out = [0] * m
    cur = 1
    for i in range(m):
        out[i] = cur
        cur = cur * root % p
    return out


def dispatch_cols(x: torch.Tensor, chunk: int | None, fn) -> torch.Tensor:
    """Apply `fn` to [chunk, ...] slices of the leading axis of x and
    concatenate: bounds the working set of a large batched transform.
    chunk None takes the whole batch at once."""
    C = x.shape[0]
    if chunk is None or C <= chunk:
        return fn(x) if C else x
    return torch.cat([fn(x[i : i + chunk]) for i in range(0, C, chunk)], dim=0)


class NTT:
    """NTT/INTT of size 2^log_n over Fr, on limb-major [..., 16, n] tensors
    on `device`: one ntt_small launch per call up to 2^11 points; above, the
    JAX package's NTT, a stage loop of one ntt_butterfly launch a stage
    (``ntt_stages``; only HALO2_NO_FOURSTEP_NTT=1 sends such lengths here)."""

    def __init__(self, df: DeviceField, log_n: int, device):
        field = df.field
        assert log_n <= field.s, f"field 2-adicity {field.s} < log_n {log_n}"
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
        # forward_cols/inverse_cols: every column in one ntt_small launch;
        # the stage loop's temporaries bounded as FourStepNTT's
        self.CHUNK = None if self.n <= cf.NTT_SMALL_MAX else NTT_CHUNK
        self._init_tables()

    def _init_tables(self) -> None:
        if self.n < 2:
            raise ValueError(f"radix-2 NTT needs n >= 2, got {self.n}")
        # the [16, n/2] twiddle rows of the forward and the inverse transform
        self.tw = {
            True: pows_host(self.df, self.omega, self.n // 2, self.device),
            False: pows_host(self.df, self.omega_inv, self.n // 2, self.device),
        }

    def _small(self, x: torch.Tensor, forward: bool, pre=None, post=None) -> torch.Tensor:
        lead = tuple(x.shape[:-2])
        x = x.reshape(-1, N_LIMBS, self.n)
        if self.n <= cf.NTT_SMALL_MAX:
            y = cf.ntt_small(self.df.fid, x, self.tw[forward], pre, post)
        else:
            y = ntt_stages(self.df.fid, x, self.tw[forward], pre, post)
        return y.reshape(lead + (N_LIMBS, self.n))

    def forward(self, coeffs: torch.Tensor, pre: torch.Tensor | None = None) -> torch.Tensor:
        """Evaluations at w^i (natural order) from coefficients, each first
        multiplied by the diagonal `pre` [16, n] when it is given."""
        return self._small(coeffs, True, pre=pre)

    def inverse(self, evals: torch.Tensor, post: torch.Tensor | None = None) -> torch.Tensor:
        """Coefficients from evaluations, scaled by 1/n, or by the diagonal
        `post` when it is given: an `inverse_post` table, which holds the
        1/n (the kernel applies one diagonal as it stores)."""
        return self._small(evals, False, post=self.n_inv_mont if post is None else post)

    def inverse_post(self, root: int) -> torch.Tensor:
        """The [16, n] diagonal root^i for `inverse(post=...)`, with the 1/n
        this transform applies in the same product."""
        return pows_host(self.df, root, self.n, self.device, scale=self.n_inv)

    def forward_cols(self, x: torch.Tensor) -> torch.Tensor:
        """[C, 16, n] -> [C, 16, n], CHUNK columns per dispatch (all of them
        when CHUNK is None)."""
        return dispatch_cols(x, self.CHUNK, self.forward)

    def inverse_cols(self, x: torch.Tensor) -> torch.Tensor:
        return dispatch_cols(x, self.CHUNK, self.inverse)


# Four-step plan (ops/ntt4.py): mid factors and the base factor at most 128;
# from 2^12 points up.
A_MID = 128
A_BASE = 128
MIN_FOURSTEP = 1 << 12


def _plan(n: int) -> list[int]:
    """Ascending factors, mids <= A_MID, last <= A_BASE, product n."""
    fs = []
    rem = n
    while rem > A_BASE:
        fs.append(A_MID)
        rem //= A_MID
    fs.append(rem)
    fs.sort()
    return fs


class FourStepNTT(NTT):
    """Four-step (Bailey) NTT, n >= MIN_FOURSTEP: the same API and the same
    values as NTT, one colntt launch per level; the diagonals of forward and
    inverse are one mont_mul launch each."""

    def _init_tables(self) -> None:
        if self.n < MIN_FOURSTEP:
            raise ValueError(f"four-step NTT needs n >= {MIN_FOURSTEP}, got {self.n}")
        n, dev = self.n, self.device
        self.CHUNK = max(1, min(NTT_CHUNK, (cf.COLNTT_MAX_LIMBS - 1) // (N_LIMBS * n)))
        self.factors = _plan(n)
        self._levels = {}
        for forward in (True, False):
            # every table is a gather from the n powers of the n-th root
            # (built on the device): at level li the sub-problem length is
            # rem and its root w_rem = root_n^(n / rem)
            pw = pows_device(self.df, self.omega if forward else self.omega_inv, n, dev)
            tw, mids = {}, []
            rem = n
            for li, A in enumerate(self.factors):
                if A not in tw:  # powers of the A-th root w_A = root_n^(n / A)
                    tw[A] = pw[:, :: n // A][:, : A // 2].contiguous()
                B = rem // A
                if li < len(self.factors) - 1:
                    # mid diagonal w_rem^(k1 * b), k1 < A, b < B; the inverse
                    # folds the global 1/n into the first level's mid (every
                    # element passes through it exactly once)
                    k1 = torch.arange(A, device=dev)[:, None]
                    b = torch.arange(B, device=dev)[None, :]
                    idx = (k1 * b % rem) * (n // rem)
                    mid = pw[:, idx.reshape(-1)].reshape(N_LIMBS, A, B).permute(1, 0, 2)
                    if not forward and li == 0:
                        mid = self.df._mont_mul(mid, self.n_inv_mont)
                    mids.append(mid.contiguous())
                else:
                    mids.append(None)
                rem = B
            self._levels[forward] = (tw, mids)

    def _rec(self, y: torch.Tensor, level: int, forward: bool) -> torch.Tensor:
        """y: [L, 16, M] -> NTT along the lane axis (natural order)."""
        tw, mids = self._levels[forward]
        A = self.factors[level]
        fid = self.df.fid
        L, _, M = y.shape
        if level == len(self.factors) - 1:
            # base: lanes become rows (the four-step transpose)
            z = y.permute(2, 1, 0).contiguous()[None]  # [1, M, 16, L]
            return cf.colntt(fid, z, tw[A])[0].permute(2, 1, 0)
        B = M // A
        z = y.reshape(L, N_LIMBS, A, B).permute(0, 2, 1, 3).contiguous()  # [L, A, 16, B]
        z = cf.colntt(fid, z, tw[A], mids[level])
        z = self._rec(z.reshape(L * A, N_LIMBS, B), level + 1, forward)
        z = z.reshape(L, A, N_LIMBS, B).permute(0, 2, 3, 1)  # [L, 16, B, A]: X[k2 * A + k1]
        return z.reshape(L, N_LIMBS, A * B)

    def _transform(self, x: torch.Tensor, forward: bool) -> torch.Tensor:
        lead = tuple(x.shape[:-2])
        y = self._rec(x.reshape(-1, N_LIMBS, self.n), 0, forward)
        return y.reshape(lead + (N_LIMBS, self.n)).contiguous()

    def forward(self, coeffs: torch.Tensor, pre: torch.Tensor | None = None) -> torch.Tensor:
        if pre is not None:
            coeffs = self.df._mont_mul(coeffs, pre)
        return self._transform(coeffs, True)

    def inverse(self, evals: torch.Tensor, post: torch.Tensor | None = None) -> torch.Tensor:
        # the inverse's 1/n is folded into the level-0 mid table
        out = self._transform(evals, False)
        return out if post is None else self.df._mont_mul(out, post)

    def inverse_post(self, root: int) -> torch.Tensor:
        return pows_host(self.df, root, self.n, self.device)


def ntt_stages(fid: int, x: torch.Tensor, tw: torch.Tensor, pre=None, post=None) -> torch.Tensor:
    """The radix-2 Stockham DIF transform of x [C, 16, N] as the JAX
    package's NTT runs it: the `pre` product (one mont_mul launch), then per
    stage (n, s) one ntt_butterfly launch over the two halves with the
    twiddles w^(p s) at lane p s + j, and the interleave of its outputs (a
    torch stack); then the `post` product. tw: [16, N/2] powers of the root.
    The same values as ntt_small's one launch, at any N."""
    C, _, N = x.shape
    if pre is not None:
        x = cf.mont_mul(fid, x, pre)
    n, s = N, 1
    while n > 1:
        m = n // 2
        wp = tw[:, ::s][:, :m, None].expand(N_LIMBS, m, s).reshape(N_LIMBS, N // 2)
        top, bot = cf.ntt_butterfly(fid, x[..., : N // 2], x[..., N // 2 :], wp)
        x = torch.stack([top.reshape(C, N_LIMBS, m, s), bot.reshape(C, N_LIMBS, m, s)], dim=-2)
        x = x.reshape(C, N_LIMBS, N)
        n, s = m, 2 * s
    return x if post is None else cf.mont_mul(fid, x, post)


# the sizes the digit-plane DFT (ops/ntt_mxu.py) takes on a CUDA device
MXU_MIN_LOG = 6


def new_ntt(df: DeviceField, log_n: int, device):
    """NTT factory, by the JAX package's rule (halo2_lib_tpu/ops/ntt.py:
    263-285) with the accelerator read as a CUDA device: the four-step
    transform from 2^12 points up unless HALO2_NO_FOURSTEP_NTT=1; on a CUDA
    device the digit-plane DFT (ops/ntt_mxu.py; one dft_ntt launch a call
    up to 2^11 points) from 2^6 points unless HALO2_NO_MXU_NTT=1; radix-2
    Stockham otherwise, and on the CPU (one ntt_small launch a call up to
    2^11 points, a stage loop of ntt_butterfly launches above). All give
    the same values."""
    device = torch.device(device)
    if log_n >= MIN_FOURSTEP.bit_length() - 1 and os.environ.get("HALO2_NO_FOURSTEP_NTT") != "1":
        return FourStepNTT(df, log_n, device)
    if (device.type == "cuda" and log_n >= MXU_MIN_LOG
            and os.environ.get("HALO2_NO_MXU_NTT") != "1"):
        from .ntt_mxu import MxuNTT  # it builds on this module

        return MxuNTT(df, log_n, device)
    return NTT(df, log_n, device)


class CosetNTT:
    """Evaluation over the coset shift * H of the extended domain: the
    forward transform multiplies by the shift's powers first, the inverse by
    their inverses last (inside ntt_small's one launch below 2^12 points; one
    mont_mul launch beside the four-step transform)."""

    def __init__(self, df: DeviceField, log_n: int, shift: int, device):
        self.ntt = new_ntt(df, log_n, device)
        self.df = df
        p = df.field.p
        n = 1 << log_n
        self.shift_pows = pows_host(df, shift, n, self.ntt.device)
        self.shift_inv_post = self.ntt.inverse_post(pow(shift, p - 2, p))

    def forward(self, coeffs: torch.Tensor) -> torch.Tensor:
        """Evaluate the polynomial at shift * w^i."""
        return self.ntt.forward(coeffs, pre=self.shift_pows)

    def inverse(self, evals: torch.Tensor) -> torch.Tensor:
        return self.ntt.inverse(evals, post=self.shift_inv_post)

    def forward_cols(self, x: torch.Tensor) -> torch.Tensor:
        return dispatch_cols(x, self.ntt.CHUNK, self.forward)

    def inverse_cols(self, x: torch.Tensor) -> torch.Tensor:
        return dispatch_cols(x, self.ntt.CHUNK, self.inverse)
