"""NTTs over bn254 Fr: radix-2 Stockham, and four-step for large domains.

The port of ``halo2_lib_tpu/ops/ntt.py`` and ``ops/ntt4.py``: coefficient
<-> evaluation conversion and extended-coset evaluation for the quotient.
Input and output are natural order, Montgomery form, limb-major
``int32[..., 16, n]``; leading batch dims transform together.

``NTT`` (small domains): Stockham DIF needs no bit reversal. Each of the
log n stages pairs the two contiguous halves of the lane axis, runs one
butterfly kernel launch (a + b, (a - b) * w) over every column of the batch,
and interleaves the halves at block granularity s (a reshape). The stage
loop is a Python loop of launches where JAX had ``lax.fori_loop``.

``FourStepNTT`` (n >= 2^12): n = A1 * ... * Ak, ascending factors of at most
128. Level l runs every stage of its length-Al sub-transforms in one
``colntt`` launch, with the four-step diagonal twiddle fused, and torch
transposes move the data between levels.
"""

from __future__ import annotations

import torch

from . import cuda_field as cf
from .limbs import N_LIMBS, DeviceField, ints_to_limbs_T, to_device

# Columns per dispatch of forward_cols/inverse_cols: bounds the temporaries
# of one stage (no compile cache to share, unlike the JAX package's chunks).
NTT_CHUNK = 64


def pows_host(df: DeviceField, root: int, m: int, device=None):
    """[16, m] Montgomery powers 1, root, ..., root^(m-1), computed with exact
    host ints; device=None returns the numpy limbs."""
    p = df.p_int
    r = df.R
    out = [0] * m
    cur = 1
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


def dispatch_cols(x: torch.Tensor, chunk: int, fn) -> torch.Tensor:
    """Apply `fn` to [chunk, ...] slices of the leading axis of x and
    concatenate: bounds the working set of a large batched transform."""
    C = x.shape[0]
    if C <= chunk:
        return fn(x) if C else x
    return torch.cat([fn(x[i : i + chunk]) for i in range(0, C, chunk)], dim=0)


class NTT:
    """NTT/INTT of size 2^log_n over Fr, on limb-major [..., 16, n] tensors
    on `device`."""

    CHUNK = NTT_CHUNK

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
        self._init_tables()

    def _init_tables(self) -> None:
        half = max(self.n // 2, 1)
        tw = {
            True: pows_host(self.df, self.omega, half, self.device),
            False: pows_host(self.df, self.omega_inv, half, self.device),
        }
        # per stage: the [16, n/2] twiddle row of each butterfly lane
        self._stage_tw = {fwd: self._stage_tables(tw[fwd]) for fwd in (True, False)}

    def _stage_tables(self, tw: torch.Tensor) -> list[torch.Tensor]:
        """Stage (n, s), m = n/2: lane i*s + j of the halves uses w^(i*N/n),
        the strided table repeated s times along lanes."""
        N, half = self.n, self.n // 2
        out = []
        n, s = N, 1
        while n > 1:
            m = n // 2
            wp = tw[:, :: N // n][:, :m]
            if s > 1:
                wp = wp[:, :, None].expand(N_LIMBS, m, s).reshape(N_LIMBS, half)
            out.append(wp.contiguous())
            n, s = m, 2 * s
        return out

    def _transform(self, x: torch.Tensor, forward: bool) -> torch.Tensor:
        """Stockham radix-2 DIF, natural order in and out. Stage (n, s) with
        m = n/2 pairs lanes i*s + j and (m+i)*s + j, the two contiguous
        halves; the interleave writes top/bot back at block granularity s."""
        N = self.n
        if N == 1:
            return x
        batch = tuple(x.shape[:-2])
        half = N // 2
        n, s = N, 1
        for wp in self._stage_tw[forward]:
            m = n // 2
            top, bot = cf.ntt_butterfly(self.df.fid, x[..., :half], x[..., half:], wp)
            stacked = torch.stack(
                [top.reshape(batch + (N_LIMBS, m, s)), bot.reshape(batch + (N_LIMBS, m, s))],
                dim=-2,
            )  # [..., 16, m, 2, s]
            x = stacked.reshape(batch + (N_LIMBS, N))
            n, s = m, 2 * s
        return x

    def _body(self, x: torch.Tensor, forward: bool) -> torch.Tensor:
        out = self._transform(x, forward)
        if not forward:
            out = self.df._mont_mul(out, self.n_inv_mont)
        return out

    def forward(self, coeffs: torch.Tensor) -> torch.Tensor:
        """Evaluations at w^i (natural order) from coefficients."""
        return self._body(coeffs, True)

    def inverse(self, evals: torch.Tensor) -> torch.Tensor:
        """Coefficients from evaluations, including the 1/n scaling."""
        return self._body(evals, False)

    def forward_cols(self, x: torch.Tensor) -> torch.Tensor:
        """[C, 16, n] -> [C, 16, n], CHUNK columns per dispatch."""
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
    values as NTT, one colntt launch per level."""

    def _init_tables(self) -> None:
        if self.n < MIN_FOURSTEP:
            raise ValueError(f"four-step NTT needs n >= {MIN_FOURSTEP}, got {self.n}")
        n, dev = self.n, self.device
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

    def _body(self, x: torch.Tensor, forward: bool) -> torch.Tensor:
        # the inverse's 1/n is folded into the level-0 mid table
        return self._transform(x, forward)


def new_ntt(df: DeviceField, log_n: int, device):
    """NTT factory, as ops/ntt.py:new_ntt picks on the TPU: the four-step
    transform from 2^12 points up, radix-2 Stockham below. (The TPU's MXU
    digit-matmul NTT for 2^6..2^11 is not ported; radix-2 serves there.)
    Both give the same values."""
    if log_n >= MIN_FOURSTEP.bit_length() - 1:
        return FourStepNTT(df, log_n, device)
    return NTT(df, log_n, device)


class CosetNTT:
    """Evaluation over the coset shift * H of the extended domain: one
    elementwise Montgomery multiply by the shift's powers before (after) the
    forward (inverse) NTT."""

    def __init__(self, df: DeviceField, log_n: int, shift: int, device):
        self.ntt = new_ntt(df, log_n, device)
        self.df = df
        p = df.field.p
        n = 1 << log_n
        self.shift_pows = pows_host(df, shift, n, self.ntt.device)
        self.shift_inv_pows = pows_host(df, pow(shift, p - 2, p), n, self.ntt.device)

    def forward(self, coeffs: torch.Tensor) -> torch.Tensor:
        """Evaluate the polynomial at shift * w^i."""
        return self.ntt.forward(self.df._mont_mul(coeffs, self.shift_pows))

    def inverse(self, evals: torch.Tensor) -> torch.Tensor:
        return self.df._mont_mul(self.ntt.inverse(evals), self.shift_inv_pows)

    def forward_cols(self, x: torch.Tensor) -> torch.Tensor:
        return dispatch_cols(x, self.ntt.CHUNK, self.forward)

    def inverse_cols(self, x: torch.Tensor) -> torch.Tensor:
        return dispatch_cols(x, self.ntt.CHUNK, self.inverse)
