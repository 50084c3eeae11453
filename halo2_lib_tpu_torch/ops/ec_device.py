"""Device elliptic-curve arithmetic: batched Jacobian G1 ops and Pippenger MSM.

The port of ``halo2_lib_tpu/ops/ec_device.py``, the engine of every KZG
commitment. Points are three limb-major ``int32[..., 16, B]`` Montgomery
tensors over Fq (Jacobian X, Y, Z; identity Z == 0). Point add, double and
the mixed Jacobian + affine add are the ``ec_add``/``ec_double``/``ec_madd``
kernels of ops/cuda_field.py; the bucket accumulation is its
``bucket_sums_fused`` kernel, and the MSM's tail its ``bucket_weight`` and
``msm_combine`` kernels.

The MSM is Pippenger with sort + segmented-scan bucket accumulation:
  * per window: sort the points by digit; one ``bucket_sums_fused`` call
    runs every (window, lane) chain of mixed adds, the segmented scan of the
    lane-boundary carries and the carried buckets' adds, and writes only the
    bucket sums;
  * the weighted bucket reduction runs on merged lanes, all windows at once
    (one ``bucket_weight`` launch);
  * the windows combine MSB first by repeated doubling (one ``msm_combine``
    launch).
The other ``lax.scan``/``fori_loop`` loops of the JAX package are Python
loops of kernel launches here. ``msm_device`` and ``DeviceCurve.msm`` are
the JAX package's general MSM of one scalar column over an affine lift
(bases that may repeat: the complete mixed add).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.curves import ShortWeierstrass
from ..utils.device import resolve_device
from . import cuda_field as cf
from .limbs import DeviceField, ints_to_limbs_T, to_device


def _where(cond, a, b):
    """Select along the element dims: cond is shaped like [..., B]."""
    return torch.where(cond[..., None, :], a, b)


class DeviceCurve:
    """Batched Jacobian arithmetic for y^2 = x^3 + b over df.field (Fq)."""

    def __init__(self, df: DeviceField, curve: ShortWeierstrass):
        assert df.field == curve.base
        assert df.fid == cf.FQ, "the EC kernels are specialised to bn254 G1 over Fq"
        self.df = df
        self.curve = curve

    def _add(self, P1, P2):
        """Complete add (ec_add kernel)."""
        return cf.ec_add(P1, P2)

    def _double(self, P):
        """Jacobian doubling (ec_double kernel)."""
        return cf.ec_double(P)

    add, double = _add, _double

    def _madd(self, P1, A2, distinct: bool):
        """Jacobian P1 + affine A2 ((0, 0) = identity) (ec_madd kernel);
        `distinct=True` drops the doubling branch (sound for SRS bases)."""
        return cf.ec_madd(P1, A2, distinct)

    # --- packing (on `device`: the CUDA card unless the caller asks for another) ---
    def pack_points(self, points, device=None):
        """Affine host points ((x, y) or None) -> Jacobian limb-major [16, n],
        the affine lift: Z = R (the Montgomery one), or 0 for the identity."""
        device = resolve_device(device)
        p = self.df.p_int
        R = self.df.R
        xs = [0 if pt is None else (pt[0] * R) % p for pt in points]
        ys = [0 if pt is None else (pt[1] * R) % p for pt in points]
        zs = [0 if pt is None else R % p for pt in points]
        return tuple(to_device(ints_to_limbs_T(v), device) for v in (xs, ys, zs))

    def unpack_points(self, P) -> list:
        """Jacobian limb-major tensors -> affine host points (None = identity)."""
        F = self.curve.base
        xs, ys, zs = (self.df.unpack(t) for t in P)
        out = []
        for x, y, z in zip(xs, ys, zs):
            if z == 0:
                out.append(None)
                continue
            zinv = F.inv(z)
            zi2 = F.mul(zinv, zinv)
            out.append((F.mul(x, zi2), F.mul(y, F.mul(zi2, zinv))))
        return out

    def pack_points_affine(self, points, device=None):
        """Host affine points -> (Ax, Ay) limb-major [16, n] Montgomery,
        identity as the (0, 0) sentinel; the conversion to Montgomery form
        runs as one mont_mul launch per coordinate."""
        device = resolve_device(device)
        xs = [0 if pt is None else pt[0] for pt in points]
        ys = [0 if pt is None else pt[1] for pt in points]
        return tuple(
            self.df._to_mont(to_device(ints_to_limbs_T(v), device)) for v in (xs, ys)
        )

    def identity(self, shape=(), device=None) -> tuple:
        z = self.df.zero(shape, device)
        return (z, z, z)

    def select(self, cond, P, Q):
        """cond ? P : Q, cond shaped like the element dims."""
        return tuple(_where(cond, a, b) for a, b in zip(P, Q))

    def tree_reduce(self, P):
        """Sum points along the lane axis -> [..., 16, 1] (halving tree)."""
        X, Y, Z = P
        n = X.shape[-1]
        while n > 1:
            half = n // 2
            even = tuple(t[..., 0 : 2 * half : 2] for t in (X, Y, Z))
            odd = tuple(t[..., 1 : 2 * half : 2] for t in (X, Y, Z))
            s = self._add(even, odd)
            if n % 2:
                X, Y, Z = (torch.cat([a, t[..., -1:]], -1) for a, t in zip(s, (X, Y, Z)))
            else:
                X, Y, Z = s
            n = X.shape[-1]
        return (X, Y, Z)

    # --- MSM ----------------------------------------------------------------------
    def pack_scalars(self, scalars: list[int], window_bits: int, device=None) -> torch.Tensor:
        """Scalars -> int32[num_windows, n] window digits on `device`."""
        return pack_scalars(self, scalars, window_bits, device)

    def msm(self, points, scalars: list[int], window_bits: int = 8, device=None):
        """Pippenger MSM of host points and ints on `device`: the Jacobian
        point as [16, 1] coordinates."""
        P = self.pack_points(points, device)
        digits = self.pack_scalars(scalars, window_bits, P[0].device)
        return msm_device(self, P, digits, window_bits)


# Bytes the bucket accumulation needs per window beyond the sort's own
# output: its sorted digits and order (int32, 8 B a slot), the bucket sums
# and the lanes' trailing sums (three 64-byte coordinates each). Windows go
# to the kernel in groups within _MSM_GROUP_BYTES: one group per MSM call at
# k = 15 (about 0.5 MB a window), several from about n = 2^20 up.
_MSM_GROUP_BYTES = 1 << 30


# On the card the MSM takes the JAX package's tuning at every size. On the
# CPU, where the kernels' plain versions run and cost what their element
# count costs, MSMs below _SMALL_CPU_MSM points take narrower windows and
# lanes: fewer buckets to reduce and a shorter cross-lane carry scan (a k=9
# keygen and proof run several times faster on one core).
_SMALL_CPU_MSM = 1 << 13


def _small_cpu(n: int, device) -> bool:
    return torch.device(device).type == "cpu" and n < _SMALL_CPU_MSM


def msm_window_bits(n: int, device) -> int:
    """Pippenger window width c for n points on `device`: balances mixed-add
    work (W(c) * n * 11 products, W = ceil(254 / c)) against the 2^c-slot
    bucket reduction; wide windows only pay off once n >> 2^c."""
    if n >= 1 << 18:
        return 13
    if n >= 1 << 16:
        return 12
    if n >= 1 << 13:
        return 10
    return 6 if _small_cpu(n, device) else 8


def _scan_lanes(n: int, device) -> int:
    """Lanes CL of the bucket-accumulation scan; each chain is R = n / CL
    mixed adds long, and the lane-boundary carry scan costs log2(CL)
    complete adds over Wb * CL lanes, so CL shrinks with n."""
    if n >= 1 << 18:
        return 1024
    if n >= 1 << 14:
        return 256
    return 16 if _small_cpu(n, device) else 128


def weight_lanes(nbuckets: int, n: int, device) -> int:
    """Lanes CL2 of the weighted bucket reduction: min(64, buckets rounded up
    to a power of two); for small CPU MSMs a power of two at most
    sqrt(buckets) (2 * R2 row adds and 3 log2(CL2) suffix levels, each over
    Wtot * CL2 lanes or twice that)."""
    if _small_cpu(n, device):
        return max(2, 1 << (nbuckets.bit_length() - 1) // 2)
    return min(64, 1 << (max(nbuckets - 1, 1)).bit_length())


def bucket_sums(A, digits: torch.Tensor, window_bits: int, distinct: bool):
    """Bucket sums of every window of every column: int32[C * W, 16, nbuckets]
    (X, Y, Z), window w of column i at row i * W + w, bucket b at slot b - 1,
    identity (Z = 0) where a window has no digit b.

    A: (Ax, Ay) limb-major [16, n] affine bases (Montgomery; (0, 0) =
    identity); digits: int[C, W, n]. All C*W windows share one sort; each
    window's sorted slots form CL lanes of R = n / CL consecutive slots
    (CL from _scan_lanes, by device), and one bucket_sums_fused call per
    group of windows within _MSM_GROUP_BYTES runs every lane's chain of
    mixed adds, the segmented scan of the lane-boundary carries and the
    carried buckets' adds."""
    C, W, n = digits.shape
    nbuckets = (1 << window_bits) - 1
    flat = digits.reshape(C * W, n).to(torch.int32)
    d_sorted, order = torch.sort(flat, dim=1, stable=True)
    order = order.to(torch.int32)
    bases = cf.pack_bases(*A)
    CL = _scan_lanes(n, digits.device)
    while n % CL:
        CL //= 2

    Wtot = C * W
    group = max(1, _MSM_GROUP_BYTES // (8 * n + 3 * 64 * (nbuckets + CL)))
    parts = [
        cf.bucket_sums_fused(bases, order[i : i + group], d_sorted[i : i + group], CL, nbuckets,
                             distinct)
        for i in range(0, Wtot, group)
    ]
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat([p[j] for p in parts], dim=0) for j in range(3))


def _msm_from_digits(dc: DeviceCurve, A, digits: torch.Tensor, window_bits: int, distinct: bool):
    """Core MSM: affine bases + per-column window digits -> [16, C] Jacobian.

    The weighted bucket reduction T_w = sum_b b * S_b (bucket_weight, on
    blocks of CL2 merged lanes) gives [16, C * W] window sums; the windows
    combine MSB first across all C columns (msm_combine)."""
    _, W, n = digits.shape
    S = bucket_sums(A, digits, window_bits, distinct)
    T = cf.bucket_weight(S, weight_lanes(S[0].shape[-1], n, digits.device))
    return cf.msm_combine(T, W, window_bits)


@torch.inference_mode()
def msm_many_device(dc: DeviceCurve, A, digits: torch.Tensor, window_bits: int, distinct: bool = False):
    """Batched Pippenger MSM over shared affine bases.

    A: (Ax, Ay) limb-major int32[16, n] Montgomery affine bases ((0, 0) =
    identity). digits: int[C, W, n] window digits of C scalar columns.
    Returns Jacobian (X, Y, Z), each int32[16, C]. `distinct=True` uses the
    mixed add without its doubling branch: sound only when no bucket partial
    sum can equal a base (powers-of-tau SRS bases)."""
    return _msm_from_digits(dc, A, digits, window_bits, distinct)


@torch.inference_mode()
def msm_device(dc: DeviceCurve, P, digits: torch.Tensor, window_bits: int):
    """Pippenger MSM of one scalar column. P: (X, Y, Z) limb-major [16, n]
    affine lift, Z in {0, R} (R the Montgomery one, as pack_points gives);
    digits: int[W, n]. A Z = 0 point becomes the (0, 0) base, and the
    column runs msm_many_device with the complete mixed add (distinct=False:
    the bases may repeat). Returns the Jacobian point as [16, 1] coordinates."""
    X, Y, Z = P
    inf = dc.df.is_zero(Z)[None, :]
    A = (torch.where(inf, 0, X), torch.where(inf, 0, Y))
    res = _msm_from_digits(dc, A, digits[None], window_bits, False)
    return tuple(t[:, :1] for t in res)


def pack_scalars(dc: DeviceCurve, scalars: list[int], window_bits: int, device=None):
    """Scalars -> int32[num_windows, n] window digits on `device` (the CUDA
    card unless the caller asks for another)."""
    r = dc.curve.scalar.p
    nbits = r.bit_length()
    num_windows = -(-nbits // window_bits)
    n = len(scalars)
    nbytes = (num_windows * window_bits + 7) // 8
    buf = b"".join((int(s) % r).to_bytes(nbytes, "little") for s in scalars)
    bytes_arr = np.frombuffer(buf, dtype=np.uint8).reshape(n, nbytes)
    bits = np.unpackbits(bytes_arr, axis=1, bitorder="little")
    bits = bits[:, : num_windows * window_bits].reshape(n, num_windows, window_bits)
    weights = (1 << np.arange(window_bits)).astype(np.int64)
    out = (bits * weights).sum(axis=2).T.astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(out)).to(resolve_device(device))
