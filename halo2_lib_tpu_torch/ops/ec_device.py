"""Device elliptic-curve arithmetic: batched Jacobian G1 ops and Pippenger MSM.

The port of ``halo2_lib_tpu/ops/ec_device.py``, the engine of every KZG
commitment. Points are three limb-major ``int32[..., 16, B]`` Montgomery
tensors over Fq (Jacobian X, Y, Z; identity Z == 0). Point add, double and
the mixed Jacobian + affine add are the ``ec_add``/``ec_double``/``ec_madd``
kernels of ops/cuda_field.py; the bucket accumulation is its ``bucket_scan``
kernel, and the MSM's tail its ``bucket_weight`` and ``msm_combine`` kernels.

The MSM is Pippenger with sort + segmented-scan bucket accumulation:
  * per window: sort the points by digit, run every (window, lane) chain of
    mixed adds in one ``bucket_scan`` launch, fix the lane-boundary carries
    with a small segmented scan and pick each bucket's sum by binary search;
  * the weighted bucket reduction runs on merged lanes, all windows at once
    (one ``bucket_weight`` launch);
  * the windows combine MSB first by repeated doubling (one ``msm_combine``
    launch).
The other ``lax.scan``/``fori_loop`` loops of the JAX package are Python
loops of kernel launches here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.curves import ShortWeierstrass
from . import cuda_field as cf
from .limbs import N_LIMBS, DeviceField, ints_to_limbs_T, to_device


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
        self.add = self._add
        self.double = self._double

    def _add(self, P1, P2):
        """Complete add (ec_add kernel)."""
        return cf.ec_add(P1, P2)

    def _double(self, P):
        """Jacobian doubling (ec_double kernel)."""
        return cf.ec_double(P)

    def _madd(self, P1, A2, distinct: bool):
        """Jacobian P1 + affine A2 ((0, 0) = identity) (ec_madd kernel);
        `distinct=True` drops the doubling branch (sound for SRS bases)."""
        return cf.ec_madd(P1, A2, distinct)

    # --- packing ----------------------------------------------------------------
    def pack_points(self, points, device="cpu"):
        """Affine host points ((x, y) or None) -> Jacobian limb-major [16, n]."""
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

    def pack_points_affine(self, points, device="cpu"):
        """Host affine points -> (Ax, Ay) limb-major [16, n] Montgomery,
        identity as the (0, 0) sentinel; the conversion to Montgomery form
        runs as one mont_mul launch per coordinate."""
        xs = [0 if pt is None else pt[0] for pt in points]
        ys = [0 if pt is None else pt[1] for pt in points]
        return tuple(
            self.df._to_mont(to_device(ints_to_limbs_T(v), device)) for v in (xs, ys)
        )

    def identity(self, shape=(), device="cpu") -> tuple:
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


def _seg_scan(dc: DeviceCurve, X, Y, Z, flag, width: int | None = None):
    """Inclusive segmented EC-sum scan along the lane axis (Hillis-Steele).

    `flag` [L] marks segment starts; elements never absorb sums across a
    start. With `width`, every width-lane block is an independent scan."""
    L = X.shape[-1]
    w = width or L
    idx = torch.arange(L, device=X.device) % w
    x, y, z, f = X, Y, Z, flag
    for d in range((w - 1).bit_length()):
        shift = 1 << d
        px, py, pz = (torch.roll(t, shift, dims=-1) for t in (x, y, z))
        pf = torch.roll(f, shift, dims=-1)
        s = dc._add((x, y, z), (px, py, pz))
        use = (~f) & (idx >= shift)
        x, y, z = (_where(use, a, b) for a, b in zip(s, (x, y, z)))
        f = f | (use & pf) | (idx < shift)
    return x, y, z


# Point-slots of one bucket-accumulation group (packed bases 64 B + scan
# outputs 192 B per slot: 2^22 slots ~ 1.1 GB at peak).
_MSM_GROUP_SLOTS = 1 << 22


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


def _pack_pairs(A: torch.Tensor) -> torch.Tensor:
    """[16, nb] limbs -> [8, nb] int32 rows holding limb j | limb j+8 << 16.
    The high limb lands on the sign bit of int32, so the value is built in
    int64 and wrapped explicitly."""
    v = A[: N_LIMBS // 2].to(torch.int64) | (A[N_LIMBS // 2 :].to(torch.int64) << 16)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def _group_bucket_sums(dc: DeviceCurve, A, order, d_sorted, nbuckets: int, distinct: bool):
    """Bucket sums for one group of windows.

    A: (Ax, Ay) limb-major [16, nb] affine bases (Montgomery; (0, 0) =
    identity). order/d_sorted: [Wb, n] sorted digit order per window.
    Returns (bX, bY, bZ) int32[Wb, 16, nbuckets], identity where empty.

    Sorted points are laid out [lanes, R] (lane = contiguous chunk of the
    sorted order); one bucket_scan launch runs every chain, lane-boundary
    carries are fixed by a segmented scan across lanes, and bucket values are
    picked by binary-search gathers.
    """
    Ax, Ay = A
    dev = Ax.device
    Wb, n = d_sorted.shape
    CL = _scan_lanes(n, dev)
    while n % CL:
        CL //= 2
    R = n // CL

    seg_start = torch.cat(
        [torch.ones((Wb, 1), dtype=torch.bool, device=dev), d_sorted[:, 1:] != d_sorted[:, :-1]],
        dim=1,
    )
    live = d_sorted > 0
    Axy = torch.cat([_pack_pairs(Ax), _pack_pairs(Ay)], dim=0)  # [16, nb]
    # order_perm[w, r, l] = sorted position l*R + r
    order_perm = order.reshape(Wb, CL, R).transpose(1, 2)
    g = Axy[:, order_perm.reshape(-1)].reshape(N_LIMBS, Wb, R, CL)
    live_perm = live.reshape(Wb, CL, R).transpose(1, 2)
    g = torch.where(live_perm[None], g, torch.zeros_like(g))
    axy = g.permute(1, 2, 0, 3).contiguous()  # [Wb, R, 16, CL]
    st = seg_start.reshape(Wb, CL, R).transpose(1, 2).to(torch.int32).contiguous()
    out = cf.bucket_scan(axy, st, distinct)  # [Wb, R, 48, CL]
    last = out[:, R - 1]  # [Wb, 48, CL]
    lastv = tuple(last[:, 16 * i : 16 * (i + 1), :] for i in range(3))

    # lane-boundary carries: inclusive segmented scan (across lanes) of each
    # lane's trailing-run sum, shifted right by one lane; all Wb windows' lanes
    # merge into one axis of width-CL blocks
    has_start = seg_start.reshape(Wb, CL, R).any(dim=2)  # [Wb, CL]
    lastm = tuple(t.transpose(0, 1).reshape(N_LIMBS, Wb * CL) for t in lastv)
    cm = _seg_scan(dc, *lastm, has_start.reshape(Wb * CL), width=CL)
    zero = torch.zeros((Wb, N_LIMBS, 1), dtype=torch.int32, device=dev)
    cx, cy, cz = (
        torch.cat([zero, t.reshape(N_LIMBS, Wb, CL).transpose(0, 1)[..., :-1]], dim=-1)
        for t in cm
    )

    # bucket b's lane-local sum sits at the LAST index of digit b; add the
    # lane carry iff b's run began before that lane
    targets = torch.arange(1, nbuckets + 1, device=dev, dtype=d_sorted.dtype)
    targets = targets.expand(Wb, nbuckets).contiguous()
    last_idx = torch.searchsorted(d_sorted, targets, right=True) - 1  # [Wb, nbuckets]
    first_idx = torch.searchsorted(d_sorted, targets, right=False)
    present = last_idx >= first_idx
    safe_idx = last_idx.clamp(0, n - 1)
    lane = safe_idx // R
    idx_r = safe_idx % R
    # vals[w, c, b] = out[w, idx_r[b], c, lane[b]]
    cols = torch.arange(3 * N_LIMBS, device=dev)
    lin = (idx_r[:, None, :] * (3 * N_LIMBS) + cols[None, :, None]) * CL + lane[:, None, :]
    vals = torch.gather(out.reshape(Wb, R * 3 * N_LIMBS * CL), 1, lin.reshape(Wb, -1))
    vals = vals.reshape(Wb, 3 * N_LIMBS, nbuckets)
    bX, bY, bZ = vals[:, :N_LIMBS], vals[:, N_LIMBS : 2 * N_LIMBS], vals[:, 2 * N_LIMBS :]
    # add the carry only to the buckets whose run began in an earlier lane (at
    # most one per lane): gather them, one add, scatter back
    wi, bi = torch.nonzero(first_idx < lane * R, as_tuple=True)
    li = lane[wi, bi]
    fixed = dc._add(
        tuple(t[wi, :, bi].T for t in (bX, bY, bZ)),
        tuple(t[wi, :, li].T for t in (cx, cy, cz)),
    )
    bX, bY, bZ = (t.clone() for t in (bX, bY, bZ))
    for t, f in zip((bX, bY, bZ), fixed):
        t[wi, :, bi] = f.T
    bZ = _where(present, bZ, torch.zeros_like(bZ))
    return bX, bY, bZ


def bucket_sums(dc: DeviceCurve, A, digits: torch.Tensor, window_bits: int, distinct: bool):
    """Bucket sums of every window of every column: int32[C * W, 16, nbuckets]
    (X, Y, Z), window w of column i at row i * W + w, bucket b at slot b - 1.

    digits: int[C, W, n]. All C*W windows share one sort and are
    bucket-accumulated in memory-budgeted groups."""
    C, W, n = digits.shape
    nbuckets = (1 << window_bits) - 1
    flat = digits.reshape(C * W, n).to(torch.int64)
    d_sorted, order = torch.sort(flat, dim=1, stable=True)

    Wtot = C * W
    divs = [g for g in range(1, Wtot + 1) if Wtot % g == 0 and g * n <= _MSM_GROUP_SLOTS]
    good = [g for g in divs if g % 4 == 0] or divs or [1]
    group = Wtot if Wtot * n <= _MSM_GROUP_SLOTS else max(good)
    parts = [
        _group_bucket_sums(dc, A, order[i : i + group], d_sorted[i : i + group], nbuckets, distinct)
        for i in range(0, Wtot, group)
    ]
    return tuple(torch.cat([p[j] for p in parts], dim=0) for j in range(3))


def _msm_from_digits(dc: DeviceCurve, A, digits: torch.Tensor, window_bits: int, distinct: bool):
    """Core MSM: affine bases + per-column window digits -> [16, C] Jacobian.

    The weighted bucket reduction T_w = sum_b b * S_b (bucket_weight, on
    blocks of CL2 merged lanes) gives [16, C * W] window sums; the windows
    combine MSB first across all C columns (msm_combine)."""
    _, W, n = digits.shape
    S = bucket_sums(dc, A, digits, window_bits, distinct)
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


def pack_scalars(dc: DeviceCurve, scalars: list[int], window_bits: int, device="cpu"):
    """Scalars -> int32[num_windows, n] window digits."""
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
    return torch.from_numpy(np.ascontiguousarray(out)).to(device)
