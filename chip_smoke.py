#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (halo2_lib_tpu_torch) once on one NVIDIA card.

    python3 chip_smoke.py [--ptxas]

(--ptxas prints each kernel's registers and spills from nvcc.) Phases, each
printing its own lines; any failure raises and exits non-zero:

1. build   - compile the CUDA kernels from halo2_lib_tpu_torch/csrc (nvcc).
2. kernels - every kernel against its plain PyTorch version on the card, at a
             ragged size, bit for bit (ec_add and ec_madd with identity
             operands, P + P and P + (-P) lanes, ec_madd with (0, 0) bases and
             both `distinct` values; the MSM tail's bucket_weight at 2, 8 and
             64 lanes with empty, repeated and inverse bucket sums, and
             msm_combine at 1 and 42 columns with a doubling and an identity
             lane; bucket_sums_fused at 8, 16 and 256 lanes and a ragged
             window count, with a run across many lanes, one bucket filling a
             window, dead windows (digit 0), buckets below every digit, P + P
             (distinct False) and P + (-P) in a run, and also against the
             composition it replaced (bucket_scan, the lane-carry scan of
             single ec_add launches, the pick and the fix; kept here, not in
             the package); colntt at A = 2..1024, with and without the mid,
             ragged B, tw[0] random and the Montgomery one); ntt_small at n =
             2..2^11 and C = 1, 3, 12 and 65 columns, forward and inverse,
             without diagonals, with the pre row, the post scalar (1/n), the
             post row (shift^-i / n), and both with random twiddles, with 0,
             1, p - 1 and R mod p among the values, also against the per-stage
             composition it replaced (ntt_butterfly launches, the torch
             interleave and the mont_mul scalings; kept here, not in the
             package); commit_dbl_add
             at (C, m) = (1, 1), (3, 13), (8, 512) and (3, 1024) with
             scalars 0, 1 and r - 1, an all-zero column and a (0, 0) base,
             also against the per-bit composition it replaced (ec_double,
             ec_madd, select, then the ec_add lane tree; kept here, not in
             the package); fermat_inv on both fields at [1, 16, 1],
             [11, 16, 1] and [3, 16, 1000] with 0, 1, p - 1, R mod p and
             2^-1 among random values.
3. k=9     - keygen + create_proof of the golden circuit (seconds of each
             printed); the vk and proof bytes must equal the JAX package's
             goldens in tests/data/torch_goldens/. Its domains (2^9, 2^11)
             take the radix-2 NTT, one ntt_small launch per NTT call (8),
             and its commits (m = 2^9 <= 1024) the fused double-and-add, one
             commit_dbl_add launch per commit call, never Pippenger,
             ec_madd, ec_double or ec_add. Then one k=9 commit is timed three
             ways: the old per-bit loop, commit_dbl_add (Jacobian-equal to
             it) and Pippenger (equal in affine form).
3b. phases - the two other k=9 circuits: the two-phase RLC circuit
             (create_proof with phase_fns) and the RAM circuit (dynamic
             lookup): keygen, create_proof, verify_proof and a tampered proof
             rejected, vk and proof bytes equal to the JAX goldens
             (multiphase_k9.npz, dynlookup_k9.npz); launches and the NTT
             domains each took printed, one ntt_small launch per NTT call
             below 2^12 points.
4. k=15    - keygen -> create_proof -> verify_proof of the slice circuit (4
             advice + 1 lookup column, every column 2^15 rows), with a
             tampered proof rejected and the proof's SHA-256 held against the
             JAX digest. Its domains (2^15, 2^17) take the four-step NTT
             (colntt) and its commits Pippenger (bucket_sums_fused).
4b. ECDSA  - the main path at full width: the repo's secp256k1 ECDSA-verify
             circuit (bench.py's, 18 advice + 3 lookup-advice + 1 fixed
             column at k=15): keygen, then the pinned prover builder's
             witness and create_proof, then verify_proof and a tampered proof
             rejected; the proof's and the vk's SHA-256 held against the JAX
             package's (ecdsa_k15.json).
             Kernel launch counts (and the NTT and commit calls) are reset
             just before phases 3, 3b, 4 and 4b and read just after each;
             every kernel must have launched in the phases whose paths run
             it: k=9 every kernel but colntt and the Pippenger ones
             (bucket_sums_fused, bucket_weight, msm_combine); k=15 and ECDSA
             every kernel but ntt_small and commit_dbl_add (the MSM is
             bucket_sums_fused, bucket_weight and msm_combine, one launch
             each per MSM call). ntt_small launches once per NTT call below
             2^12 points in every phase (none at k=15 and ECDSA, whose
             domains are 2^15 and 2^17). The literal ports ntt_butterfly,
             ec_madd, ec_double, ec_add and bucket_scan run on no path: 0
             launches in all of them.
5. timing  - every kernel again, at the largest shapes the main path gave it
             (ntt_butterfly, ec_madd, ec_double, ec_add and bucket_scan, off
             the path, at the shapes they had on it before their fusion):
             kernel time, plain version time and the bound, as one JSON line;
             the fused kernels' and fermat_inv's serial chains on [timing]
             lines, commit_dbl_add also at m = 1024, and ntt_small beside
             the per-stage composition it replaced, at the same shape.
5b. MSM    - one whole MSM at the ECDSA advice commit's shape (21 columns x
             2^15 points, window 10, distinct bases), in turns old, new, new,
             old: "old" accumulates the buckets by the bucket_scan composition
             (grouped as before, 91 windows a group), "new" is
             msm_many_device (bucket_sums_fused); both end in the fused tail
             and must give the same bucket sums and Jacobian points. Whole-MSM
             milliseconds and each stage's (CUDA events: sort, gather, scan,
             carry, pick; or sort, pack, fused) per turn; then the step-loop
             tail (the loop of single point ops) against the fused one
             (equal points, both timed), ec_add at [16, 139776], and the
             Montgomery product alone: a
             chain of dependent products per thread with the carry-chain
             product and with the 64-bit C one it replaced (products/s of
             each, in turns, outputs equal).

The last line is {"ok": true, "device": {...}}. Without a CUDA device the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and the 32-bit scalar
# rate outside the tensor cores (the 67 TFLOP/s float32 line, also used for
# 32-bit integer multiply-adds: a lower bound on their time).
PEAK_BYTES = 3.35e12
PEAK_OPS32 = 67e12
# 32-bit operations of one Montgomery product (CIOS, 8 x 32-bit words):
# 136 partial products, each a low and a high multiply-add.
MM_OPS = 2 * 136
SOURCES = {
    "mont_mul": ("csrc/field_kernels.cu", "halo2_lib_tpu/ops/pallas_field.py:300"),
    "field_add": ("csrc/field_kernels.cu", "halo2_lib_tpu/ops/pallas_field.py:817"),
    "field_sub": ("csrc/field_kernels.cu", "halo2_lib_tpu/ops/pallas_field.py:822"),
    "fermat_inv": ("csrc/fermat_kernel.cu", "halo2_lib_tpu/ops/pallas_field.py:755"),
    "ntt_butterfly": ("csrc/ntt_kernels.cu", "halo2_lib_tpu/ops/pallas_field.py:708"),
    # every stage of a small transform: the stage loop of _butterfly_kernel
    # calls and the coset / 1/n scalings around it
    "ntt_small": ("csrc/ntt_kernels.cu", "halo2_lib_tpu/ops/pallas_field.py:708"),
    "colntt": ("csrc/ntt_kernels.cu", "halo2_lib_tpu/ops/ntt4.py:67"),
    "ec_add": ("csrc/ec_kernels.cu", "halo2_lib_tpu/ops/pallas_field.py:304"),
    "ec_double": ("csrc/ec_kernels.cu", "halo2_lib_tpu/ops/pallas_field.py:448"),
    "ec_madd": ("csrc/ec_kernels.cu", "halo2_lib_tpu/ops/pallas_field.py:430"),
    "bucket_scan": ("csrc/ec_kernels.cu", "halo2_lib_tpu/ops/pallas_field.py:620"),
    # the bucket accumulation with its lane-carry scan, pick and fix
    # (ec_device.py:463-591 around _bucket_scan_kernel)
    "bucket_sums_fused": ("csrc/ec_kernels.cu", "halo2_lib_tpu/ops/pallas_field.py:620"),
    # the fused MSM tail: the lax.scan / fori_loop bodies of single
    # _ec_add_kernel / _ec_double_kernel calls at ec_device.py:624-688
    "bucket_weight": ("csrc/ec_kernels.cu", "halo2_lib_tpu/ops/pallas_field.py:304"),
    "msm_combine": ("csrc/ec_kernels.cu", "halo2_lib_tpu/ops/pallas_field.py:448"),
    # the small-column commit: the lax.scan of _ec_double_kernel and
    # _ec_madd_kernel steps and the _ec_add_kernel lane tree
    "commit_dbl_add": ("csrc/ec_kernels.cu", "halo2_lib_tpu/ops/pallas_field.py:430"),
}
# kernels the main path no longer launches: (work, shape) as LARGEST kept
# them on the last path that ran them (ECDSA for bucket_scan, k=9 for the
# single point ops and the butterfly)
OFF_PATH_SHAPES = {
    "ntt_butterfly": (0, ((12, 16, 1024), (16, 1024))),
    "bucket_scan": (0, ((91, 128, 16, 256), True)),
    "ec_add": (0, ((8, 16, 256),)),
    "ec_double": (0, ((8, 16, 512),)),
    "ec_madd": (0, ((8, 16, 512), (16, 512), False)),
}
FUSES = {
    "ntt_small": "halo2_lib_tpu/ops/ntt.py:159-245, halo2_lib_tpu/ops/ntt.py:315-323",
    "bucket_sums_fused": "halo2_lib_tpu/ops/ec_device.py:463-591",
    "bucket_weight": "halo2_lib_tpu/ops/ec_device.py:624-674",
    "msm_combine": "halo2_lib_tpu/ops/ec_device.py:676-688",
    "commit_dbl_add": "halo2_lib_tpu/backend/kzg.py:499-519, halo2_lib_tpu/ops/ec_device.py:308",
}
# 32-bit operations of one batch of the inversion (csrc/fermat_kernel.cu):
# the 2x2 matrix on (d, e), 6 multiply-adds a limb with the multiple of p,
# and on (f, g), 4 a limb, over 9 limbs, each a 32 x 32 -> 64-bit product
# (a low and a high half); and 30 divsteps of about 10 operations.
INV_BATCH_OPS = 2 * 9 * (6 + 4) + 10 * 30


def log(msg: str) -> None:
    print(msg, flush=True)


def rand_limbs(gen, shape, torch, p: int):
    """Random canonical field elements below p (limb-major int32)."""
    x = torch.randint(0, 1 << 16, shape, generator=gen, dtype=torch.int32, device="cuda")
    x[..., 15, :] %= p >> 240  # top limb below p's: value < p
    return x


def special_lanes(S, cf, torch):
    """Random Jacobian coordinates S (three [.., 16, B]) with, every seven
    lanes, an identity (Z = 0), a copy of the lane before (equal points: the
    doubling branch of a complete add or of an MSM row chain) and a negation
    of it (P + (-P))."""
    X, Y, Z = (t.clone() for t in S)

    def from_lane_before(t, src, lane):
        n = t[..., lane::7].shape[-1]
        t[..., lane::7] = src[..., lane - 1 :: 7][..., :n]

    Z[..., 3::7] = 0
    for t in (X, Y, Z):
        from_lane_before(t, t, 5)
    negY = cf.field_sub_plain(cf.FQ, torch.zeros_like(Y), Y)
    from_lane_before(X, X, 2)
    from_lane_before(Z, Z, 2)
    from_lane_before(Y, negY, 2)
    return X, Y, Z


def combine_specials(T, W: int, c: int, cf, torch):
    """In place: column 0 of the window sums T ([16, C * W], lane = column *
    W + w) meets res == T_{W-2} after its c doublings (the doubling branch);
    the last column, where C > 1, res == -T_{W-2} (the identity)."""
    C = T[0].shape[-1] // W
    top = tuple(t[:, W - 1 : W] for t in T)
    D = top
    for _ in range(c):
        D = cf.ec_double_plain(D)
    negD = (D[0], cf.field_sub_plain(cf.FQ, torch.zeros_like(D[1]), D[1]), D[2])
    for t, p, d, nd in zip(T, top, D, negD):
        t[:, W - 2 : W - 1] = d
        if C > 1:
            t[:, C * W - 1 : C * W] = p
            t[:, C * W - 2 : C * W - 1] = nd


class Stages:
    """CUDA-event stage timer: mark(name) closes the stage that began at the
    previous mark; ms() reads them after a synchronize."""

    def __init__(self, torch):
        self.torch = torch
        self.events = [(None, self._record())]

    def _record(self):
        e = self.torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def mark(self, name: str) -> None:
        self.events.append((name, self._record()))

    def ms(self) -> dict:
        self.torch.cuda.synchronize()
        out = {}
        for (_, a), (name, b) in zip(self.events, self.events[1:]):
            out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out


def divsteps_needed(x: int, p: int) -> int:
    """Divsteps the inversion kernel runs on x before g = 0 (one at a time on
    whole integers, eta = -delta from -1, as the kernel starts)."""
    eta, f, g, n = -1, p, x, 0
    while g:
        if g & 1:
            if eta < 0:
                eta, f, g = -eta, g, -f
            g += f
        g >>= 1
        eta -= 1
        n += 1
    return n


def old_commit_double_and_add(cf, dc, scalars, Ax, Ay):
    """backend/kzg.py:commit_double_and_add before the fusion, on canonical
    scalars [C, 16, m]: the 254 one-bit windows MSB first, per bit one
    ec_double and one ec_madd launch (with its doubling branch) over all C
    * m lanes and a select, then DeviceCurve.tree_reduce (ec_add launches)
    -> Jacobian [16, C]."""
    C, _, m = scalars.shape
    Am = (Ax[:, :m].contiguous(), Ay[:, :m].contiguous())
    acc = dc.identity((C, m), scalars.device)
    for b in range(253, -1, -1):
        bit = ((scalars[:, b // 16, :] >> (b % 16)) & 1) != 0
        acc = cf.ec_double(acc)
        acc = dc.select(bit, cf.ec_madd(acc, Am, False), acc)
    X, Y, Z = dc.tree_reduce(acc)  # [C, 16, 1]
    return tuple(t[..., 0].transpose(0, 1) for t in (X, Y, Z))


def old_stage_tables(torch, tw):
    """The per-stage twiddle rows ops/ntt.py built once per table before the
    fusion: stage (n, s) uses w^(p s) at lane p s + j of the halves."""
    N = 2 * tw.shape[1]
    out, n, s = [], N, 1
    while n > 1:
        m = n // 2
        out.append(tw[:, ::s][:, :m, None].expand(16, m, s).reshape(16, N // 2).contiguous())
        n, s = m, 2 * s
    return out


def old_ntt_small(cf, torch, fid, x, stage_tw, pre=None, post=None):
    """ops/ntt.py's NTT and CosetNTT before the fusion, on x [C, 16, n]: the
    pre product (one mont_mul launch), then per stage one ntt_butterfly
    launch over the two halves (which its wrapper copies contiguous) and the
    interleave (a torch stack and reshape), then the post product (one
    mont_mul launch; the inverse coset took two, 1/n and then the shift
    powers, with the same result)."""
    C, _, N = x.shape
    if pre is not None:
        x = cf.mont_mul(fid, x, pre)
    n, s = N, 1
    for wp in stage_tw:
        m = n // 2
        top, bot = cf.ntt_butterfly(fid, x[..., : N // 2], x[..., N // 2 :], wp)
        x = torch.stack([top.reshape(C, 16, m, s), bot.reshape(C, 16, m, s)], dim=-2)
        x = x.reshape(C, 16, N)
        n, s = m, 2 * s
    return x if post is None else cf.mont_mul(fid, x, post)


def ntt_chain(spec) -> tuple[int, int]:
    """(products a thread of ntt_small runs, its dependent chain) at spec:
    4 elements a thread, so 2 butterflies a stage, and the diagonal
    products of its 4 elements."""
    (_, _, n), with_pre, post_n = spec
    logn = n.bit_length() - 1
    diag = int(with_pre) + int(post_n > 0)
    return 2 * logn + 4 * diag, logn + diag


def commit_case(gen, torch, cf, spec, P: dict):
    """Inputs of commit_dbl_add at spec ((C, 16, m), (16, n)): random
    canonical Fr scalars and Fq bases (the formulas need no curve points to
    agree with their plain version); lanes 0-2 of column 0 hold the scalars
    0, 1 and r - 1, the last column of three or more is all zeros (its sum
    the identity), and base 3 is (0, 0)."""
    (C, _, m), (_, n) = spec
    scal = rand_limbs(gen, (C, 16, m), torch, P[cf.FR])
    r = P[cf.FR]
    for lane, v in enumerate((0, 1, r - 1)[:m]):
        scal[0, :, lane] = torch.tensor([(v >> (16 * i)) & 0xFFFF for i in range(16)],
                                        dtype=torch.int32, device="cuda")
    if C >= 3:
        scal[C - 1] = 0
    Ax, Ay = (rand_limbs(gen, (16, n), torch, P[cf.FQ]) for _ in range(2))
    if m > 3:
        Ax[:, 3] = Ay[:, 3] = 0
    return scal, Ax, Ay


def commit_work(scalars, m: int):
    """(Montgomery products commit_dbl_add runs on these scalars, the longest
    thread's chain of them): per lane, a doubling (7) at and below its top
    bit and a mixed add (11) at each set bit but the first (which meets the
    identity); then m - 1 complete adds (16) per column, log2(m) levels."""
    tops, sets = [], []
    for x in scalars:
        tops.append(x.bit_length())
        sets.append(bin(x).count("1"))
    lane = [7 * t + 11 * max(s - 1, 0) for t, s in zip(tops, sets)]
    C = len(scalars) // m
    levels = (m - 1).bit_length()
    return sum(lane) + 16 * C * (m - 1), max(lane) + 16 * levels


def old_seg_scan(cf, torch, X, Y, Z, flag, width: int):
    """The lane-carry scan before the fusion: Hillis-Steele levels of single
    ec_add launches and torch rolls and selects (ops/ec_device.py before
    the fusion)."""
    idx = torch.arange(X.shape[-1], device=X.device) % width
    x, y, z, f = X, Y, Z, flag
    for d in range((width - 1).bit_length()):
        shift = 1 << d
        px, py, pz = (torch.roll(t, shift, dims=-1) for t in (x, y, z))
        pf = torch.roll(f, shift, dims=-1)
        s = cf.ec_add((x, y, z), (px, py, pz))
        use = (~f) & (idx >= shift)
        x, y, z = (torch.where(use[..., None, :], a, b) for a, b in zip(s, (x, y, z)))
        f = f | (use & pf) | (idx < shift)
    return x, y, z


def old_group_bucket_sums(cf, torch, A, order, d_sorted, nbuckets: int, distinct: bool, CL: int,
                          st=None):
    """The bucket accumulation before the fusion (ops/ec_device.py,
    _group_bucket_sums before the fusion): the packed gather of the bases into the
    [Wb, R, 16, CL] scan layout, one bucket_scan launch writing every step,
    the lane-carry scan, the binary-search pick of each bucket's last slot
    and one ec_add for the buckets whose run began in an earlier lane. `st`
    (a Stages) marks gather, scan, carry and pick."""
    Ax, Ay = A
    dev = Ax.device
    Wb, n = d_sorted.shape
    R = n // CL
    mark = st.mark if st is not None else (lambda name: None)
    order, d_sorted = order.to(torch.int64), d_sorted.to(torch.int64)
    seg_start = torch.cat(
        [torch.ones((Wb, 1), dtype=torch.bool, device=dev), d_sorted[:, 1:] != d_sorted[:, :-1]],
        dim=1,
    )
    live = d_sorted > 0

    def pack_pairs(t):
        v = t[:8].to(torch.int64) | (t[8:].to(torch.int64) << 16)
        return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)

    Axy = torch.cat([pack_pairs(Ax), pack_pairs(Ay)], dim=0)
    order_perm = order.reshape(Wb, CL, R).transpose(1, 2)
    g = Axy[:, order_perm.reshape(-1)].reshape(16, Wb, R, CL)
    live_perm = live.reshape(Wb, CL, R).transpose(1, 2)
    g = torch.where(live_perm[None], g, torch.zeros_like(g))
    axy = g.permute(1, 2, 0, 3).contiguous()
    sst = seg_start.reshape(Wb, CL, R).transpose(1, 2).to(torch.int32).contiguous()
    mark("gather")
    out = cf.bucket_scan(axy, sst, distinct)
    mark("scan")
    last = out[:, R - 1]
    lastv = tuple(last[:, 16 * i : 16 * (i + 1), :] for i in range(3))
    has_start = seg_start.reshape(Wb, CL, R).any(dim=2)
    lastm = tuple(t.transpose(0, 1).reshape(16, Wb * CL) for t in lastv)
    cm = old_seg_scan(cf, torch, *lastm, has_start.reshape(Wb * CL), CL)
    zero = torch.zeros((Wb, 16, 1), dtype=torch.int32, device=dev)
    cx, cy, cz = (
        torch.cat([zero, t.reshape(16, Wb, CL).transpose(0, 1)[..., :-1]], dim=-1) for t in cm
    )
    mark("carry")
    targets = torch.arange(1, nbuckets + 1, device=dev, dtype=d_sorted.dtype)
    targets = targets.expand(Wb, nbuckets).contiguous()
    last_idx = torch.searchsorted(d_sorted, targets, right=True) - 1
    first_idx = torch.searchsorted(d_sorted, targets, right=False)
    present = last_idx >= first_idx
    safe_idx = last_idx.clamp(0, n - 1)
    lane = safe_idx // R
    idx_r = safe_idx % R
    cols = torch.arange(48, device=dev)
    lin = (idx_r[:, None, :] * 48 + cols[None, :, None]) * CL + lane[:, None, :]
    vals = torch.gather(out.reshape(Wb, R * 48 * CL), 1, lin.reshape(Wb, -1))
    vals = vals.reshape(Wb, 48, nbuckets)
    bX, bY, bZ = vals[:, :16], vals[:, 16:32], vals[:, 32:]
    wi, bi = torch.nonzero(first_idx < lane * R, as_tuple=True)
    li = lane[wi, bi]
    fixed = cf.ec_add(
        tuple(t[wi, :, bi].T for t in (bX, bY, bZ)),
        tuple(t[wi, :, li].T for t in (cx, cy, cz)),
    )
    bX, bY, bZ = (t.clone() for t in (bX, bY, bZ))
    for t, f in zip((bX, bY, bZ), fixed):
        t[wi, :, bi] = f.T
    bZ = torch.where(present[:, None, :], bZ, torch.zeros_like(bZ))
    mark("pick")
    return bX, bY, bZ


def old_bucket_sums(cf, torch, A, digits, window_bits: int, distinct: bool, CL: int, st=None):
    """ops/ec_device.py:bucket_sums before the fusion: one sort, then groups of
    windows within 2^22 point-slots (91 windows a group at n = 2^15)."""
    C, W, n = digits.shape
    nbuckets = (1 << window_bits) - 1
    flat = digits.reshape(C * W, n).to(torch.int64)
    d_sorted, order = torch.sort(flat, dim=1, stable=True)
    if st is not None:
        st.mark("sort")
    Wtot = C * W
    divs = [g for g in range(1, Wtot + 1) if Wtot % g == 0 and g * n <= 1 << 22]
    good = [g for g in divs if g % 4 == 0] or divs or [1]
    group = Wtot if Wtot * n <= 1 << 22 else max(good)
    parts = [
        old_group_bucket_sums(cf, torch, A, order[i : i + group], d_sorted[i : i + group],
                              nbuckets, distinct, CL, st)
        for i in range(0, Wtot, group)
    ]
    return tuple(torch.cat([p[j] for p in parts], dim=0) for j in range(3))


def bucket_case(gen, torch, cf, spec, p: int, special: bool):
    """Inputs of bucket_sums_fused at spec ((Wtot, n), (npts, 16), lanes,
    nbuckets, distinct): random canonical Fq bases (point-major words) and
    random window digits, sorted. With `special`, windows 0-5 hold: bases 0
    and 1 (equal: P + P) alone in bucket 5; bases 0 and 2 (P, -P) alone in
    bucket 6; every digit 0; one bucket everywhere; a run of n/2 slots in
    bucket 1 between digits >= 3; no digit below 4. Returns (args, A) with A
    the limb-major affine bases."""
    (Wtot, n), (npts, _), lanes, nb, distinct = spec
    Ax, Ay = (rand_limbs(gen, (16, npts), torch, p) for _ in range(2))
    digits = torch.randint(0, nb + 1, (Wtot, n), generator=gen, device="cuda", dtype=torch.int32)
    if special:
        Ax[:, 1], Ay[:, 1] = Ax[:, 0], Ay[:, 0]
        Ax[:, 2] = Ax[:, 0]
        Ay[:, 2:3] = cf.field_sub_plain(cf.FQ, torch.zeros_like(Ay[:, :1]), Ay[:, :1])
        digits[0][digits[0] == 5] = 4
        digits[0, :2] = 5
        digits[1][digits[1] == 6] = 7
        digits[1, 0] = digits[1, 2] = 6
        digits[2] = 0
        digits[3] = min(nb, 7)
        digits[4] = torch.where(digits[4] < 3, 3, digits[4])
        digits[4, n // 4 : 3 * n // 4] = 1
        digits[5] = torch.clamp(digits[5], min=min(nb, 4))
    d_sorted, order = torch.sort(digits, dim=1, stable=True)
    return (cf.pack_bases(Ax, Ay), order.to(torch.int32), d_sorted, lanes, nb, distinct), (Ax, Ay)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, HERE)
    import numpy as np

    from halo2_lib_tpu_torch.backend.keygen import keygen
    from halo2_lib_tpu_torch.backend.kzg import (
        ParamsKZG, _pack_affine, commit_double_and_add, window_digits,
    )
    from halo2_lib_tpu_torch.backend.prover import create_proof
    from halo2_lib_tpu_torch.backend.verifier import verify_proof
    from halo2_lib_tpu_torch.ops import cuda_field as cf
    from halo2_lib_tpu_torch.ops.ec_device import (
        DeviceCurve, _scan_lanes, msm_many_device, msm_window_bits, weight_lanes,
    )
    from halo2_lib_tpu_torch.ops.limbs import DeviceField, limbs_to_ints
    from halo2_lib_tpu_torch.ops.ntt import NTT
    from halo2_lib_tpu_torch.backend.kzg import COMMIT_SIMPLE_MAX
    from halo2_lib_tpu_torch.utils.curves import BN254_G1
    from halo2_lib_tpu_torch.utils.fields import FQ_BN254, FR_BN254
    from halo2_lib_tpu_torch.utils.pinning import pinning_of
    from halo2_lib_tpu_torch.utils.testing import (
        ecdsa_circuit, ecdsa_inputs, ecdsa_witness, golden_circuit, ram_circuit, rlc_circuit,
        rlc_prover, slice_circuit,
    )

    dev = torch.device("cuda")
    P = {cf.FR: FR_BN254.p, cf.FQ: FQ_BN254.p}
    fr_df = DeviceField(FR_BN254)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    # --- 1. build ---------------------------------------------------------------
    t = time.time()
    cf.build(verbose="--ptxas" in sys.argv)
    log(f"[build] kernels built in {time.time() - t:.2f}s; load {cf.load():.3f}s")

    # --- kernel calls on given inputs (kernel and plain) -------------------------
    def make_inputs(name: str, spec):
        """Random inputs for kernel `name` at shapes `spec` (LARGEST's
        shapes)."""
        if name in ("mont_mul", "field_add", "field_sub"):
            (sa, sb), fid = spec, cf.FR
            return fid, (rand_limbs(gen, sa, torch, P[fid]), rand_limbs(gen, sb, torch, P[fid]))
        if name == "fermat_inv":
            (sa,) = spec
            return cf.FR, (rand_limbs(gen, sa, torch, P[cf.FR]),)
        if name == "commit_dbl_add":
            return cf.FQ, commit_case(gen, torch, cf, spec, P)
        if name == "ntt_butterfly":
            sa, sw = spec
            a = rand_limbs(gen, sa, torch, P[cf.FR])
            return cf.FR, (a, rand_limbs(gen, sa, torch, P[cf.FR]), rand_limbs(gen, sw, torch, P[cf.FR]))
        if name == "ntt_small":
            # the NTT's own table (inverse where a post diagonal is given)
            (C, _, n), with_pre, post_n = spec
            tw = NTT(fr_df, n.bit_length() - 1, dev).tw[post_n == 0]
            x = rand_limbs(gen, (C, 16, n), torch, P[cf.FR])
            pre = rand_limbs(gen, (16, n), torch, P[cf.FR]) if with_pre else None
            post = rand_limbs(gen, (16, post_n), torch, P[cf.FR]) if post_n else None
            return cf.FR, (x, tw, pre, post)
        if name == "colntt":
            (L, A, _, B), with_mid = spec
            x = rand_limbs(gen, (L, A, 16, B), torch, P[cf.FR])
            tw = rand_limbs(gen, (16, A // 2), torch, P[cf.FR])
            mid = rand_limbs(gen, (A, 16, B), torch, P[cf.FR]) if with_mid else None
            return cf.FR, (x, tw, mid)
        if name in ("ec_add", "ec_double"):
            (shape,) = spec
            n = 6 if name == "ec_add" else 3
            pts = [rand_limbs(gen, shape, torch, P[cf.FQ]) for _ in range(n)]
            # exercise the special cases: identities, P + P, P + (-P)
            if name == "ec_add":
                B = shape[-1]
                pts[2][..., : B // 8] = 0  # P1 = O
                pts[5][..., B // 8 : B // 4] = 0  # P2 = O
                for i in range(3):  # P2 = P1
                    pts[3 + i][..., B // 4 : B // 2] = pts[i][..., B // 4 : B // 2]
                neg = cf.field_sub_plain(cf.FQ, torch.zeros_like(pts[1]), pts[1])
                pts[3][..., B // 2 : 5 * B // 8] = pts[0][..., B // 2 : 5 * B // 8]
                pts[4][..., B // 2 : 5 * B // 8] = neg[..., B // 2 : 5 * B // 8]
                pts[5][..., B // 2 : 5 * B // 8] = pts[2][..., B // 2 : 5 * B // 8]
            return cf.FQ, (tuple(pts[:3]), tuple(pts[3:])) if name == "ec_add" else (tuple(pts),)
        if name == "ec_madd":
            shape, ashape, distinct = spec
            P1 = [rand_limbs(gen, shape, torch, P[cf.FQ]) for _ in range(3)]
            A2 = [rand_limbs(gen, ashape, torch, P[cf.FQ]) for _ in range(2)]
            # the special cases, on lane ranges: accumulator = identity, base =
            # (0, 0), both, base == accumulator (Z = 1; the doubling branch),
            # base == -accumulator
            B = shape[-1]
            cut = [B * i // 10 for i in range(6)]
            one = torch.tensor(
                [((1 << 256) % P[cf.FQ] >> (16 * i)) & 0xFFFF for i in range(16)],
                dtype=torch.int32, device="cuda",
            )[:, None]
            P1[2][..., cut[0] : cut[1]] = 0
            A2[0][..., cut[1] : cut[3]] = 0
            A2[1][..., cut[1] : cut[3]] = 0
            P1[2][..., cut[2] : cut[3]] = 0
            lanes = slice(cut[3], cut[5])
            P1[0][..., lanes] = A2[0][..., lanes]
            P1[1][..., lanes] = A2[1][..., lanes]
            P1[2][..., lanes] = one
            neg = cf.field_sub_plain(cf.FQ, torch.zeros_like(A2[1]), A2[1])
            P1[1][..., cut[4] : cut[5]] = neg[..., cut[4] : cut[5]]
            return cf.FQ, (tuple(P1), tuple(A2), bool(distinct))
        if name == "bucket_scan":
            shape, distinct = spec
            Wb, R, _, CL = shape
            x = rand_limbs(gen, (Wb, R, 16, CL), torch, P[cf.FQ])
            y = rand_limbs(gen, (Wb, R, 16, CL), torch, P[cf.FQ])
            axy = torch.cat(
                [cf_pack(x, torch), cf_pack(y, torch)], dim=2
            )  # [Wb, R, 16, CL]
            dead = torch.rand((Wb, R, 1, CL), generator=gen, device="cuda") < 0.05
            axy = torch.where(dead, torch.zeros_like(axy), axy)
            start = (torch.rand((Wb, R, CL), generator=gen, device="cuda") < 1 / 16).to(torch.int32)
            return cf.FQ, (axy, start, bool(distinct))
        if name == "bucket_sums_fused":
            return cf.FQ, bucket_case(gen, torch, cf, spec, P[cf.FQ], special=True)[0]
        if name == "bucket_weight":
            shape, lanes = spec
            S = [rand_limbs(gen, shape, torch, P[cf.FQ]) for _ in range(3)]
            return cf.FQ, (special_lanes(S, cf, torch), lanes)
        if name == "msm_combine":
            shape, W, c = spec
            T = special_lanes([rand_limbs(gen, shape, torch, P[cf.FQ]) for _ in range(3)],
                              cf, torch)
            combine_specials(T, W, c, cf, torch)
            return cf.FQ, (T, W, c)
        raise KeyError(name)

    def cf_pack(x, torch):
        v = x[..., :8, :].to(torch.int64) | (x[..., 8:, :].to(torch.int64) << 16)
        return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)

    def run(name, fid, args, plain: bool):
        if name in ("mont_mul", "field_add", "field_sub"):
            fn = getattr(cf, f"{name}_plain" if plain else name)
            return (fn(fid, *args),)
        if name == "fermat_inv":
            return ((cf.fermat_inv_plain if plain else cf.fermat_inv)(fid, *args),)
        if name == "ntt_butterfly":
            return (cf.ntt_butterfly_plain if plain else cf.ntt_butterfly)(fid, *args)
        if name == "colntt":
            return ((cf.colntt_plain if plain else cf.colntt)(fid, *args),)
        if name == "ntt_small":
            return ((cf.ntt_small_plain if plain else cf.ntt_small)(fid, *args),)
        if name == "ec_add":
            return (cf.ec_add_plain if plain else cf.ec_add)(*args)
        if name == "ec_double":
            return (cf.ec_double_plain if plain else cf.ec_double)(*args)
        if name == "ec_madd":
            return (cf.ec_madd_plain if plain else cf.ec_madd)(*args)
        if name == "bucket_scan":
            return ((cf.bucket_scan_plain if plain else cf.bucket_scan)(*args),)
        if name in ("bucket_sums_fused", "bucket_weight", "msm_combine", "commit_dbl_add"):
            return getattr(cf, f"{name}_plain" if plain else name)(*args)
        raise KeyError(name)

    def max_err(a, b) -> int:
        return max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max()) if x.numel() else 0
                   for x, y in zip(a, b))

    def check(name, spec):
        fid, args = make_inputs(name, spec)
        got = run(name, fid, args, plain=False)
        torch.cuda.synchronize()
        want = run(name, fid, args, plain=True)
        torch.cuda.synchronize()
        err = max_err(got, want)
        if err != 0:
            raise AssertionError(f"kernel {name} disagrees with its plain version: max |diff| {err}")
        return fid, args, err

    # --- 2. kernel checks at ragged sizes -------------------------------------------
    ragged = {
        "mont_mul": ((3, 16, 1000), (16, 1)),
        "field_add": ((3, 16, 1000), (3, 16, 1000)),
        "field_sub": ((3, 16, 1000), (16, 1000)),
        "fermat_inv": ((5, 16, 3),),
        "ntt_butterfly": ((3, 16, 777), (16, 777)),
        "ntt_small": ((3, 16, 64), True, 1),
        "colntt": ((3, 128, 16, 77), True),
        "ec_add": ((2, 16, 1000),),
        "ec_double": ((2, 16, 1000),),
        "ec_madd": ((3, 16, 1000), (16, 1000), False),
        "bucket_scan": ((6, 5, 16, 33), False),
        "bucket_sums_fused": ((7, 512), (512, 16), 16, 63, False),
        "bucket_weight": ((13, 16, 7), 2),
        "msm_combine": ((16, 26), 26, 10),
        "commit_dbl_add": ((3, 16, 13), (16, 20)),
    }
    for name, spec in ragged.items():
        check(name, spec)
        log(f"[kernels] {name} at {spec}: kernel == plain (max |diff| 0)")
    for spec in (((3, 16, 1000), (16, 1000), True), ((2, 16, 777), (2, 16, 777), False),
                 ((2, 16, 777), (2, 16, 777), True)):
        check("ec_madd", spec)
        log(f"[kernels] ec_madd at {spec}: kernel == plain (max |diff| 0)")
    check("bucket_scan", ((6, 5, 16, 33), True))
    log("[kernels] bucket_scan (distinct) at (6, 5, 16, 33): kernel == plain (max |diff| 0)")
    for spec in (((2, 2, 16, 1000), True), ((1, 8, 16, 333), False), ((5, 32, 16, 1), False),
                 ((2, 4, 16, 50), True), ((2, 16, 16, 40), True), ((2, 64, 16, 70), False),
                 ((1, 256, 16, 40), True), ((1, 1024, 16, 5), True)):
        check("colntt", spec)
        log(f"[kernels] colntt at {spec}: kernel == plain (max |diff| 0)")
    # tw[0] the Montgomery one, as the NTT's tables have it: the kernel skips
    # the products by it
    mont_one = torch.tensor([((1 << 256) % P[cf.FR] >> (16 * i)) & 0xFFFF for i in range(16)],
                            dtype=torch.int32, device="cuda")
    for spec in (((3, 128, 16, 77), True), ((2, 8, 16, 300), False)):
        _, (x, tw, mid) = make_inputs("colntt", spec)
        tw[:, 0] = mont_one
        err = max_err(run("colntt", cf.FR, (x, tw, mid), False), run("colntt", cf.FR, (x, tw, mid), True))
        if err:
            raise AssertionError(f"colntt (tw[0] = 1) at {spec} disagrees with its plain version")
        log(f"[kernels] colntt (tw[0] = 1) at {spec}: kernel == plain (max |diff| 0)")
    # ntt_small at every n and C = 1, 3, 12, 65: the NTT's tables with the
    # diagonal each caller passes (none, 1/n, the coset's pre row, the
    # inverse coset's post row), then random twiddles (tw[0] not one: no
    # product skipped) with both; 0, 1, p - 1 and R mod p among the values;
    # held to the plain version and to the per-stage composition
    for log_n in range(1, 12):
        n = 1 << log_n
        ntt_chk = NTT(fr_df, log_n, dev)
        pre_row = rand_limbs(gen, (16, n), torch, P[cf.FR])
        post_row = ntt_chk.inverse_post(7)
        rand_tw = rand_limbs(gen, (16, n // 2), torch, P[cf.FR])
        variants = {
            "forward": (ntt_chk.tw[True], None, None),
            "inverse (1/n)": (ntt_chk.tw[False], None, ntt_chk.n_inv_mont),
            "forward, pre row": (ntt_chk.tw[True], pre_row, None),
            "inverse, post row": (ntt_chk.tw[False], None, post_row),
            "random tw, pre and post rows": (rand_tw, pre_row, post_row),
        }
        specials = [0, 1, P[cf.FR] - 1, (1 << 256) % P[cf.FR]][:n]
        for C in (1, 3, 12, 65):
            x = rand_limbs(gen, (C, 16, n), torch, P[cf.FR])
            x[0, :, : len(specials)] = torch.tensor(
                [[(v >> (16 * i)) & 0xFFFF for v in specials] for i in range(16)],
                dtype=torch.int32, device="cuda")
            for label, (tw, pre, post) in variants.items():
                got = cf.ntt_small(cf.FR, x, tw, pre, post)
                want = cf.ntt_small_plain(cf.FR, x, tw, pre, post)
                old = old_ntt_small(cf, torch, cf.FR, x, old_stage_tables(torch, tw), pre, post)
                if not (torch.equal(got, want) and torch.equal(got, old)):
                    raise AssertionError(f"ntt_small at n = {n}, C = {C} ({label}) disagrees with "
                                         f"its plain version or the per-stage composition")
        log(f"[kernels] ntt_small at n = {n}, C = 1, 3, 12, 65, {len(variants)} variants: kernel "
            f"== plain == the per-stage composition (max |diff| 0)")
    # the fused bucket accumulation: the special windows at 8, 16 and 256
    # lanes, both distinct values, ragged window counts; then against the
    # composition it replaced (bucket_scan, lane-carry scan, pick, fix)
    for spec in (((7, 512), (512, 16), 8, 63, True), ((9, 4096), (4096, 16), 256, 1023, False),
                 ((13, 4096), (4096, 16), 256, 1023, True)):
        check("bucket_sums_fused", spec)
        log(f"[kernels] bucket_sums_fused at {spec}: kernel == plain (max |diff| 0)")
    for spec in (((7, 512), (512, 16), 16, 63, False), ((11, 4096), (4096, 16), 256, 1023, True),
                 ((6, 4096), (4096, 16), 256, 1023, False)):
        args, A = bucket_case(gen, torch, cf, spec, P[cf.FQ], special=True)
        order, d_sorted, lanes, nb, distinct = args[1:]
        got = cf.bucket_sums_fused(*args)
        want = old_group_bucket_sums(cf, torch, A, order, d_sorted, nb, distinct, lanes)
        err = max_err(got, want)
        if err:
            raise AssertionError(f"bucket_sums_fused at {spec} differs from the old composition")
        log(f"[kernels] bucket_sums_fused at {spec}: == the bucket_scan composition (max |diff| 0)")
    # the fused MSM tail: CL2 = 8 and 64 lanes (the card's) at ragged window
    # counts, and 42 columns of 26 windows (the ECDSA path's widest commit)
    for name, spec in (("bucket_weight", ((7, 16, 255), 8)),
                       ("bucket_weight", ((11, 16, 1023), 64)),
                       ("msm_combine", ((16, 42 * 26), 26, 10))):
        check(name, spec)
        log(f"[kernels] {name} at {spec}: kernel == plain (max |diff| 0)")
    # the fused small-column commit: m = 1, 13 (an odd tree), 512 and 1024,
    # C = 1, 3 and 8, against its plain version and the per-bit composition
    dc_chk = DeviceCurve(DeviceField(FQ_BN254), BN254_G1)
    for spec in (((1, 16, 1), (16, 1)), ((3, 16, 13), (16, 13)), ((8, 16, 512), (16, 512)),
                 ((3, 16, 1024), (16, 1024))):
        fid, args, _ = check("commit_dbl_add", spec)
        if max_err(cf.commit_dbl_add(*args), old_commit_double_and_add(cf, dc_chk, *args)):
            raise AssertionError(f"commit_dbl_add at {spec} differs from the per-bit composition")
        log(f"[kernels] commit_dbl_add at {spec}: kernel == plain == the per-bit composition "
            f"(max |diff| 0)")
    # the inversion on both fields, with 0, 1, p - 1, R mod p and 2^-1
    for fid in (cf.FR, cf.FQ):
        p = P[fid]
        special = [0, 1, p - 1, (1 << 256) % p, pow(2, -1, p)]
        for shape in ((1, 16, 1), (11, 16, 1), (3, 16, 1000)):
            a = rand_limbs(gen, shape, torch, p)
            flat = a.permute(1, 0, 2).reshape(16, -1)  # element j = row j // B, lane j % B
            for j, v in enumerate(special if flat.shape[1] > 1 else [p - 1]):
                flat[:, j] = torch.tensor([(v >> (16 * i)) & 0xFFFF for i in range(16)],
                                          dtype=torch.int32, device="cuda")
            a = flat.reshape(16, shape[0], shape[2]).permute(1, 0, 2).contiguous()
            err = max_err((cf.fermat_inv(fid, a),), (cf.fermat_inv_plain(fid, a),))
            if err:
                raise AssertionError(f"fermat_inv (field {fid}) at {shape} disagrees with its "
                                     f"plain version")
            log(f"[kernels] fermat_inv (field {fid}) at {shape}: kernel == plain (max |diff| 0)")

    def time_ms(fn, reps: int) -> float:
        """Mean milliseconds of fn() on the card (CUDA events), after one
        warm-up call."""
        fn()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    def stage_line(d: dict) -> str:
        return json.dumps({k: round(v, 4) for k, v in d.items()})

    def tampered_rejected(params, vk, proof) -> bool:
        bad = bytearray(proof)
        bad[len(bad) // 2] ^= 1
        return not verify_proof(params, vk, bytes(bad))

    # every NTT call below 2^12 points (NTT.forward / NTT.inverse, which the
    # coset transforms call too; FourStepNTT has its own): its length
    ntt_calls = []

    def counted(method):
        def call(self, x, *args, **kwargs):
            ntt_calls.append(self.n)
            return method(self, x, *args, **kwargs)
        return call

    NTT.forward, NTT.inverse = counted(NTT.forward), counted(NTT.inverse)

    def reset_counts() -> None:
        torch.cuda.synchronize()
        cf.reset_launches()
        ntt_calls.clear()

    def ntt_rule(name: str, launches: dict, calls: list) -> None:
        """One ntt_small launch per NTT call below 2^12 points; no butterfly."""
        if launches["ntt_small"] != len(calls) or launches["ntt_butterfly"]:
            raise AssertionError(f"{name}: ntt_small {launches['ntt_small']} launches for "
                                 f"{len(calls)} NTT calls, ntt_butterfly "
                                 f"{launches['ntt_butterfly']} (want one each, and 0)")

    # --- 3. k=9 parity with the JAX goldens ---------------------------------------------
    t = time.time()
    gold = np.load(os.path.join(HERE, "tests", "data", "torch_goldens", "golden_k9.npz"))
    params9 = ParamsKZG.read(os.path.join(HERE, "params", "kzg_bn254_9.srs"), device=dev)
    # the commit calls that take the double-and-add (C >= 1, m <= 1024)
    commit_calls9 = []
    commit_columns9 = params9.commit_columns

    def counted_commit(fr_df, vals, bases, window_bits=None):
        if vals.shape[0] and vals.shape[2] <= COMMIT_SIMPLE_MAX:
            commit_calls9.append(tuple(vals.shape))
        return commit_columns9(fr_df, vals, bases, window_bits)

    params9.commit_columns = counted_commit
    reset_counts()
    t9 = time.time()
    pk9 = keygen(params9, golden_circuit(), device=dev)
    torch.cuda.synchronize()
    t_keygen9 = time.time() - t9
    t9 = time.time()
    proof9 = create_proof(params9, pk9, golden_circuit(), seed=0, device=dev)
    torch.cuda.synchronize()
    t_prove9 = time.time() - t9
    launches9, largest9, ntt_calls9 = dict(cf.LAUNCHES), dict(cf.LARGEST), list(ntt_calls)
    params9.commit_columns = commit_columns9
    if pk9.vk.to_bytes() != bytes(gold["vk"]):
        raise AssertionError("k=9 vk bytes differ from the JAX golden")
    if proof9 != bytes(gold["proof"]):
        raise AssertionError("k=9 proof bytes differ from the JAX golden")
    if not verify_proof(params9, pk9.vk, proof9):
        raise AssertionError("k=9 proof does not verify")
    log(f"[k=9] vk and proof byte-identical to the JAX goldens ({len(proof9)} bytes), "
        f"verifies; keygen {t_keygen9:.3f}s, create_proof {t_prove9:.3f}s; "
        f"{time.time() - t:.2f}s in all")
    log("[k=9] launches: " + json.dumps(launches9))
    # the JAX package's device path at k=9: every commit (m <= 1024) by the
    # fused double-and-add, one launch per commit call; no single point op
    # and no Pippenger bucket accumulation
    want9 = {"commit_dbl_add": len(commit_calls9), "ec_madd": 0, "ec_double": 0, "ec_add": 0,
             "bucket_scan": 0, "bucket_sums_fused": 0}
    if not commit_calls9 or any(launches9[k] != v for k, v in want9.items()):
        raise AssertionError(f"k=9 launches {launches9}; want {want9} "
                             f"({len(commit_calls9)} commit calls)")
    ntt_rule("k=9", launches9, ntt_calls9)
    if not ntt_calls9:
        raise AssertionError("k=9: no NTT call took ntt_small")
    log(f"[k=9] {len(commit_calls9)} commit calls {commit_calls9}, one commit_dbl_add launch "
        f"each; {len(ntt_calls9)} NTT calls of n = {ntt_calls9}, one ntt_small launch each; "
        f"mont_mul {launches9['mont_mul']} launches")

    # one k=9 commit three ways: the largest column set the k=9 run committed
    (C9, _, m9), _ = largest9["commit_dbl_add"][1]
    dc9 = params9.device_curve()
    vals9 = fr_df._to_mont(rand_limbs(gen, (C9, 16, m9), torch, P[cf.FR]))
    bases9 = params9.affine_lagrange_bases(dev)
    wb9 = msm_window_bits(m9, dev)
    commits9 = {
        "old loop": lambda: old_commit_double_and_add(cf, dc9, fr_df._from_mont(vals9), *bases9),
        "commit_dbl_add": lambda: commit_double_and_add(dc9, fr_df, vals9, bases9),
        "Pippenger": lambda: msm_many_device(
            dc9, bases9, torch.nn.functional.pad(window_digits(fr_df, vals9, wb9),
                                                 (0, params9.n - m9)), wb9, True),
    }
    jac9 = {k: fn() for k, fn in commits9.items()}
    if max_err(jac9["old loop"], jac9["commit_dbl_add"]):
        raise AssertionError("k=9 commit: commit_dbl_add's Jacobian points differ from the loop's")
    aff9 = {k: _pack_affine(dc9.df, *v) for k, v in jac9.items()}
    if any(not torch.equal(v, aff9["old loop"]) for v in aff9.values()):
        raise AssertionError("k=9 commit: the loop, commit_dbl_add and Pippenger disagree")
    ms9 = {k: time_ms(fn, 3) for k, fn in commits9.items()}
    log(f"[k=9] one commit of {C9} columns x {m9} points: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in ms9.items())
        + f" (Pippenger window {wb9}); the loop and commit_dbl_add equal as Jacobian points, "
        f"all three in affine form")

    # --- 3b. the multi-phase and dynamic-lookup k=9 circuits --------------------------------
    launches_3b = {k: 0 for k in cf.KERNELS}
    for cname in ("multiphase", "dynlookup"):
        t = time.time()
        gold = np.load(os.path.join(HERE, "tests", "data", "torch_goldens", f"{cname}_k9.npz"))
        reset_counts()
        builder = rlc_circuit() if cname == "multiphase" else ram_circuit()
        pk3 = keygen(params9, builder, device=dev)
        if cname == "multiphase":
            # phase 1 is witnessed from the challenge create_proof squeezes
            pb, phase_fns = rlc_prover(pk3, builder.break_points())
            proof3 = create_proof(params9, pk3, pb, seed=0, phase_fns=phase_fns, device=dev)
        else:
            proof3 = create_proof(params9, pk3, builder, seed=0, device=dev)
        torch.cuda.synchronize()
        launches3, calls3 = dict(cf.LAUNCHES), list(ntt_calls)
        for k in cf.KERNELS:
            launches_3b[k] += launches3[k]
        if pk3.vk.to_bytes() != bytes(gold["vk"]):
            raise AssertionError(f"{cname} k=9 vk bytes differ from the JAX golden")
        if proof3 != bytes(gold["proof"]):
            raise AssertionError(f"{cname} k=9 proof bytes differ from the JAX golden")
        if not verify_proof(params9, pk3.vk, proof3):
            raise AssertionError(f"{cname} k=9 proof does not verify")
        if not tampered_rejected(params9, pk3.vk, proof3):
            raise AssertionError(f"{cname} k=9 tampered proof verifies")
        ntt_rule(cname, launches3, calls3)
        if not calls3:
            raise AssertionError(f"{cname}: no NTT call took ntt_small")
        log(f"[3b] {cname}: vk and proof byte-identical to the JAX goldens ({len(proof3)} bytes), "
            f"verifies, tampered proof rejected; {time.time() - t:.2f}s")
        log(f"[3b] {cname}: {len(calls3)} NTT calls below 2^12 points, n = {sorted(set(calls3))} "
            f"(ntt_small {launches3['ntt_small']}); colntt {launches3['colntt']} launches "
            f"(the four-step transform, n >= 2^12)")
        log(f"[3b] {cname} launches: " + json.dumps(launches3))

    # --- 4. k=15 slice circuit -------------------------------------------------------------
    t = time.time()
    params = ParamsKZG.read(os.path.join(HERE, "params", "kzg_bn254_15.srs"), device=dev)
    t_read = time.time() - t
    t = time.time()
    builder = slice_circuit()
    cp = builder.config_params
    t_wit = time.time() - t
    log(f"[k=15] SRS read {t_read:.2f}s; witness {t_wit:.2f}s; columns: advice "
        f"{cp.num_advice_per_phase}, lookup {cp.num_lookup_advice_per_phase}, "
        f"fixed {cp.num_fixed}, lookup_bits {cp.lookup_bits}")
    reset_counts()
    kstages, stages = {}, {}
    t = time.time()
    pk = keygen(params, builder, device=dev, timings=kstages)
    torch.cuda.synchronize()
    t_keygen = time.time() - t
    t = time.time()
    proof = create_proof(params, pk, slice_circuit(), seed=0, device=dev, timings=stages)
    torch.cuda.synchronize()
    t_prove = time.time() - t
    launches15, largest15, ntt_calls15 = dict(cf.LAUNCHES), dict(cf.LARGEST), list(ntt_calls)
    t = time.time()
    ok = verify_proof(params, pk.vk, proof)
    t_verify = time.time() - t
    if not ok:
        raise AssertionError("k=15 proof does not verify")
    if not tampered_rejected(params, pk.vk, proof):
        raise AssertionError("k=15 tampered proof verifies")
    digest = hashlib.sha256(proof).hexdigest()
    ref_path = os.path.join(HERE, "tests", "data", "torch_goldens", "slice_k15.json")
    with open(ref_path) as f:
        ref = json.load(f)
    if digest != ref["proof_sha256"]:
        raise AssertionError(f"k=15 proof sha256 {digest} != JAX {ref['proof_sha256']}")
    log(f"[k=15] keygen {t_keygen:.3f}s, create_proof {t_prove:.3f}s, verify_proof "
        f"{t_verify:.3f}s; proof {len(proof)} bytes, sha256 equals the JAX proof's; "
        f"tampered proof rejected")
    log("[k=15] keygen stages (s): " + stage_line(kstages))
    log("[k=15] create_proof stages (s): " + stage_line(stages))
    log("[k=15] launches: " + json.dumps(launches15))

    # --- 4b. the ECDSA circuit at k=15: the main path at full width ---------------------------
    # The witness draws random points; one generator seeded as the JAX
    # package's (0x5EC0), drawn by the keygen builder first and the prover
    # builder second, as bench.py and make_goldens.py --ecdsa build them.
    rng = random.Random(0x5EC0)
    with open(os.path.join(HERE, "tests", "data", "torch_goldens", "ecdsa_k15.json")) as f:
        eref = json.load(f)
    t = time.time()
    ebuilder = ecdsa_circuit(15, 14, rng=rng)
    ecp = ebuilder.config_params
    t_ewit = time.time() - t
    cols = [list(ecp.num_advice_per_phase), list(ecp.num_lookup_advice_per_phase), ecp.num_fixed]
    want_cols = [eref["num_advice_per_phase"], eref["num_lookup_advice_per_phase"], eref["num_fixed"]]
    if cols != want_cols:
        raise AssertionError(f"ECDSA columns {cols} != JAX {want_cols}")
    log(f"[ecdsa] keygen witness {t_ewit:.2f}s; columns: advice {ecp.num_advice_per_phase}, "
        f"lookup {ecp.num_lookup_advice_per_phase}, fixed {ecp.num_fixed}, lookup_bits "
        f"{ecp.lookup_bits}")
    reset_counts()
    ekstages, estages = {}, {}
    t = time.time()
    epk = keygen(params, ebuilder, device=dev, timings=ekstages)
    torch.cuda.synchronize()
    t_ekeygen = time.time() - t
    t = time.time()
    pb = pinning_of(ebuilder).prover_builder()
    ecdsa_witness(pb, ecdsa_inputs(), rng)
    t_epwit = time.time() - t
    t = time.time()
    eproof = create_proof(params, epk, pb, seed=0, device=dev, timings=estages)
    torch.cuda.synchronize()
    t_eprove = time.time() - t
    launches_e, largest_e, ntt_calls_e = dict(cf.LAUNCHES), dict(cf.LARGEST), list(ntt_calls)
    t = time.time()
    ok = verify_proof(params, epk.vk, eproof)
    t_everify = time.time() - t
    log(f"[ecdsa] keygen {t_ekeygen:.3f}s, prover witness (pinned builder) {t_epwit:.3f}s, "
        f"create_proof {t_eprove:.3f}s, verify_proof {t_everify:.3f}s; proof {len(eproof)} bytes")
    log("[ecdsa] keygen stages (s): " + stage_line(ekstages))
    log("[ecdsa] create_proof stages (s): " + stage_line(estages))
    if not ok:
        raise AssertionError("ECDSA proof does not verify")
    if not tampered_rejected(params, epk.vk, eproof):
        raise AssertionError("ECDSA tampered proof verifies")
    evk = hashlib.sha256(epk.vk.to_bytes()).hexdigest()
    edigest = hashlib.sha256(eproof).hexdigest()
    if (evk, edigest) != (eref["vk_sha256"], eref["proof_sha256"]):
        raise AssertionError(
            f"ECDSA vk sha256 {evk}, proof sha256 {edigest} != JAX "
            f"{eref['vk_sha256']}, {eref['proof_sha256']}"
        )
    log("[ecdsa] proof verifies, tampered proof rejected; vk and proof sha256 equal the "
        "JAX package's")
    log("[ecdsa] launches: " + json.dumps(launches_e))

    # k=9 runs the radix-2 NTT (ntt_small) and commits by the fused
    # double-and-add (commit_dbl_add); k=15 runs the four-step colntt and
    # commits by Pippenger (bucket_sums_fused, then the fused tail:
    # bucket_weight and msm_combine, one launch each per MSM call); the
    # literal ports of the butterfly, the single point ops and the bucket
    # scan run nowhere; every other kernel runs at both sizes
    off_path = ("ntt_butterfly", "ec_add", "ec_double", "ec_madd", "bucket_scan")
    pippenger = ("bucket_sums_fused", "bucket_weight", "msm_combine")
    missing = [k for k in cf.KERNELS
               if k not in ("colntt", *off_path, *pippenger) and launches9[k] == 0]
    for name, counts, calls in (("k=15", launches15, ntt_calls15),
                                ("ecdsa", launches_e, ntt_calls_e)):
        # no domain below 2^12 at k=15: ntt_small only if a call took one
        ntt_rule(name, counts, calls)
        never = (*off_path, "commit_dbl_add")
        missing += [
            f"{k} ({name})" for k in cf.KERNELS
            if k not in ("ntt_small", *never) and counts[k] == 0
        ]
        per_call = {counts[k] for k in ("bucket_sums_fused", "bucket_weight", "msm_combine")}
        if any(counts[k] for k in never) or len(per_call) != 1:
            raise AssertionError(
                f"{name}: " + ", ".join(f"{k} {counts[k]}" for k in never) + " launches (want 0); "
                + ", ".join(f"{k} {counts[k]}" for k in ("bucket_sums_fused", "bucket_weight",
                                                          "msm_combine")) + " (want equal)"
            )
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    # --- 5. every kernel at its main-path shapes: check and time ----------------------------
    def numel(shape) -> int:
        out = 1
        for d in shape:
            out *= d
        return out

    def bound(name, spec):
        """(bound_ms, bound_by): bytes each input read once and each output
        written once, against operations at the 32-bit peak."""
        if name in ("mont_mul", "field_add", "field_sub"):
            sa, sb = spec
            n = max(numel(sa), numel(sb)) // 16
            nbytes = 4 * (numel(sa) + numel(sb)) + 64 * n
            ops = n * (MM_OPS if name == "mont_mul" else 2 * 16)
        elif name == "fermat_inv":
            # the batches of divsteps this run's elements need (one for 0)
            n = numel(spec[0]) // 16
            nbytes, ops = 128 * n, work["inv_batches"] * INV_BATCH_OPS
        elif name == "commit_dbl_add":
            # the scalars and the m bases read once, [16, C] Jacobian sums
            # written; the doublings, mixed adds and tree adds these scalars
            # need (commit_work)
            (C, _, m), _ = spec
            nbytes, ops = 64 * (C * m + 2 * m + 3 * C), work["commit"][0] * MM_OPS
        elif name == "ntt_butterfly":
            sa, sw = spec
            n = numel(sa) // 16
            nbytes = 4 * (2 * numel(sa) + numel(sw)) + 128 * n
            ops = n * (MM_OPS + 3 * 16)
        elif name == "ntt_small":
            # x read and written once, the twiddle row and the diagonals read
            # once; (n/2) log2 n butterflies a column and the diagonal products
            (C, _, n), with_pre, post_n = spec
            nbytes = 128 * C * n + 32 * n + (64 * n if with_pre else 0) + 64 * post_n
            ops = (C * n // 2 * (n.bit_length() - 1) * (MM_OPS + 3 * 16)
                   + C * n * MM_OPS * (int(with_pre) + int(post_n > 0)))
        elif name == "colntt":
            (L, A, _, B), with_mid = spec
            n = L * A * B
            nbytes = 64 * n * (3 if with_mid else 2) + 32 * A
            # (A/2) log2(A) butterflies per column, then the mid product
            ops = n * (A.bit_length() - 1) // 2 * (MM_OPS + 3 * 16) + (n * MM_OPS if with_mid else 0)
        elif name == "ec_add":
            # the add path's 16 products on every lane (the doubling branch,
            # 8 + 7, and the identity lanes, 0, do no more)
            n = numel(spec[0]) // 16
            nbytes, ops = 9 * 64 * n, n * 16 * MM_OPS
        elif name == "ec_double":
            n = numel(spec[0]) // 16
            nbytes, ops = 6 * 64 * n, n * 7 * MM_OPS
        elif name == "ec_madd":
            shape, ashape, distinct = spec
            n, na = numel(shape) // 16, numel(ashape) // 16
            # P1 in and the result out (3 coordinates each), the affine bases
            # once (shared by every row when they broadcast)
            nbytes, ops = 64 * (6 * n + 2 * na), n * (11 if distinct else 17) * MM_OPS
        elif name == "bucket_weight":
            (Wtot, _, nb), lanes = spec
            # per window, the function's own work: T_w = sum_b b * S_b as two
            # running sums from the top bucket down (2 nb - 2 complete adds)
            # and the log2(lanes) doublings; the suffix scans' extra adds are
            # overhead of this design (see design_adds), not part of the bound
            nbytes = 3 * 64 * Wtot * (nb + 1)
            ops = Wtot * (16 * (2 * nb - 2) + 7 * (lanes.bit_length() - 1)) * MM_OPS
        elif name == "msm_combine":
            (_, CW), W, c = spec
            C = CW // W
            # W * c doublings and W - 1 adds (the first meets the identity)
            nbytes = 3 * 64 * (CW + C)
            ops = C * (7 * W * c + 16 * (W - 1)) * MM_OPS
        elif name == "bucket_sums_fused":
            (Wtot, n), (npts, _), _, nb, distinct = spec
            # the packed bases once, the sorted order and digits once, the
            # bucket sums written once; a mixed add for every live slot of
            # this run's digits (dead slots add nothing; the carry scan's adds
            # are this design's, not the function's)
            nbytes = 64 * npts + 8 * Wtot * n + 3 * 64 * Wtot * nb
            ops = work["live_slots"] * (11 if distinct else 17) * MM_OPS
        else:
            (Wb, R, _, CL), distinct = spec
            n = Wb * R * CL
            nbytes = n * (64 + 4 + 192)
            ops = n * (11 if distinct else 17) * MM_OPS
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_OPS32 * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def design_adds(spec) -> int:
        """Complete adds bucket_weight runs per window: the acc chain's past
        each lane's first bucket, the tot chain's past its first row, the
        three Hillis-Steele suffix scans' adds of lanes in range, D and + TS."""
        (_, _, nb), lanes = spec
        R2, levels = -(-nb // lanes), lanes.bit_length() - 1
        scans = 3 * sum(lanes - (1 << d) for d in range(levels))
        return (nb - lanes) + lanes * (R2 - 1) + scans + 2

    def serial_products(name, spec) -> int:
        """Montgomery products on the fused kernel's longest dependent chain
        (complete adds at their 16, doublings at 7)."""
        if name == "bucket_weight":
            (_, _, nb), lanes = spec
            levels = lanes.bit_length() - 1
            return 16 * (2 * -(-nb // lanes) + 3 * levels + 2) + 7 * levels
        if name == "bucket_sums_fused":
            # a lane's R mixed adds, then its carry scan's levels and the fix
            (_, n), _, lanes, _, distinct = spec
            return (n // lanes) * (11 if distinct else 17) + 16 * ((lanes - 1).bit_length() + 1)
        if name == "commit_dbl_add":
            return work["commit"][1]
        if name == "ntt_small":
            return ntt_chain(spec)[1]
        (_, CW), W, c = spec
        return 7 * W * c + 16 * W

    def host_ints(t) -> list[int]:
        """[..., 16, B] limbs -> the elements as ints, lane fastest."""
        return limbs_to_ints(t.movedim(-2, -1).reshape(-1, 16).cpu().numpy())

    rows = []
    work = {}  # data-dependent work of this run's inputs, for the bounds
    for name in cf.KERNELS:
        # the kernels off the main path are timed at the shapes it gave them
        # before their fusion
        spec = (largest_e.get(name) or largest15.get(name) or largest9.get(name)
                or OFF_PATH_SHAPES[name])[1]
        if name == "colntt":
            # the NTT's stage twiddles start at the Montgomery one
            fid, args = make_inputs(name, spec)
            args[1][:, 0] = mont_one
            err = max_err(run(name, fid, args, False), run(name, fid, args, True))
            if err:
                raise AssertionError(f"colntt at {spec} disagrees with its plain version")
        elif name == "bucket_sums_fused":
            # the main path's widest MSM call with digits as random scalars
            # give them (no special windows), held to the plain version
            fid, args = cf.FQ, bucket_case(gen, torch, cf, spec, P[cf.FQ], special=False)[0]
            err = max_err(cf.bucket_sums_fused(*args), cf.bucket_sums_fused_plain(*args))
            if err:
                raise AssertionError(f"bucket_sums_fused at {spec} disagrees with its plain version")
            work["live_slots"] = int((args[2] > 0).sum())
        else:
            fid, args, err = check(name, spec)
        if name == "fermat_inv":
            steps = [divsteps_needed(x, P[fid]) for x in host_ints(args[0])]
            work["inv_batches"] = sum(max(1, -(-d // 30)) for d in steps)
        if name == "commit_dbl_add":
            work["commit"] = commit_work(host_ints(args[0]), spec[0][2])
        reps = 3 if name in ("bucket_scan", "bucket_sums_fused") else 10
        ms = time_ms(lambda: run(name, fid, args, plain=False), reps)
        plain_ms = time_ms(lambda: run(name, fid, args, plain=True), 1)
        bms, by = bound(name, spec)
        src, rep = SOURCES[name]
        row = {
            "name": name,
            "route": "cuda",
            "source": f"halo2_lib_tpu_torch/{src}",
            "replaces": rep,
            # the main path's launches: the k=9, the two phase-3b k=9
            # circuits', the k=15 slice and the ECDSA runs
            "launches": launches9[name] + launches_3b[name] + launches15[name] + launches_e[name],
            "launches_k9": launches9[name],
            "launches_k9_phases": launches_3b[name],
            "launches_k15": launches15[name],
            "launches_ecdsa": launches_e[name],
            "max_abs_err": err,
            "ms": round(ms, 6),
            "plain_ms": round(plain_ms, 6),
            "bound_ms": round(bms, 6),
            "bound_by": by,
            "library_ms": None,
            "shape": [list(s) if isinstance(s, tuple) else s for s in spec],
        }
        if name in FUSES:
            row["fuses"] = FUSES[name]
        rows.append(row)
        log(f"[timing] {name} at {spec}: {ms:.4f} ms (plain {plain_ms:.3f} ms, "
            f"bound {bms:.4f} ms by {by}), kernel == plain")
        if name in FUSES:
            log(f"[timing] {name}: its longest thread runs a chain of "
                f"{serial_products(name, spec)} dependent Montgomery products, a floor the "
                f"roofline bound does not see")
        if name == "bucket_weight":
            nb = spec[0][2]
            log(f"[timing] bucket_weight: {design_adds(spec)} complete adds per window where "
                f"the weighted sum needs {2 * nb - 2} (the suffix scans' extra adds)")
        if name == "fermat_inv":
            log(f"[timing] fermat_inv: its longest thread runs {-(-max(steps) // 30)} batches of "
                f"30 divsteps ({max(steps)} divsteps before g = 0), each batch's 2x2 matrix "
                f"applied to 9-limb (f, g) and (d, e); the Fermat chain ran about 330 dependent "
                f"Montgomery products")
        if name == "ntt_small":
            # the per-stage composition it replaced, at the same shape
            x, tw, pre, post = args
            stage_tw = old_stage_tables(torch, tw)
            if not torch.equal(old_ntt_small(cf, torch, fid, x, stage_tw, pre, post),
                               cf.ntt_small(fid, *args)):
                raise AssertionError(f"ntt_small at {spec} differs from the per-stage composition")
            old_ms = time_ms(lambda: old_ntt_small(cf, torch, fid, x, stage_tw, pre, post), reps)
            row["composition_ms"] = round(old_ms, 6)
            runs = ntt_chain(spec)[0]
            log(f"[timing] ntt_small at {spec}: {ms:.4f} ms against {old_ms:.4f} ms for the "
                f"per-stage composition it replaced ({len(stage_tw)} ntt_butterfly launches and "
                f"interleaves, {int(pre is not None) + int(post is not None)} mont_mul), equal "
                f"outputs; a thread runs {runs} Montgomery products")
        if name == "commit_dbl_add":
            # the same columns at m = 1024, the longest the path sends it
            C = spec[0][0]
            spec_big = ((C, 16, 1024), (16, 1024))
            args_big = commit_case(gen, torch, cf, spec_big, P)
            if max_err(cf.commit_dbl_add(*args_big), cf.commit_dbl_add_plain(*args_big)):
                raise AssertionError(f"commit_dbl_add at {spec_big} disagrees with its plain "
                                     f"version")
            ms_big = time_ms(lambda: cf.commit_dbl_add(*args_big), reps)
            work["commit"] = commit_work(host_ints(args_big[0]), 1024)
            bms_big, by_big = bound(name, spec_big)
            log(f"[timing] commit_dbl_add at {spec_big}: {ms_big:.4f} ms (bound {bms_big:.4f} ms "
                f"by {by_big}; a chain of {work['commit'][1]} dependent Montgomery products), "
                f"kernel == plain")

    # --- 5b. one whole MSM at the ECDSA advice commit's shape: old vs fused buckets ---------
    def old_tail(dc, S, W: int, c: int, CL2: int):
        """The MSM's tail before the fusion: the merged-lane weighted bucket
        reduction and the window combine as loops of single ec_add /
        ec_double launches (ops/ec_device.py before bucket_weight and
        msm_combine)."""
        Wtot, _, nb = S[0].shape
        R2 = -(-nb // CL2)
        M = Wtot * CL2
        St = tuple(
            torch.nn.functional.pad(t, (0, R2 * CL2 - nb)).reshape(Wtot, 16, R2, CL2) for t in S
        )
        rows = tuple(t.permute(2, 1, 0, 3).reshape(R2, 16, M).flip(0) for t in St)
        acc = tot = dc.identity((M,), dev)
        for r in range(R2):
            acc = cf.ec_add(acc, tuple(t[r] for t in rows))
            tot = cf.ec_add(tot, acc)

        def suffix_local(Pt):
            l_loc = torch.arange(Pt[0].shape[-1], device=dev) % CL2
            for d in range(max(CL2.bit_length() - 1, 1)):
                ok = (l_loc + (1 << d) < CL2)[None, :]
                Qt = tuple(torch.where(ok, torch.roll(t, -(1 << d), dims=-1), torch.zeros_like(t))
                           for t in Pt)
                Pt = cf.ec_add(Pt, Qt)
            return Pt

        suf1 = suffix_local(tuple(torch.cat([a, t], dim=-1) for a, t in zip(acc, tot)))
        sufA = tuple(t[..., :M] for t in suf1)
        suf2 = suffix_local(sufA)
        TA = tuple(t[..., 0::CL2] for t in sufA)
        TT = tuple(t[..., M::CL2] for t in suf1)
        TS = tuple(t[..., 0::CL2] for t in suf2)
        D = cf.ec_add(TT, (TA[0], dc.df._neg(TA[1]), TA[2]))
        for _ in range(CL2.bit_length() - 1):
            D = cf.ec_double(D)
        tX, tY, tZ = cf.ec_add(D, TS)
        res = dc.identity((Wtot // W,), dev)
        for w in range(W - 1, -1, -1):
            for _ in range(c):
                res = cf.ec_double(res)
            res = cf.ec_add(res, tuple(t.reshape(16, Wtot // W, W)[..., w] for t in (tX, tY, tZ)))
        return res

    def wall_ms(fn, reps: int):
        """Mean host-clock milliseconds of fn() between synchronizes (the old
        bucket accumulation synchronizes inside, at its carry gathers);
        returns the last result too."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps, out

    C5, c5 = 21, 10
    dc5 = params.device_curve()
    bases5 = params.affine_lagrange_bases(dev)
    vals5 = fr_df._to_mont(rand_limbs(gen, (C5, 16, params.n), torch, P[cf.FR]))
    digits5 = window_digits(fr_df, vals5, c5)  # [C, W, n]
    W5 = digits5.shape[1]
    CL5 = _scan_lanes(params.n, dev)
    CL2_5 = weight_lanes((1 << c5) - 1, params.n, dev)

    def old_msm(st=None):
        """The parent's MSM: the bucket_scan composition, then the fused tail."""
        S = old_bucket_sums(cf, torch, bases5, digits5, c5, True, CL5, st)
        out = cf.msm_combine(cf.bucket_weight(S, CL2_5), W5, c5)
        if st is not None:
            st.mark("tail")
        return out, S

    def new_msm(st=None):
        """msm_many_device; with `st`, its steps one by one (ops/ec_device.py
        bucket_sums at k = 15: one group of windows) between stage marks."""
        if st is None:
            return msm_many_device(dc5, bases5, digits5, c5, True), None
        flat = digits5.reshape(-1, params.n).to(torch.int32)
        d_sorted, order = torch.sort(flat, dim=1, stable=True)
        order = order.to(torch.int32)
        st.mark("sort")
        packed = cf.pack_bases(*bases5)
        st.mark("pack")
        S = cf.bucket_sums_fused(packed, order, d_sorted, CL5, (1 << c5) - 1, True)
        st.mark("fused")
        out = cf.msm_combine(cf.bucket_weight(S, CL2_5), W5, c5)
        st.mark("tail")
        return out, S

    turns = {"old": old_msm, "new": new_msm}
    for fn in turns.values():  # warm-up
        fn()
    outs, sums, msm5 = {}, {}, []
    for name in ("old", "new", "new", "old"):
        ms_all, (outs[name], _) = wall_ms(turns[name], 3)
        st = Stages(torch)
        _, sums[name] = turns[name](st)
        stages = st.ms()
        msm5.append({"turn": name, "msm_ms": round(ms_all, 3),
                     "stages_ms": {k: round(v, 3) for k, v in stages.items()}})
        log(f"[msm] {name}: one MSM of {C5} columns x {params.n} points (window {c5}, "
            f"{W5} windows, {CL5} scan lanes, {CL2_5} weight lanes): {ms_all:.3f} ms; stages "
            f"(ms, CUDA events) " + stage_line(stages))
    if any(not torch.equal(a, b) for a, b in zip(sums["old"], sums["new"])):
        raise AssertionError("MSM: bucket_sums_fused's sums differ from the bucket_scan composition's")
    if any(not torch.equal(a, b) for a, b in zip(outs["old"], outs["new"])):
        raise AssertionError("MSM: the fused bucket sums' Jacobian output differs from the old one")
    log("[msm] bucket sums and MSM points equal bit for bit, old and new")

    # the step-loop tail against the fused one
    S5 = sums["new"]
    tails = {
        "old": lambda: old_tail(dc5, S5, W5, c5, CL2_5),
        "new": lambda: cf.msm_combine(cf.bucket_weight(S5, CL2_5), W5, c5),
    }
    tail_ms = {k: time_ms(fn, 3) for k, fn in tails.items()}
    if any(not torch.equal(a, b) for a, b in zip(tails["old"](), tails["new"]())):
        raise AssertionError("MSM: the fused tail's Jacobian output differs from the step loop's")
    big = tuple(rand_limbs(gen, (16, 139776), torch, P[cf.FQ]) for _ in range(6))
    ms_add_big = time_ms(lambda: cf.ec_add(big[:3], big[3:]), 10)
    log(f"[msm] tail: step loop {tail_ms['old']:.3f} ms, fused {tail_ms['new']:.3f} ms, same "
        f"Jacobian points; ec_add at [16, 139776] (the step loop's widest launch): "
        f"{ms_add_big:.4f} ms")

    # the Montgomery product alone: dependent chains, carry-chain vs 64-bit C
    lanes_mul, iters_mul = 132 * 2048, 256
    ma, mb = (rand_limbs(gen, (16, lanes_mul), torch, P[cf.FQ]) for _ in range(2))
    if not torch.equal(cf.mul_chain_bench(ma, mb, iters_mul, True),
                       cf.mul_chain_bench(ma, mb, iters_mul, False)):
        raise AssertionError("the carry-chain product differs from the 64-bit C one")
    mul_turns = []
    for chains in (False, True, True, False):
        ms = time_ms(lambda: cf.mul_chain_bench(ma, mb, iters_mul, chains), 5)
        rate = lanes_mul * iters_mul / ms / 1e6
        mul_turns.append({"product": "carry chains" if chains else "64-bit C", "ms": round(ms, 4),
                          "g_products_per_s": round(rate, 3)})
        log(f"[mul] {'carry-chain' if chains else '64-bit C'} product: {lanes_mul} threads x "
            f"{iters_mul} dependent products in {ms:.4f} ms, {rate:.2f} G products/s")
    log(json.dumps({"msm_turns": msm5, "tail_ms": {k: round(v, 3) for k, v in tail_ms.items()},
                    "ec_add_16x139776_ms": round(ms_add_big, 6), "mul_chain": mul_turns}))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    log(smi[0] if smi else "nvidia-smi: no output")
    log(json.dumps({"kernels": rows}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
