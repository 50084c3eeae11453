"""The port's fused bucket accumulation (halo2_lib_tpu_torch/ops/cuda_field.py:
bucket_sums_fused, through its plain version on the CPU) against the
composition it replaces, and against the JAX package's own.

The reference composition below is a copy of ops/ec_device.py's bucket
accumulation before the fusion: one bucket_scan of every (window, lane)
chain (its per-step output written out), a Hillis-Steele segmented scan of
the lanes' trailing sums made of single complete adds, a binary-search pick
of each bucket's sum and one add of the carry where a bucket's run began in
an earlier lane. The fused function must run the same point ops in the same
order, so every bucket sum, empty ones included, agrees limb for limb
(tolerance 0). Inputs are curve points and window digits from fixed seeds:
a run across many lanes, one bucket filling a window, a window of dead
slots (digit 0), a window with no digit below 3, P + (-P) and P + P inside
a run, an identity base, and a ragged window count. The fused sums are
also held, limb for limb, to the JAX package's _bucket_sums
(halo2_lib_tpu/ops/ec_device.py:463) at its own tuning for n = 512 (128
lanes of 4 slots), through the digests tests/data/torch_goldens/
make_goldens.py froze.
"""

import hashlib
import json
import os
import random

import numpy as np
import pytest
import torch

from halo2_lib_tpu_torch.ops import cuda_field as cf
from halo2_lib_tpu_torch.ops.ec_device import (
    DeviceCurve, bucket_sums, msm_many_device, pack_scalars,
)
from halo2_lib_tpu_torch.ops.limbs import DeviceField
from halo2_lib_tpu_torch.utils.curves import BN254_G1

# One core per test process: the suite runs in parallel workers, and a
# thread pool per worker would oversubscribe the host.
torch.set_num_threads(1)

Q = BN254_G1.base.p
N_LIMBS = 16


@pytest.fixture(scope="module")
def dc():
    return DeviceCurve(DeviceField(BN254_G1.base), BN254_G1)


def bucket_sums_case():
    """tests/data/torch_goldens/make_goldens.py:bucket_sums_case, made with
    the port's copy of utils/curves.py: (c, bases, digits [Wtot][n])."""
    rng = random.Random(33)
    n, c = 512, 6
    pool = [BN254_G1.random_point(rng) for _ in range(24)]
    bases = [rng.choice(pool) for _ in range(n)]
    P = pool[0]
    bases[1], bases[2] = P, (P[0], Q - P[1])
    bases[10] = bases[11] = pool[1]
    bases[5] = None
    nb = (1 << c) - 1
    w0 = [rng.randrange(nb + 1) for _ in range(n)]
    w1 = [37] * n
    w2 = [0] * n
    w3 = [rng.choice([3, 9, 40, 41, 63]) for _ in range(n)]
    for i in range(100, 400):
        w3[i] = 5
    w4 = [rng.randrange(nb + 1) for _ in range(n)]
    w4[1] = w4[2] = 20
    w4[10] = w4[11] = 21
    for i in range(n):
        if i not in (1, 2, 10, 11) and w4[i] in (20, 21):
            w4[i] = 22
    return c, bases, [w0, w1, w2, w3, w4]


def _affine(dc, bases):
    return tuple(dc.df.pack([0 if pt is None else pt[i] for pt in bases], device="cpu") for i in (0, 1))


def _sorted(digits):
    flat = torch.tensor(digits, dtype=torch.int32)
    d_sorted, order = torch.sort(flat, dim=1, stable=True)
    return order.to(torch.int32), d_sorted


# --- the composition before the fusion (ops/ec_device.py) ----------------------


def _pack_pairs(A):
    v = A[: N_LIMBS // 2].to(torch.int64) | (A[N_LIMBS // 2 :].to(torch.int64) << 16)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def _where(cond, a, b):
    return torch.where(cond[..., None, :], a, b)


def _seg_scan(X, Y, Z, flag, width):
    L = X.shape[-1]
    idx = torch.arange(L, device=X.device) % width
    x, y, z, f = X, Y, Z, flag
    for d in range((width - 1).bit_length()):
        shift = 1 << d
        px, py, pz = (torch.roll(t, shift, dims=-1) for t in (x, y, z))
        pf = torch.roll(f, shift, dims=-1)
        s = cf.ec_add((x, y, z), (px, py, pz))
        use = (~f) & (idx >= shift)
        x, y, z = (_where(use, a, b) for a, b in zip(s, (x, y, z)))
        f = f | (use & pf) | (idx < shift)
    return x, y, z


def old_bucket_sums(A, order, d_sorted, nbuckets, distinct, CL):
    Ax, Ay = A
    dev = Ax.device
    Wb, n = d_sorted.shape
    R = n // CL
    order, d_sorted = order.to(torch.int64), d_sorted.to(torch.int64)
    seg_start = torch.cat(
        [torch.ones((Wb, 1), dtype=torch.bool, device=dev), d_sorted[:, 1:] != d_sorted[:, :-1]],
        dim=1,
    )
    live = d_sorted > 0
    Axy = torch.cat([_pack_pairs(Ax), _pack_pairs(Ay)], dim=0)
    order_perm = order.reshape(Wb, CL, R).transpose(1, 2)
    g = Axy[:, order_perm.reshape(-1)].reshape(N_LIMBS, Wb, R, CL)
    live_perm = live.reshape(Wb, CL, R).transpose(1, 2)
    g = torch.where(live_perm[None], g, torch.zeros_like(g))
    axy = g.permute(1, 2, 0, 3).contiguous()
    st = seg_start.reshape(Wb, CL, R).transpose(1, 2).to(torch.int32).contiguous()
    out = cf.bucket_scan(axy, st, distinct)
    last = out[:, R - 1]
    lastv = tuple(last[:, 16 * i : 16 * (i + 1), :] for i in range(3))
    has_start = seg_start.reshape(Wb, CL, R).any(dim=2)
    lastm = tuple(t.transpose(0, 1).reshape(N_LIMBS, Wb * CL) for t in lastv)
    cm = _seg_scan(*lastm, has_start.reshape(Wb * CL), CL)
    zero = torch.zeros((Wb, N_LIMBS, 1), dtype=torch.int32, device=dev)
    cx, cy, cz = (
        torch.cat([zero, t.reshape(N_LIMBS, Wb, CL).transpose(0, 1)[..., :-1]], dim=-1)
        for t in cm
    )
    targets = torch.arange(1, nbuckets + 1, dtype=d_sorted.dtype, device=dev)
    targets = targets.expand(Wb, nbuckets).contiguous()
    last_idx = torch.searchsorted(d_sorted, targets, right=True) - 1
    first_idx = torch.searchsorted(d_sorted, targets, right=False)
    present = last_idx >= first_idx
    safe_idx = last_idx.clamp(0, n - 1)
    lane = safe_idx // R
    idx_r = safe_idx % R
    cols = torch.arange(3 * N_LIMBS, device=dev)
    lin = (idx_r[:, None, :] * (3 * N_LIMBS) + cols[None, :, None]) * CL + lane[:, None, :]
    vals = torch.gather(out.reshape(Wb, R * 3 * N_LIMBS * CL), 1, lin.reshape(Wb, -1))
    vals = vals.reshape(Wb, 3 * N_LIMBS, nbuckets)
    bX, bY, bZ = vals[:, :N_LIMBS], vals[:, N_LIMBS : 2 * N_LIMBS], vals[:, 2 * N_LIMBS :]
    wi, bi = torch.nonzero(first_idx < lane * R, as_tuple=True)
    li = lane[wi, bi]
    fixed = cf.ec_add(
        tuple(t[wi, :, bi].T for t in (bX, bY, bZ)),
        tuple(t[wi, :, li].T for t in (cx, cy, cz)),
    )
    bX, bY, bZ = (t.clone() for t in (bX, bY, bZ))
    for t, f in zip((bX, bY, bZ), fixed):
        t[wi, :, bi] = f.T
    bZ = _where(present, bZ, torch.zeros_like(bZ))
    return bX, bY, bZ


# --- tests ------------------------------------------------------------------------


@pytest.mark.parametrize("distinct", [False, True])
@pytest.mark.parametrize("lanes", [16, 128])
def test_fused_plain_matches_old_composition(dc, lanes, distinct):
    c, bases, digits = bucket_sums_case()
    A = _affine(dc, bases)
    order, d_sorted = _sorted(digits)
    nb = (1 << c) - 1
    got = cf.bucket_sums_fused(cf.pack_bases(*A), order, d_sorted, lanes, nb, distinct)
    want = old_bucket_sums(A, order, d_sorted, nb, distinct, lanes)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == (5, N_LIMBS, nb)
        assert torch.equal(g, w)


def test_fused_plain_ragged_windows_and_lane_edges(dc):
    """Three windows (a ragged count) at 8 lanes of 4 slots: a run that
    ends on a lane's last slot, one that starts on a lane's first, a
    carried run into the last lane, and buckets below every digit."""
    rng = random.Random(5)
    n, c = 32, 4
    bases = [BN254_G1.random_point(rng) for _ in range(n)]
    digits = [
        [2] * 8 + [3] * 4 + [7] * 9 + [9] * 11,
        [rng.randrange(16) for _ in range(n)],
        [0] * 6 + [15] * 26,
    ]
    A = _affine(dc, bases)
    order, d_sorted = _sorted(digits)
    nb = (1 << c) - 1
    got = cf.bucket_sums_fused(cf.pack_bases(*A), order, d_sorted, 8, nb, False)
    want = old_bucket_sums(A, order, d_sorted, nb, False, 8)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.fixture(scope="module")
def jax_digests():
    here = os.path.join(os.path.dirname(__file__), "data", "torch_goldens")
    with open(os.path.join(here, "ec_digests.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("distinct", [False, True])
def test_fused_matches_jax_digests(dc, jax_digests, distinct):
    """At the JAX package's tuning for n = 512 (128 lanes of 4 slots)."""
    c, bases, digits = bucket_sums_case()
    order, d_sorted = _sorted(digits)
    got = cf.bucket_sums_fused(
        cf.pack_bases(*_affine(dc, bases)), order, d_sorted, 128, (1 << c) - 1, distinct
    )
    digest = hashlib.sha256(np.stack([t.numpy() for t in got]).astype("<u4").tobytes()).hexdigest()
    assert digest == jax_digests["bucket_sums_distinct" if distinct else "bucket_sums"]


def test_pack_bases_round_trip(dc):
    rng = np.random.default_rng(3)
    Ax = torch.from_numpy(rng.integers(0, 1 << 16, (N_LIMBS, 7)).astype(np.int32))
    Ay = torch.from_numpy(rng.integers(0, 1 << 16, (N_LIMBS, 7)).astype(np.int32))
    words = cf.pack_bases(Ax, Ay)
    assert words.shape == (7, N_LIMBS) and words.dtype == torch.int32
    x, y = cf.unpack_point_words(words)
    assert torch.equal(x, Ax.to(torch.int64)) and torch.equal(y, Ay.to(torch.int64))


def test_bucket_sums_groups_windows(dc, monkeypatch):
    """bucket_sums splits the windows into groups within its byte budget and
    joins them in order: the same sums as one group."""
    from halo2_lib_tpu_torch.ops import ec_device

    rng = random.Random(8)
    n = 64
    A = _affine(dc, [BN254_G1.random_point(rng) for _ in range(n)])
    digits = torch.tensor([[[rng.randrange(16) for _ in range(n)] for _ in range(3)]
                           for _ in range(2)], dtype=torch.int32)
    whole = bucket_sums(A, digits, 4, True)
    monkeypatch.setattr(ec_device, "_MSM_GROUP_BYTES", 1)
    calls = []
    real = cf.bucket_sums_fused
    monkeypatch.setattr(cf, "bucket_sums_fused", lambda *a: calls.append(a[1].shape) or real(*a))
    parts = bucket_sums(A, digits, 4, True)
    assert calls == [(1, n)] * 6
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)


def test_msm_through_fused_sums_matches_host(dc):
    """A 2-column MSM (msm_many_device, whose bucket accumulation is now
    bucket_sums_fused) against the host curve's double-and-add."""
    rng = random.Random(12)
    n, c = 20, 5
    pts = [BN254_G1.random_point(rng) for _ in range(n)]
    scalars = [[rng.randrange(BN254_G1.scalar.p) for _ in range(n)] for _ in range(2)]
    A = _affine(dc, pts)
    digits = torch.stack([pack_scalars(dc, s, c, device="cpu") for s in scalars])
    out = dc.unpack_points(msm_many_device(dc, A, digits, c))
    for col, want_s in zip(out, scalars):
        want = None
        for pt, s in zip(pts, want_s):
            want = BN254_G1.add(want, BN254_G1.mul(pt, s))
        assert col == want
