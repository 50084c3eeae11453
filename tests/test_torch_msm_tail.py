"""The fused tail of the port's Pippenger MSM (halo2_lib_tpu_torch/ops/
cuda_field.py: bucket_weight and msm_combine, through their plain versions on
the CPU) against the loops of single point ops it replaces, and the MSM
around it against the host curve oracle.

The reference loops below are written here from the single-op plain versions
(ec_add_plain, ec_double_plain): the merged-lane weighted bucket reduction
and the MSB-first window combine of ops/ec_device.py before the fusion. The
fused versions must run the same point ops in the same order, so their
Jacobian coordinates agree limb for limb (tolerance 0). Inputs are curve
points made from a numpy seed, in Jacobian form with random Z, with the
special lanes of the complete add: identities (empty buckets), equal points
(the doubling branch) and inverse pairs (P + (-P)). Both fused steps are
also held, limb for limb, to the JAX package's own MSM tail
(halo2_lib_tpu/ops/ec_device.py:_msm_from_digits) through the digests that
tests/data/torch_goldens/make_goldens.py froze on fixed bucket sums.
"""

import hashlib
import json
import os
import random

import numpy as np
import pytest
import torch

from halo2_lib_tpu_torch.ops import cuda_field as cf
from halo2_lib_tpu_torch.ops.ec_device import DeviceCurve, msm_many_device, pack_scalars
from halo2_lib_tpu_torch.ops.limbs import DeviceField
from halo2_lib_tpu_torch.utils.curves import BN254_G1

# One core per test process: the suite runs in parallel workers, and a
# thread pool per worker would oversubscribe the host.
torch.set_num_threads(1)

Q = BN254_G1.base.p
R_ORDER = BN254_G1.scalar.p


@pytest.fixture(scope="module")
def dc():
    return DeviceCurve(DeviceField(BN254_G1.base), BN254_G1)


def _neg(pt):
    return None if pt is None else (pt[0], (Q - pt[1]) % Q)


def _jacobian(dc, pts, rng):
    """Host points (None = identity) -> Montgomery Jacobian [16, n] limbs
    with a random Z per point."""
    X, Y, Z = [], [], []
    for pt in pts:
        if pt is None:
            X.append(0), Y.append(0), Z.append(0)
            continue
        z = int(rng.integers(1, 1 << 62)) * int(rng.integers(1, 1 << 62)) % Q
        X.append(pt[0] * z * z % Q), Y.append(pt[1] * z**3 % Q), Z.append(z)
    return tuple(dc.df.pack(v, device="cpu") for v in (X, Y, Z))


def _pool(rng, k):
    return [BN254_G1.mul(BN254_G1.g, int(rng.integers(1, 1 << 62))) for _ in range(k)]


# --- the loops before the fusion, on the single-op plain versions -----------------


def _suffix_local(P, CL2):
    M = P[0].shape[-1]
    l_loc = torch.arange(M) % CL2
    for d in range(max(CL2.bit_length() - 1, 1)):
        sh = 1 << d
        ok = l_loc + sh < CL2
        Qs = tuple(torch.where(ok, torch.roll(t, -sh, dims=-1), torch.zeros_like(t)) for t in P)
        P = cf.ec_add_plain(P, Qs)
    return P


def _step_loop_weight(S, CL2):
    Wtot, _, nb = S[0].shape
    R2 = -(-nb // CL2)
    M = Wtot * CL2
    St = tuple(
        torch.nn.functional.pad(t, (0, R2 * CL2 - nb)).reshape(Wtot, 16, R2, CL2) for t in S
    )
    rows = tuple(t.permute(2, 1, 0, 3).reshape(R2, 16, M).flip(0) for t in St)
    zero = torch.zeros((16, M), dtype=torch.int32)
    acc = tot = (zero, zero, zero)
    for r in range(R2):
        acc = cf.ec_add_plain(acc, tuple(t[r] for t in rows))
        tot = cf.ec_add_plain(tot, acc)
    suf1 = _suffix_local(tuple(torch.cat([a, t], dim=-1) for a, t in zip(acc, tot)), CL2)
    sufA = tuple(t[..., :M] for t in suf1)
    sufT = tuple(t[..., M:] for t in suf1)
    suf2 = _suffix_local(sufA, CL2)
    TA = tuple(t[..., 0::CL2] for t in sufA)
    TT = tuple(t[..., 0::CL2] for t in sufT)
    TS = tuple(t[..., 0::CL2] for t in suf2)
    negTA = (TA[0], cf.field_sub_plain(cf.FQ, torch.zeros_like(TA[1]), TA[1]), TA[2])
    D = cf.ec_add_plain(TT, negTA)
    for _ in range(CL2.bit_length() - 1):
        D = cf.ec_double_plain(D)
    return cf.ec_add_plain(D, TS)


def _step_loop_combine(T, W, c):
    C = T[0].shape[-1] // W
    zero = torch.zeros((16, C), dtype=torch.int32)
    res = (zero, zero, zero)
    for w in range(W - 1, -1, -1):
        for _ in range(c):
            res = cf.ec_double_plain(res)
        res = cf.ec_add_plain(res, tuple(t.reshape(16, C, W)[..., w] for t in T))
    return res


# --- the fused versions against them -------------------------------------------------


def _bucket_points(rng, Wtot, nb, CL2):
    """[Wtot][nb] host bucket sums, about a fifth empty. Window 0's first
    lanes meet the special cases in the row chain: acc + row doubles, tot +
    acc doubles, acc + row = P + (-P). Window 1 holds one point per lane, so
    the suffix scan's first level adds P + (-P) and P + P."""
    pool = _pool(rng, 12)
    pts = [
        [None if rng.random() < 0.2 else pool[int(rng.integers(len(pool)))] for _ in range(nb)]
        for _ in range(Wtot)
    ]
    R2 = -(-nb // CL2)

    def slots(l):
        """The lane's top slot in range (rows are walked from the top) and
        the slot one row below it."""
        ra = R2 - 1 if (R2 - 1) * CL2 + l < nb else R2 - 2
        return ra * CL2 + l, (ra - 1) * CL2 + l

    P = pool[0]
    for l, (a, b) in enumerate([(P, P), (P, None), (P, _neg(P))][:CL2]):
        sa, sb = slots(l)
        pts[0][sa], pts[0][sb] = a, b
    pts[1] = [None] * nb
    for l, a in enumerate([P, _neg(P), P, P][:CL2]):
        pts[1][slots(l)[0]] = a
    return pts


def _weighted_sum(bucket_pts):
    """sum_b b * S_b on the host: running suffix sums."""
    running = total = None
    for pt in reversed(bucket_pts):
        running = BN254_G1.add(running, pt)
        total = BN254_G1.add(total, running)
    return total


@pytest.mark.parametrize("CL2, nb, Wtot", [(2, 7, 5), (8, 31, 3), (64, 100, 3)])
def test_bucket_weight_plain_equals_step_loop(dc, CL2, nb, Wtot):
    rng = np.random.default_rng(CL2)
    pts = _bucket_points(rng, Wtot, nb, CL2)
    flat = _jacobian(dc, [p for w in pts for p in w], rng)
    S = tuple(t.reshape(16, Wtot, nb).permute(1, 0, 2).contiguous() for t in flat)
    got = cf.bucket_weight(S, CL2)
    want = _step_loop_weight(S, CL2)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == (16, Wtot)
        assert torch.equal(g, w)
    # and the weighted sums themselves, in affine form
    assert dc.unpack_points(got) == [_weighted_sum(w) for w in pts]


@pytest.mark.parametrize("C", [1, 3])
def test_msm_combine_plain_equals_step_loop(dc, C):
    """W = 4 windows of c = 3 bits; column 1 meets 2^c * res == T_w (the
    doubling branch), column 2 2^c * res == -T_w (the identity case)."""
    W, c = 4, 3
    rng = np.random.default_rng(40 + C)
    pool = _pool(rng, 4)
    cols = [[pool[rng.integers(4)] for _ in range(W)] for _ in range(C)]
    cols[0][1] = None
    if C > 1:
        cols[1][W - 1], cols[1][W - 2] = pool[0], BN254_G1.mul(pool[0], 1 << c)
        cols[2][W - 1], cols[2][W - 2] = pool[1], _neg(BN254_G1.mul(pool[1], 1 << c))
    T = _jacobian(dc, [p for col in cols for p in col], rng)  # lane = column * W + w
    got = cf.msm_combine(T, W, c)
    for g, w in zip(got, _step_loop_combine(T, W, c)):
        assert g.shape == (16, C) and torch.equal(g, w)
    expect = []
    for col in cols:
        acc = None
        for w, pt in enumerate(col):
            acc = BN254_G1.add(acc, BN254_G1.mul(pt, 1 << (c * w)) if pt is not None else None)
        expect.append(acc)
    assert dc.unpack_points(got) == expect


def _tail_case_points():
    """make_goldens.msm_tail_case_points: C = 3 columns x W = 3 windows of
    c = 8 bits, their bucket sums as host points (None = empty) and as
    Jacobian int lists with a random Z per point; window 0's lanes 0-2 meet
    the row chain's special cases, window 1's lanes 0-3 the suffix scan's."""
    C, W, c = 3, 3, 8
    nb = (1 << c) - 1
    rng = random.Random(21)
    pool = [BN254_G1.random_point(rng) for _ in range(12)]
    pts = [
        [None if rng.random() < 0.2 else rng.choice(pool) for _ in range(nb)] for _ in range(C * W)
    ]
    P = pool[0]
    for l, (a, b) in enumerate([(P, P), (P, None), (P, _neg(P))]):
        pts[0][192 + l], pts[0][128 + l] = a, b
    pts[1] = [None] * nb
    for l, a in enumerate([P, _neg(P), P, P]):
        pts[1][192 + l] = a
    jac = []
    for pt in (p for w in pts for p in w):
        z = rng.randrange(1, Q)
        jac.append((0, 0, 0) if pt is None else (pt[0] * z * z % Q, pt[1] * z**3 % Q, z))
    return C, W, c, pts, [list(v) for v in zip(*jac)]


def _digest(P) -> str:
    return hashlib.sha256(torch.stack(list(P)).numpy().astype("<u4").tobytes()).hexdigest()


def test_tail_matches_jax_digests(dc):
    """bucket_weight at the card's 64 lanes, then msm_combine, on fixed
    bucket sums: the window sums and the combined points equal the JAX
    package's tail on the same sums limb for limb, and the host's sums."""
    path = os.path.join(os.path.dirname(__file__), "data", "torch_goldens", "ec_digests.json")
    with open(path) as f:
        golden = json.load(f)
    C, W, c, pts, jac = _tail_case_points()
    nb = (1 << c) - 1
    S = tuple(dc.df.pack(v, device="cpu").reshape(16, C * W, nb).permute(1, 0, 2).contiguous()
              for v in jac)
    T = cf.bucket_weight(S, 64)
    assert _digest(T) == golden["msm_tail_window_sums"]
    assert dc.unpack_points(T) == [_weighted_sum(w) for w in pts]
    assert _digest(cf.msm_combine(T, W, c)) == golden["msm_tail"]


def test_msm_many_columns_match_host(dc):
    """msm_many_device, whose tail is now the two fused steps, on C = 3
    columns against the host MSM over the bases (i + 1) * G."""
    n, c, C = 96, 5, 3
    rng = np.random.default_rng(7)
    pts, acc = [], None
    for _ in range(n):
        acc = BN254_G1.add(acc, BN254_G1.g)
        pts.append(acc)
    scal = [[int(rng.integers(0, 1 << 62)) ** 4 % R_ORDER for _ in range(n)] for _ in range(C)]
    scal[1][: n // 2] = [0] * (n // 2)
    digits = torch.stack([pack_scalars(dc, s, c, device="cpu") for s in scal])
    got = msm_many_device(dc, dc.pack_points_affine(pts, device="cpu"), digits, c, distinct=False)
    expect = [BN254_G1.mul(BN254_G1.g, sum(k * (i + 1) for i, k in enumerate(s))) for s in scal]
    assert dc.unpack_points(got) == expect


def test_tail_wrappers_reject_bad_shapes():
    z = torch.zeros((3, 16, 7), dtype=torch.int32)
    with pytest.raises(ValueError):
        cf.bucket_weight((z, z, z), 3)
    with pytest.raises(ValueError):
        cf.bucket_weight((z, z, z[:2]), 2)
    t = torch.zeros((16, 10), dtype=torch.int32)
    with pytest.raises(ValueError):
        cf.msm_combine((t, t, t), 4, 3)
