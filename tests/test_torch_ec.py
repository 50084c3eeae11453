"""Port G1 arithmetic, Pippenger MSM and the small-column double-and-add
commit (halo2_lib_tpu_torch/ops/ec_device.py, backend/kzg.py and the EC
kernels' plain versions in ops/cuda_field.py) vs the JAX package's DeviceCurve
and the host curve oracle BN254_G1.

Jacobian outputs are compared limb for limb with the JAX package's XLA
formulas (the same formulas, so the same coordinates), through the SHA-256 of
the JAX outputs that tests/data/torch_goldens/make_goldens.py froze on the
same points, and in affine form with the host oracle. Tolerance 0
throughout.
"""

import hashlib
import json
import os
import random

import numpy as np
import pytest
import torch

from halo2_lib_tpu.utils.curves import BN254_G1 as JAX_G1
from halo2_lib_tpu_torch.backend.kzg import ParamsKZG, _pack_affine, commit_double_and_add, host_points, window_digits
from halo2_lib_tpu_torch.ops import cuda_field as cf
from halo2_lib_tpu_torch.ops.ec_device import DeviceCurve, msm_many_device, pack_scalars
from halo2_lib_tpu_torch.ops.limbs import DeviceField
from halo2_lib_tpu_torch.utils.curves import BN254_G1
from halo2_lib_tpu_torch.utils.fields import FR_BN254

# One core per test process: the suite runs in parallel workers, and a
# thread pool per worker would oversubscribe the host.
torch.set_num_threads(1)

Q = BN254_G1.base.p
R_ORDER = BN254_G1.scalar.p


@pytest.fixture(scope="module")
def dc():
    return DeviceCurve(DeviceField(BN254_G1.base), BN254_G1)


@pytest.fixture(scope="module")
def jax_digests():
    path = os.path.join(os.path.dirname(__file__), "data", "torch_goldens", "ec_digests.json")
    with open(path) as f:
        return json.load(f)


def _case_points():
    """make_goldens.ec_case_points: generic pairs plus every special case of
    the complete add, and the points to double."""
    rng = random.Random(7)
    pts1 = [BN254_G1.random_point(rng) for _ in range(16)]
    pts2 = [BN254_G1.random_point(rng) for _ in range(16)]
    pts1[0] = None  # O + Q
    pts2[1] = None  # P + O
    pts1[2] = pts2[2] = None  # O + O
    pts2[3] = pts1[3]  # P + P: the doubling branch
    x, y = pts1[4]
    pts2[4] = (x, Q - y)  # P + (-P) = O
    rng = random.Random(9)
    dbl = [BN254_G1.random_point(rng) for _ in range(15)] + [None]
    return pts1, pts2, dbl


def _digest(P) -> str:
    return hashlib.sha256(torch.stack(list(P)).numpy().astype("<u4").tobytes()).hexdigest()


def test_case_points_match_the_jax_oracle():
    """The port's copy of the host oracle draws the same points."""
    rng_a, rng_b = random.Random(7), random.Random(7)
    assert [BN254_G1.random_point(rng_a) for _ in range(4)] == [
        JAX_G1.random_point(rng_b) for _ in range(4)
    ]


def test_ec_add_all_cases(dc, jax_digests):
    pts1, pts2, _ = _case_points()
    got = dc.add(dc.pack_points(pts1, device="cpu"), dc.pack_points(pts2, device="cpu"))
    assert dc.unpack_points(got) == [BN254_G1.add(p, q) for p, q in zip(pts1, pts2)]
    assert _digest(got) == jax_digests["add"]


def test_ec_double(dc, jax_digests):
    _, _, pts = _case_points()
    got = dc.double(dc.pack_points(pts, device="cpu"))
    assert dc.unpack_points(got) == [BN254_G1.double(p) for p in pts]
    assert _digest(got) == jax_digests["double"]


def _madd_case_points():
    """make_goldens.madd_case_points: Jacobian accumulators with random Z
    and affine bases; lanes 0-4 are identity accumulator, identity base,
    both, base == accumulator and base == -accumulator. Also returns the
    host points."""
    rng = random.Random(13)
    acc = [BN254_G1.random_point(rng) for _ in range(16)]
    base = [BN254_G1.random_point(rng) for _ in range(16)]
    acc[0] = None
    base[1] = None
    acc[2] = base[2] = None
    base[3] = acc[3]
    base[4] = (acc[4][0], Q - acc[4][1])
    jac = []
    for pt in acc:
        z = rng.randrange(1, Q)
        jac.append((0, 0, 0) if pt is None else (pt[0] * z * z % Q, pt[1] * z**3 % Q, z))
    aff = [(0, 0) if pt is None else pt for pt in base]
    return [list(c) for c in zip(*jac)], [list(c) for c in zip(*aff)], acc, base


@pytest.mark.parametrize("distinct", [False, True])
def test_ec_madd_all_cases(dc, jax_digests, distinct):
    """ec_madd's plain version equals the JAX package's _madd_xla limb for
    limb (frozen digest) and the host oracle in affine form; with
    distinct=True the doubling lane (3) is outside the contract."""
    jac, aff, acc, base = _madd_case_points()
    P1 = tuple(dc.df.pack(c, device="cpu") for c in jac)
    A2 = tuple(dc.df.pack(c, device="cpu") for c in aff)
    got = cf.ec_madd(P1, A2, distinct)
    assert _digest(got) == jax_digests["madd_distinct" if distinct else "madd"]
    want = [BN254_G1.add(p, q) for p, q in zip(acc, base)]
    pts = dc.unpack_points(got)
    if distinct:
        pts, want = pts[:3] + pts[4:], want[:3] + want[4:]
    assert pts == want
    assert torch.equal(torch.stack(dc._madd(P1, A2, distinct)), torch.stack(got))


def test_ec_madd_shared_bases(dc):
    """A [2, 16, B] accumulator plus one [16, B] set of bases."""
    rng = random.Random(14)
    acc = [BN254_G1.random_point(rng) for _ in range(8)]
    base = [BN254_G1.random_point(rng) for _ in range(4)]
    P = tuple(t.reshape(16, 2, 4).permute(1, 0, 2) for t in dc.pack_points(acc, device="cpu"))
    A = dc.pack_points_affine(base, device="cpu")
    got = tuple(t.permute(1, 0, 2).reshape(16, 8) for t in cf.ec_madd(P, A, False))
    assert dc.unpack_points(got) == [BN254_G1.add(p, base[i % 4]) for i, p in enumerate(acc)]


@pytest.fixture(scope="module")
def srs8():
    path = os.path.join(os.path.dirname(__file__), "..", "params", "kzg_bn254_8.srs")
    return ParamsKZG.read(path, device="cpu")


@pytest.mark.parametrize("m", [16, 64])
def test_commit_double_and_add(dc, srs8, m):
    """The card's small-column commit path, run here on the kernels' plain
    versions (C = 2 columns), against a host-int MSM over the SRS Lagrange
    bases and against the Pippenger MSM (msm_many_device) on the same
    bases."""
    fr_df = DeviceField(FR_BN254)
    rng = np.random.default_rng(m)
    cols = []
    for _ in range(2):
        words = rng.integers(0, 1 << 62, size=(m, 5), dtype=np.int64)
        cols.append([sum(int(w) << (62 * i) for i, w in enumerate(row)) % R_ORDER for row in words])
    cols[1][:3] = [0, 1, R_ORDER - 1]
    vals = torch.stack([fr_df.pack(c, device="cpu") for c in cols])  # [2, 16, m] Montgomery
    bases = srs8.affine_lagrange_bases("cpu")
    got = host_points(_pack_affine(dc.df, *commit_double_and_add(dc, fr_df, vals, bases)))
    want = []
    for c in cols:
        acc = None
        for k, pt in zip(c, srs8.g_lagrange[:m]):
            acc = BN254_G1.add(acc, BN254_G1.mul(pt, k))
        want.append(acc)
    assert got == want
    digits = window_digits(fr_df, vals, 4)
    pip = msm_many_device(dc, tuple(t[:, :m] for t in bases), digits, 4, distinct=True)
    assert host_points(_pack_affine(dc.df, *pip)) == want


def test_ec_add_batched_broadcast(dc):
    """[2, 16, B] points plus one [16, 1] point."""
    rng = random.Random(3)
    pts = [BN254_G1.random_point(rng) for _ in range(8)]
    q = BN254_G1.random_point(rng)
    P = tuple(t.reshape(16, 2, 4).permute(1, 0, 2) for t in dc.pack_points(pts, device="cpu"))
    Qp = dc.pack_points([q], device="cpu")
    got = dc.unpack_points(tuple(t.permute(1, 0, 2).reshape(16, 8) for t in dc.add(P, Qp)))
    assert got == [BN254_G1.add(p, q) for p in pts]


@pytest.mark.parametrize("distinct", [False, True])
def test_bucket_scan_plain_matches_host(dc, distinct):
    """Each (window, lane) chain's running sum, reset at segment starts,
    equals the host oracle's affine running sum."""
    rng = random.Random(11 + distinct)
    Wb, R, CL = 2, 6, 5
    pts = [[[BN254_G1.random_point(rng) for _ in range(CL)] for _ in range(R)] for _ in range(Wb)]
    dead = {(0, 2, 1), (1, 0, 3)}
    for w, r, l in dead:
        pts[w][r][l] = None
    start = np.zeros((Wb, R, CL), dtype=np.int32)
    start[:, 0, :] = 1
    start[0, 3, 2] = start[1, 4, 0] = 1
    flat = [pts[w][r][l] for w in range(Wb) for r in range(R) for l in range(CL)]
    Ax, Ay = dc.pack_points_affine(flat, device="cpu")  # [16, Wb*R*CL]
    axy = torch.cat([_pack(Ax), _pack(Ay)], dim=0).reshape(16, Wb, R, CL).permute(1, 2, 0, 3)
    out = cf.bucket_scan(axy.contiguous(), torch.from_numpy(start), distinct)
    assert out.shape == (Wb, R, 48, CL)
    for w in range(Wb):
        for l in range(CL):
            acc = None
            for r in range(R):
                acc = pts[w][r][l] if start[w, r, l] else BN254_G1.add(acc, pts[w][r][l])
                o = out[w, r, :, l]
                got = dc.unpack_points((o[:16, None], o[16:32, None], o[32:, None]))[0]
                assert got == acc, (w, r, l)


def _pack(A):
    v = A[:8].to(torch.int64) | (A[8:].to(torch.int64) << 16)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def _multiples(n):
    """(i + 1) * G for i < n, by repeated addition."""
    out, acc = [], None
    for _ in range(n):
        acc = BN254_G1.add(acc, BN254_G1.g)
        out.append(acc)
    return out


@pytest.mark.parametrize("n, window_bits", [(256, 10), (1024, 8), (512, 6)])
def test_msm_many_matches_host(dc, n, window_bits):
    rng = np.random.default_rng(n + window_bits)
    pts = _multiples(n)
    cols = []
    for c in range(2 if n == 512 else 1):
        words = rng.integers(0, 1 << 62, size=(n, 5), dtype=np.int64)
        cols.append([sum(int(w) << (62 * i) for i, w in enumerate(row)) % R_ORDER for row in words])
    cols[-1][: n // 3] = [0] * (n // 3)
    cols[-1][n // 3] = R_ORDER - 1
    A = dc.pack_points_affine(pts, device="cpu")
    digits = torch.stack([pack_scalars(dc, s, window_bits, device="cpu") for s in cols])
    got = dc.unpack_points(msm_many_device(dc, A, digits, window_bits, distinct=False))
    want = [BN254_G1.mul(BN254_G1.g, sum(k * (i + 1) for i, k in enumerate(s))) for s in cols]
    assert got == want


def test_msm_distinct_bases(dc):
    """distinct=True (the SRS path) on bases 2^i * H and 2^i * H' (i < 128)
    for two random points: no partial bucket sum can equal a base."""
    rng = random.Random(5)
    H, H2 = BN254_G1.random_point(rng), BN254_G1.random_point(rng)
    pts = []
    for base in (H, H2):
        acc = base
        for _ in range(128):
            pts.append(acc)
            acc = BN254_G1.double(acc)
    scal = [rng.randrange(R_ORDER) for _ in range(len(pts))]
    A = dc.pack_points_affine(pts, device="cpu")
    digits = pack_scalars(dc, scal, 8, device="cpu")[None]
    got = dc.unpack_points(msm_many_device(dc, A, digits, 8, distinct=True))
    e1 = sum(k << i for i, k in enumerate(scal[:128]))
    e2 = sum(k << i for i, k in enumerate(scal[128:]))
    assert got == [BN254_G1.add(BN254_G1.mul(H, e1), BN254_G1.mul(H2, e2))]


def test_tree_reduce_and_select(dc):
    rng = random.Random(12)
    pts = [BN254_G1.random_point(rng) for _ in range(5)] + [None]
    P = dc.pack_points(pts, device="cpu")
    total = None
    for p in pts:
        total = BN254_G1.add(total, p)
    assert dc.unpack_points(dc.tree_reduce(P)) == [total]
    cond = torch.tensor([True, False] * 3)
    Q = dc.identity((6,), device="cpu")
    assert dc.unpack_points(dc.select(cond, P, Q)) == [p if i % 2 == 0 else None for i, p in enumerate(pts)]
