"""The port's small-column commit (halo2_lib_tpu_torch/ops/cuda_field.py:
commit_dbl_add, through its plain version on the CPU) against the per-bit
composition it replaces, against the JAX package's own small branch, and
against the host curve oracle.

The reference composition below is a copy of backend/kzg.py's
commit_double_and_add before the fusion: one-bit window digits reversed to
MSB first, then for each of the 254 bits a doubling (ec_double), a mixed
add with its doubling branch (ec_madd, distinct=False) and a select by the
bit, then DeviceCurve.tree_reduce over each column's lanes. The fused
function runs the same point ops in the same order, so its Jacobian output
agrees limb for limb (tolerance 0); so does the JAX package's branch
(halo2_lib_tpu/backend/kzg.py:499-519 before its pack_out), through the
digest tests/data/torch_goldens/make_goldens.py froze on the same columns.
Inputs: C = 3 columns of Fr scalars from a fixed seed, with 0, 1 and r - 1
among them, at m = 16 and m = 13 (an odd tree) against the k=8 SRS
Lagrange bases.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from halo2_lib_tpu_torch.backend.kzg import ParamsKZG, _pack_affine, host_points, window_digits
from halo2_lib_tpu_torch.ops import cuda_field as cf
from halo2_lib_tpu_torch.ops.ec_device import DeviceCurve
from halo2_lib_tpu_torch.ops.limbs import DeviceField
from halo2_lib_tpu_torch.utils.curves import BN254_G1
from halo2_lib_tpu_torch.utils.fields import FR_BN254

# One core per test process: the suite runs in parallel workers, and a
# thread pool per worker would oversubscribe the host.
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))


def commit_simple_case() -> list[list[int]]:
    """tests/data/torch_goldens/make_goldens.py:commit_simple_case: three
    columns of 16 Fr scalars, 0, 1 and r - 1 among them."""
    r = FR_BN254.p
    rng = np.random.default_rng(41)
    cols = []
    for _ in range(3):
        words = rng.integers(0, 1 << 62, size=(16, 5), dtype=np.int64)
        cols.append([sum(int(w) << (62 * i) for i, w in enumerate(row)) % r for row in words])
    cols[1][:3] = [0, 1, r - 1]
    cols[2][10:13] = [r - 1, 0, 1]
    return cols


def old_lane_sums(dc, fr_df, vals_mont, bases):
    """backend/kzg.py:commit_double_and_add before the fusion, on the
    kernels' plain versions, up to its tree: [C, 16, m] Montgomery columns
    -> each lane's double-and-add sum (Jacobian [C, 16, m])."""
    C, _, m = vals_mont.shape
    Am = tuple(t[:, :m].contiguous() for t in bases)
    bits = window_digits(fr_df, vals_mont, 1).flip(-2) != 0  # [C, 254, m], MSB first
    acc = dc.identity((C, m), vals_mont.device)
    for w in range(bits.shape[-2]):
        acc = cf.ec_double_plain(acc)
        acc = dc.select(bits[:, w], cf.ec_madd_plain(acc, Am, False), acc)
    return acc


def old_tree(dc, acc):
    """The rest of the old commit_double_and_add: tree_reduce over each
    column's lanes -> Jacobian [16, C]."""
    X, Y, Z = dc.tree_reduce(acc)  # [C, 16, 1]
    return tuple(t[..., 0].transpose(0, 1) for t in (X, Y, Z))


@pytest.fixture(scope="module")
def case():
    """(curve, SRS, host columns, the old composition's 16 lane sums, the
    fused commit's output at m = 16 and m = 13). Lanes are independent until
    the tree, so the old lane sums at m = 13 are the first 13 of these."""
    dc = DeviceCurve(DeviceField(BN254_G1.base), BN254_G1)
    fr_df = DeviceField(FR_BN254)
    srs = ParamsKZG.read(os.path.join(HERE, "..", "params", "kzg_bn254_8.srs"), device="cpu")
    cols = commit_simple_case()
    vals = torch.stack([fr_df.pack(c, device="cpu") for c in cols])  # [3, 16, 16]
    bases = srs.affine_lagrange_bases("cpu")
    canon = fr_df._from_mont(vals)
    got = {m: cf.commit_dbl_add(canon[..., :m], *bases) for m in (16, 13)}
    return dc, srs, cols, old_lane_sums(dc, fr_df, vals, bases), got


@pytest.mark.parametrize("m", [16, 13])
def test_commit_dbl_add_equals_old_composition(case, m):
    dc, _, _, old, got = case
    want = old_tree(dc, tuple(t[..., :m] for t in old))
    for g, w in zip(got[m], want):
        assert g.shape == (16, 3) and torch.equal(g, w)


def test_commit_dbl_add_matches_jax_digest(case):
    *_, got = case
    with open(os.path.join(HERE, "data", "torch_goldens", "ec_digests.json")) as f:
        want = json.load(f)["commit_simple"]
    data = b"".join(torch.stack(list(got[m])).numpy().astype("<u4").tobytes() for m in (16, 13))
    assert hashlib.sha256(data).hexdigest() == want


def test_commit_dbl_add_matches_host_msm(case):
    """At m = 13; test_torch_ec.py holds m = 16 and 64 to the host MSM."""
    dc, srs, cols, _, got = case
    m = 13
    want = []
    for c in cols:
        acc = None
        for k, pt in zip(c[:m], srs.g_lagrange[:m]):
            acc = BN254_G1.add(acc, BN254_G1.mul(pt, k))
        want.append(acc)
    assert host_points(_pack_affine(dc.df, *got[m])) == want


def test_commit_dbl_add_rejects_bad_operands(case):
    _, srs, *_ = case
    bases = srs.affine_lagrange_bases("cpu")
    with pytest.raises(ValueError):
        cf.commit_dbl_add(torch.zeros((2, 15, 4), dtype=torch.int32), *bases)
    with pytest.raises(ValueError):
        cf.commit_dbl_add(torch.zeros((2, 16, 0), dtype=torch.int32), *bases)
    with pytest.raises(ValueError):
        cf.commit_dbl_add(torch.zeros((2, 16, 300), dtype=torch.int32), *bases)
