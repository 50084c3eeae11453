"""The plain reference against exact Python ints, against the port on the
CPU at small sizes, and against the JAX package's frozen golden proof."""

import os
import random

import numpy as np
import pytest
import torch

from benchmark.reference import ecdsa, fr_vec, kzg, ntt
from benchmark.reference.fr_torch import FrTorch
from benchmark.reference.proofs import ProofChecker

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_fr_torch_against_ints():
    F = FrTorch("cpu")
    p = F.p_int
    rng = random.Random(1)
    xs = [0, 1, p - 1, p - 2, (1 << 255) % p] + [rng.randrange(p) for _ in range(300)]
    ys = [rng.randrange(p) for _ in xs]
    a, b = F.from_ints(xs), F.from_ints(ys)
    assert F.to_ints(F.mul(a, b)) == [x * y % p for x, y in zip(xs, ys)]
    assert F.to_ints(F.add(a, b)) == [(x + y) % p for x, y in zip(xs, ys)]
    assert F.to_ints(F.sub(a, b)) == [(x - y) % p for x, y in zip(xs, ys)]
    assert F.to_ints(F.sub(b, a)) == [(y - x) % p for x, y in zip(xs, ys)]
    assert F.to_ints(F.powers(7, 37)) == [pow(7, i, p) for i in range(37)]
    nz = [x for x in xs if x]
    assert F.to_ints(F.batch_inverse(F.from_ints(nz))) == [pow(x, -1, p) for x in nz]
    plain = F.canonical_limbs(F.from_ints([12345, p - 1]))
    assert fr_vec.limbs_to_ints(plain.astype(np.int64)) == [12345, p - 1]


def test_limb_dot_against_ints():
    p = FrTorch("cpu").p_int
    rng = np.random.default_rng(3)
    x = rng.integers(0, 1 << 16, size=(2, 16, 3000), dtype=np.int64)
    w_ints = [int(v) % p for v in rng.integers(0, 1 << 62, size=3000)]
    w = np.array([[(v >> (16 * i)) & 0xFFFF for i in range(16)] for v in w_ints], dtype=np.float64)
    got = fr_vec.limb_dot(x, w, p)
    for c in range(2):
        xs = fr_vec.limbs_to_ints(np.moveaxis(x[c], 0, -1))
        assert got[c] == sum(a * b for a, b in zip(xs, w_ints)) % p


@pytest.mark.parametrize("lagrange", [True, False])
def test_commitments_against_the_port(lagrange):
    from halo2_lib_tpu_torch.backend.kzg import ParamsKZG
    from halo2_lib_tpu_torch.ops.limbs import DeviceField
    from halo2_lib_tpu_torch.utils.fields import FR_BN254

    params = ParamsKZG.read(os.path.join(REPO, "params", "kzg_bn254_8.srs"), device="cpu")
    g = torch.Generator().manual_seed(5)
    cols = torch.randint(0, 1 << 16, (2, 16, 256), generator=g, dtype=torch.int32)
    cols[:, 15] %= 0x3064
    bases = params.affine_lagrange_bases("cpu") if lagrange else params.affine_bases("cpu")
    out = params.commit_columns(DeviceField(FR_BN254), cols, bases)
    want = kzg.Committer(8, lagrange).commit(cols.numpy())
    assert kzg.packed_points(out.numpy()) == want
    out[1, 3] ^= 1
    assert kzg.packed_points(out.numpy())[1] != want[1]


def test_transform_check_against_the_port():
    from halo2_lib_tpu_torch.ops.limbs import DeviceField
    from halo2_lib_tpu_torch.ops.ntt import new_ntt
    from halo2_lib_tpu_torch.utils.fields import FR_BN254

    t = new_ntt(DeviceField(FR_BN254), 12, "cpu")
    g = torch.Generator().manual_seed(6)
    x = torch.randint(0, 1 << 16, (1, 16, 4096), generator=g, dtype=torch.int32)
    x[:, 15] %= 0x3064
    y = t.forward(x)
    back = t.inverse(y)
    check = ntt.TransformCheck(12, 987654321)
    assert check.forward_mismatches(x.numpy(), y.numpy()) == 0
    assert check.inverse_mismatches(x.numpy(), back.numpy()) == 0
    y[0, 2, 100] ^= 4
    assert check.forward_mismatches(x.numpy(), y.numpy()) == 1
    assert check.inverse_mismatches(x.numpy(), y.numpy()) == 1


def test_signatures_verify_and_repeat_by_seed():
    sigs = ecdsa.signatures(2**33 + 1, 3)
    assert sigs == ecdsa.signatures(2**33 + 1, 3) and sigs != ecdsa.signatures(2**33 + 2, 3)
    for pub, r, s, msghash in sigs:
        assert ecdsa.verify(pub, msghash, r, s)
        assert not ecdsa.verify(pub, msghash + 1, r, s)


def test_the_frozen_verifier_on_the_jax_golden_proof():
    golden = np.load(os.path.join(REPO, "tests", "data", "torch_goldens", "golden_k9.npz"))
    checker = ProofChecker(bytes(golden["vk"]))
    assert checker.vk.transcript_repr() == int.from_bytes(bytes(golden["transcript_repr"]), "little")
    proof = bytes(golden["proof"])
    assert checker.verifies(proof)
    assert not checker.verifies(proof[:100] + bytes([proof[100] ^ 1]) + proof[101:])
