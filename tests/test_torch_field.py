"""Port field layer (halo2_lib_tpu_torch/ops/limbs.py, ops/cuda_field.py) vs
the JAX package's DeviceField and exact host ints.

On the CPU every port wrapper runs its kernel's plain version; the same
inputs (numpy seed) go through the JAX package's XLA field math and, for the
Montgomery product, its Pallas kernel in interpret mode. Results are compared
exactly: limbs as integers, tolerance 0.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from halo2_lib_tpu.ops import pallas_field as jpf
from halo2_lib_tpu.ops.limbs import DeviceField as JaxField
from halo2_lib_tpu_torch.ops import cuda_field as cf
from halo2_lib_tpu_torch.ops.limbs import DeviceField
from halo2_lib_tpu_torch.utils.fields import FQ_BN254, FR_BN254

# One core per test process: the suite runs in parallel workers, and a
# thread pool per worker would oversubscribe the host.
torch.set_num_threads(1)

FIELDS = {"Fr": FR_BN254, "Fq": FQ_BN254}
B = 72  # lanes: 64 random values + the edge values


def _values(p: int, seed: int) -> list[int]:
    """64 random canonical values, then 0, p-1, R mod p and 1, each twice."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 62, size=(B - 8, 5), dtype=np.int64)
    rand = [sum(int(w) << (62 * i) for i, w in enumerate(row)) % p for row in words]
    edges = [0, p - 1, (1 << 256) % p, 1]
    return rand + edges + edges[::-1]


@pytest.fixture(scope="module", params=sorted(FIELDS))
def fields(request):
    F = FIELDS[request.param]
    from halo2_lib_tpu.utils.fields import FQ_BN254 as JFQ, FR_BN254 as JFR

    jf = JaxField(JFR if request.param == "Fr" else JFQ)
    return DeviceField(F), jf, F.p


def _pair(df, jf, p, seed):
    xs, ys = _values(p, seed), _values(p, seed + 1)[::-1]
    a, b = df.pack(xs, device="cpu"), df.pack(ys, device="cpu")
    return xs, ys, a, b, jnp.asarray(a.numpy().astype(np.uint32)), jnp.asarray(b.numpy().astype(np.uint32))


def _np(t):
    return np.asarray(t).astype(np.int64)


@pytest.mark.parametrize("op", ["mont_mul", "add", "sub"])
def test_binary_ops_match_jax(fields, op):
    df, jf, p = fields
    xs, ys, a, b, ja, jb = _pair(df, jf, p, 1)
    got = getattr(df, op)(a, b)
    jax_fn = {"mont_mul": jf._mont_mul_xla, "add": jf._add, "sub": jf._sub}[op]
    want = jax.jit(jax_fn)(ja, jb)
    assert np.array_equal(_np(got), _np(want))
    host = {
        "mont_mul": [x * y % p for x, y in zip(xs, ys)],
        "add": [(x + y) % p for x, y in zip(xs, ys)],
        "sub": [(x - y) % p for x, y in zip(xs, ys)],
    }[op]
    assert df.unpack(got) == host


def test_mont_conversions(fields):
    df, jf, p = fields
    xs = _values(p, 3)
    raw = df.pack(xs, mont=False, device="cpu")
    m = df.to_mont(raw)
    assert df.unpack(m) == xs
    assert df.unpack(df.from_mont(m), mont=False) == xs
    assert np.array_equal(_np(m), _np(jf.pack(xs)))


def test_broadcast_scalar_and_batch(fields):
    df, _, p = fields
    xs = _values(p, 5)
    a = df.pack(xs, device="cpu").reshape(16, 2, B // 2).permute(1, 0, 2)  # [2, 16, B/2]
    c = df.pack([12345], device="cpu")  # [16, 1]
    assert df.unpack(df.mont_mul(a, c)) == [v * 12345 % p for v in xs]


def test_inverse_zero_maps_to_zero(fields):
    df, _, p = fields
    xs = _values(p, 7)[:6] + [0]
    got = df.unpack(df.inv(df.pack(xs, device="cpu")))
    assert got == [pow(x, p - 2, p) for x in xs]


def test_batch_inv_matches_host(fields):
    df, _, p = fields
    xs = _values(p, 9)
    got = df.unpack(df.batch_inv(df.pack(xs, device="cpu")))
    assert got == [pow(x, p - 2, p) if x else 0 for x in xs]


def test_batch_inv_matches_jax_fr():
    """Against the SHA-256 of the JAX package's DeviceField.batch_inv of the
    same values (make_goldens.py; its XLA compile alone takes seconds)."""
    df = DeviceField(FR_BN254)
    with open(os.path.join(os.path.dirname(__file__), "data", "torch_goldens", "field_digests.json")) as f:
        want = json.load(f)["batch_inv_fr"]
    got = df.batch_inv(df.pack(_values(FR_BN254.p, 11), device="cpu"))
    assert hashlib.sha256(got.numpy().astype("<u4").tobytes()).hexdigest() == want


def test_batch_inv_batched_rows():
    """[2, 16, B] along the lane axis, row by row."""
    df = DeviceField(FR_BN254)
    p = FR_BN254.p
    xs, ys = _values(p, 13), _values(p, 14)
    a = torch.stack([df.pack(xs, device="cpu"), df.pack(ys, device="cpu")])
    got = df.batch_inv(a)
    assert df.unpack(got[0]) == [pow(x, p - 2, p) for x in xs]
    assert df.unpack(got[1]) == [pow(y, p - 2, p) for y in ys]


def test_mont_mul_matches_pallas_interpret():
    """The Pallas kernel itself (interpret mode), as tests/test_pallas_field.py
    runs it, on 512 lanes."""
    df = DeviceField(FR_BN254)
    from halo2_lib_tpu.utils.fields import FR_BN254 as JFR

    jf = JaxField(JFR)
    rng = np.random.default_rng(21)
    vals = [int(v) for v in rng.integers(0, 1 << 62, size=512)]
    vals[:4] = [0, 1, FR_BN254.p - 1, (1 << 256) % FR_BN254.p]
    a = df.pack(vals, device="cpu")
    b = df.pack(vals[::-1], device="cpu")
    want = jpf.mont_mul(
        jf, jnp.asarray(a.numpy().astype(np.uint32)), jnp.asarray(b.numpy().astype(np.uint32)),
        interpret=True,
    )
    assert np.array_equal(_np(df.mont_mul(a, b)), _np(want))


@pytest.mark.parametrize("name", ["mont_mul", "field_add", "field_sub", "fermat_inv"])
def test_cpu_wrappers_use_the_plain_version(name):
    """On CPU tensors a wrapper runs the plain version and launches nothing."""
    cf.reset_launches()
    a = DeviceField(FR_BN254).pack([3, 5, 7], device="cpu")
    out = cf.fermat_inv(cf.FR, a) if name == "fermat_inv" else getattr(cf, name)(cf.FR, a, a)
    plain = getattr(cf, f"{name}_plain")
    want = plain(cf.FR, a) if name == "fermat_inv" else plain(cf.FR, a, a)
    assert torch.equal(out, want)
    assert cf.LAUNCHES[name] == 0


def test_wrappers_reject_bad_operands():
    a = torch.zeros((3, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        cf.mont_mul(cf.FR, a, a)
    b = torch.zeros((16, 5), dtype=torch.int32)
    with pytest.raises(ValueError):
        cf.field_add(cf.FR, b, torch.zeros((16, 3), dtype=torch.int32))
