"""Port NTT (halo2_lib_tpu_torch/ops/ntt.py) vs the JAX package's NTT.

The inputs of every size are made from a numpy seed exactly as
tests/data/torch_goldens/make_goldens.py made them for the JAX NTT
(ops/ntt.py:99) and CosetNTT (:297) on the CPU; the port's outputs must hash
to the same SHA-256 (limbs as little-endian uint32, tolerance 0). One size
also runs live against the JAX NTT, and one against an exact host DFT.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from halo2_lib_tpu.ops.limbs import DeviceField as JaxField
from halo2_lib_tpu.ops.ntt import NTT as JaxNTT
from halo2_lib_tpu_torch.ops.limbs import DeviceField
from halo2_lib_tpu_torch.ops.ntt import NTT, CosetNTT, new_ntt, pows_host
from halo2_lib_tpu_torch.utils.fields import FR_BN254

# One core per test process: the suite runs in parallel workers, and a
# thread pool per worker would oversubscribe the host.
torch.set_num_threads(1)

GOLDENS = os.path.join(os.path.dirname(__file__), "data", "torch_goldens", "ntt_digests.json")
P = FR_BN254.p


def ntt_inputs(log_n: int, cols: int = 2) -> list[list[int]]:
    """The golden script's inputs (make_goldens.ntt_inputs)."""
    rng = np.random.default_rng(1000 + log_n)
    words = rng.integers(0, 1 << 63, size=(cols, 1 << log_n, 4), dtype=np.int64)
    return [[sum(int(w) << (63 * i) for i, w in enumerate(el)) % P for el in col] for col in words]


@pytest.fixture(scope="module")
def df():
    return DeviceField(FR_BN254)


@pytest.fixture(scope="module")
def digests():
    with open(GOLDENS) as f:
        return json.load(f)


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.numpy().astype("<u4").tobytes()).hexdigest()


@pytest.mark.parametrize("log_n", range(1, 11))
def test_ntt_matches_jax_goldens(df, digests, log_n):
    x = torch.stack([df.pack(c) for c in ntt_inputs(log_n)])  # [2, 16, n]
    ntt, coset = NTT(df, log_n, "cpu"), CosetNTT(df, log_n, 7, "cpu")
    want = digests[str(log_n)]
    assert _digest(ntt.forward(x)) == want["forward"]
    assert _digest(ntt.inverse(x)) == want["inverse"]
    assert _digest(coset.forward(x)) == want["coset_forward"]
    assert _digest(coset.inverse(x)) == want["coset_inverse"]


def test_ntt_matches_jax_live(df):
    from halo2_lib_tpu.utils.fields import FR_BN254 as JFR

    log_n = 4
    x = torch.stack([df.pack(c) for c in ntt_inputs(log_n, 3)])
    jntt = JaxNTT(JaxField(JFR), log_n)
    jx = jnp.asarray(x.numpy().astype(np.uint32))
    ntt = NTT(df, log_n, "cpu")
    assert np.array_equal(ntt.forward(x).numpy(), np.asarray(jntt.forward(jx)).astype(np.int32))
    assert np.array_equal(ntt.inverse(x).numpy(), np.asarray(jntt.inverse(jx)).astype(np.int32))


def test_ntt_matches_host_dft(df):
    log_n = 3
    n = 1 << log_n
    (coeffs,) = ntt_inputs(log_n, 1)
    w = FR_BN254.nth_root_of_unity(log_n)
    want = [sum(c * pow(w, i * j, P) for j, c in enumerate(coeffs)) % P for i in range(n)]
    got = df.unpack(new_ntt(df, log_n, "cpu").forward(df.pack(coeffs)))
    assert got == want


def test_forward_cols_chunks_and_round_trip(df):
    log_n = 5
    cols = ntt_inputs(log_n, 3)
    x = torch.stack([df.pack(c) for c in cols])
    ntt = NTT(df, log_n, "cpu")
    ntt.CHUNK = 2  # exercise the column chunking
    y = ntt.forward_cols(x)
    assert torch.equal(y, ntt.forward(x))
    assert torch.equal(ntt.inverse_cols(y), x)


def test_plan_matches_jax():
    from halo2_lib_tpu.ops.ntt4 import _plan as jax_plan

    from halo2_lib_tpu_torch.ops.ntt import _plan

    for log_n in range(12, 23):
        assert _plan(1 << log_n) == jax_plan(1 << log_n)


def test_colntt_matches_jax_kernel(df):
    """The four-step column kernel's plain version against the JAX package's
    _colntt_kernel in pallas interpret mode, on the same limbs, with the mid
    twiddle (the kernel without it is held against the JAX NTT below)."""
    from halo2_lib_tpu.ops.ntt4 import _colntt_call

    from halo2_lib_tpu_torch.ops import cuda_field as cf

    L, A, B = 1, 4, 8  # one lane block of width B
    rng = np.random.default_rng(7)
    w_a = FR_BN254.nth_root_of_unity(2)
    tw_rows = pows_host(df, w_a, A // 2)  # numpy [16, A/2]
    x = rng.integers(0, 1 << 16, size=(L, A, 16, B), dtype=np.uint32)
    x[:, :, 15] %= P >> 240
    mid = rng.integers(0, 1 << 16, size=(A, 16, B), dtype=np.uint32)
    mid[:, 15] %= P >> 240
    jtw = np.ascontiguousarray(np.broadcast_to(tw_rows.T[:, :, None], (A // 2, 16, B)))
    want = _colntt_call(P, L, A, B, B, True, True)(*map(jnp.asarray, (x, jtw, mid)))
    got = cf.colntt(cf.FR, *(torch.from_numpy(v.astype(np.int32)) for v in (x, tw_rows, mid)))
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int32))


def test_four_step_matches_jax_live(df):
    """FourStepNTT (what new_ntt picks from 2^12 up) against the JAX NTT on
    the CPU, forward and inverse (the inverse's 1/n folded into a mid)."""
    from halo2_lib_tpu.utils.fields import FR_BN254 as JFR

    from halo2_lib_tpu_torch.ops.ntt import FourStepNTT

    log_n = 12
    ntt = new_ntt(df, log_n, "cpu")
    assert isinstance(ntt, FourStepNTT) and ntt.factors == [32, 128]
    x = torch.stack([df.pack(c) for c in ntt_inputs(log_n, 2)])
    jntt = JaxNTT(JaxField(JFR), log_n)
    jx = jnp.asarray(x.numpy().astype(np.uint32))
    assert np.array_equal(ntt.forward(x).numpy(), np.asarray(jntt.forward(jx)).astype(np.int32))
    assert np.array_equal(ntt.inverse(x).numpy(), np.asarray(jntt.inverse(jx)).astype(np.int32))
    assert torch.equal(ntt.inverse(ntt.forward(x)), x)
