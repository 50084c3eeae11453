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
from halo2_lib_tpu_torch.ops.limbs import DeviceField, ints_to_limbs_T, limbs_to_ints
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
    x = torch.stack([df.pack(c, device="cpu") for c in ntt_inputs(log_n)])  # [2, 16, n]
    ntt, coset = NTT(df, log_n, "cpu"), CosetNTT(df, log_n, 7, "cpu")
    want = digests[str(log_n)]
    assert _digest(ntt.forward(x)) == want["forward"]
    assert _digest(ntt.inverse(x)) == want["inverse"]
    assert _digest(coset.forward(x)) == want["coset_forward"]
    assert _digest(coset.inverse(x)) == want["coset_inverse"]


def test_ntt_matches_jax_live(df):
    from halo2_lib_tpu.utils.fields import FR_BN254 as JFR

    log_n = 4
    x = torch.stack([df.pack(c, device="cpu") for c in ntt_inputs(log_n, 3)])
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
    got = df.unpack(new_ntt(df, log_n, "cpu").forward(df.pack(coeffs, device="cpu")))
    assert got == want


def test_forward_cols_chunks_and_round_trip(df):
    log_n = 5
    cols = ntt_inputs(log_n, 3)
    x = torch.stack([df.pack(c, device="cpu") for c in cols])
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
    x = torch.stack([df.pack(c, device="cpu") for c in ntt_inputs(log_n, 2)])
    jntt = JaxNTT(JaxField(JFR), log_n)
    jx = jnp.asarray(x.numpy().astype(np.uint32))
    assert np.array_equal(ntt.forward(x).numpy(), np.asarray(jntt.forward(jx)).astype(np.int32))
    assert np.array_equal(ntt.inverse(x).numpy(), np.asarray(jntt.inverse(jx)).astype(np.int32))
    assert torch.equal(ntt.inverse(ntt.forward(x)), x)


# --- a model of the card's ntt_small schedule (csrc/ntt_kernels.cu) ------------
# The kernel cannot run here. The model below runs its schedule on the CPU,
# block by block, pass by pass and thread by thread, on the stored
# (Montgomery) values as ints: the rows each thread loads, the twiddle index
# of each product, the tile words it writes for the next pass and the output
# words of the last. Element (column g, row r) of a tile is word g * n + r
# of each of the kernel's 8 word planes; the model keeps one value per word
# position.
NTS_EPT, NTS_MIN_TILE, NTS_KMAX = 4, 256, 2
R_MOD = (1 << 256) % P
R_INV = pow(1 << 256, -1, P)
SHIFT = 7  # the coset shift make_goldens.py froze the JAX CosetNTT with


def _mont(a: int, b: int) -> int:
    return a * b * R_INV % P


def model_ntt_small(x, tw, pre=None, post=None):
    """ntt_small on columns x (C lists of n ints) with twiddles tw (n/2
    ints), optional pre (n ints) and post (n or 1 ints), as the kernel
    schedules it. Asserts, per pass, that the threads read every tile word
    once and write every tile word once (no two threads write one word), and
    that every output word is written once. Returns the output columns."""
    C, n = len(x), len(x[0])
    m = n.bit_length() - 1
    T = max(n, NTS_MIN_TILE)
    G, NT = T // n, T // NTS_EPT
    tw0_one = tw[0] == R_MOD
    out = [[None] * n for _ in range(C)]
    for c0 in range(0, C, G):
        cols = min(G, C - c0)
        tile = None  # the words the previous pass wrote
        st = 0
        while st < m:
            K = min(m - st, NTS_KMAX)
            E = 1 << K
            first, last = st == 0, st + K == m
            read, written = set(), {}
            for tid in range(NT):
                for g in range(NTS_EPT // E):
                    it = g * NT + tid
                    col, o = it >> (m - K), it & ((1 << (m - K)) - 1)
                    cl = min(col, cols - 1)  # past the last column: read the last
                    idx = [(e << (m - K)) | o for e in range(E)]
                    if first:
                        v = [x[c0 + cl][r] for r in idx]
                        if pre is not None:
                            v = [_mont(a, pre[r]) for a, r in zip(v, idx)]
                    else:
                        words = [col * n + r for r in idx]
                        assert read.isdisjoint(words)
                        read.update(words)
                        v = [tile[w] for w in words]
                    for k in range(K):
                        bit, s = K - 1 - k, 1 << (st + k)
                        for a in range(E):
                            if a & (1 << bit):
                                continue
                            b = a | (1 << bit)
                            i = idx[a]
                            ps, j = i & ~(s - 1), i & (s - 1)
                            # a top element and its partner n/2 further on
                            assert i < n // 2 and idx[b] == i + n // 2
                            d = (v[a] - v[b]) % P
                            v[a] = (v[a] + v[b]) % P
                            v[b] = d if tw0_one and ps == 0 else _mont(d, tw[ps])
                            idx[a], idx[b] = 2 * ps + j, 2 * ps + s + j
                    for e in range(E):
                        if last:
                            if col < cols:
                                r = v[e] if post is None else _mont(
                                    v[e], post[0 if len(post) == 1 else idx[e]])
                                assert out[c0 + col][idx[e]] is None
                                out[c0 + col][idx[e]] = r
                        else:
                            w = col * n + idx[e]
                            assert w not in written, "two threads write one word in a pass"
                            written[w] = v[e]
            if not first:
                assert read == set(range(T))
            if not last:
                assert set(written) == set(range(T))
                tile = written
            st += K
    assert all(r is not None for column in out for r in column)
    return out


def _stored(t: torch.Tensor) -> list[list[int]]:
    """[C, 16, n] limbs -> the stored (Montgomery) ints of each column."""
    return [limbs_to_ints(c.T.numpy()) for c in t]


def _tensor(cols: list[list[int]]) -> torch.Tensor:
    return torch.stack([torch.from_numpy(ints_to_limbs_T(c).astype(np.int32)) for c in cols])


def _small_case(df, log_n: int, variant: str):
    """(x, tw, pre, post) of one NTT call as ops/ntt.py makes it: three
    columns (the golden script's two, then one holding 0, 1 and p - 1)."""
    cols = ntt_inputs(log_n, 3)
    cols[2][: 3] = [0, 1, P - 1][: len(cols[2])]
    x = torch.stack([df.pack(c, device="cpu") for c in cols])
    ntt, coset = NTT(df, log_n, "cpu"), CosetNTT(df, log_n, SHIFT, "cpu")
    forward = variant in ("forward", "coset_forward")
    pre = coset.shift_pows if variant == "coset_forward" else None
    post = {"inverse": ntt.n_inv_mont, "coset_inverse": coset.shift_inv_post}.get(variant)
    return x, ntt.tw[forward], pre, post


@pytest.fixture(scope="module")
def jax_2_11():
    """The JAX NTT and CosetNTT at 2^11 (beyond the frozen digests) on the
    first two columns of the model's inputs."""
    from halo2_lib_tpu.ops.ntt import CosetNTT as JaxCosetNTT
    from halo2_lib_tpu.utils.fields import FR_BN254 as JFR

    jdf = JaxField(JFR)
    x = torch.stack([DeviceField(FR_BN254).pack(c, device="cpu") for c in ntt_inputs(11)])
    jx = jnp.asarray(x.numpy().astype(np.uint32))
    jntt, jcoset = JaxNTT(jdf, 11), JaxCosetNTT(jdf, 11, SHIFT)
    fns = {"forward": jntt.forward, "inverse": jntt.inverse,
           "coset_forward": jcoset.forward, "coset_inverse": jcoset.inverse}
    return {k: hashlib.sha256(np.asarray(f(jx)).astype("<u4").tobytes()).hexdigest()
            for k, f in fns.items()}


@pytest.mark.parametrize("variant", ["forward", "inverse", "coset_forward", "coset_inverse"])
@pytest.mark.parametrize("log_n", range(1, 12))
def test_ntt_small_schedule_model(df, digests, jax_2_11, log_n, variant):
    """The kernel's schedule, modelled, equals ntt_small_plain (which the
    card's kernel is held to) on three columns, and the JAX package's NTT
    (frozen digests up to 2^10, live at 2^11) on the first two: forward and
    inverse, with the pre diagonal (coset forward) and the post diagonal as
    a scalar (1/n) and as a row (shift^-i / n)."""
    from halo2_lib_tpu_torch.ops import cuda_field as cf

    x, tw, pre, post = _small_case(df, log_n, variant)
    got = model_ntt_small(*(None if t is None else _stored(t[None])[0] if t.dim() == 2
                            else _stored(t) for t in (x, tw, pre, post)))
    want = cf.ntt_small_plain(cf.FR, x, tw, pre, post)
    assert got == _stored(want)
    jax_digest = jax_2_11[variant] if log_n == 11 else digests[str(log_n)][variant]
    assert _digest(_tensor(got[:2])) == jax_digest
