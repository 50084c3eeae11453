"""The port's digit-plane DFT NTT (halo2_lib_tpu_torch/ops/ntt_mxu.py) and its
stage (ops/cuda_field.py dft_stage_plain) against the JAX MXU NTT.

On the CPU the stage runs its plain version. The JAX MxuNTT compiles for
minutes on the CPU, so its outputs are frozen as SHA-256 digests
(tests/data/torch_goldens/mxu_digests.json, written by make_goldens.py
--mxu) on the inputs made here exactly as the golden script made them;
every comparison is bit for bit (limbs as little-endian uint32, tolerance
0). The transforms are also held to the JAX Stockham NTT's digests
(ntt_digests.json) at 2^6..2^10. A Python model of csrc/dft_kernels.cu's
schedule (shared-memory staging, the m16n8k32 fragments, the warps'
windows of columns, the epilogue's Montgomery fold) is held to the plain
version, since the CPU cannot run the kernel. The live JAX comparison is
marked slow.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from halo2_lib_tpu_torch.ops import cuda_field as cf
from halo2_lib_tpu_torch.ops import ntt as ntt_mod
from halo2_lib_tpu_torch.ops.limbs import DeviceField
from halo2_lib_tpu_torch.ops.ntt import new_ntt, pows_host
from halo2_lib_tpu_torch.ops.ntt_mxu import MxuNTT, dft_planes_np
from halo2_lib_tpu_torch.utils.fields import FR_BN254

# One core per test process: the suite runs in parallel workers, and a
# thread pool per worker would oversubscribe the host.
torch.set_num_threads(1)

GOLDENS = os.path.join(os.path.dirname(__file__), "data", "torch_goldens")
P = FR_BN254.p
R_MONT = 1 << 256


def ntt_inputs(log_n: int, cols: int = 2) -> list[list[int]]:
    """The golden script's inputs (make_goldens.ntt_inputs)."""
    rng = np.random.default_rng(1000 + log_n)
    words = rng.integers(0, 1 << 63, size=(cols, 1 << log_n, 4), dtype=np.int64)
    return [[sum(int(w) << (63 * i) for i, w in enumerate(el)) % P for el in col] for col in words]


def mxu_stage_case() -> torch.Tensor:
    """make_goldens.mxu_stage_case: [16, 64, 32] limbs, 0, 1, p - 1 and
    2^253 - 1 in the first four columns of every row."""
    rng = np.random.default_rng(64)
    words = rng.integers(0, 1 << 63, size=(64, 32, 4), dtype=np.int64)
    vals = [[sum(int(w) << (63 * i) for i, w in enumerate(el)) % P for el in row] for row in words]
    for row in vals:
        row[:4] = [0, 1, P - 1, (1 << 253) - 1]
    flat = [v for row in vals for v in row]
    limbs = [[(v >> (16 * j)) & 0xFFFF for v in flat] for j in range(16)]
    return torch.tensor(limbs, dtype=torch.int32).reshape(16, 64, 32)


def mxu_fold_case() -> torch.Tensor:
    """make_goldens.mxu_fold_case: [64, 32] column sums at the 2^29 bound."""
    rng = np.random.default_rng(29)
    cols = rng.integers(0, 1 << 29, size=(64, 32), dtype=np.int64)
    cols[:, :8] = (1 << 29) - 1
    cols[:, 28:] = 0
    cols[::2, 28:] = (1 << 29) - 1
    return torch.from_numpy(cols)


@pytest.fixture(scope="module")
def df():
    return DeviceField(FR_BN254)


@pytest.fixture(scope="module")
def mxu_digests():
    with open(os.path.join(GOLDENS, "mxu_digests.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def ntt_digests():
    with open(os.path.join(GOLDENS, "ntt_digests.json")) as f:
        return json.load(f)


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.numpy().astype("<u4").tobytes()).hexdigest()


def _four(df, log_n: int, x: torch.Tensor) -> dict:
    """forward, inverse and the shift-7 coset transforms through MxuNTT, as
    CosetNTT drives its transform (pre / post diagonals)."""
    mxu = MxuNTT(df, log_n, "cpu")
    shift_pows = pows_host(df, 7, mxu.n, "cpu")
    post = mxu.inverse_post(pow(7, P - 2, P))
    return {
        "forward": mxu.forward(x),
        "inverse": mxu.inverse(x),
        "coset_forward": mxu.forward(x, pre=shift_pows),
        "coset_inverse": mxu.inverse(x, post=post),
    }


@pytest.mark.parametrize("log_n", [6, 7, 9, 11])
def test_mxu_matches_jax_mxu_digests(df, mxu_digests, log_n):
    x = torch.stack([df.pack(c) for c in ntt_inputs(log_n)])
    got = {k: _digest(v) for k, v in _four(df, log_n, x).items()}
    assert got == mxu_digests[str(log_n)]


@pytest.mark.parametrize("log_n", range(6, 11))
def test_mxu_matches_stockham_digests(df, ntt_digests, log_n):
    x = torch.stack([df.pack(c) for c in ntt_inputs(log_n)])
    got = {k: _digest(v) for k, v in _four(df, log_n, x).items()}
    assert got == ntt_digests[str(log_n)]


def test_mxu_batched_and_forced_split(df, mxu_digests):
    """3 columns at 2^7, and the outer four-step level over two base
    transforms forced at 2^8 (k1 = 3, k2 = 5), as the JAX test builds it."""
    mxu = MxuNTT(df, 7, "cpu")
    x = torch.stack([df.pack(c) for c in ntt_inputs(7, 3)])
    assert _digest(mxu.forward(x)) == mxu_digests["batched_7"]["forward"]
    assert _digest(mxu.inverse(x)) == mxu_digests["batched_7"]["inverse"]
    ref = MxuNTT(df, 8, "cpu")
    forced = MxuNTT.__new__(MxuNTT)
    forced.__dict__.update(ref.__dict__)
    forced.k1, forced.k2 = 3, 5
    forced.sub = (MxuNTT(df, 3, "cpu"), MxuNTT(df, 5, "cpu"))
    forced._consts = {fwd: forced._build(fwd) for fwd in (True, False)}
    x = torch.stack([df.pack(c) for c in ntt_inputs(8)])
    assert _digest(forced.forward(x)) == mxu_digests["split_8"]["forward"]
    assert _digest(forced.inverse(x)) == mxu_digests["split_8"]["inverse"]
    assert torch.equal(forced.forward(x), ref.forward(x))


def test_stage_and_fold_match_jax(mxu_digests):
    """_stage_limbs alone on canonical values with 0, 1, p - 1 and 2^253 - 1
    (the 64-point planes of MxuNTT(11)'s first stage), and _fold_mod_p alone
    on column sums at 2^29 - 1."""
    w = FR_BN254.nth_root_of_unity(11)
    planes = torch.from_numpy(dft_planes_np(P, pow(w, 32, P), 64))
    out = cf.dft_stage_plain(cf.FR, mxu_stage_case()[None], planes)[0]
    assert _digest(out) == mxu_digests["stage"]
    folded = cf.dft_fold_plain(cf.FR, mxu_fold_case())
    assert _digest(folded.to(torch.int32)) == mxu_digests["fold"]


def test_worst_case_column_sums_fit_s32():
    """The kernel's exactness argument in int64: every digit 255 at R = 256
    (planes and input), the plain version's column sums t = i + j stay
    below 2^29 < 2^31, the value sum_t 2^(8t) col_t below 2^526 (the
    epilogue's 17 words, with the top word under the Montgomery product's
    p), and the fold gives that value mod p."""
    R = 256
    d = torch.full((R, cf.DFT_DIGITS), 255, dtype=torch.float64)
    W = torch.full((cf.DFT_DIGITS, R), 255, dtype=torch.float64)
    pair = torch.mm(W, d).to(torch.int64)  # [i, j]: sum over r of 255 * 255
    cols = torch.zeros(cf.DFT_COLS, dtype=torch.int64)
    for i in range(cf.DFT_DIGITS):
        cols[i : i + cf.DFT_DIGITS] += pair[i]
    assert int(cols.max()) == 32 * R * 255 * 255 < (1 << 29) < (1 << 31)
    V = sum(int(c) << (8 * t) for t, c in enumerate(cols.tolist()))
    assert V < (1 << 526) and V >> 512 < P
    folded = cf.dft_fold_plain(cf.FR, cols[:, None])[:, 0].tolist()
    assert sum(v << (16 * j) for j, v in enumerate(folded)) == V % P


def test_new_ntt_dispatch(df, monkeypatch):
    """The JAX package's rule on a CUDA device: MxuNTT for 2^6..2^11 unless
    HALO2_NO_MXU_NTT=1, four-step from 2^12, radix-2 below 2^6; radix-2
    below 2^12 on the CPU. (The card's classes are recorded, not built.)"""
    import halo2_lib_tpu_torch.ops.ntt_mxu as mxu_mod

    made = []
    monkeypatch.setattr(mxu_mod, "MxuNTT", lambda d, k, dev: made.append((k, str(dev))) or "mxu")
    monkeypatch.setattr(ntt_mod, "NTT", lambda d, k, dev: "ntt")
    monkeypatch.setattr(ntt_mod, "FourStepNTT", lambda d, k, dev: "four")
    monkeypatch.delenv("HALO2_NO_MXU_NTT", raising=False)
    assert [new_ntt(df, k, "cuda") for k in (5, 6, 9, 11, 12)] == ["ntt", "mxu", "mxu", "mxu", "four"]
    assert [new_ntt(df, k, "cpu") for k in (5, 6, 11, 12)] == ["ntt", "ntt", "ntt", "four"]
    assert made == [(6, "cuda"), (9, "cuda"), (11, "cuda")]
    monkeypatch.setenv("HALO2_NO_MXU_NTT", "1")
    assert new_ntt(df, 9, "cuda:0") == "ntt"


# --- a model of csrc/dft_kernels.cu, thread by thread --------------------------------

T0 = [0, 15, 22, 27, 32, 36, 41, 48]
T1 = [14, 21, 26, 31, 35, 40, 47, 62]
TM, TN, D = 16, 8, 32
LANE = np.arange(32)
G, TG = LANE >> 2, LANE & 3


def _bytes(regs: np.ndarray) -> np.ndarray:
    """uint64 registers [..., q] -> their bytes [..., q, 4], low byte first."""
    return (regs[..., None] >> (8 * np.arange(4, dtype=np.uint64))) & 0xFF


def _mma(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """mma.m16n8k32.row.col.s32.u8.u8 from the lanes' registers a [32, 4],
    b [32, 2] (the PTX fragment layouts), as the lanes' d [32, 4]."""
    A = np.zeros((16, 32), dtype=np.int64)
    ab = _bytes(a).astype(np.int64)
    for q in range(4):
        for bt in range(4):
            A[G + 8 * (q & 1), 4 * TG + bt + 16 * (q >> 1)] = ab[:, q, bt]
    B = np.zeros((32, 8), dtype=np.int64)
    bb = _bytes(b).astype(np.int64)
    for q in range(2):
        for bt in range(4):
            B[4 * TG + bt + 16 * q, G] = bb[:, q, bt]
    Dm = A @ B
    return np.stack([Dm[G + 8 * (q >> 1), 2 * TG + (q & 1)] for q in range(4)], axis=1)


def _words(limbs) -> list[int]:
    return [int(limbs[2 * k]) | (int(limbs[2 * k + 1]) << 16) for k in range(8)]


def _val(limbs) -> int:
    return sum(int(v) << (16 * j) for j, v in enumerate(limbs))


def _mont(a: int, b: int) -> int:
    return a * b * pow(R_MONT, -1, P) % P


def kernel_model(x, planes, pre=None, post=None) -> torch.Tensor:
    """dft_stage as csrc/dft_kernels.cu computes it, block by block and warp
    by warp: the staging loops (the weight words, the digit bytes), each lane's
    fragment addresses, the mma's fragment layouts, the column sums through
    shared memory, and the epilogue (17 words, the 4p / 2p / p ladders, the
    Montgomery products by R^2 and R^3). Field products by Python ints."""
    L, _, R, C = x.shape
    Ro = planes.shape[1]
    KW = -(-R // 32) * 8
    S = KW + 4
    N = L * C
    xn, pn = x.numpy(), planes.numpy()
    out = np.zeros((L, 16, Ro, C), dtype=np.int64)
    r2, r3 = R_MONT * R_MONT % P, R_MONT ** 3 % P
    for by in range(-(-Ro // TM)):
        m0 = by * TM
        for bx in range(-(-N // TN)):
            n0 = bx * TN
            Ws = np.zeros(D * TM * S, dtype=np.uint64)
            for it in range(D * TM * KW):
                kw, m, i = it % KW, (it // KW) % TM, it // (KW * TM)
                v = 0
                if m0 + m < Ro and 4 * kw < R:
                    for q in range(4):
                        if 4 * kw + q < R:
                            v |= int(pn[i, m0 + m, 4 * kw + q]) << (8 * q)
                Ws[(i * TM + m) * S + kw] = v
            xs8 = np.zeros(4 * D * TN * S, dtype=np.uint64)  # Xs byte by byte
            for it in range(TN * 4 * KW):
                n, r = it % TN, it // TN
                nn = n0 + n
                v = 0
                if nn < N and r < R:
                    l, c = divmod(nn, C)
                    v = _val(xn[l, :, r, c])
                    if pre is not None:
                        v = _mont(v, _val(pre.numpy()[:, r, c]))
                col = 4 * (n * S + (r >> 2)) + (r & 3)
                for j in range(D):
                    xs8[col + 4 * j * TN * S] = (v >> (8 * j)) & 0xFF
            Xs = (xs8.reshape(-1, 4) << (8 * np.arange(4, dtype=np.uint64))).sum(axis=1)
            cs = np.zeros((64, TM * TN), dtype=np.int64)
            seen = np.zeros((64,), dtype=np.int64)
            for warp in range(8):
                t0, t1 = T0[warp], T1[warp]
                acc = np.zeros((16, 32, 4), dtype=np.int64)
                for kk in range(0, KW, 8):
                    for i in range(max(0, t0 - 31), min(31, t1) + 1):
                        wa = (i * TM + G) * S + kk + TG
                        a = np.stack([Ws[wa], Ws[wa + 8 * S], Ws[wa + 4], Ws[wa + 8 * S + 4]], 1)
                        for dt in range(16):
                            j = t0 + dt - i
                            if t0 + dt <= t1 and 0 <= j < D:
                                xb = (j * TN + G) * S + kk + TG
                                acc[dt] += _mma(a, np.stack([Xs[xb], Xs[xb + 4]], 1))
                                seen[t0 + dt] += 1
                for dt in range(t1 - t0 + 1):
                    row = cs[t0 + dt]
                    row[G * TN + 2 * TG] = acc[dt][:, 0]
                    row[G * TN + 2 * TG + 1] = acc[dt][:, 1]
                    row[(G + 8) * TN + 2 * TG] = acc[dt][:, 2]
                    row[(G + 8) * TN + 2 * TG + 1] = acc[dt][:, 3]
            # every digit pair (i, j) summed once per contraction step
            assert seen.tolist() == [(min(t, 62 - t) + 1) * (KW // 8) for t in range(63)] + [0]
            assert int(cs.max()) < 1 << 31
            for e in range(TM * TN):
                m, n = divmod(e, TN)
                k, nn = m0 + m, n0 + n
                if k >= Ro or nn >= N:
                    continue
                vw, carry = [0] * 17, 0
                for t in range(68):
                    v = (int(cs[t, e]) if t < 63 else 0) + carry
                    assert v < 1 << 32
                    vw[t >> 2] |= (v & 0xFF) << (8 * (t & 3))
                    carry = v >> 8
                assert carry == 0
                a0 = sum(vw[j] << (32 * j) for j in range(8))
                a1 = sum(vw[8 + j] << (32 * j) for j in range(8))
                a2 = vw[16]

                def reduce_256(a):
                    for mp in (4 * P, 2 * P, P):
                        a = a - mp if a >= mp else a
                    return a

                res = (reduce_256(a0) + _mont(reduce_256(a1), r2)) % P
                res = (res + _mont(a2, r3)) % P
                l, c = divmod(nn, C)
                if post is not None:
                    pv = post.numpy()[:, 0] if post.dim() == 2 else post.numpy()[:, k, c]
                    res = _mont(res, _val(pv))
                out[l, :, k, c] = [(res >> (16 * j)) & 0xFFFF for j in range(16)]
    return torch.from_numpy(out).to(torch.int32)


def _rand_limbs(gen, shape) -> torch.Tensor:
    x = torch.randint(0, 1 << 16, shape, generator=gen, dtype=torch.int32)
    x[..., 15, :, :] %= P >> 240
    return x


@pytest.mark.parametrize("L, R, C, diag", [(1, 8, 8, "none"), (2, 16, 3, "pre"),
                                           (1, 64, 5, "post"), (3, 2, 1, "both"),
                                           (1, 32, 12, "scalar")])
def test_kernel_model_matches_plain(df, L, R, C, diag):
    """The model of the CUDA kernel against dft_stage_plain on DFT planes of
    the R-th root (R = 2: the forced split's sub-transform; R = 64: two
    contraction steps), ragged column counts, the diagonals' forms."""
    gen = torch.Generator().manual_seed(R * 10 + C)
    root = FR_BN254.nth_root_of_unity(R.bit_length() - 1)
    planes = torch.from_numpy(dft_planes_np(P, root, R))
    x = _rand_limbs(gen, (L, 16, R, C))
    x[0, :, 0, 0] = torch.tensor([((P - 1) >> (16 * j)) & 0xFFFF for j in range(16)])
    pre = _rand_limbs(gen, (16, R, C)) if diag in ("pre", "both") else None
    post = {"post": _rand_limbs(gen, (16, R, C)), "both": _rand_limbs(gen, (16, R, C)),
            "scalar": df.pack(7)}.get(diag)
    want = cf.dft_stage_plain(cf.FR, x, planes, pre, post)
    assert torch.equal(kernel_model(x, planes, pre, post), want)
    assert torch.equal(cf.dft_stage(cf.FR, x, planes, pre, post), want)


@pytest.mark.slow
def test_mxu_matches_jax_live(df):
    """The JAX MxuNTT itself (minutes of XLA compile on the CPU)."""
    import jax.numpy as jnp

    from halo2_lib_tpu.ops.limbs import DeviceField as JaxField
    from halo2_lib_tpu.ops.ntt_mxu import MxuNTT as JaxMxuNTT
    from halo2_lib_tpu.utils.fields import FR_BN254 as JFR

    log_n = 6
    x = torch.stack([df.pack(c) for c in ntt_inputs(log_n, 3)])
    jm = JaxMxuNTT(JaxField(JFR), log_n)
    jx = jnp.asarray(x.numpy().astype(np.uint32))
    mxu = MxuNTT(df, log_n, "cpu")
    assert np.array_equal(mxu.forward(x).numpy(), np.asarray(jm.forward(jx)).astype(np.int32))
    assert np.array_equal(mxu.inverse(x).numpy(), np.asarray(jm.inverse(jx)).astype(np.int32))
