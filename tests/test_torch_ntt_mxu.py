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
version, since the CPU cannot run the kernel; so is a model of dft_ntt, the
one-launch base transform (its swizzled panels, the digit staging and stage
2's re-digitized operand), and its plain version to the frozen digests. The live JAX comparison is
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
    x = torch.stack([df.pack(c, device="cpu") for c in ntt_inputs(log_n)])
    got = {k: _digest(v) for k, v in _four(df, log_n, x).items()}
    assert got == mxu_digests[str(log_n)]


@pytest.mark.parametrize("log_n", range(6, 11))
def test_mxu_matches_stockham_digests(df, ntt_digests, log_n):
    x = torch.stack([df.pack(c, device="cpu") for c in ntt_inputs(log_n)])
    got = {k: _digest(v) for k, v in _four(df, log_n, x).items()}
    assert got == ntt_digests[str(log_n)]


def test_mxu_batched_and_forced_split(df, mxu_digests):
    """3 columns at 2^7, and the outer four-step level over two base
    transforms forced at 2^8 (k1 = 3, k2 = 5), as the JAX test builds it."""
    mxu = MxuNTT(df, 7, "cpu")
    x = torch.stack([df.pack(c, device="cpu") for c in ntt_inputs(7, 3)])
    assert _digest(mxu.forward(x)) == mxu_digests["batched_7"]["forward"]
    assert _digest(mxu.inverse(x)) == mxu_digests["batched_7"]["inverse"]
    ref = MxuNTT(df, 8, "cpu")
    forced = MxuNTT.__new__(MxuNTT)
    forced.__dict__.update(ref.__dict__)
    forced.k1, forced.k2 = 3, 5
    forced.sub = (MxuNTT(df, 3, "cpu"), MxuNTT(df, 5, "cpu"))
    forced._consts = {fwd: forced._build(fwd) for fwd in (True, False)}
    x = torch.stack([df.pack(c, device="cpu") for c in ntt_inputs(8)])
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
    shared memory, and the epilogue (the fold of _fold_model, the post
    product). Field products by Python ints."""
    L, _, R, C = x.shape
    Ro = planes.shape[1]
    KW = -(-R // 32) * 8
    S = KW + 4
    N = L * C
    xn, pn = x.numpy(), planes.numpy()
    out = np.zeros((L, 16, Ro, C), dtype=np.int64)
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
                res = _fold_model(cs[:, e])
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
            "scalar": df.pack(7, device="cpu")}.get(diag)
    want = cf.dft_stage_plain(cf.FR, x, planes, pre, post)
    assert torch.equal(kernel_model(x, planes, pre, post), want)
    assert torch.equal(cf.dft_stage(cf.FR, x, planes, pre, post), want)


# --- dft_ntt: the whole base transform in one launch ---------------------------------


def _ntt_consts(df, log_n: int):
    """MxuNTT(log_n)'s tables (forward, inverse), the shift-7 coset rows and
    1/n: dft_ntt's operands as MxuNTT passes them."""
    mxu = MxuNTT(df, log_n, "cpu")
    return mxu, mxu._consts[True], mxu._consts[False]


def _ntt_forms(df, log_n: int, x: torch.Tensor) -> dict:
    """dft_ntt_plain in the four forms the prover uses, by name."""
    mxu, fwd, inv = _ntt_consts(df, log_n)
    pre = pows_host(df, 7, mxu.n, "cpu")
    post = mxu.inverse_post(pow(7, P - 2, P))
    tw, w1, w2 = fwd
    itw, iw1, iw2 = inv
    return {
        "forward": cf.dft_ntt_plain(cf.FR, x, w1, w2, tw),
        "inverse": cf.dft_ntt_plain(cf.FR, x, iw1, iw2, itw, None, mxu.n_inv_mont),
        "coset_forward": cf.dft_ntt_plain(cf.FR, x, w1, w2, tw, pre),
        "coset_inverse": cf.dft_ntt_plain(cf.FR, x, iw1, iw2, itw, None, post),
    }


@pytest.mark.parametrize("log_n", range(6, 12))
def test_dft_ntt_plain_matches_the_frozen_digests(df, mxu_digests, ntt_digests, log_n):
    """dft_ntt_plain itself (forward, forward with pre, inverse with 1/n,
    inverse with post) against the JAX MXU NTT's digests (2^6, 2^7, 2^9,
    2^11) and the JAX Stockham NTT's (2^6..2^10)."""
    x = torch.stack([df.pack(c, device="cpu") for c in ntt_inputs(log_n)])
    got = {k: _digest(v) for k, v in _ntt_forms(df, log_n, x).items()}
    held = [d[str(log_n)] for d in (mxu_digests, ntt_digests) if str(log_n) in d]
    assert held and all(got == want for want in held)


def test_dft_ntt_stops_at_2048_points(df, monkeypatch):
    """Stage 2's contraction in dft_ntt is one 32-byte chunk (N2 <= 32): the
    wrapper refuses MxuNTT(2^12)'s 64 x 64 planes before any dispatch, and
    MxuNTT at 2^12 takes the two dft_stage calls instead, with the
    four-step NTT's values."""
    mxu = MxuNTT(df, 12, "cpu")
    tw, w1, w2 = mxu._consts[True]
    x = torch.stack([df.pack(c, device="cpu") for c in ntt_inputs(12, cols=1)])
    with pytest.raises(ValueError, match="n <= 2048"):
        cf.dft_ntt(cf.FR, x, w1, w2, tw)

    def no_dft_ntt(*args, **kwargs):
        raise AssertionError("MxuNTT(2^12) called dft_ntt")

    monkeypatch.setattr(cf, "dft_ntt", no_dft_ntt)
    assert torch.equal(mxu.forward(x), ntt_mod.FourStepNTT(df, 12, "cpu").forward(x))


def _fold_model(col) -> int:
    """dft_fold as the kernel runs it on one element's 63 column sums: the
    carries into 17 words, the 4p / 2p / p ladders, the Montgomery products
    by R^2 and R^3."""
    vw, carry = [0] * 17, 0
    for t in range(68):
        v = (int(col[t]) if t < 63 else 0) + carry
        assert v < 1 << 32
        vw[t >> 2] |= (v & 0xFF) << (8 * (t & 3))
        carry = v >> 8
    assert carry == 0

    def reduce_256(a):
        for mp in (4 * P, 2 * P, P):
            a = a - mp if a >= mp else a
        return a

    a0 = sum(vw[j] << (32 * j) for j in range(8))
    a1 = sum(vw[8 + j] << (32 * j) for j in range(8))
    res = (reduce_256(a0) + _mont(reduce_256(a1), R_MONT * R_MONT % P)) % P
    return (res + _mont(vw[16], R_MONT ** 3 % P)) % P


def _word(b) -> int:
    return int(b[0]) | int(b[1]) << 8 | int(b[2]) << 16 | int(b[3]) << 24


def ntt_kernel_model(x, w1, w2, tw, pre=None, post=None) -> torch.Tensor:
    """dft_ntt as csrc/dft_kernels.cu computes it, block by block (KT = 8
    rows k1 each) and lane by lane: the swizzled panels (w ^ (row & 4)), the weight words, the digit
    staging shared by a column's cluster (each block's own rows, written to
    the column's panel in device memory, which every block copies back),
    each lane's fragment words in
    both stages, the column sums of up to two tiles, the fold, the twiddle
    and stage 2's re-digitized B (BB's bytes), the post product and the
    natural-order store."""
    L, _, n = x.shape
    N1, N2 = w1.shape[1], w2.shape[1]
    NQ1, M = -(-N1 // 32), max(16, N2)
    MT = M // 16
    xn, w1n, w2n, twn = x.numpy(), w1.numpy(), w2.numpy(), tw.numpy()
    out = np.zeros((L, 16, n), dtype=np.int64)
    o0 = TG ^ (G & 4)
    o2 = o0 ^ 4
    KT = 8
    S = N1 // KT  # the blocks of a column: one cluster
    for l in range(L):
        # each block of the cluster stages its own rows r = k0 .. k0 + KT - 1
        # into its XA (one element a thread, digit bytes), then copies the
        # other blocks' rows out of theirs (words of 8 or 16 bytes)
        # the digit panels start as garbage: only the weight panels'
        # padding is zeroed, and it must keep the digits' padding out
        junk = np.random.default_rng(l)
        xa8 = [junk.integers(0, 256, 4 * 32 * NQ1 * M * 8).astype(np.uint64) for _ in range(S)]
        staged = []
        for rank in range(S):
            k0 = rank * KT
            for it in range(KT * N2):
                r, c = k0 + it % KT, it // KT
                idx = r * N2 + c
                staged.append(idx)
                v = _val(xn[l, :, idx])
                if pre is not None:
                    v = _mont(v, _val(pre.numpy()[:, idx]))
                at = 4 * (((r // 32) * M + c) * 8 + (((r % 32) // 4) ^ (c & 4))) + (r & 3)
                for j in range(D):
                    xa8[rank][at + 4 * j * NQ1 * M * 8] = (v >> (8 * j)) & 0xFF
        assert sorted(staged) == list(range(n))  # every element once
        own = [(b.reshape(-1, 4) << (8 * np.arange(4, dtype=np.uint64))).sum(axis=1) for b in xa8]
        # each block writes its rows' words into the column's panel in device
        # memory (garbage elsewhere), and copies the whole panel back
        xs = junk.integers(0, 1 << 32, 32 * NQ1 * M * 8).astype(np.uint64)
        for rank in range(S):
            k0 = rank * KT
            for it in range(D * N2):
                c, j = it % N2, it // N2
                off = ((j * NQ1 + k0 // 32) * M + c) * 8 + (((k0 % 32) // 4) ^ (c & 4))
                xs[off : off + KT // 4] = own[rank][off : off + KT // 4]
        for rank in range(S):
            k0 = rank * KT
            XA = xs.copy()
            WB1 = np.zeros(32 * NQ1 * KT * 8, dtype=np.uint64)
            WA2 = np.zeros(32 * M * 8, dtype=np.uint64)
            BB8 = junk.integers(0, 256, 4 * 32 * KT * 8).astype(np.uint64)
            KW1, KW2 = N1 // 4, N2 // 4
            for it in range(32 * KT * KW1):
                kw, m, i = it % KW1, (it // KW1) % KT, it // (KW1 * KT)
                WB1[((i * NQ1 + kw // 8) * KT + m) * 8 + ((kw % 8) ^ (m & 4))] = _word(
                    w1n[i, k0 + m, 4 * kw : 4 * kw + 4])
            for it in range(32 * N2 * KW2):
                kw, m, i = it % KW2, (it // KW2) % N2, it // (KW2 * N2)
                WA2[(i * M + m) * 8 + (kw ^ (m & 4))] = _word(w2n[i, m, 4 * kw : 4 * kw + 4])
            for stage in range(2):
                A, NQ = (XA, NQ1) if stage == 0 else (WA2, 1)
                if stage == 0:
                    B = WB1
                else:
                    B = (BB8.reshape(-1, 4) << (8 * np.arange(4, dtype=np.uint64))).sum(axis=1)
                a_chunk, b_chunk = M * 8, KT * 8
                a_plane, b_plane = NQ * a_chunk, NQ * b_chunk
                tiles = MT * (KT // 8)
                for r0 in range(0, tiles, 2):
                    in_round = min(2, tiles - r0)
                    cs = np.zeros((64, 256), dtype=np.int64)
                    for u in range(in_round):
                        mt, nt = (r0 + u) % MT, (r0 + u) // MT
                        pa, pb = (mt * 16 + G) * 8, (nt * 8 + G) * 8
                        for warp in range(8):
                            t0, t1 = T0[warp], T1[warp]
                            acc = np.zeros((16, 32, 4), dtype=np.int64)
                            for q in range(NQ):
                                for i in range(max(0, t0 - 31), min(31, t1) + 1):
                                    a = pa + i * a_plane + q * a_chunk
                                    afr = np.stack([A[a + o0], A[a + 64 + o0], A[a + o2],
                                                    A[a + 64 + o2]], 1)
                                    for dt in range(t1 - t0 + 1):
                                        j = t0 + dt - i
                                        if 0 <= j < D:
                                            b = pb + j * b_plane + q * b_chunk
                                            acc[dt] += _mma(afr, np.stack([B[b + o0], B[b + o2]], 1))
                            for dt in range(t1 - t0 + 1):
                                row = cs[t0 + dt, u * 128 :]
                                row[G * TN + 2 * TG] = acc[dt][:, 0]
                                row[G * TN + 2 * TG + 1] = acc[dt][:, 1]
                                row[(G + 8) * TN + 2 * TG] = acc[dt][:, 2]
                                row[(G + 8) * TN + 2 * TG + 1] = acc[dt][:, 3]
                    for e in range(in_round * 128):
                        u, m, nn = e >> 7, (e >> 3) & 15, e & 7
                        mt, nt = (r0 + u) % MT, (r0 + u) // MT
                        row, kl = mt * 16 + m, nt * 8 + nn
                        if row >= N2:
                            continue  # a padding row (its sums may be garbage)
                        assert int(cs[:, e].max()) < 1 << 31
                        idx = k0 + kl + N1 * row
                        v = _fold_model(cs[:, e])
                        if stage == 0:
                            v = _mont(v, _val(twn[:, k0 + kl, row]))
                            at = 4 * (kl * 8 + ((row >> 2) ^ (kl & 4))) + (row & 3)
                            for j in range(D):
                                BB8[at + 4 * j * KT * 8] = (v >> (8 * j)) & 0xFF
                        else:
                            if post is not None:
                                pv = post.numpy()[:, 0 if post.shape[1] == 1 else idx]
                                v = _mont(v, _val(pv))
                            out[l, :, idx] = [(v >> (16 * j)) & 0xFFFF for j in range(16)]
    return torch.from_numpy(out).to(torch.int32)


@pytest.mark.parametrize("log_n, form", [(6, "coset_forward"), (6, "inverse"), (7, "forward"),
                                         (7, "coset_inverse")])
def test_ntt_kernel_model_matches_plain(df, log_n, form):
    """The model of dft_ntt's kernel against dft_ntt_plain at 2^6 (N1 = N2 =
    8: M-side padding rows, one contraction chunk) and 2^7 (N1 = 16: a
    cluster of two blocks), 2 columns with p - 1 among the values, in the form named
    (pre row, 1/n scalar, post row)."""
    mxu, fwd, inv = _ntt_consts(df, log_n)
    x = torch.stack([df.pack(c, device="cpu") for c in ntt_inputs(log_n)])
    x[0, :, 0] = torch.tensor([((P - 1) >> (16 * j)) & 0xFFFF for j in range(16)])
    tw, w1, w2 = fwd if form.endswith("forward") else inv
    pre = pows_host(df, 7, mxu.n, "cpu") if form == "coset_forward" else None
    post = {"inverse": mxu.n_inv_mont, "coset_inverse": mxu.inverse_post(pow(7, P - 2, P))}.get(form)
    want = cf.dft_ntt_plain(cf.FR, x, w1, w2, tw, pre, post)
    assert torch.equal(ntt_kernel_model(x, w1, w2, tw, pre, post), want)
    assert torch.equal(cf.dft_ntt(cf.FR, x, w1, w2, tw, pre, post), want)


@pytest.mark.slow
def test_mxu_matches_jax_live(df):
    """The JAX MxuNTT itself (minutes of XLA compile on the CPU)."""
    import jax.numpy as jnp

    from halo2_lib_tpu.ops.limbs import DeviceField as JaxField
    from halo2_lib_tpu.ops.ntt_mxu import MxuNTT as JaxMxuNTT
    from halo2_lib_tpu.utils.fields import FR_BN254 as JFR

    log_n = 6
    x = torch.stack([df.pack(c, device="cpu") for c in ntt_inputs(log_n, 3)])
    jm = JaxMxuNTT(JaxField(JFR), log_n)
    jx = jnp.asarray(x.numpy().astype(np.uint32))
    mxu = MxuNTT(df, log_n, "cpu")
    assert np.array_equal(mxu.forward(x).numpy(), np.asarray(jm.forward(jx)).astype(np.int32))
    assert np.array_equal(mxu.inverse(x).numpy(), np.asarray(jm.inverse(jx)).astype(np.int32))
