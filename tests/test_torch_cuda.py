"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card with nvcc (marker `cuda`); without one they
skip. On the card: python -m pytest tests/test_torch_cuda.py -q. Every
comparison is exact (integer limbs, tolerance 0).
"""

import random

import pytest
import torch

from halo2_lib_tpu_torch.ops import cuda_field as cf
from halo2_lib_tpu_torch.ops.ec_device import DeviceCurve, msm_many_device, pack_scalars
from halo2_lib_tpu_torch.ops.limbs import DeviceField
from halo2_lib_tpu_torch.utils.curves import BN254_G1
from halo2_lib_tpu_torch.utils.fields import FQ_BN254, FR_BN254

# One core per test process: the suite runs in parallel workers, and a
# thread pool per worker would oversubscribe the host.
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cf.load()
    return torch.device("cuda")


def _rand(shape, p, gen, dev):
    x = torch.randint(0, 1 << 16, shape, generator=gen, dtype=torch.int32).to(dev)
    x[..., 15, :] %= p >> 240
    return x


@pytest.mark.parametrize("name", ["mont_mul", "field_add", "field_sub"])
@pytest.mark.parametrize("fid", [cf.FR, cf.FQ])
def test_field_kernels(dev, name, fid):
    p = FR_BN254.p if fid == cf.FR else FQ_BN254.p
    gen = torch.Generator().manual_seed(fid)
    a, b = _rand((3, 16, 1000), p, gen, dev), _rand((16, 1), p, gen, dev)
    got = getattr(cf, name)(fid, a, b)
    assert torch.equal(got, getattr(cf, f"{name}_plain")(fid, a, b))


def test_fermat_and_butterfly(dev):
    gen = torch.Generator().manual_seed(2)
    a = _rand((5, 16, 3), FR_BN254.p, gen, dev)
    assert torch.equal(cf.fermat_inv(cf.FR, a), cf.fermat_inv_plain(cf.FR, a))
    x, y, w = (_rand(s, FR_BN254.p, gen, dev) for s in ((3, 16, 777), (3, 16, 777), (16, 777)))
    for k, pl in zip(cf.ntt_butterfly(cf.FR, x, y, w), cf.ntt_butterfly_plain(cf.FR, x, y, w)):
        assert torch.equal(k, pl)


@pytest.mark.parametrize("A,with_mid", [(2, True), (8, False), (128, True), (4, True),
                                        (16, False), (64, True), (256, True), (1024, False)])
def test_colntt(dev, A, with_mid):
    gen = torch.Generator().manual_seed(A)
    x = _rand((3, A, 16, 77), FR_BN254.p, gen, dev)
    tw = _rand((16, A // 2), FR_BN254.p, gen, dev)
    mid = _rand((A, 16, 77), FR_BN254.p, gen, dev) if with_mid else None
    assert torch.equal(cf.colntt(cf.FR, x, tw, mid), cf.colntt_plain(cf.FR, x, tw, mid))


@pytest.mark.parametrize("A", [8, 128])
def test_colntt_unit_first_twiddle(dev, A):
    """tw[0] the Montgomery one, as the NTT's tables have it: the kernel
    skips the last stage's products by it and must still agree."""
    gen = torch.Generator().manual_seed(A + 1)
    x = _rand((2, A, 16, 45), FR_BN254.p, gen, dev)
    tw = _rand((16, A // 2), FR_BN254.p, gen, dev)
    one = (1 << 256) % FR_BN254.p
    tw[:, 0] = torch.tensor([(one >> (16 * i)) & 0xFFFF for i in range(16)], dtype=torch.int32)
    mid = _rand((A, 16, 45), FR_BN254.p, gen, dev)
    assert torch.equal(cf.colntt(cf.FR, x, tw, mid), cf.colntt_plain(cf.FR, x, tw, mid))


def test_four_step_ntt_on_the_card_matches_cpu(dev):
    from halo2_lib_tpu_torch.ops.ntt import FourStepNTT, new_ntt

    df = DeviceField(FR_BN254)
    gen = torch.Generator().manual_seed(9)
    x = _rand((2, 16, 1 << 13), FR_BN254.p, gen, "cpu")
    cpu, card = new_ntt(df, 13, "cpu"), new_ntt(df, 13, dev)
    assert isinstance(card, FourStepNTT)
    cf.reset_launches()
    y = card.forward(x.to(dev))
    assert torch.equal(y.cpu(), cpu.forward(x))
    assert torch.equal(card.inverse(y).cpu(), x)
    assert cf.LAUNCHES["colntt"] == 4 and cf.LAUNCHES["ntt_butterfly"] == 0


@pytest.mark.parametrize("log_n", range(1, 12))
def test_ntt_small(dev, log_n):
    """ntt_small against its plain version at ragged column counts: the
    NTT's tables with each diagonal its callers pass (none, 1/n, the coset's
    pre row, the inverse coset's post row), and random twiddles (no product
    skipped) with both diagonals."""
    from halo2_lib_tpu_torch.ops.ntt import NTT

    n = 1 << log_n
    gen = torch.Generator().manual_seed(300 + log_n)
    ntt = NTT(DeviceField(FR_BN254), log_n, dev)
    pre = _rand((16, n), FR_BN254.p, gen, dev)
    post = ntt.inverse_post(7)
    cases = (
        (ntt.tw[True], None, None),
        (ntt.tw[False], None, ntt.n_inv_mont),
        (ntt.tw[True], pre, None),
        (ntt.tw[False], None, post),
        (_rand((16, n // 2), FR_BN254.p, gen, dev), pre, post),
    )
    for C in (1, 3, 65):
        x = _rand((C, 16, n), FR_BN254.p, gen, dev)
        for tw, pr, po in cases:
            got = cf.ntt_small(cf.FR, x, tw, pr, po)
            assert torch.equal(got, cf.ntt_small_plain(cf.FR, x, tw, pr, po))


def test_small_ntt_on_the_card_matches_cpu(dev, monkeypatch):
    """The k=9 domains through NTT (2^9) and CosetNTT (2^11) on the card
    (HALO2_NO_MXU_NTT=1 keeps CosetNTT's transform radix-2): the CPU's
    values, one ntt_small launch per call, its scalings inside (no mont_mul
    launch) and no butterfly."""
    from halo2_lib_tpu_torch.ops.ntt import NTT, CosetNTT

    monkeypatch.setenv("HALO2_NO_MXU_NTT", "1")
    df = DeviceField(FR_BN254)
    gen = torch.Generator().manual_seed(11)
    for log_n, make in ((9, lambda d: NTT(df, 9, d)), (11, lambda d: CosetNTT(df, 11, 7, d))):
        cpu, card = make("cpu"), make(dev)
        x = _rand((12, 16, 1 << log_n), FR_BN254.p, gen, "cpu")
        cf.reset_launches()
        y = card.forward(x.to(dev))
        assert torch.equal(y.cpu(), cpu.forward(x))
        assert torch.equal(card.inverse(y).cpu(), x)
        assert cf.LAUNCHES["ntt_small"] == 2
        assert cf.LAUNCHES["ntt_butterfly"] == 0 and cf.LAUNCHES["mont_mul"] == 0


def _dft_planes(R: int, dev):
    from halo2_lib_tpu_torch.ops.ntt_mxu import dft_planes_np

    root = FR_BN254.nth_root_of_unity(R.bit_length() - 1)
    return torch.from_numpy(dft_planes_np(FR_BN254.p, root, R)).to(dev)


@pytest.mark.parametrize("R", [8, 16, 32, 64, 128, 256])
@pytest.mark.parametrize("C", [8, 16, 32, 64, 128, 256])
def test_dft_stage(dev, R, C):
    """dft_stage against its plain version: the R-point DFT's planes, 1, 3,
    12 and 105 columns of C lanes (fewer where the plain version's products
    would pass 2^26 entries), without diagonals, with the pre row and the
    twiddle-shaped post, with the 1/n scalar post, with a post row; p - 1
    among the values."""
    gen = torch.Generator().manual_seed(R * 1000 + C)
    planes = _dft_planes(R, dev)
    pm1 = torch.tensor([((FR_BN254.p - 1) >> (16 * j)) & 0xFFFF for j in range(16)],
                       dtype=torch.int32, device=dev)
    def block(lead):  # canonical [*lead, 16, R, C] (_rand takes the limb axis at -2)
        return _rand((*lead, 16, R * C), FR_BN254.p, gen, dev).reshape(*lead, 16, R, C)

    diags = (
        (None, None),
        (block(()), block(())),
        (None, DeviceField(FR_BN254).pack(pow(R, -1, FR_BN254.p), device=dev)),
        (None, block(())),
    )
    for L, (pre, post) in zip((1, 3, 12, 105), diags):
        if L > 1 and 1024 * R * L * C > 1 << 26:
            L = max(1, (1 << 26) // (1024 * R * C))
        x = block((L,))
        x[0, :, 0, 0] = pm1
        cf.reset_launches()
        got = cf.dft_stage(cf.FR, x, planes, pre, post)
        assert cf.LAUNCHES["dft_stage"] == 1
        assert torch.equal(got, cf.dft_stage_plain(cf.FR, x, planes, pre, post))


def _mxu_launches(log_n: int) -> dict:
    """dft_ntt and dft_stage launches of one MxuNTT call: one dft_ntt up to
    2^11 points, two dft_stage for a base transform above, and over the
    outer four-step level (above 2^16) its two sub-transforms' own."""
    if log_n <= 11:
        return {"dft_ntt": 1, "dft_stage": 0}
    if log_n <= 16:
        return {"dft_ntt": 0, "dft_stage": 2}
    subs = [_mxu_launches(k) for k in (log_n // 2, log_n - log_n // 2)]
    return {k: subs[0][k] + subs[1][k] for k in subs[0]}


@pytest.mark.parametrize("log_n", [6, 7, 8, 9, 10, 11, 12, 15, 17])
def test_mxu_ntt_on_the_card(dev, log_n):
    """MxuNTT against the radix-2 NTT (below 2^12) or the four-step one, on
    the card, in all four forms the prover uses; one dft_ntt launch a call
    up to 2^11 points (no dft_stage, no ntt_small), two dft_stage above (the
    sub-transforms' own over the outer level at 2^17); new_ntt picks it for
    2^6..2^11."""
    from halo2_lib_tpu_torch.ops.ntt import NTT, FourStepNTT, new_ntt
    from halo2_lib_tpu_torch.ops.ntt_mxu import MxuNTT

    df = DeviceField(FR_BN254)
    n = 1 << log_n
    gen = torch.Generator().manual_seed(700 + log_n)
    mxu = MxuNTT(df, log_n, dev)
    ref = (NTT if log_n < 12 else FourStepNTT)(df, log_n, dev)
    assert isinstance(new_ntt(df, log_n, dev), MxuNTT if log_n < 12 else FourStepNTT)
    x = _rand((3, 16, n), FR_BN254.p, gen, dev)
    pre = _rand((16, n), FR_BN254.p, gen, dev)
    cf.reset_launches()
    got = [mxu.forward(x), mxu.inverse(x), mxu.forward(x, pre=pre),
           mxu.inverse(x, post=mxu.inverse_post(7))]
    want = _mxu_launches(log_n)
    assert {k: cf.LAUNCHES[k] for k in want} == {k: 4 * v for k, v in want.items()}
    assert cf.LAUNCHES["ntt_small"] == 0
    for a, b in zip(got, [ref.forward(x), ref.inverse(x), ref.forward(x, pre=pre),
                          ref.inverse(x, post=ref.inverse_post(7))]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("log_n", range(6, 12))
@pytest.mark.parametrize("C", [1, 3, 12, 105])
def test_dft_ntt(dev, log_n, C):
    """dft_ntt against its plain version (dft_stage_plain, the transpose,
    dft_stage_plain) at 2^6..2^11 points and 1, 3, 12 and 105 columns, in
    the four forms (forward, forward with the pre row, inverse with 1/n,
    inverse with the post row), one launch each; p - 1 among the values."""
    from halo2_lib_tpu_torch.ops.ntt_mxu import MxuNTT

    df = DeviceField(FR_BN254)
    n = 1 << log_n
    gen = torch.Generator().manual_seed(900 + 10 * log_n + C)
    mxu = MxuNTT(df, log_n, dev)
    x = _rand((C, 16, n), FR_BN254.p, gen, dev)
    x[0, :, 0] = torch.tensor([((FR_BN254.p - 1) >> (16 * j)) & 0xFFFF for j in range(16)],
                              dtype=torch.int32, device=dev)
    pre = _rand((16, n), FR_BN254.p, gen, dev)
    fwd, inv = mxu._consts[True], mxu._consts[False]
    forms = [(fwd, None, None), (fwd, pre, None), (inv, None, mxu.n_inv_mont),
             (inv, None, mxu.inverse_post(7))]
    for (tw, w1, w2), pr, po in forms:
        cf.reset_launches()
        got = cf.dft_ntt(cf.FR, x, w1, w2, tw, pr, po)
        assert cf.LAUNCHES["dft_ntt"] == 1
        assert torch.equal(got, cf.dft_ntt_plain(cf.FR, x, w1, w2, tw, pr, po))


def test_ec_kernels(dev):
    rng = random.Random(4)
    dc = DeviceCurve(DeviceField(BN254_G1.base), BN254_G1)
    pts = [BN254_G1.random_point(rng) for _ in range(30)] + [None, None]
    qts = pts[16:] + pts[:16]
    P, Qp = dc.pack_points(pts, dev), dc.pack_points(qts, dev)
    for k, pl in zip(cf.ec_add(P, Qp), cf.ec_add_plain(P, Qp)):
        assert torch.equal(k, pl)
    for k, pl in zip(cf.ec_double(P), cf.ec_double_plain(P)):
        assert torch.equal(k, pl)


@pytest.mark.parametrize("distinct", [False, True])
def test_ec_madd(dev, distinct):
    """Random accumulators plus one shared set of affine bases, with
    identity accumulators, (0, 0) bases, P + P and P + (-P) lanes."""
    rng = random.Random(8 + distinct)
    dc = DeviceCurve(DeviceField(BN254_G1.base), BN254_G1)
    acc = [BN254_G1.random_point(rng) for _ in range(60)]
    base = [BN254_G1.random_point(rng) for _ in range(30)]
    acc[0] = base[1] = None
    acc[2] = base[2] = None
    acc[3] = base[3]
    acc[4] = (base[4][0], BN254_G1.base.p - base[4][1])
    P = tuple(t.reshape(16, 2, 30).permute(1, 0, 2).contiguous().to(dev)
              for t in dc.pack_points(acc, device="cpu"))
    A = tuple(t.to(dev) for t in dc.pack_points_affine(base, device="cpu"))
    cf.reset_launches()
    got = cf.ec_madd(P, A, distinct)
    assert cf.LAUNCHES["ec_madd"] == 1
    for k, pl in zip(got, cf.ec_madd_plain(P, A, distinct)):
        assert torch.equal(k, pl)


@pytest.mark.parametrize("distinct", [False, True])
def test_bucket_scan(dev, distinct):
    gen = torch.Generator().manual_seed(5)
    x = _rand((4, 7, 16, 33), FQ_BN254.p, gen, dev)
    axy = (x[:, :, :8].to(torch.int64) | (x[:, :, 8:].to(torch.int64) << 16))
    axy = torch.where(axy >= 1 << 31, axy - (1 << 32), axy).to(torch.int32)
    axy = torch.cat([axy, axy.flip(-1)], dim=2).contiguous()
    start = (torch.rand((4, 7, 33), generator=gen) < 0.2).to(torch.int32).to(dev)
    got = cf.bucket_scan(axy, start, distinct)
    assert torch.equal(got, cf.bucket_scan_plain(axy, start, distinct))


@pytest.mark.parametrize("lanes, distinct", [(8, False), (16, True), (128, False), (128, True)])
def test_bucket_sums_fused(dev, lanes, distinct):
    """The fused bucket accumulation on the card against its plain version
    and against the bucket_scan composition it replaced, on the special
    windows of tests/test_torch_bucket_sums.py (a run across many lanes,
    one bucket filling a window, a dead window, buckets below every digit,
    P + P and P + (-P) in a run, an identity base)."""
    from test_torch_bucket_sums import _affine, _sorted, bucket_sums_case, old_bucket_sums

    dc = DeviceCurve(DeviceField(BN254_G1.base), BN254_G1)
    c, bases, digits = bucket_sums_case()
    A = tuple(t.to(dev) for t in _affine(dc, bases))
    order, d_sorted = (t.to(dev) for t in _sorted(digits))
    nb = (1 << c) - 1
    args = (cf.pack_bases(*A), order, d_sorted, lanes, nb, distinct)
    cf.reset_launches()
    got = cf.bucket_sums_fused(*args)
    assert cf.LAUNCHES["bucket_sums_fused"] == 1
    for k, pl, old in zip(got, cf.bucket_sums_fused_plain(*args),
                          old_bucket_sums(A, order, d_sorted, nb, distinct, lanes)):
        assert torch.equal(k, pl) and torch.equal(k, old)


def _special_lanes(S):
    """Random Jacobian coordinates S (three [.., 16, B]) with identities,
    copies of the lane before (equal points: the doubling branch) and
    negations of it (P + (-P)) on every few lanes."""
    X, Y, Z = (t.clone() for t in S)
    B = X.shape[-1]
    Z[..., 3::7] = 0
    for t in (X, Y, Z):
        t[..., 5::7] = t[..., 4::7][..., : t[..., 5::7].shape[-1]]
    X[..., 2::7] = X[..., 1::7][..., : X[..., 2::7].shape[-1]]
    Z[..., 2::7] = Z[..., 1::7][..., : Z[..., 2::7].shape[-1]]
    negY = cf.field_sub_plain(cf.FQ, torch.zeros_like(Y), Y)
    Y[..., 2::7] = negY[..., 1::7][..., : Y[..., 2::7].shape[-1]]
    return X, Y, Z


@pytest.mark.parametrize("CL2, nb, Wtot", [(2, 7, 13), (8, 255, 7), (64, 1023, 11)])
def test_bucket_weight(dev, CL2, nb, Wtot):
    gen = torch.Generator().manual_seed(CL2)
    S = _special_lanes([_rand((Wtot, 16, nb), FQ_BN254.p, gen, dev) for _ in range(3)])
    cf.reset_launches()
    got = cf.bucket_weight(S, CL2)
    assert cf.LAUNCHES["bucket_weight"] == 1
    for k, pl in zip(got, cf.bucket_weight_plain(S, CL2)):
        assert torch.equal(k, pl)


def _combine_specials(T, W: int, c: int):
    """Column 0 meets res == T_{W-2} after its c doublings (the doubling
    branch); the last column, where C > 1, res == -T_{W-2} (the identity)."""
    C = T[0].shape[-1] // W
    top = tuple(t[:, W - 1 : W] for t in T)
    D = top
    for _ in range(c):
        D = cf.ec_double_plain(D)
    negD = (D[0], cf.field_sub_plain(cf.FQ, torch.zeros_like(D[1]), D[1]), D[2])
    for t, p, d, nd in zip(T, top, D, negD):
        t[:, W - 2 : W - 1] = d
        if C > 1:
            t[:, C * W - 1 : C * W] = p
            t[:, C * W - 2 : C * W - 1] = nd


@pytest.mark.parametrize("C", [1, 42])
def test_msm_combine(dev, C):
    W, c = 26, 10
    gen = torch.Generator().manual_seed(C)
    T = _special_lanes([_rand((16, C * W), FQ_BN254.p, gen, dev) for _ in range(3)])
    _combine_specials(T, W, c)
    cf.reset_launches()
    got = cf.msm_combine(T, W, c)
    assert cf.LAUNCHES["msm_combine"] == 1
    for k, pl in zip(got, cf.msm_combine_plain(T, W, c)):
        assert torch.equal(k, pl)


def test_msm_on_the_card_matches_cpu(dev):
    rng = random.Random(6)
    dc = DeviceCurve(DeviceField(BN254_G1.base), BN254_G1)
    pts = [BN254_G1.random_point(rng) for _ in range(256)]
    scal = [rng.randrange(BN254_G1.scalar.p) for _ in range(256)]
    A_cpu = dc.pack_points_affine(pts, device="cpu")
    digits = pack_scalars(dc, scal, 8, device="cpu")[None]
    want = dc.unpack_points(msm_many_device(dc, A_cpu, digits, 8))
    A_dev = tuple(t.to(dev) for t in A_cpu)
    cf.reset_launches()
    got = dc.unpack_points(msm_many_device(dc, A_dev, digits.to(dev), 8))
    assert got == want
    # the bucket accumulation and the tail run as the three fused kernels,
    # no bucket_scan and no single add or doubling
    assert cf.LAUNCHES["bucket_sums_fused"] == 1 and cf.LAUNCHES["bucket_scan"] == 0
    assert cf.LAUNCHES["ec_add"] == 0 and cf.LAUNCHES["ec_double"] == 0
    assert cf.LAUNCHES["bucket_weight"] == 1 and cf.LAUNCHES["msm_combine"] == 1


def test_small_commit_on_the_card_takes_ec_madd(dev):
    """commit_columns at m <= COMMIT_SIMPLE_MAX: the double-and-add on the
    card, as one commit_dbl_add launch (the fused ec_double and ec_madd
    steps and ec_add tree; none of those single point ops launched), no
    Pippenger, and the same points as the CPU's Pippenger."""
    import os

    from halo2_lib_tpu_torch.backend.kzg import ParamsKZG

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cpu = ParamsKZG.read(os.path.join(root, "params", "kzg_bn254_8.srs"), device="cpu")
    card = ParamsKZG.read(os.path.join(root, "params", "kzg_bn254_8.srs"), device=dev)
    fr_df = DeviceField(FR_BN254)
    gen = torch.Generator().manual_seed(10)
    vals = fr_df._to_mont(_rand((3, 16, 256), FR_BN254.p, gen, "cpu"))
    want = cpu.commit_columns(fr_df, vals, cpu.affine_lagrange_bases("cpu"))
    cf.reset_launches()
    got = card.commit_columns(fr_df, vals.to(dev), card.affine_lagrange_bases(dev))
    assert torch.equal(got.cpu(), want)
    assert cf.LAUNCHES["commit_dbl_add"] == 1 and cf.LAUNCHES["bucket_sums_fused"] == 0
    assert cf.LAUNCHES["ec_madd"] == cf.LAUNCHES["ec_double"] == cf.LAUNCHES["ec_add"] == 0


@pytest.mark.parametrize("fid", [cf.FR, cf.FQ])
@pytest.mark.parametrize("shape", [(1, 16, 1), (11, 16, 1), (3, 16, 1000)])
def test_fermat_inv_special_inputs(dev, fid, shape):
    """The inversion on both fields against its plain version, with 0, 1,
    p - 1, R mod p and 2^-1 among random values (the first elements, row
    by row)."""
    p = FR_BN254.p if fid == cf.FR else FQ_BN254.p
    gen = torch.Generator().manual_seed(20 + fid)
    a = _rand(shape, p, gen, "cpu")
    flat = a.permute(1, 0, 2).reshape(16, -1)
    special = [0, 1, p - 1, (1 << 256) % p, pow(2, -1, p)]
    for j, v in enumerate(special[: flat.shape[1]]):
        flat[:, j] = torch.tensor([(v >> (16 * i)) & 0xFFFF for i in range(16)], dtype=torch.int32)
    a = flat.reshape(16, shape[0], shape[2]).permute(1, 0, 2).contiguous().to(dev)
    cf.reset_launches()
    got = cf.fermat_inv(fid, a)
    assert cf.LAUNCHES["fermat_inv"] == 1
    assert torch.equal(got, cf.fermat_inv_plain(fid, a))


def _old_commit(dc, scalars, A):
    """backend/kzg.py:commit_double_and_add before the fusion, on canonical
    scalars: per bit (MSB first) ec_double, ec_madd and a select, then the
    ec_add lane tree -> Jacobian [16, C]."""
    C, _, m = scalars.shape
    Am = tuple(t[:, :m].contiguous() for t in A)
    acc = dc.identity((C, m), scalars.device)
    for b in range(253, -1, -1):
        bit = ((scalars[:, b // 16, :] >> (b % 16)) & 1) != 0
        acc = cf.ec_double(acc)
        acc = dc.select(bit, cf.ec_madd(acc, Am, False), acc)
    X, Y, Z = dc.tree_reduce(acc)
    return tuple(t[..., 0].transpose(0, 1) for t in (X, Y, Z))


@pytest.mark.parametrize("C, m", [(1, 1), (3, 13), (2, 256)])
def test_commit_dbl_add(dev, C, m):
    """The fused small-column commit against its plain version and against
    the per-bit composition of ec_double, ec_madd and ec_add launches it
    replaced, on the k=8 SRS Lagrange bases, with scalars 0, 1 and r - 1,
    an all-zero column (C = 3) and a (0, 0) base."""
    import os

    from halo2_lib_tpu_torch.backend.kzg import ParamsKZG

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    srs = ParamsKZG.read(os.path.join(root, "params", "kzg_bn254_8.srs"), device=dev)
    A = tuple(t.clone() for t in srs.affine_lagrange_bases(dev))
    if m > 3:
        A[0][:, 3] = A[1][:, 3] = 0
    gen = torch.Generator().manual_seed(C * m)
    scal = _rand((C, 16, m), FR_BN254.p, gen, "cpu")
    r = FR_BN254.p
    for lane, v in enumerate((0, 1, r - 1)[:m]):
        scal[0, :, lane] = torch.tensor([(v >> (16 * i)) & 0xFFFF for i in range(16)],
                                        dtype=torch.int32)
    if C == 3:
        scal[2] = 0
    scal = scal.to(dev)
    dc = DeviceCurve(DeviceField(BN254_G1.base), BN254_G1)
    cf.reset_launches()
    got = cf.commit_dbl_add(scal, *A)
    assert cf.LAUNCHES["commit_dbl_add"] == 1
    for k, pl, old in zip(got, cf.commit_dbl_add_plain(scal, *A), _old_commit(dc, scal, A)):
        assert torch.equal(k, pl) and torch.equal(k, old)


@pytest.mark.parametrize("n", [1, 13, 300])
def test_g1_batch_mul(dev, n):
    """The SRS setup's comb of G against its plain version (Jacobian-equal,
    one launch) and, in affine form, against the old
    per-lane double-and-add; scalars 0, 1, r - 1, then every edge scalar of
    the comb (utils/testing.py comb_edge_scalars) where n leaves room."""
    from halo2_lib_tpu_torch.backend.kzg import _affine_mont
    from halo2_lib_tpu_torch.utils.testing import comb_edge_scalars, old_g1_batch_mul

    gen = torch.Generator().manual_seed(n)
    scal = _rand((16, n), FR_BN254.p, gen, "cpu")
    r = FR_BN254.p
    edge = [0, 1, r - 1] + list(comb_edge_scalars().values())
    for lane, v in enumerate(edge[:n]):
        scal[:, lane] = torch.tensor([(v >> (16 * i)) & 0xFFFF for i in range(16)],
                                     dtype=torch.int32)
    dc = DeviceCurve(DeviceField(BN254_G1.base), BN254_G1)
    Gx, Gy = dc.pack_points_affine([BN254_G1.g], dev)
    sc = scal.to(dev)
    cf.reset_launches()
    got = cf.g1_batch_mul(sc, Gx, Gy)
    assert cf.LAUNCHES["g1_batch_mul"] == 1
    for a, b in zip(got, cf.g1_batch_mul_plain(sc, Gx, Gy)):
        assert torch.equal(a, b)
    old = old_g1_batch_mul(sc, Gx, Gy)
    for a, b in zip(_affine_mont(dc.df, *got), _affine_mont(dc.df, *old)):
        assert torch.equal(a, b)


def test_setup_on_the_card_reproduces_the_committed_srs(dev):
    """ParamsKZG.setup(9) through g1_batch_mul on the card: byte for byte
    params/kzg_bn254_9.srs."""
    import os

    from halo2_lib_tpu_torch.backend.kzg import ParamsKZG

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "params", "kzg_bn254_9.srs"), "rb") as f:
        want = f.read()
    assert ParamsKZG.setup(9, device=dev).to_halo2_bytes() == want


def test_msm_t_config_proof_on_the_card(dev):
    """The reference's MSM circuit at configs/bn254/msm_circuit.t.config
    (k=13, batch 8, 181 + 30 advice columns): setup(13), keygen on the MOCK
    builder, the pinned PROVER builder's witness and create_proof on the
    card give the JAX package's SRS, vk and proof digests
    (msm_digests.json); the proof verifies."""
    import hashlib
    import json
    import os
    import random

    from halo2_lib_tpu_torch.backend.keygen import keygen
    from halo2_lib_tpu_torch.backend.kzg import ParamsKZG
    from halo2_lib_tpu_torch.backend.prover import create_proof
    from halo2_lib_tpu_torch.backend.verifier import verify_proof
    from halo2_lib_tpu_torch.ecc import ec as port_ec
    from halo2_lib_tpu_torch.utils.pinning import pinning_of
    from halo2_lib_tpu_torch.utils.testing import MSM_T_CONFIG, load_config, msm_circuit, msm_witness

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "tests", "data", "torch_goldens", "msm_digests.json")) as f:
        gold = json.load(f)
    want = gold["t_config"]
    cfg = load_config(MSM_T_CONFIG)
    params = ParamsKZG.setup(13, device=dev)
    assert hashlib.sha256(params.to_halo2_bytes()).hexdigest() == want["srs_sha256"]
    port_ec.DEFAULT_RNG.seed(gold["rng_seed"])
    builder = msm_circuit(cfg)
    pk = keygen(params, builder, device=dev)
    assert hashlib.sha256(pk.vk.to_bytes()).hexdigest() == want["vk_sha256"]
    pb = pinning_of(builder).prover_builder()
    msm_witness(pb, cfg, None, random.Random(gold["rng_seed"]))
    proof = create_proof(params, pk, pb, seed=0, device=dev)
    assert hashlib.sha256(proof).hexdigest() == want["proof_sha256"]
    assert verify_proof(params, pk.vk, proof)


def test_pipelined_k9_proof_on_a_side_stream(dev):
    """prove_pipelined of the golden circuit on the card: its columns commit
    on the pipeline's second CUDA stream (commit_dbl_add at k=9) while the
    witness runs; the proof is golden_k9.npz's bytes, as the plain one is."""
    import os

    import numpy as np

    from halo2_lib_tpu_torch.backend.keygen import keygen
    from halo2_lib_tpu_torch.backend.kzg import ParamsKZG
    from halo2_lib_tpu_torch.backend.pipeline import Phase0Pipeline
    from halo2_lib_tpu_torch.backend.prover import create_proof
    from halo2_lib_tpu_torch.utils.pinning import pinning_of
    from halo2_lib_tpu_torch.utils.testing import golden_circuit, golden_witness

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    gold = np.load(os.path.join(root, "tests", "data", "torch_goldens", "golden_k9.npz"))
    params = ParamsKZG.read(os.path.join(root, "params", "kzg_bn254_9.srs"), device=dev)
    builder = golden_circuit()
    pk = keygen(params, builder, device=dev)
    pinning = pinning_of(builder)
    cf.reset_launches()
    pipe = Phase0Pipeline(params, pk, pinning.prover_builder(), device=dev)
    assert pipe._side is not None and pipe._side != torch.cuda.current_stream(dev)
    pipe.run(golden_witness)
    assert cf.LAUNCHES["commit_dbl_add"] == len(pipe.groups) >= 1
    proof = create_proof(params, pk, pipe.builder, device=dev, phase0=pipe)
    assert proof == bytes(gold["proof"])


def test_mesh_k9_proof_on_a_virtual_card_mesh(dev):
    """create_proof of the golden circuit over a virtual mesh of 4 shards on
    the card (or over the visible cards, when there are 4): the shards'
    commits are commit_dbl_add launches folded by ec_add, the NTTs the
    sharded four-step; the proof is golden_k9.npz's bytes."""
    import os

    import numpy as np

    from halo2_lib_tpu_torch.backend.kzg import ParamsKZG
    from halo2_lib_tpu_torch.backend.prover import create_proof
    from halo2_lib_tpu_torch.convert import proving_key_from_numpy
    from halo2_lib_tpu_torch.parallel import make_mesh
    from halo2_lib_tpu_torch.utils.testing import golden_circuit

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    gold = np.load(os.path.join(root, "tests", "data", "torch_goldens", "golden_k9.npz"))
    params = ParamsKZG.read(os.path.join(root, "params", "kzg_bn254_9.srs"), device=dev)
    pk = proving_key_from_numpy(gold, dev)
    mesh = make_mesh(4) if torch.cuda.device_count() >= 4 else make_mesh(4, device=dev)
    cf.reset_launches()
    proof = create_proof(params, pk, golden_circuit(), mesh=mesh)
    assert proof == bytes(gold["proof"])
    assert cf.LAUNCHES["ec_add"] > 0 and cf.LAUNCHES["commit_dbl_add"] > 0


@pytest.mark.parametrize("prank", [False, True])
def test_device_mock_stencil_on_the_card(dev, prank):
    """The device mock's gate stencil (mont_mul, field_add, field_sub on the
    card) against its plain version on the same columns, and the verdicts
    on the card and the CPU equal."""
    from halo2_lib_tpu_torch.backend.mock_device import DeviceMockProver, gate_residual
    from halo2_lib_tpu_torch.core.cells import Existing
    from halo2_lib_tpu_torch.utils.testing import golden_circuit

    builder = golden_circuit()
    if prank:
        ctx = builder.main(0)
        x = ctx.load_witness(5)
        builder.range_chip().gate.mul(ctx, Existing(x), Existing(x)).debug_prank(ctx, 7)
    circuit = builder.synthesize()
    table, _, ngate, _ = DeviceMockProver(circuit, dev)._columns()
    df = DeviceField(FR_BN254)
    cf.reset_launches()
    got = gate_residual(df, table[:ngate])
    assert all(cf.LAUNCHES[k] == 1 for k in ("mont_mul", "field_add", "field_sub"))
    assert torch.equal(got.cpu(), gate_residual(df, table[:ngate].cpu()))
    errors = DeviceMockProver(circuit, dev).verify()
    assert errors == DeviceMockProver(circuit, "cpu").verify()
    assert bool(errors) == prank
