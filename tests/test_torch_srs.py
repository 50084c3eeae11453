"""The port's SRS creation and formats (halo2_lib_tpu_torch/backend/kzg.py,
utils/chacha.py) on the CPU.

`ParamsKZG.setup(8, device="cpu")` runs the plain version of the setup's
kernel (g1_batch_mul, a fixed-base comb whose digits, table and sums are
held to the host curve and to the old double-and-add) and must reproduce
the committed
params/kzg_bn254_8.srs byte for byte; a seeded test SRS is held to the host
curve (g[i] = tau^i G, g_lagrange[i] = L_i(tau) G). The Processed format is
held to the JAX package's bytes, the compressed point conventions to
tests/test_parity_golden.py's, and the ChaCha20 generator to
tests/test_chacha.py's vectors. SRS files are written under tmp_path only.
"""

import os
import random

import pytest
import torch

from halo2_lib_tpu_torch.backend import kzg
from halo2_lib_tpu_torch.backend.kzg import ParamsKZG, gen_srs
from halo2_lib_tpu_torch.ops import cuda_field as cf
from halo2_lib_tpu_torch.ops.ec_device import DeviceCurve
from halo2_lib_tpu_torch.ops.limbs import DeviceField, ints_to_limbs_T, limbs_to_ints, to_device
from halo2_lib_tpu_torch.utils.chacha import ChaCha20Rng, chacha20_block, reference_srs_tau
from halo2_lib_tpu_torch.utils.curves import BN254_G1, BN254_G2
from halo2_lib_tpu_torch.utils.fields import FQ_BN254, FR_BN254
from halo2_lib_tpu_torch.utils.testing import comb_edge_scalars, old_g1_batch_mul

# One core per test process: the suite runs in parallel workers.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRS8 = os.path.join(ROOT, "params", "kzg_bn254_8.srs")
KEYSTREAM0 = bytes.fromhex(
    "76b8e0ada0f13d90405d6ae55386bd28bdd219b8a08ded1aa836efcc8b770dc7"
    "da41597c5157488d7724e03fb8d84a376a43b8f41518a11cc387b669b2ee6586"
)


@pytest.fixture(scope="module")
def setup8():
    return ParamsKZG.setup(8, device="cpu")


@pytest.fixture(scope="module")
def srs8_bytes():
    with open(SRS8, "rb") as f:
        return f.read()


# --- ChaCha20 (tests/test_chacha.py's vectors) -------------------------------------


def test_rfc8439_block_vector():
    key = bytes(range(32))
    nonce = bytes.fromhex("000000090000004a00000000")
    assert chacha20_block(key, 1, nonce) == bytes.fromhex(
        "10f1e7e4d13b5915500fdd1fa32071c4c7d1f4c733c068030422aa9ac3d46c4e"
        "d2826446079faa0914c2d705d98b02a2b5129cd1de164eb9cbd083e8a2503c4e"
    )


def test_zero_key_keystream():
    assert ChaCha20Rng(b"\x00" * 32).fill_bytes(64) == KEYSTREAM0


def test_reference_tau_reduction():
    assert reference_srs_tau() == int.from_bytes(KEYSTREAM0, "little") % FR_BN254.p


# --- setup ----------------------------------------------------------------------------


def test_setup_reproduces_the_committed_srs(setup8, srs8_bytes):
    """The reference tau, both bases through g1_batch_mul's plain version,
    affine on the CPU: byte for byte the committed k=8 file."""
    assert setup8.to_halo2_bytes() == srs8_bytes


def test_seeded_setup_against_the_host_curve():
    """A throwaway SRS (seed 3, k=4): tau drawn as the JAX package draws it,
    g[i] = tau^i G and g_lagrange[i] = L_i(tau) G on the host curve, and
    s_g2 = tau G2."""
    k, n, r = 4, 16, FR_BN254.p
    tau = random.Random(("kzg-srs", 3, k).__repr__()).randrange(1, r)
    params = ParamsKZG.setup(k, seed=3, device="cpu")
    w = FR_BN254.nth_root_of_unity(k)
    lag = []
    for i in range(n):
        wi = pow(w, i, r)
        lag.append(wi * (pow(tau, n, r) - 1) * pow(n * (tau - wi), -1, r) % r)
    assert lag == kzg._lagrange_scalars(tau, k)
    assert params.g == [BN254_G1.mul(BN254_G1.g, pow(tau, i, r)) for i in range(n)]
    assert params.g_lagrange == [BN254_G1.mul(BN254_G1.g, s) for s in lag]
    assert params.g2 == BN254_G2.g and params.s_g2 == BN254_G2.mul(BN254_G2.g, tau)


def test_g1_batch_mul_plain_against_the_host_curve():
    """s G for random scalars and 0, 1, 2, r - 1: the wrapper on CPU tensors
    (its plain version), made affine as setup does, equals BN254_G1.mul; 0
    gives the (0, 0) identity."""
    r = FR_BN254.p
    rng = random.Random(5)
    scalars = [0, 1, 2, r - 1] + [rng.randrange(r) for _ in range(12)]
    dc = DeviceCurve(DeviceField(BN254_G1.base), BN254_G1)
    Gx, Gy = dc.pack_points_affine([BN254_G1.g], device="cpu")
    X, Y, Z = cf.g1_batch_mul(to_device(ints_to_limbs_T(scalars), "cpu"), Gx, Gy)
    ax, ay = kzg._affine_mont(dc.df, X, Y, Z)
    got = list(zip(dc.df.unpack(ax), dc.df.unpack(ay)))
    want = [BN254_G1.mul(BN254_G1.g, s) or (0, 0) for s in scalars]
    assert got == want


# --- the comb of g1_batch_mul: its digits, table and sums ---------------------------

EDGE = comb_edge_scalars()


def _ints(t) -> list:
    return limbs_to_ints(t.T.numpy())


def _signed_digits(scalars: list) -> list:
    """Per scalar, the comb's signed digits (cf.comb_digits), low first."""
    d = cf.comb_digits(torch.from_numpy(ints_to_limbs_T(scalars).astype("int64")))
    return [[int(m[i]) * (-1 if bool(ng[i]) else 1) for m, ng in d] for i in range(len(scalars))]


@pytest.mark.parametrize("name", list(EDGE))
def test_comb_digits_of_each_edge_scalar(name):
    """The signed digits sum back to the scalar, lie in (-64, 64], and show
    the case the scalar is named for."""
    s = EDGE[name]
    (d,) = _signed_digits([s])
    assert len(d) == cf.COMB_WINDOWS == 37
    assert sum(v << (cf.COMB_W * j) for j, v in enumerate(d)) == s
    assert all(-cf.COMB_HALF < v <= cf.COMB_HALF for v in d)
    top = cf.COMB_W * (cf.COMB_WINDOWS - 1)
    mid = cf.COMB_WINDOWS // 2
    r = FR_BN254.p
    want = {
        "zero": lambda: not any(d),
        "one": lambda: d == [1] + [0] * 36,
        "two": lambda: d == [2] + [0] * 36,
        "r - 1": lambda: s == r - 1,
        "carry into the top window": lambda: d[-2:] == [-1, 3] and s >> top == 2,
        "carry through every window": lambda: d == [-1] + [0] * 35 + [2],
        "every digit +64": lambda: d[:-1] == [64] * 36,
        "every digit -63": lambda: d[:-1] == [-63] * 36,
        "a digit 0 in the middle": lambda: d[mid] == 0 and d[mid - 1] and d[mid + 1],
        "a digit 0 from a carry": lambda: d[mid] == 0 and (s >> (cf.COMB_W * mid)) & 127 == 127,
        # the lower windows' sum is the top entry: the mixed add's doubling
        "the top entry doubled": lambda: (sum(v << (cf.COMB_W * j) for j, v in enumerate(d[:-1]))
                                          - d[-1] * (1 << top)) % r == 0 and d[-1] == 3,
    }[name]
    assert want()


def test_comb_table_entries_are_the_multiples_of_g():
    """Entry j * 64 + d - 1 of G's table is d 2^(7j) G (Montgomery affine
    words), at sampled (j, d) over every window's first and last."""
    dc = DeviceCurve(DeviceField(BN254_G1.base), BN254_G1)
    tab = cf.g1_comb_table(*dc.pack_points_affine([BN254_G1.g], device="cpu"))
    assert tuple(tab.shape) == (cf.COMB_WINDOWS * cf.COMB_HALF, 16)
    tx, ty = cf.unpack_point_words(tab)
    q = FQ_BN254.p
    rinv = pow(1 << 256, -1, q)
    for j, d in [(0, 1), (0, 64), (1, 1), (17, 33), (35, 64), (36, 1), (36, 64)]:
        e = j * cf.COMB_HALF + d - 1
        got = tuple(v * rinv % q for v in (_ints(tx[:, e : e + 1])[0], _ints(ty[:, e : e + 1])[0]))
        assert got == BN254_G1.mul(BN254_G1.g, d << (cf.COMB_W * j))


def test_comb_against_the_host_curve_and_the_old_double_and_add():
    """Every edge scalar and 5 random ones through the wrapper on CPU
    tensors (the comb's plain version): made affine, equal to BN254_G1.mul
    and to the old per-lane double-and-add; the Jacobian triples differ."""
    r = FR_BN254.p
    rng = random.Random(11)
    scalars = list(EDGE.values()) + [rng.randrange(r) for _ in range(5)]
    dc = DeviceCurve(DeviceField(BN254_G1.base), BN254_G1)
    Gx, Gy = dc.pack_points_affine([BN254_G1.g], device="cpu")
    sc = to_device(ints_to_limbs_T(scalars), "cpu")
    comb = cf.g1_batch_mul(sc, Gx, Gy)
    old = old_g1_batch_mul(sc, Gx, Gy)
    aff = [kzg._affine_mont(dc.df, *P) for P in (comb, old)]
    assert all(torch.equal(a, b) for a, b in zip(*aff))
    got = list(zip(dc.df.unpack(aff[0][0]), dc.df.unpack(aff[0][1])))
    assert got == [BN254_G1.mul(BN254_G1.g, s) or (0, 0) for s in scalars]
    assert not torch.equal(comb[2], old[2])


# --- formats --------------------------------------------------------------------------


def test_rawbytes_round_trip(setup8, srs8_bytes):
    got = ParamsKZG.from_halo2_bytes(srs8_bytes, device="cpu")
    assert got.to_halo2_bytes() == srs8_bytes
    assert got.g == setup8.g and got.g_lagrange == setup8.g_lagrange
    assert (got.g2, got.s_g2) == (setup8.g2, setup8.s_g2)
    Ax, Ay = got.affine_lagrange_bases("cpu")
    assert torch.equal(Ax, setup8.affine_lagrange_bases("cpu")[0])
    assert torch.equal(Ay, got.device_curve().pack_points_affine(got.g_lagrange, device="cpu")[1])


@pytest.mark.parametrize("basis, point, coord, value", [(0, 0, 0, 0), (1, 255, 1, 0), (0, 7, 1, 1)])
def test_rawbytes_coordinate_not_below_q_is_refused(srs8_bytes, basis, point, coord, value):
    """A RawBytes coordinate of q (or q + 1, or 2^256 - 1) is refused: kept
    as is it would give the card other bases than the host decodes."""
    q = FQ_BN254.p
    n = 256
    off = 4 + ((basis * n + point) * 2 + coord) * 32
    for bad in (q + value, (1 << 256) - 1):
        data = bytearray(srs8_bytes)
        data[off : off + 32] = bad.to_bytes(32, "little")
        with pytest.raises(ValueError, match="not below q"):
            ParamsKZG.from_halo2_bytes(bytes(data), device="cpu")
    data = bytearray(srs8_bytes)
    data[off : off + 32] = (q - 1).to_bytes(32, "little")
    ParamsKZG.from_halo2_bytes(bytes(data), device="cpu")


def test_processed_round_trip_and_jax_bytes(setup8, srs8_bytes):
    """Processed (compressed) bytes equal the JAX package's for the same
    file, and read back to the same SRS."""
    from halo2_lib_tpu.backend.kzg import ParamsKZG as JaxParams

    proc = setup8.to_halo2_bytes(raw=False)
    assert len(proc) == 4 + 2 * 256 * 32 + 2 * 64
    assert proc == JaxParams.from_halo2_bytes(srs8_bytes).to_halo2_bytes(raw=False)
    back = ParamsKZG.from_halo2_bytes(proc, device="cpu")
    assert back.to_halo2_bytes() == srs8_bytes


def test_compressed_conventions():
    """tests/test_parity_golden.py's G1 and G2 conventions: y parity in the
    top bit, identity all zeros."""
    g = BN254_G1.g
    raw = kzg._g1_compress(g)
    assert len(raw) == 32 and raw[0] == 1 and raw[31] & 0x80 == 0
    assert kzg._g1_decompress(raw) == g
    neg = BN254_G1.neg(g)
    assert kzg._g1_compress(neg)[31] & 0x80 == 0x80
    assert kzg._g1_decompress(kzg._g1_compress(neg)) == neg
    assert kzg._g1_compress(None) == b"\x00" * 32 and kzg._g1_decompress(b"\x00" * 32) is None
    g2 = BN254_G2.g
    assert len(kzg._g2_compress(g2)) == 64
    assert kzg._g2_decompress(kzg._g2_compress(g2)) == g2
    assert kzg._g2_decompress(kzg._g2_compress(BN254_G2.neg(g2))) == BN254_G2.neg(g2)
    with pytest.raises(ValueError):
        kzg._g1_decompress(FQ_BN254.p.to_bytes(32, "little"))


def _legacy_bytes(params) -> bytes:
    """The repo's old H2TPUSR3 container: magic, k, then canonical x, y of
    both bases and the G2 coordinates, 32 bytes LE each."""
    enc = lambda c: c.to_bytes(32, "little")
    out = bytearray(b"H2TPUSR3" + params.k.to_bytes(4, "little"))
    for basis in (params.g, params.g_lagrange):
        for x, y in basis:
            out += enc(x) + enc(y)
    for x, y in (params.g2, params.s_g2):
        out += enc(x[0]) + enc(x[1]) + enc(y[0]) + enc(y[1])
    return bytes(out)


def test_legacy_container_and_stale_magic(setup8, srs8_bytes, tmp_path):
    path = tmp_path / "legacy.srs"
    path.write_bytes(_legacy_bytes(setup8))
    assert ParamsKZG.read(str(path), device="cpu").to_halo2_bytes() == srs8_bytes
    stale = tmp_path / "stale.srs"
    stale.write_bytes(b"H2TPUSR2" + srs8_bytes)
    with pytest.raises(ValueError, match="stale"):
        ParamsKZG.read(str(stale), device="cpu")
    with pytest.raises(ValueError):
        ParamsKZG.from_halo2_bytes(srs8_bytes[:-1], device="cpu")


def test_gen_srs_read_or_create(setup8, srs8_bytes, tmp_path, monkeypatch):
    """gen_srs under PARAMS_DIR: a missing file is created by setup and
    written; an existing one is read; a legacy one is read and rewritten in
    RawBytes; a stale one is regenerated (setup counted, the first SRS
    reused for the regeneration)."""
    monkeypatch.setenv("PARAMS_DIR", str(tmp_path))
    path = tmp_path / "kzg_bn254_4.srs"
    made = gen_srs(4, device="cpu")
    assert path.read_bytes() == made.to_halo2_bytes()
    assert made.g[1] == BN254_G1.mul(BN254_G1.g, reference_srs_tau())
    calls = []
    monkeypatch.setattr(
        ParamsKZG, "setup", staticmethod(lambda k, **kw: calls.append(k) or made)
    )
    assert gen_srs(4, device="cpu").to_halo2_bytes() == made.to_halo2_bytes()
    assert calls == []
    path.write_bytes(b"H2TPUSRS" + b"\x00" * 8)
    gen_srs(4, device="cpu")
    assert calls == [4] and path.read_bytes() == made.to_halo2_bytes()
    path8 = tmp_path / "kzg_bn254_8.srs"
    path8.write_bytes(_legacy_bytes(setup8))
    assert gen_srs(8, device="cpu").g[:4] == setup8.g[:4]
    assert path8.read_bytes() == srs8_bytes and calls == [4]


def test_entry_points_need_a_device_without_a_card(tmp_path, monkeypatch, srs8_bytes):
    """setup, gen_srs, from_halo2_bytes and read, keygen and create_proof
    default to the card and raise without one; gen_srs writes nothing."""
    from halo2_lib_tpu_torch.backend.keygen import keygen
    from halo2_lib_tpu_torch.backend.prover import create_proof
    from halo2_lib_tpu_torch.utils.testing import golden_circuit

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    monkeypatch.setenv("PARAMS_DIR", str(tmp_path))
    params = ParamsKZG.from_halo2_bytes(srs8_bytes, device="cpu")
    for call in (
        lambda: ParamsKZG.setup(4),
        lambda: gen_srs(4),
        lambda: ParamsKZG.from_halo2_bytes(srs8_bytes),
        lambda: ParamsKZG.read(SRS8),
        lambda: keygen(params, golden_circuit()),
        lambda: create_proof(params, None, golden_circuit(), seed=0),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not os.listdir(tmp_path)
