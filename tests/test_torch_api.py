"""The port's standalone device API against the JAX package's, on the CPU.

halo2_lib_tpu_torch's ``backend/poly.py`` ``Domain`` (halo2's
EvaluationDomain: the conversions, vanishing division, element-wise math,
rotations, constants, scans, powers and evaluations), ``ops/limbs.py``
``DeviceField.pow``, ``eq`` and ``const``, ``backend/kzg.py``
``ParamsKZG.commit``, ``commit_lagrange``, ``commit_dev`` and
``commit_many``, and ``ops/ec_device.py`` ``DeviceCurve.msm`` and
``msm_device``, through the kernels' plain versions, against the JAX
package's outputs on the same inputs. The JAX device MSM costs minutes of
XLA:CPU compile, so its outputs are frozen in
tests/data/torch_goldens/api_digests.json (make_goldens.py --api, which
held every MSM there to the host curve before writing it); the live check
is ``slow``. Tolerance 0: tensors are compared as SHA-256 of their limbs,
host ints and points exactly. Also the device defaults: the constructors
and every new entry point raise without a card unless given
``device="cpu"``.
"""

import hashlib
import json
import os
import random

import numpy as np
import pytest
import torch

from halo2_lib_tpu.ops.ntt4 import _plan as jax_plan
from halo2_lib_tpu_torch.backend.kzg import ParamsKZG
from halo2_lib_tpu_torch.backend.poly import Domain
from halo2_lib_tpu_torch.ops import cuda_field as cf
from halo2_lib_tpu_torch.ops.ec_device import DeviceCurve, msm_device, pack_scalars
from halo2_lib_tpu_torch.ops.limbs import DeviceField
from halo2_lib_tpu_torch.ops.ntt import _plan
from halo2_lib_tpu_torch.utils.curves import BN254_G1
from halo2_lib_tpu_torch.utils.fields import FQ_BN254, FR_BN254

# One core per test process: the suite runs in parallel workers.
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CPU = "cpu"
# make_goldens.py's API_K, API_EXT, API_KZG_K and API_POW_EXPONENTS
API_K, API_EXT, API_KZG_K = 4, 4, 8
API_POW_EXPONENTS = (0, 1, 2, 5, (1 << 64) + 1, FR_BN254.p - 2,
                     0x2A5F3C9E1B7D4F6081C3E5A7B9D1F3E5C7A9B1D3F5E7C9A1B3D5F7E9C1A3B5D7)


def api_values(seed: int, m: int, p: int = FR_BN254.p) -> list[int]:
    """make_goldens.api_values: m canonical field values from a numpy seed,
    0, 1 and p - 1 among them."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 62, size=(m, 5), dtype=np.int64)
    vals = [sum(int(w) << (62 * i) for i, w in enumerate(row)) % p for row in words]
    for i, v in enumerate((0, 1, p - 1), start=1):
        if i < m:
            vals[i] = v
    return vals


def api_msm_cases() -> dict:
    """make_goldens.api_msm_cases: the 64-point case of
    tests/test_ec_device.py:test_msm (identity base, zero scalar, duplicate
    bases) and random (37, 4) and (128, 8) cases."""
    r = BN254_G1.scalar.p
    out = {}
    rng = random.Random(64)
    n = 64
    pts = [BN254_G1.random_point(rng) for _ in range(n)]
    scalars = [BN254_G1.random_scalar(rng) for _ in range(n)]
    pts[3] = None
    scalars[5] = 0
    pts[10] = pts[11] = pts[12]
    scalars[10] = scalars[11] = scalars[12]
    pts[20] = pts[21]
    scalars[30] = 1
    scalars[31] = 255
    out["dup_64"] = (pts, scalars, 8)
    for n, c in ((37, 4), (128, 8)):
        seed = int(np.random.default_rng(1000 + n).integers(0, 1 << 31))
        rng = random.Random(seed)
        pts = [BN254_G1.random_point(rng) for _ in range(n)]
        out[f"rand_{n}_{c}"] = (pts, api_values(n, n, r), c)
    return out


def _sha(t) -> str:
    a = t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)
    return hashlib.sha256(np.ascontiguousarray(a).astype("<u4").tobytes()).hexdigest()


def _hex_point(pt):
    return None if pt is None else [hex(pt[0]), hex(pt[1])]


@pytest.fixture(scope="module")
def want():
    with open(os.path.join(HERE, "data", "torch_goldens", "api_digests.json")) as f:
        return json.load(f)


def domain_outputs() -> dict:
    """The keys of make_goldens.api_digest's "domain", by the port."""
    dom = Domain(API_K, API_EXT)
    n = dom.n
    c, e, q = api_values(1, n), api_values(2, n), api_values(3, n)
    x = api_values(5, 1)[0]
    C, E = dom.pack(c, CPU), dom.pack(e, CPU)
    ext = dom.coeff_to_extended(C)
    return {
        "lagrange_to_coeff": _sha(dom.lagrange_to_coeff(E)),
        "coeff_to_lagrange": _sha(dom.coeff_to_lagrange(C)),
        "coeff_to_extended": _sha(ext),
        "extended_to_coeff": _sha(dom.extended_to_coeff(ext)),
        "divide_by_vanishing": _sha(dom.divide_by_vanishing(ext)),
        "mul": _sha(dom.mul(C, E)),
        "add": _sha(dom.add(C, E)),
        "sub": _sha(dom.sub(C, E)),
        "rotate_ext_1": _sha(dom.rotate_ext(ext, 1)),
        "rotate_ext_-2": _sha(dom.rotate_ext(ext, -2)),
        "const_ext": _sha(dom.const_ext(5, device=CPU)),
        "const_h": _sha(dom.const_h(q[0], device=CPU)),
        "prefix_prod": _sha(dom.prefix_prod(torch.stack([C, E]))),
        "pows_dev_16": _sha(dom.pows_dev(x, n, device=CPU)),
        "pows_dev_5": _sha(dom.pows_dev(x, 5, device=CPU)),
        "eval_many_at": [hex(v) for v in dom.eval_many_at(torch.stack([C, E, dom.pack(q, CPU)]), x)],
        "eval_many_at_odd": [hex(v) for v in dom.eval_many_at(C[None, :, :13], x)],
        "eval_coeffs_host": hex(dom.eval_coeffs_host(c, x)),
        "l0_host": hex(dom.l0_host(x)),
    }


def field_outputs() -> dict:
    f = {}
    for name, F in (("fr", FR_BN254), ("fq", FQ_BN254)):
        df = DeviceField(F)
        a = df.pack(api_values(6, 8, F.p), device=CPU)
        for ex in API_POW_EXPONENTS:
            f[f"pow_{name}_{ex:x}"] = _sha(df.pow(a, ex))
        b = df.pack(api_values(6, 4, F.p) + api_values(7, 4, F.p), device=CPU)
        f[f"eq_{name}"] = [bool(v) for v in df.eq(a, b)]
        for shape in ((), 8, (3, 8)):
            f[f"const_{name}_{shape}"] = _sha(df.const(F.p - 3, shape, device=CPU))
    return f


def test_domain_matches_jax(want):
    got = domain_outputs()
    assert got == want["domain"]


def test_domain_host_math():
    """The device methods against exact host arithmetic: the round trips,
    Z_H * q divided by Z_H, the evaluations, the rotation and the powers."""
    dom = Domain(API_K, API_EXT)
    p, n = FR_BN254.p, dom.n
    c, q = api_values(1, n), api_values(3, n)
    x = api_values(5, 1)[0]
    C = dom.pack(c, CPU)
    assert dom.unpack(dom.lagrange_to_coeff(dom.coeff_to_lagrange(C))) == c
    ext = dom.coeff_to_extended(C)
    assert dom.unpack(dom.extended_to_coeff(ext)) == c + [0] * (dom.n_ext - n)
    # Z_H(X) q(X) = X^n q(X) - q(X): its coefficients, then its values
    zhq = [(-v) % p for v in q] + q + [0] * (dom.n_ext - 2 * n)
    back = dom.extended_to_coeff(dom.divide_by_vanishing(dom.coeff_to_extended(dom.pack(zhq, CPU))))
    assert dom.unpack(back) == q + [0] * (dom.n_ext - n)
    assert dom.eval_many_at(C[None], x) == [dom.eval_coeffs_host(c, x)]
    assert dom.unpack(dom.pows_dev(x, 7, device=CPU)) == [pow(x, i, p) for i in range(7)]
    vals = dom.unpack(ext)
    rot = dom.unpack(dom.rotate_ext(ext, 1))
    assert rot == vals[dom.ext_factor:] + vals[: dom.ext_factor]
    lag = [0] * n
    lag[0] = 1
    l0 = dom.eval_coeffs_host(dom.unpack(dom.lagrange_to_coeff(dom.pack(lag, CPU))), x)
    assert dom.l0_host(x) == l0
    pre = dom.unpack(dom.prefix_prod(C))
    acc, want_pre = 1, []
    for v in c:
        acc = acc * v % p
        want_pre.append(acc)
    assert pre == want_pre


def test_field_pow_eq_const_match_jax(want):
    assert field_outputs() == want["field"]


def test_pow_host_math_and_cache():
    """pow is square-and-multiply on mont_mul: the host's pow, and the
    exponent's bits cached by e."""
    df = DeviceField(FR_BN254)
    p = FR_BN254.p
    xs = api_values(6, 8)
    a = df.pack(xs, device=CPU)
    for e in (0, 1, 3, p - 2, (1 << 200) + 12345):
        assert df.unpack(df.pow(a, e)) == [pow(v, e, p) for v in xs]
    assert (p - 2) in df._pow_cache
    with pytest.raises(ValueError):
        df.pow(a, -1)


def test_commit_rejects_more_values_than_the_srs(params8):
    with pytest.raises(ValueError):
        params8.commit([1] * (params8.n + 1))


def test_new_ntt_plans_at_the_north_star_sizes():
    """2^22 is the four-step plan [2, 128, 128, 128] (the JAX ntt4 plan);
    2^20 in the radix-2 NTT is the stage loop (above ntt_small's 2^11)."""
    for log_n in (20, 22):
        assert _plan(1 << log_n) == jax_plan(1 << log_n)
    assert _plan(1 << 22) == [2, 128, 128, 128]
    assert (1 << 20) > cf.NTT_SMALL_MAX


@pytest.fixture(scope="module")
def params8():
    return ParamsKZG.read(os.path.join(ROOT, "params", f"kzg_bn254_{API_KZG_K}.srs"), device=CPU)


@pytest.fixture(scope="module")
def commits(params8):
    """The keys of make_goldens.api_digest's "kzg", by the port (host points)."""
    params = params8
    fr_df = DeviceField(FR_BN254)
    nk = params.n
    p1, p2 = api_values(11, nk), api_values(12, nk)
    return (p1, p2), {
        "commit": params.commit(p1),
        "commit_short": params.commit(p1[:100]),
        "commit_lagrange": params.commit_lagrange(p2),
        "commit_lagrange_short": params.commit_lagrange(p2[:37]),
        "commit_dev": params.commit_dev(fr_df.pack(p1[:200], device=CPU), fr_df),
        "commit_many": params.commit_many([p1[:64], p2]),
    }


def test_kzg_commits_match_jax(want, commits):
    got = {k: ([_hex_point(v) for v in val] if k == "commit_many" else _hex_point(val))
           for k, val in commits[1].items()}
    assert got == want["kzg"]


def test_kzg_commit_agrees_with_commit_columns(params8, commits):
    """commit / commit_lagrange (msm_device, the complete mixed add) and
    commit_columns (the prover's route, distinct bases) give one point; the
    packed bases are the affine lift of g."""
    from halo2_lib_tpu_torch.backend.kzg import host_points

    params = params8
    fr_df = DeviceField(FR_BN254)
    (p1, p2), got = commits
    cols = torch.stack([fr_df.pack(p1, device=CPU), fr_df.pack(p2, device=CPU)])
    assert host_points(params.commit_columns(fr_df, cols[:1], params.affine_bases())) == [got["commit"]]
    assert (host_points(params.commit_columns(fr_df, cols[1:], params.affine_lagrange_bases()))
            == [got["commit_lagrange"]])
    X, Y, Z = params.packed_bases()
    assert params.device_curve().unpack_points((X[:, :5], Y[:, :5], Z[:, :5])) == params.g[:5]


def test_commit_many_inside_and_packed_bases_match_jax(want, params8):
    """commit_many_inside (two coefficient columns of m = 200 < n points:
    the digits padded to n) against the JAX package's commit_dev and commit
    of the same values; packed_bases limb for limb the JAX package's, live
    (its pack_points of g: host packing, no compile)."""
    from halo2_lib_tpu.backend.kzg import ParamsKZG as JaxParams

    params = params8
    fr_df = DeviceField(FR_BN254)
    p1 = api_values(11, params.n)
    cols = torch.stack([fr_df.pack(p1[:200], device=CPU),
                        fr_df.pack(p1[:100] + [0] * 100, device=CPU)])
    got = params.device_curve().unpack_points(params.commit_many_inside(fr_df, cols, False))
    assert [_hex_point(v) for v in got] == [want["kzg"]["commit_dev"], want["kzg"]["commit_short"]]
    jax_params = JaxParams.read(os.path.join(ROOT, "params", f"kzg_bn254_{API_KZG_K}.srs"))
    for mine, theirs in zip(params.packed_bases(), jax_params.packed_bases()):
        assert np.array_equal(mine.numpy().astype(np.uint32), np.asarray(theirs))


@pytest.mark.parametrize("case", ["dup_64", "rand_37_4", "rand_128_8"])
def test_msm_matches_jax(want, case):
    """DeviceCurve.msm (host points and ints) against the JAX MSM; on the
    64-point case also msm_device called directly on the affine lift (Z in
    {0, R}, a Z = 0 base among them) and the method pack_scalars."""
    pts, sc, wb = api_msm_cases()[case]
    dc = DeviceCurve(DeviceField(BN254_G1.base), BN254_G1)
    if case != "dup_64":
        got = dc.unpack_points(dc.msm(pts, sc, wb, device=CPU))[0]
        assert _hex_point(got) == want["msm"][case]
        return
    P = dc.pack_points(pts, device=CPU)
    assert dc.df.is_zero(P[2]).tolist() == [pt is None for pt in pts]
    digits = dc.pack_scalars(sc, wb, device=CPU)
    assert torch.equal(digits, pack_scalars(dc, sc, wb, device=CPU))
    X, Y, Z = msm_device(dc, P, digits, wb)
    assert X.shape == Y.shape == Z.shape == (16, 1)
    assert _hex_point(dc.unpack_points((X, Y, Z))[0]) == want["msm"][case]


def test_device_defaults_raise_without_a_card(monkeypatch):
    """Each constructor and new entry point that makes a tensor targets the
    card by default: without one it raises; with device="cpu" it runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    df = DeviceField(FR_BN254)
    dc = DeviceCurve(DeviceField(BN254_G1.base), BN254_G1)
    dom = Domain(API_K, API_EXT)
    g = [BN254_G1.g]
    calls = {
        "DeviceField.pack": lambda **kw: df.pack([1, 2], **kw),
        "DeviceField.zero": lambda **kw: df.zero(4, **kw),
        "DeviceField.one_mont": lambda **kw: df.one_mont(4, **kw),
        "DeviceField.const": lambda **kw: df.const(9, 4, **kw),
        "DeviceCurve.pack_points": lambda **kw: dc.pack_points(g, **kw),
        "DeviceCurve.pack_points_affine": lambda **kw: dc.pack_points_affine(g, **kw),
        "DeviceCurve.identity": lambda **kw: dc.identity(4, **kw),
        "DeviceCurve.pack_scalars": lambda **kw: dc.pack_scalars([3], 8, **kw),
        "pack_scalars": lambda **kw: pack_scalars(dc, [3], 8, **kw),
        "DeviceCurve.msm": lambda **kw: dc.msm(g, [3], 8, **kw),
        "Domain.const_ext": lambda **kw: dom.const_ext(1, **kw),
        "Domain.const_h": lambda **kw: dom.const_h(1, **kw),
        "Domain.pows_dev": lambda **kw: dom.pows_dev(3, 4, **kw),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        out = call(device=CPU)
        first = out[0] if isinstance(out, tuple) else out
        assert first.device.type == "cpu", name


@pytest.mark.slow
def test_api_live_against_jax():
    """The whole frozen digest recomputed live by the JAX package (minutes of
    XLA:CPU compile for its device MSM) equals the port's outputs."""
    import sys

    sys.path.insert(0, os.path.join(HERE, "data", "torch_goldens"))
    import make_goldens

    live = make_goldens.api_digest()
    assert domain_outputs() == live["domain"]
    assert field_outputs() == live["field"]
    with open(os.path.join(HERE, "data", "torch_goldens", "api_digests.json")) as f:
        assert json.load(f) == json.loads(json.dumps(live))
