"""Freeze the JAX package's keys and proofs for the port's parity tests.

One-off script: it runs the JAX reference on the CPU and writes, next to
itself,

* ``golden_k9.npz`` and ``instance_k9.npz``: for the two k=9 circuits of
  ``halo2_lib_tpu_torch/utils/testing.py``, the verifying key's bytes and
  ``transcript_repr``, the proving key's host columns, its sigma tensor
  (``perm_values``) and the proof of seed 0;
* ``ntt_digests.json``: for log n = 1..10, the SHA-256 of the JAX NTT's
  forward, inverse, coset-forward and coset-inverse transforms of two
  columns made by ``ntt_inputs``;
* ``field_digests.json``: the SHA-256 of the JAX package's batch inversion
  (``DeviceField.batch_inv``) of the Fr values of ``field_values(11)``;
* ``ec_digests.json``: the SHA-256 of the JAX package's Jacobian complete
  add (``DeviceCurve._add_xla``) and double (``_double_xla``) on the points
  of ``ec_case_points``, every special case of the add included, and of its
  mixed add (``_madd_xla``, both ``distinct`` values) on ``madd_case_points``,
  and of the MSM tail of ``_msm_from_digits`` (window sums and combined
  result) on the bucket sums of ``msm_tail_case_points``, and of the bucket
  accumulation ``_bucket_sums`` (both ``distinct`` values) on the bases and
  window digits of ``bucket_sums_case``, and of the small-column commit
  (``commit_simple``: ``kzg.py``'s 254-step double-and-add scan and
  ``tree_reduce``, before ``pack_out``) on the columns of
  ``commit_simple_case``;
* ``multiphase_k9.npz`` and ``dynlookup_k9.npz`` (with ``--phases``, which
  freezes these two and nothing else): the same keys as ``golden_k9.npz``
  for the two k=9 circuits that exercise ``create_proof``'s ``phase_fns``
  (the RLC circuit of ``tests/test_multiphase.py``, its phase-1 witnesses
  made from the squeezed challenge) and the dynamic-lookup columns (the RAM
  circuit of ``tests/test_dyn_lookup.py`` at k=9), committed k=9 SRS, seed 0;
* ``slice_k15.json`` (with ``--k15``): the SHA-256 of the JAX proof of the
  k=15 slice circuit at seed 0, which ``chip_smoke.py`` compares with;
* ``ecdsa_k15.json`` (with ``--ecdsa``): the SHA-256 of the vk and of the
  seed-0 proof of the repo's secp256k1 ECDSA-verify bench circuit at k=15
  (``bench.py``: keygen builder, pinned prover builder, create_proof), and
  its column counts.

Run from the repository root:

    JAX_PLATFORMS=cpu python tests/data/torch_goldens/make_goldens.py [--k15] [--ecdsa] [--ops-only]
    JAX_PLATFORMS=cpu python tests/data/torch_goldens/make_goldens.py --phases

The circuits are built here with the JAX eDSL, step for step as the port's
``utils/testing.py`` builds them with its own copy (the ECDSA circuit with
``bench.py``'s own helpers). The ECDSA witness draws random points from the
JAX package's ``ecc/ec.py`` generator, so ``--ecdsa`` must build its two
circuits first in a fresh process: it runs before every other freeze.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, ROOT)

from halo2_lib_tpu.backend.keygen import keygen  # noqa: E402
from halo2_lib_tpu.backend.challenges import mock_challenge  # noqa: E402
from halo2_lib_tpu.backend.kzg import ParamsKZG  # noqa: E402
from halo2_lib_tpu.backend.prover import create_proof  # noqa: E402
from halo2_lib_tpu.backend.verifier import verify_proof  # noqa: E402
from halo2_lib_tpu.core.cells import Constant, Existing  # noqa: E402
from halo2_lib_tpu.core.dyn_lookup import BasicDynLookupManager  # noqa: E402
from halo2_lib_tpu.gates.circuit import BaseCircuitBuilder, CircuitBuilderStage  # noqa: E402
from halo2_lib_tpu.gates.flex_gate import GateChip  # noqa: E402
from halo2_lib_tpu.utils.fields import FR_BN254  # noqa: E402


def golden_circuit(x_val: int = 12345, k: int = 9):
    builder = BaseCircuitBuilder.from_stage(CircuitBuilderStage.MOCK).use_k(k)
    builder.set_lookup_bits(8)
    rc = builder.range_chip()
    gate = rc.gate
    ctx = builder.main(0)
    x = ctx.load_witness(x_val)
    y = gate.mul(ctx, Existing(x), Existing(x))
    z = gate.add(ctx, Existing(y), Constant(7))
    for _ in range(10):
        z = gate.mul_add(ctx, Existing(z), Existing(x), Constant(3))
    rc.range_check(ctx, z, 240)
    rc.check_less_than(ctx, Existing(x), Constant(1 << 40), 48)
    builder.calculate_params(minimum_rows=9)
    p = builder.config_params
    p.num_advice_per_phase[0] = max(p.num_advice_per_phase[0], 2)
    p.num_lookup_advice_per_phase[0] = max(p.num_lookup_advice_per_phase[0], 1)
    return builder


def instance_circuit(xv: int = 1234567, yv: int = 89, k: int = 9):
    builder = BaseCircuitBuilder.from_stage(CircuitBuilderStage.MOCK).use_k(k)
    builder.set_instance_columns(1)
    gate = GateChip(FR_BN254)
    ctx = builder.main(0)
    x = ctx.load_witness(xv)
    y = ctx.load_witness(yv)
    z = gate.mul(ctx, Existing(x), Existing(y))
    builder.assigned_instances[0].extend([x, z])
    builder.calculate_params(minimum_rows=9)
    builder.config_params.num_advice_per_phase[0] = max(
        builder.config_params.num_advice_per_phase[0], 1
    )
    return builder, [[xv, xv * yv % FR_BN254.p]]


def slice_circuit(k: int = 15, iters: int = 7000, seed: int = 0):
    rng = random.Random(repr(("slice-circuit", seed)))
    lookup_bits = k - 1
    builder = BaseCircuitBuilder.from_stage(CircuitBuilderStage.MOCK).use_k(k)
    builder.set_lookup_bits(lookup_bits)
    rc = builder.range_chip()
    gate = rc.gate
    ctx = builder.main(0)
    z = ctx.load_witness(rng.randrange(1 << 56))
    for _ in range(iters):
        a = ctx.load_witness(rng.randrange(1 << 56))
        rc.range_check(ctx, a, 4 * lookup_bits)
        z = gate.mul_add(ctx, Existing(z), Existing(a), Constant(3))
    builder.calculate_params(minimum_rows=9)
    return builder


RLC_VALS = [3, 1415926, 535897, 93238462]


def rlc_phase1(builder, gate, vals, challenge: int):
    """Phase-1 witnesses of the RLC circuit: pin the challenge, then fold
    vals by Horner (tests/test_multiphase.py:_rlc_phase1)."""
    ctx1 = builder.main(1)
    ch = ctx1.load_witness(challenge)
    builder.constrain_challenge(ch, 0)
    acc = vals[0]
    for v in vals[1:]:
        acc = gate.mul_add(ctx1, acc, ch, v)
    return acc


def rlc_circuit(k: int = 9):
    """The two-phase RLC circuit on a MOCK builder, its phase 1 made with the
    mock challenge (tests/test_multiphase.py:_build and _keygen)."""
    builder = BaseCircuitBuilder.from_stage(CircuitBuilderStage.MOCK).use_k(k)
    gate = GateChip(FR_BN254)
    ctx0 = builder.main(0)
    vs = [ctx0.load_witness(v) for v in RLC_VALS]
    rlc_phase1(builder, gate, vs, mock_challenge(0))
    builder.calculate_params(minimum_rows=9)
    return builder


def rlc_prover(pk, break_points):
    """The prover builder with the phase-0 witnesses, and the phase_fns that
    add phase 1 from the challenge create_proof squeezes."""
    pb = BaseCircuitBuilder.prover(pk.config_params, break_points)
    gate = GateChip(FR_BN254)
    ctx0 = pb.main(0)
    vs = [ctx0.load_witness(v) for v in RLC_VALS]

    def phase1(b, chals):
        rlc_phase1(b, gate, vs, chals[0])

    return pb, {1: phase1}


def ram_circuit(k: int = 9):
    """The RAM circuit of tests/test_dyn_lookup.py:build_ram_circuit: 64
    (index, value) table rows and 32 reads through a dynamic lookup with
    key_col=2, at >= 2 advice columns (test_ram_real_prover_roundtrip)."""
    rng = random.Random(81)
    memory = [rng.randrange(1 << 64) for _ in range(64)]
    reads = [rng.randrange(64) for _ in range(32)]
    builder = BaseCircuitBuilder.from_stage(CircuitBuilderStage.MOCK).use_k(k)
    mgr = BasicDynLookupManager(key_col=2)
    builder.dyn_lookup_manager = mgr
    ctx = builder.main(0)
    for idx, val in enumerate(memory):
        mgr.sets[0].add_table_row((ctx.load_witness(idx), ctx.load_witness(val)))
    for r in reads:
        mgr.sets[0].add_lookup((ctx.load_witness(r), ctx.load_witness(memory[r])))
    builder.calculate_params(minimum_rows=9)
    p = builder.config_params
    p.num_advice_per_phase[0] = max(p.num_advice_per_phase[0], 2)
    return builder


def ntt_inputs(log_n: int, cols: int = 2) -> list[list[int]]:
    """`cols` columns of 2^log_n canonical Fr elements from a numpy seed
    (tests/test_torch_ntt.py makes the same ones)."""
    rng = np.random.default_rng(1000 + log_n)
    words = rng.integers(0, 1 << 63, size=(cols, 1 << log_n, 4), dtype=np.int64)
    p = FR_BN254.p
    return [
        [sum(int(w) << (63 * i) for i, w in enumerate(el)) % p for el in col] for col in words
    ]


def freeze_ntt() -> None:
    import jax.numpy as jnp

    from halo2_lib_tpu.ops.limbs import DeviceField
    from halo2_lib_tpu.ops.ntt import NTT, CosetNTT

    df = DeviceField(FR_BN254)
    out = {}
    for log_n in range(1, 11):
        cols = ntt_inputs(log_n)
        x = jnp.stack([df.pack(c) for c in cols])  # [2, 16, n] Montgomery
        ntt, coset = NTT(df, log_n), CosetNTT(df, log_n, 7)
        res = {
            "forward": ntt.forward(x),
            "inverse": ntt.inverse(x),
            "coset_forward": coset.forward(x),
            "coset_inverse": coset.inverse(x),
        }
        out[str(log_n)] = {
            k: hashlib.sha256(np.asarray(v).astype("<u4").tobytes()).hexdigest()
            for k, v in res.items()
        }
    with open(os.path.join(HERE, "ntt_digests.json"), "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print("ntt_digests: log n = 1..10", flush=True)


def field_values(seed: int, lanes: int = 72) -> list[int]:
    """64 random canonical Fr values, then 0, p-1, R mod p and 1 twice
    (tests/test_torch_field.py makes the same ones)."""
    p = FR_BN254.p
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 62, size=(lanes - 8, 5), dtype=np.int64)
    rand = [sum(int(w) << (62 * i) for i, w in enumerate(row)) % p for row in words]
    edges = [0, p - 1, (1 << 256) % p, 1]
    return rand + edges + edges[::-1]


def freeze_field() -> None:
    from halo2_lib_tpu.ops.limbs import DeviceField

    df = DeviceField(FR_BN254)
    out = df.batch_inv(df.pack(field_values(11)))
    digest = hashlib.sha256(np.asarray(out).astype("<u4").tobytes()).hexdigest()
    with open(os.path.join(HERE, "field_digests.json"), "w") as f:
        json.dump({"batch_inv_fr": digest}, f, indent=1)
        f.write("\n")
    print("field_digests", flush=True)


def ec_case_points():
    """(add pairs, double points) from fixed seeds; tests/test_torch_ec.py
    makes the same ones with the port's copy of utils/curves.py."""
    from halo2_lib_tpu.utils.curves import BN254_G1

    rng = random.Random(7)
    pts1 = [BN254_G1.random_point(rng) for _ in range(16)]
    pts2 = [BN254_G1.random_point(rng) for _ in range(16)]
    pts1[0] = None  # O + Q
    pts2[1] = None  # P + O
    pts1[2] = pts2[2] = None  # O + O
    pts2[3] = pts1[3]  # P + P: the doubling branch
    x, y = pts1[4]
    pts2[4] = (x, BN254_G1.base.p - y)  # P + (-P) = O
    rng = random.Random(9)
    dbl = [BN254_G1.random_point(rng) for _ in range(15)] + [None]
    return pts1, pts2, dbl


def freeze_ec() -> None:
    import jax

    from halo2_lib_tpu.ops.ec_device import DeviceCurve
    from halo2_lib_tpu.ops.limbs import DeviceField
    from halo2_lib_tpu.utils.curves import BN254_G1

    dc = DeviceCurve(DeviceField(BN254_G1.base), BN254_G1)
    pts1, pts2, dbl = ec_case_points()
    digest = lambda P: hashlib.sha256(np.stack([np.asarray(t) for t in P]).astype("<u4").tobytes()).hexdigest()
    out = {
        "add": digest(jax.jit(dc._add_xla)(dc.pack_points(pts1), dc.pack_points(pts2))),
        "double": digest(jax.jit(dc._double_xla)(dc.pack_points(dbl))),
    }
    acc, base = madd_case_points()
    P1 = tuple(dc.df.pack(c) for c in acc)
    A2 = tuple(dc.df.pack(c) for c in base)
    for key, distinct in (("madd", False), ("madd_distinct", True)):
        out[key] = digest(jax.jit(dc._madd_xla, static_argnums=2)(P1, A2, distinct))
    out.update(msm_tail_digests(dc, digest))
    out.update(bucket_sums_digests(dc, digest))
    out.update(commit_simple_digest())
    with open(os.path.join(HERE, "ec_digests.json"), "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print("ec_digests", flush=True)


def msm_tail_case_points():
    """Bucket sums for the MSM tail digests: C = 3 columns x W = 3 windows of
    c = 8 bits (255 buckets; 64 weight lanes of 4 rows), as (C, W, c, host
    points [C * W][255] with None = empty, Jacobian (X, Y, Z) int lists with
    a random Z per point, window w of column i at row i * W + w) from a fixed
    seed. About a fifth of the buckets are empty. Window 0's lanes 0-2 meet
    the row chain's special cases (acc + row doubles, tot + acc doubles, acc +
    row = P + (-P)); window 1 holds one point in each of lanes 0-3, so the
    suffix scan's first level adds P + (-P) and P + P.
    tests/test_torch_msm_tail.py makes the same ones."""
    from halo2_lib_tpu.utils.curves import BN254_G1

    q = BN254_G1.base.p
    C, W, c = 3, 3, 8
    nb = (1 << c) - 1
    rng = random.Random(21)
    pool = [BN254_G1.random_point(rng) for _ in range(12)]
    pts = [
        [None if rng.random() < 0.2 else rng.choice(pool) for _ in range(nb)] for _ in range(C * W)
    ]
    P = pool[0]
    nP = (P[0], q - P[1])
    # lane l's slot in the top row (192 + l), then the one below it
    for l, (a, b) in enumerate([(P, P), (P, None), (P, nP)]):
        pts[0][192 + l], pts[0][128 + l] = a, b
    pts[1] = [None] * nb
    for l, a in enumerate([P, nP, P, P]):
        pts[1][192 + l] = a
    jac = []
    for pt in (p for w in pts for p in w):
        z = rng.randrange(1, q)
        jac.append((0, 0, 0) if pt is None else (pt[0] * z * z % q, pt[1] * z**3 % q, z))
    return C, W, c, pts, [list(v) for v in zip(*jac)]


def msm_tail_digests(dc, digest) -> dict:
    """The JAX MSM's tail (_msm_from_digits after its bucket accumulation:
    the merged-lane weighted bucket reduction and the MSB-first window
    combine) on the bucket sums of msm_tail_case_points, given to it in place
    of _bucket_sums' output. ``msm_tail_window_sums``: the window sums T
    [16, C * W], read as the combine of C * W one-window columns (c doublings
    of the identity, then + T_w, which is T_w); ``msm_tail``: the combined
    [16, C] result."""
    import jax.numpy as jnp

    from halo2_lib_tpu.ops import ec_device as jed

    C, W, c, _, jac = msm_tail_case_points()
    nb = (1 << c) - 1
    S = tuple(jnp.transpose(dc.df.pack(v).reshape(16, C * W, nb), (1, 0, 2)) for v in jac)
    real = jed._bucket_sums
    jed._bucket_sums = lambda *args: S
    try:
        n = 8
        T = jed._msm_from_digits(dc, None, jnp.zeros((C * W, 1, n), jnp.int32), c, False)
        res = jed._msm_from_digits(dc, None, jnp.zeros((C, W, n), jnp.int32), c, False)
    finally:
        jed._bucket_sums = real
    return {"msm_tail_window_sums": digest(T), "msm_tail": digest(res)}


def bucket_sums_case():
    """Bases and window digits for the bucket-accumulation digests: n = 512
    affine bases (host points, None = identity) and Wtot = 5 windows of c = 6
    bits (63 buckets), as (c, bases, digits [Wtot][n]) from a fixed seed. At
    n = 512 the JAX package scans 128 lanes of 4 slots. Window 0: random
    digits; 1: one bucket fills the window; 2: every digit 0 (dead); 3: no
    digit below 3 and one run of 300 slots (across 75 lanes), the rest
    sparse; 4: bases 1 and 2 (P, -P) share a bucket, bases 10 and 11 (equal
    points) share another (the mixed add's doubling branch unless
    `distinct`), base 5 is the identity. tests/test_torch_bucket_sums.py
    makes the same ones."""
    from halo2_lib_tpu.utils.curves import BN254_G1

    q = BN254_G1.base.p
    rng = random.Random(33)
    n, c = 512, 6
    pool = [BN254_G1.random_point(rng) for _ in range(24)]
    bases = [rng.choice(pool) for _ in range(n)]
    P = pool[0]
    bases[1], bases[2] = P, (P[0], q - P[1])
    bases[10] = bases[11] = pool[1]
    bases[5] = None
    nb = (1 << c) - 1
    w0 = [rng.randrange(nb + 1) for _ in range(n)]
    w1 = [37] * n
    w2 = [0] * n
    w3 = [rng.choice([3, 9, 40, 41, 63]) for _ in range(n)]
    for i in range(100, 400):
        w3[i] = 5
    w4 = [rng.randrange(nb + 1) for _ in range(n)]
    w4[1] = w4[2] = 20
    w4[10] = w4[11] = 21
    for i in range(n):
        if i not in (1, 2, 10, 11) and w4[i] in (20, 21):
            w4[i] = 22
    return c, bases, [w0, w1, w2, w3, w4]


def bucket_sums_digests(dc, digest) -> dict:
    """The JAX package's bucket accumulation (_bucket_sums, the sort of
    _msm_from_digits before it) on bucket_sums_case: ``bucket_sums`` and
    ``bucket_sums_distinct``, the (X, Y, Z) [Wtot, 16, 63] sums."""
    import jax.numpy as jnp

    from halo2_lib_tpu.ops import ec_device as jed

    c, bases, digits = bucket_sums_case()
    A = tuple(dc.df.pack([0 if pt is None else pt[i] for pt in bases]) for i in (0, 1))
    flat = jnp.asarray(np.array(digits, dtype=np.int32))
    order = jnp.argsort(flat, axis=1)
    d_sorted = jnp.take_along_axis(flat, order, axis=1)
    out = {}
    for key, distinct in (("bucket_sums", False), ("bucket_sums_distinct", True)):
        out[key] = digest(jed._bucket_sums(dc, A, order, d_sorted, (1 << c) - 1, distinct))
    return out


def commit_simple_case() -> list[list[int]]:
    """C = 3 columns of 16 Fr scalars from a fixed seed: random, with 0, 1
    and r - 1 at lanes 0-2 of column 1 and r - 1, 0, 1 at lanes 10-12 of
    column 2. The digest commits them at m = 16 and at their first 13 lanes
    (an odd tree). tests/test_torch_commit.py makes the same ones."""
    r = FR_BN254.p
    rng = np.random.default_rng(41)
    cols = []
    for _ in range(3):
        words = rng.integers(0, 1 << 62, size=(16, 5), dtype=np.int64)
        cols.append([sum(int(w) << (62 * i) for i, w in enumerate(row)) % r for row in words])
    cols[1][:3] = [0, 1, r - 1]
    cols[2][10:13] = [r - 1, 0, 1]
    return cols


def commit_simple_digest() -> dict:
    """The JAX package's small-column commit (the body of
    ParamsKZG._commit_chunk_jit for m <= COMMIT_SIMPLE_MAX, kzg.py:499-519,
    up to its pack_out: one-bit window digits reversed to MSB first, a
    lax.scan of _double, _madd (distinct=False) and select, then
    tree_reduce) against the k=8 SRS Lagrange bases, at m = 16 and m = 13:
    ``commit_simple``, the SHA-256 of the two (X, Y, Z) [3, 16, C] results
    one after the other."""
    import jax
    import jax.numpy as jnp

    from halo2_lib_tpu.backend.kzg import window_digits
    from halo2_lib_tpu.ops.limbs import DeviceField

    params = ParamsKZG.read(os.path.join(ROOT, "params", "kzg_bn254_8.srs"))
    dc = params.device_curve()
    fr_df = DeviceField(FR_BN254)
    Ax, Ay = params.affine_lagrange_bases()
    vals = jnp.stack([fr_df.pack(c) for c in commit_simple_case()])  # [3, 16, 16]

    def small(chunk, Ax, Ay):
        b, _, m = chunk.shape
        Am = tuple(jnp.broadcast_to(t[:, :m][None], (b, 16, m)) for t in (Ax, Ay))
        bits = window_digits(fr_df, chunk, 1)[:, ::-1, :]
        xs = bits.transpose(1, 0, 2).astype(bool)

        def step(acc, brow):
            acc = dc._double(acc)
            return dc.select(brow, dc._madd(acc, Am, False), acc), None

        acc, _ = jax.lax.scan(step, dc.identity((b, m)), xs)
        return tuple(jnp.swapaxes(t[..., 0], 0, 1) for t in dc.tree_reduce(acc))

    outs = []
    for m in (16, 13):
        P = jax.jit(small)(vals[:, :, :m], Ax, Ay)
        outs.append(np.stack([np.asarray(t) for t in P]).astype("<u4").tobytes())
    return {"commit_simple": hashlib.sha256(b"".join(outs)).hexdigest()}


def madd_case_points():
    """(Jacobian accumulators as (X, Y, Z) int lists, affine bases as (x, y)
    int lists with (0, 0) = identity) from a fixed seed; lane 0: identity
    accumulator, 1: identity base, 2: both, 3: base == accumulator (the
    doubling branch), 4: base == -accumulator. Every accumulator has a random
    Z. tests/test_torch_ec.py makes the same ones."""
    from halo2_lib_tpu.utils.curves import BN254_G1

    q = BN254_G1.base.p
    rng = random.Random(13)
    acc = [BN254_G1.random_point(rng) for _ in range(16)]
    base = [BN254_G1.random_point(rng) for _ in range(16)]
    acc[0] = None
    base[1] = None
    acc[2] = base[2] = None
    base[3] = acc[3]
    base[4] = (acc[4][0], q - acc[4][1])
    jac = []
    for pt in acc:
        z = rng.randrange(1, q)
        jac.append((0, 0, 0) if pt is None else (pt[0] * z * z % q, pt[1] * z**3 % q, z))
    aff = [(0, 0) if pt is None else pt for pt in base]
    return [list(c) for c in zip(*jac)], [list(c) for c in zip(*aff)]


def freeze_ecdsa() -> None:
    """The bench flow of bench.py at k=15 (without the pipeline): keygen on
    the MOCK builder, then witness generation on the pinned prover builder
    and create_proof at seed 0."""
    from bench import build_ecdsa_builder, ecdsa_test_inputs, ecdsa_witness
    from halo2_lib_tpu.utils.pinning import pinning_of

    t = time.time()
    params15 = ParamsKZG.read(os.path.join(ROOT, "params", "kzg_bn254_15.srs"))
    builder = build_ecdsa_builder(15, 14)
    pk = keygen(params15, builder)
    cp = builder.config_params
    pb = pinning_of(builder).prover_builder()
    ecdsa_witness(pb, ecdsa_test_inputs())
    proof = create_proof(params15, pk, pb, seed=0)
    assert verify_proof(params15, pk.vk, proof)
    out = {
        "k": 15,
        "lookup_bits": cp.lookup_bits,
        "seed": 0,
        "proof_sha256": hashlib.sha256(proof).hexdigest(),
        "proof_bytes": len(proof),
        "vk_sha256": hashlib.sha256(pk.vk.to_bytes()).hexdigest(),
        "num_advice_per_phase": list(cp.num_advice_per_phase),
        "num_lookup_advice_per_phase": list(cp.num_lookup_advice_per_phase),
        "num_fixed": cp.num_fixed,
    }
    with open(os.path.join(HERE, "ecdsa_k15.json"), "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(f"ecdsa_k15: {out} {time.time() - t:.1f}s", flush=True)


def limbs16(cols, n: int) -> np.ndarray:
    """Int columns -> uint16[C, n, 16] little-endian limbs."""
    out = np.zeros((len(cols), n, 16), dtype=np.uint16)
    for c, col in enumerate(cols):
        buf = b"".join(int(v).to_bytes(32, "little") for v in col)
        out[c, : len(col)] = np.frombuffer(buf, dtype="<u2").reshape(len(col), 16)
    return out


def freeze(name: str, builder, instances, params, prover=None) -> None:
    """Keygen on `builder`, then the seed-0 proof: of `builder` itself, or,
    with `prover(pk, break_points) -> (prover builder, phase_fns)`, of the
    builder and phase closures it returns."""
    t = time.time()
    pk = keygen(params, builder)
    if prover is None:
        proof = create_proof(params, pk, builder, instances=instances, seed=0)
    else:
        pb, phase_fns = prover(pk, builder.break_points())
        proof = create_proof(params, pk, pb, instances=instances, seed=0, phase_fns=phase_fns)
    assert verify_proof(params, pk.vk, proof, instances)
    n = 1 << pk.vk.k
    d = {
        "vk": np.frombuffer(pk.vk.to_bytes(), dtype=np.uint8),
        "transcript_repr": np.frombuffer(
            pk.vk.transcript_repr().to_bytes(32, "little"), dtype=np.uint8
        ),
        "selectors": np.asarray(pk.selectors, dtype=np.uint8).reshape(-1, n),
        "fixed_cols": limbs16(pk.fixed_cols, n),
        "dynen_cols": limbs16(pk.dynen_cols, n),
        "perm_values": np.asarray(pk.perm_values).astype(np.uint16),
        "proof": np.frombuffer(proof, dtype=np.uint8),
        "instances": limbs16(instances or [], n),
    }
    if pk.table_col is not None:
        d["table_col"] = limbs16([pk.table_col], n)[0]
    if pk.q_lookup_col is not None:
        d["q_lookup_col"] = limbs16([pk.q_lookup_col], n)[0]
    np.savez_compressed(os.path.join(HERE, f"{name}.npz"), **d)
    print(f"{name}: proof {len(proof)} bytes, {time.time() - t:.1f}s", flush=True)


def main() -> None:
    if "--phases" in sys.argv:
        params9 = ParamsKZG.read(os.path.join(ROOT, "params", "kzg_bn254_9.srs"))
        freeze("multiphase_k9", rlc_circuit(), None, params9, rlc_prover)
        freeze("dynlookup_k9", ram_circuit(), None, params9)
        return
    if "--ecdsa" in sys.argv:
        freeze_ecdsa()
    freeze_field()
    freeze_ntt()
    freeze_ec()
    if "--ops-only" in sys.argv:
        return
    params9 = ParamsKZG.read(os.path.join(ROOT, "params", "kzg_bn254_9.srs"))
    freeze("golden_k9", golden_circuit(), None, params9)
    builder, inst = instance_circuit()
    freeze("instance_k9", builder, inst, params9)
    if "--k15" in sys.argv:
        t = time.time()
        params15 = ParamsKZG.read(os.path.join(ROOT, "params", "kzg_bn254_15.srs"))
        builder = slice_circuit()
        pk = keygen(params15, builder)
        proof = create_proof(params15, pk, builder, seed=0)
        assert verify_proof(params15, pk.vk, proof)
        out = {
            "k": 15,
            "seed": 0,
            "proof_sha256": hashlib.sha256(proof).hexdigest(),
            "proof_bytes": len(proof),
            "vk_sha256": hashlib.sha256(pk.vk.to_bytes()).hexdigest(),
        }
        with open(os.path.join(HERE, "slice_k15.json"), "w") as f:
            json.dump(out, f, indent=1)
            f.write("\n")
        print(f"slice_k15: {out} {time.time() - t:.1f}s", flush=True)


if __name__ == "__main__":
    main()
