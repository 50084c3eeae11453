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
  its column counts;
* ``ntt_digests_large.json`` (with ``--large``, which freezes this and
  nothing else): the digests of ``ntt_digests.json`` at log n = 19 and 21
  (the k=19 prover's domain and extended domain), two columns made by
  ``ntt_inputs``;
* ``pairing_k19.json`` (with ``--pairing``, which freezes this and nothing
  else): the SHA-256 of the k=19 SRS bytes (the JAX ``ParamsKZG`` of
  ``host_srs``: the reference tau, points by host arithmetic), the column
  counts of the BN254 pairing circuit at ``configs/bn254/pairing_circuit.config``
  (built as ``pairing_circuit`` below), and the SHA-256 of its vk and of its
  seed-0 proof (keygen builder, pinned prover builder, create_proof),
  written after each stage with what is known so far. A full-size run:
  hours of CPU.
* ``mxu_digests.json`` (with ``--mxu``, which freezes this and nothing
  else): the SHA-256 of the JAX MXU NTT (``ops/ntt_mxu.py`` ``MxuNTT._body``
  under one jit) forward, inverse, coset-forward and coset-inverse (shift 7,
  scaled as ``ntt_digests.json``'s) at log n = 6, 7, 9 and 11 on
  ``ntt_inputs``; both directions on 3 columns at log n = 7
  (``batched_7``) and through the forced outer split k1 = 3, k2 = 5 at log
  n = 8 (``split_8``); ``_stage_limbs`` alone (``stage``) on
  ``mxu_stage_case``; ``_fold_mod_p`` alone (``fold``) on
  ``mxu_fold_case``'s column sums at their 2^29 bound. About 4 minutes.
* ``poseidon_k9.npz`` (with ``--poseidon``, which freezes this and nothing
  else): the keys of ``golden_k9.npz`` for the k=9 Poseidon + SafeTypes
  circuit (``poseidon_circuit`` below: a fixed-length hash of 32 bytes, a
  variable-length hash, a SafeBool and a SafeByte), keygen on
  ``poseidon_inputs(1)``, the seed-0 proof of the pinned prover builder on
  ``poseidon_inputs(2)``, as ``base_test().bench_builder`` runs them, and
  ``circuit_sha256``, the digest of the keygen builder's synthesized
  circuit (``circuit_digest``).

* ``msm_digests.json`` (with ``--msm [cases] [t_config] [full]``, which
  freezes the parts named, all three by default, keeps the others and
  nothing else): the MSM gadget cases of ``MSM_CASES`` (config params,
  break points, result, ``circuit_digests``), the reference's MSM circuit
  at ``configs/bn254/msm_circuit.t.config`` (those, its SRS by
  ``host_srs(13)``, vk and seed-0 proof digests; about an hour of CPU and
  20 GB, the stages after the grand products run op by op) and at ``msm_circuit.config``
  (k=17: those and its SRS; its JAX keygen passed 24 GB of RSS in its
  commit stage and is left to a host with 64 GB or more to spare), each
  built after reseeding the JAX ``ecc/ec.py`` generator to
  ``MSM_RNG_SEED``; rewritten after each stage.

* ``api_digests.json`` (with ``--api``, which freezes this and nothing
  else): the JAX package's standalone device API on ``api_values`` inputs
  (``api_digest`` below): every ``backend/poly.py`` ``Domain`` method at
  k = 4, extension 4; ``DeviceField.pow``, ``eq`` and ``const``;
  ``ParamsKZG.commit``, ``commit_lagrange``, ``commit_dev`` and
  ``commit_many`` against the committed k=8 SRS; ``DeviceCurve.msm`` (and
  so ``msm_device``) on ``api_msm_cases``. Tensors as SHA-256 of their
  uint32 limbs, host ints and points as hex; every MSM is held to the host
  curve before it is written. About 20 minutes (XLA:CPU compiles of the
  device MSM).

Run from the repository root:

    JAX_PLATFORMS=cpu python tests/data/torch_goldens/make_goldens.py [--k15] [--ecdsa] [--ops-only]
    JAX_PLATFORMS=cpu python tests/data/torch_goldens/make_goldens.py --phases
    JAX_PLATFORMS=cpu python tests/data/torch_goldens/make_goldens.py --large
    JAX_PLATFORMS=cpu python tests/data/torch_goldens/make_goldens.py --pairing
    JAX_PLATFORMS=cpu python tests/data/torch_goldens/make_goldens.py --poseidon
    JAX_PLATFORMS=cpu python tests/data/torch_goldens/make_goldens.py --mxu
    JAX_PLATFORMS=cpu python tests/data/torch_goldens/make_goldens.py --msm [cases] [t_config] [full]
    JAX_PLATFORMS=cpu python tests/data/torch_goldens/make_goldens.py --api

The circuits are built here with the JAX eDSL, step for step as the port's
``utils/testing.py`` builds them with its own copy (the ECDSA circuit with
``bench.py``'s own helpers). The ECDSA witness draws random points from the
JAX package's ``ecc/ec.py`` generator, so ``--ecdsa`` must build its two
circuits first in a fresh process: it runs before every other freeze.
"""

from __future__ import annotations

import contextlib
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


def freeze_ntt(log_ns=range(1, 11), name: str = "ntt_digests.json") -> None:
    """The JAX NTT's forward, inverse, coset-forward and coset-inverse
    (shift 7) SHA-256 at each log n. Each transform runs as one jit of the
    NTT's body on the two columns, without the chunk padding of
    forward/inverse (the same values; a quarter of the memory at 2^21)."""
    import jax
    import jax.numpy as jnp

    from halo2_lib_tpu.ops.limbs import DeviceField
    from halo2_lib_tpu.ops.ntt import NTT, CosetNTT

    df = DeviceField(FR_BN254)
    out = {}
    for log_n in log_ns:
        t = time.time()
        cols = ntt_inputs(log_n)
        x = jnp.stack([df.pack(c) for c in cols])  # [2, 16, n] Montgomery
        ntt, coset = NTT(df, log_n), CosetNTT(df, log_n, 7)
        fns = {
            "forward": lambda c: ntt._body(c, True),
            "inverse": lambda c: ntt._body(c, False),
            "coset_forward": lambda c: coset.ntt._body(df._mont_mul(c, coset.shift_pows), True),
            "coset_inverse": lambda c: df._mont_mul(coset.ntt._body(c, False), coset.shift_inv_pows),
        }
        out[str(log_n)] = {
            k: hashlib.sha256(np.asarray(jax.jit(fn)(x)).astype("<u4").tobytes()).hexdigest()
            for k, fn in fns.items()
        }
        print(f"{name}: log n = {log_n} {time.time() - t:.1f}s", flush=True)
    with open(os.path.join(HERE, name), "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")


def mxu_stage_case() -> np.ndarray:
    """uint32 [16, 64, 32] limbs of canonical Fr values for ``_stage_limbs``
    alone: random, then 0, 1, p - 1 and 2^253 - 1 (every limb 0xffff but the
    top one) in the first four columns of every row
    (tests/test_torch_ntt_mxu.py makes the same ones)."""
    p = FR_BN254.p
    rng = np.random.default_rng(64)
    words = rng.integers(0, 1 << 63, size=(64, 32, 4), dtype=np.int64)
    vals = [[sum(int(w) << (63 * i) for i, w in enumerate(el)) % p for el in row] for row in words]
    for row in vals:
        row[:4] = [0, 1, p - 1, (1 << 253) - 1]
    flat = [v for row in vals for v in row]
    limbs = np.array([[(v >> (16 * j)) & 0xFFFF for v in flat] for j in range(16)], dtype=np.uint32)
    return limbs.reshape(16, 64, 32)


def mxu_fold_case() -> np.ndarray:
    """int32 [64, 32] product columns at the fold's bound: column c holds
    2^29 - 1 in every row for c < 8, random values below 2^29 for c < 28,
    and 0 / 2^29 - 1 in alternate rows for the last four
    (tests/test_torch_ntt_mxu.py makes the same ones)."""
    rng = np.random.default_rng(29)
    cols = rng.integers(0, 1 << 29, size=(64, 32), dtype=np.int64)
    cols[:, :8] = (1 << 29) - 1
    cols[:, 28:] = 0
    cols[::2, 28:] = (1 << 29) - 1
    return cols.astype(np.int32)


def freeze_mxu() -> None:
    """The JAX MXU NTT's digests (``mxu_digests.json``, see the module
    docstring). Each transform runs as one jit of ``MxuNTT._body``, as
    ``freeze_ntt`` runs the Stockham NTT's."""
    import jax
    import jax.numpy as jnp

    from halo2_lib_tpu.ops.limbs import DeviceField
    from halo2_lib_tpu.ops.ntt import CosetNTT
    from halo2_lib_tpu.ops.ntt_mxu import MxuNTT, _dft_planes, _fold_mod_p, _stage_limbs

    df = DeviceField(FR_BN254)

    def digest(a) -> str:
        return hashlib.sha256(np.asarray(a).astype("<u4").tobytes()).hexdigest()

    def both(mxu, x) -> dict:
        return {"forward": digest(jax.jit(lambda c: mxu._body(c, True))(x)),
                "inverse": digest(jax.jit(lambda c: mxu._body(c, False))(x))}

    out = {}
    for log_n in (6, 7, 9, 11):
        t = time.time()
        x = jnp.stack([df.pack(c) for c in ntt_inputs(log_n)])
        mxu, coset = MxuNTT(df, log_n), CosetNTT(df, log_n, 7)
        out[str(log_n)] = {
            **both(mxu, x),
            "coset_forward": digest(jax.jit(
                lambda c: mxu._body(df._mont_mul(c, coset.shift_pows), True))(x)),
            "coset_inverse": digest(jax.jit(
                lambda c: df._mont_mul(mxu._body(c, False), coset.shift_inv_pows))(x)),
        }
        print(f"mxu_digests: log n = {log_n} {time.time() - t:.1f}s", flush=True)
    out["batched_7"] = both(MxuNTT(df, 7), jnp.stack([df.pack(c) for c in ntt_inputs(7, 3)]))
    # the outer four-step level over two MXU bases (the log n > 16 path),
    # forced at log n = 8 as tests/test_ntt_mxu.py:53-80 builds it
    ref = MxuNTT(df, 8)
    forced = MxuNTT.__new__(MxuNTT)
    forced.__dict__.update({k: getattr(ref, k) for k in
                            ("df", "log_n", "n", "omega", "omega_inv", "n_inv", "n_inv_mont")})
    forced.k1, forced.k2 = 3, 5
    forced.sub = (MxuNTT(df, 3), MxuNTT(df, 5))
    forced._tw = {}
    forced._consts(True)
    forced._consts(False)
    out["split_8"] = both(forced, jnp.stack([df.pack(c) for c in ntt_inputs(8)]))
    # one stage alone: the 64-point DFT planes of MxuNTT(11)'s first stage
    w = FR_BN254.nth_root_of_unity(11)
    planes = _dft_planes(FR_BN254.p, pow(w, 32, FR_BN254.p), 64)
    X = jnp.asarray(mxu_stage_case())
    out["stage"] = digest(jax.jit(lambda v: _stage_limbs(df, planes, v))(X))
    out["fold"] = digest(jax.jit(lambda c: _fold_mod_p(df, c))(jnp.asarray(mxu_fold_case())))
    with open(os.path.join(HERE, "mxu_digests.json"), "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print("mxu_digests.json written", flush=True)


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


PAIRING_K, PAIRING_LOOKUP_BITS = 19, 18  # configs/bn254/pairing_circuit.config


def pairing_inputs(seed: int = 71):
    """(P, Q) of tests/test_pairing.py at seed 71: P a random G1 point, Q =
    s G2 with s < 2^40."""
    from halo2_lib_tpu.utils.curves import BN254_G1, BN254_G2

    rng = random.Random(seed)
    P = BN254_G1.random_point(rng)
    s = rng.randrange(1, 1 << 40)
    return P, BN254_G2.mul(BN254_G2.g, s)


def pairing_witness(builder, inputs):
    """tests/test_pairing.py:33-45 at limb_bits 90, 3 limbs."""
    from halo2_lib_tpu.ecc.fields_ext import Fp12Chip
    from halo2_lib_tpu.ecc.fp import FpChip
    from halo2_lib_tpu.ecc.pairing import PairingChip
    from halo2_lib_tpu.utils import bn254_pairing
    from halo2_lib_tpu.utils.fields import FQ_BN254

    P, Q = inputs
    fp_chip = FpChip(builder.range_chip(), 90, 3, FQ_BN254)
    chip = PairingChip(fp_chip)
    ctx = builder.main(0)
    p_a = chip.load_private_g1_unchecked(ctx, P)
    q_a = chip.load_private_g2_unchecked(ctx, Q)
    f = chip.pairing(ctx, q_a, p_a)
    assert Fp12Chip(fp_chip).get_fq12_value(f) == bn254_pairing.pairing(P, Q)
    return builder


def pairing_circuit(k: int = PAIRING_K, lookup_bits: int = PAIRING_LOOKUP_BITS):
    builder = BaseCircuitBuilder.from_stage(CircuitBuilderStage.MOCK).use_k(k)
    builder.set_lookup_bits(lookup_bits)
    pairing_witness(builder, pairing_inputs())
    builder.calculate_params(minimum_rows=9)
    return builder


SRS_WINDOW = 8  # bits a window of host_srs's fixed-base tables


def _fixed_base_tables():
    """T[w][d] = d * 2^(8w) G1 in affine form, d < 256, for 32 windows."""
    from halo2_lib_tpu.utils.curves import BN254_G1

    tables, base = [], BN254_G1.g
    for _ in range(256 // SRS_WINDOW):
        row = [None, base]
        for _ in range(2, 1 << SRS_WINDOW):
            row.append(BN254_G1.add(row[-1], base))
        tables.append(row)
        base = BN254_G1.add(row[-1], base)
    return tables


def _fixed_base_muls(scalars: list[int]) -> list:
    """[s * G1] in affine form (None for 0): per scalar one Jacobian mixed
    add (madd-2007-bl) of T[w][digit] per nonzero 8-bit window, then one
    inversion. No add meets equal or opposite points: the partial sum is
    below 2^(8w) G before window w adds at least 2^(8w) G, and every value
    stays below r but the whole scalar."""
    from halo2_lib_tpu.utils.fields import FQ_BN254

    q = FQ_BN254.p
    tables = _fixed_base_tables()
    mask = (1 << SRS_WINDOW) - 1
    out = []
    for sc in scalars:
        acc = None
        for w, row in enumerate(tables):
            d = (sc >> (SRS_WINDOW * w)) & mask
            if not d:
                continue
            x2, y2 = row[d]
            if acc is None:
                acc = (x2, y2, 1)
                continue
            X1, Y1, Z1 = acc
            zz = Z1 * Z1 % q
            h = (x2 * zz - X1) % q
            hh = h * h % q
            i4 = 4 * hh % q
            j = h * i4 % q
            rr = 2 * (y2 * Z1 * zz - Y1) % q
            v = X1 * i4 % q
            X3 = (rr * rr - j - 2 * v) % q
            acc = (X3, (rr * (v - X3) - 2 * Y1 * j) % q, ((Z1 + h) * (Z1 + h) - zz - hh) % q)
        if acc is None:
            out.append(None)
            continue
        zi = pow(acc[2], -1, q)
        zi2 = zi * zi % q
        out.append((acc[0] * zi2 % q, acc[1] * zi2 * zi % q))
    return out


def host_srs(k: int, procs: int = 4):
    """The JAX package's ParamsKZG for k with the reference tau, its points
    made by host arithmetic: tau^i and the JAX package's own L_i(tau), each
    times G1 by fixed-base windows in `procs` processes. Affine points are
    unique, so the bytes are those ParamsKZG.setup(k) makes; its device scan
    (`_batch_g1_mul`) takes hours on the CPU at k=19."""
    import multiprocessing

    from halo2_lib_tpu.backend.kzg import _lagrange_scalars
    from halo2_lib_tpu.utils.chacha import reference_srs_tau
    from halo2_lib_tpu.utils.curves import BN254_G1, BN254_G2

    r, n = FR_BN254.p, 1 << k
    tau = reference_srs_tau()
    scalars = [1] * n
    for i in range(1, n):
        scalars[i] = scalars[i - 1] * tau % r
    scalars += _lagrange_scalars(tau, k)
    step = -(-len(scalars) // (8 * procs))
    chunks = [scalars[i : i + step] for i in range(0, len(scalars), step)]
    with multiprocessing.get_context("spawn").Pool(procs) as pool:
        pts = [pt for part in pool.map(_fixed_base_muls, chunks) for pt in part]
    for i in (0, 1, 2, n - 1, n, 2 * n - 1):  # spot checks by the plain ladder
        assert pts[i] == BN254_G1.mul(BN254_G1.g, scalars[i]), i
    return ParamsKZG(k, pts[:n], pts[n:], BN254_G2.g, BN254_G2.mul(BN254_G2.g, tau))


def freeze_pairing() -> None:
    """The SRS, keygen and seed-0 proof of the pairing circuit at k=19 with
    the JAX package (its SRS from ``host_srs``, never written to params/;
    its first 2^15 points must be the committed k=15 file's).
    pairing_k19.json is rewritten after each stage with the digests known so
    far, so a run stopped before its end still leaves the SRS's and the vk's;
    the proof's are written only once it verifies."""
    import resource

    from halo2_lib_tpu.utils.pinning import pinning_of

    t = time.time()
    out = {"k": PAIRING_K, "lookup_bits": PAIRING_LOOKUP_BITS, "seed": 0}

    def stage(name: str, **found) -> None:
        out.update(found)
        with open(os.path.join(HERE, "pairing_k19.json"), "w") as f:
            json.dump(out, f, indent=1)
            f.write("\n")
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
        print(f"pairing_k19: {name} done at {time.time() - t:.1f}s, peak RSS {peak:.2f} GiB, "
              f"{found}", flush=True)

    params = host_srs(PAIRING_K)
    srs15 = ParamsKZG.read(os.path.join(ROOT, "params", "kzg_bn254_15.srs"))
    assert params.g[: 1 << 15] == srs15.g, "host SRS differs from params/kzg_bn254_15.srs"
    del srs15
    stage("setup", srs_sha256=hashlib.sha256(params.to_halo2_bytes()).hexdigest())
    builder = pairing_circuit()
    stage("MOCK witness")
    pk = keygen(params, builder)
    cp = builder.config_params
    stage(
        "keygen",
        vk_sha256=hashlib.sha256(pk.vk.to_bytes()).hexdigest(),
        num_advice_per_phase=list(cp.num_advice_per_phase),
        num_lookup_advice_per_phase=list(cp.num_lookup_advice_per_phase),
        num_fixed=cp.num_fixed,
    )
    pb = pairing_witness(pinning_of(builder).prover_builder(), pairing_inputs())
    stage("pinned witness")
    proof = create_proof(params, pk, pb, seed=0)
    stage("create_proof")
    assert verify_proof(params, pk.vk, proof)
    stage("verify_proof", proof_sha256=hashlib.sha256(proof).hexdigest(), proof_bytes=len(proof))


def limbs16(cols, n: int) -> np.ndarray:
    """Int columns -> uint16[C, n, 16] little-endian limbs."""
    out = np.zeros((len(cols), n, 16), dtype=np.uint16)
    for c, col in enumerate(cols):
        buf = b"".join(int(v).to_bytes(32, "little") for v in col)
        out[c, : len(col)] = np.frombuffer(buf, dtype="<u2").reshape(len(col), 16)
    return out


def freeze(name: str, builder, instances, params, prover=None, extra=None) -> None:
    """Keygen on `builder`, then the seed-0 proof: of `builder` itself, or,
    with `prover(pk, break_points) -> (prover builder, phase_fns)`, of the
    builder and phase closures it returns. `extra` adds arrays to the file."""
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
    d.update(extra or {})
    np.savez_compressed(os.path.join(HERE, f"{name}.npz"), **d)
    print(f"{name}: proof {len(proof)} bytes, {time.time() - t:.1f}s", flush=True)


POSEIDON_K, POSEIDON_LOOKUP_BITS, POSEIDON_VAR_LEN = 9, 8, 8


def poseidon_inputs(seed: int):
    """(32 bytes, POSEIDON_VAR_LEN bytes, their length, a bool, a byte) from
    random.Random(seed); the bytes past the length are zero."""
    rng = random.Random(seed)
    fixed = [rng.randrange(256) for _ in range(32)]
    length = rng.randrange(1, POSEIDON_VAR_LEN + 1)
    var = [rng.randrange(256) for _ in range(length)] + [0] * (POSEIDON_VAR_LEN - length)
    return fixed, var, length, bool(rng.randrange(2)), rng.randrange(256)


def poseidon_logic(pool, range_chip, inputs):
    """The Poseidon + SafeTypes closure: hash_fix_len_bytes and
    hash_var_len_bytes of the inputs' bytes, a SafeBool and a SafeByte load."""
    from halo2_lib_tpu.poseidon import PoseidonChip
    from halo2_lib_tpu.poseidon.spec import default_spec
    from halo2_lib_tpu.safe_types import SafeTypeChip

    fixed, var, length, flag, byte = inputs
    ctx = pool.main()
    chip = PoseidonChip(ctx, default_spec(), range_chip)
    safe = SafeTypeChip(range_chip)
    fx = safe.raw_to_fix_len_bytes(ctx, [ctx.load_witness(b) for b in fixed])
    h_fix = chip.hash_fix_len_bytes(ctx, fx)
    vb = safe.raw_to_var_len_bytes(ctx, [ctx.load_witness(b) for b in var], ctx.load_witness(length))
    h_var = chip.hash_var_len_bytes(ctx, vb)
    safe.load_bool(ctx, flag)
    safe.load_byte(ctx, byte)
    return h_fix, h_var


def poseidon_circuit(inputs):
    """The keygen builder of base_test().use_k(9).use_lookup_bits(8)
    .bench_builder (utils/testing.py) on `inputs`."""
    builder = BaseCircuitBuilder.from_stage(CircuitBuilderStage.MOCK).use_k(POSEIDON_K)
    builder.set_lookup_bits(POSEIDON_LOOKUP_BITS)
    poseidon_logic(builder.pool(0), builder.range_chip(), inputs)
    builder.calculate_params(minimum_rows=9)
    p = builder.config_params
    p.num_advice_per_phase[0] = max(p.num_advice_per_phase[0], 2)
    p.num_lookup_advice_per_phase[0] = max(p.num_lookup_advice_per_phase[0], 1)
    return builder


def circuit_digest(circuit) -> str:
    """SHA-256 of a synthesized circuit's advice columns and selectors,
    lookup-advice and fixed columns, copies and instances, as Python reprs."""
    h = hashlib.sha256()
    for part in ([fp.columns for fp in circuit.phases], [fp.selectors for fp in circuit.phases],
                 circuit.lookup_cols, circuit.fixed_cols, circuit.copies, circuit.instances):
        h.update(repr(part).encode())
    return h.hexdigest()


def freeze_poseidon() -> None:
    from halo2_lib_tpu.utils.pinning import pinning_of

    params9 = ParamsKZG.read(os.path.join(ROOT, "params", "kzg_bn254_9.srs"))
    builder = poseidon_circuit(poseidon_inputs(1))
    digest = circuit_digest(builder.synthesize())

    def prover(pk, break_points):
        pb = pinning_of(builder).prover_builder()
        poseidon_logic(pb.pool(0), pb.range_chip(), poseidon_inputs(2))
        return pb, None

    freeze("poseidon_k9", builder, None, params9, prover,
           {"circuit_sha256": np.frombuffer(bytes.fromhex(digest), dtype=np.uint8)})


# --msm: the MSM gadgets and the reference's MSM benchmark circuit
# (configs/bn254/msm_circuit.config and its .t.config), built step for step
# as the port's utils/testing.py builds them. Each build reseeds the JAX
# ecc/ec.py generator to MSM_RNG_SEED first; the tests reseed the port's.
MSM_RNG_SEED = 0x5EC0
MSM_CASES = {  # name -> (k, lookup_bits, input seed, points, max_bits)
    "serial": (14, 13, 14, 3, 254),
    "identity": (14, 13, 15, 3, 8),
    "pippenger": (14, 13, 19, 26, 16),
    "fixed": (14, 13, 17, 4, 254),
}


def load_config(rel: str) -> dict:
    with open(os.path.join(ROOT, "configs", rel)) as f:
        return json.load(f)


def msm_case_inputs(name: str):
    from halo2_lib_tpu.utils.curves import BN254_G1

    _k, _lb, seed, npts, max_bits = MSM_CASES[name]
    rng = random.Random(seed)
    if name == "identity":
        P = BN254_G1.random_point(rng)
        return [P, BN254_G1.neg(P), None], [5, 5, 7]
    pts = [BN254_G1.random_point(rng) for _ in range(npts)]
    if max_bits == 254:
        return pts, [BN254_G1.random_scalar(rng) for _ in range(npts)]
    return pts, [rng.randrange(1 << max_bits) for _ in range(npts)]


def msm_case_circuit(name: str):
    """The MOCK builder of MSM_CASES[name] and the in-circuit result."""
    from halo2_lib_tpu.ecc.ec import EccChip
    from halo2_lib_tpu.ecc.fp import FpChip
    from halo2_lib_tpu.utils.curves import BN254_G1

    k, lookup_bits, _seed, _n, max_bits = MSM_CASES[name]
    pts, scalars = msm_case_inputs(name)
    builder = BaseCircuitBuilder.from_stage(CircuitBuilderStage.MOCK).use_k(k)
    builder.set_lookup_bits(lookup_bits)
    fp_chip = FpChip(builder.range_chip(), 88, 3, BN254_G1.base)
    chip = EccChip(fp_chip, BN254_G1)
    pool = builder.pool(0)
    ctx = pool.main()
    scs = [[ctx.load_witness(s)] for s in scalars]
    if name == "fixed":
        out = chip.fixed_base_msm(pool, pts, scs, max_scalar_bits_per_cell=max_bits)
    else:
        out = chip.variable_base_msm(pool, [chip.assign_point(ctx, p) for p in pts], scs, max_bits=max_bits)
    builder.calculate_params(minimum_rows=9)
    return builder, [fp_chip.get_assigned_value(out.x), fp_chip.get_assigned_value(out.y)]


def msm_witness(builder, cfg: dict):
    """tests/test_configs.py:run_msm_config's witness on a MOCK or PROVER builder."""
    from halo2_lib_tpu.ecc.ec import EccChip
    from halo2_lib_tpu.ecc.fp import FpChip
    from halo2_lib_tpu.utils.curves import BN254_G1

    rng = random.Random(91)
    pts = [BN254_G1.random_point(rng) for _ in range(cfg["batch_size"])]
    scalars = [BN254_G1.random_scalar(rng) for _ in range(cfg["batch_size"])]
    fp_chip = FpChip(builder.range_chip(), cfg["limb_bits"], cfg["num_limbs"], BN254_G1.base)
    chip = EccChip(fp_chip, BN254_G1)
    pool = builder.pool(0)
    ctx = pool.main()
    assigned = [chip.load_private(ctx, p) for p in pts]
    scs = [[ctx.load_witness(s)] for s in scalars]
    out = chip.variable_base_msm(pool, assigned, scs, max_bits=254, window_bits=cfg["window_bits"])
    got = (fp_chip.get_assigned_value(out.x), fp_chip.get_assigned_value(out.y))
    assert got == BN254_G1.msm(pts, scalars)
    return builder


def msm_circuit(cfg: dict):
    builder = BaseCircuitBuilder.from_stage(CircuitBuilderStage.MOCK).use_k(cfg["degree"])
    builder.set_lookup_bits(cfg["lookup_bits"])
    msm_witness(builder, cfg)
    builder.calculate_params(minimum_rows=9)
    return builder


def circuit_digests(circuit) -> dict:
    """SHA-256 of each part of a synthesized circuit, column by column (the
    port's utils/testing.py circuit_digests)."""

    def digest(seq) -> str:
        h = hashlib.sha256()
        for item in seq:
            h.update(repr(item).encode())
        return h.hexdigest()

    copies = circuit.copies
    return {
        "advice": digest(col for fp in circuit.phases for col in fp.columns),
        "selectors": digest(col for fp in circuit.phases for col in fp.selectors),
        "lookup": digest(col for cols in circuit.lookup_cols for col in cols),
        "fixed": digest(circuit.fixed_cols),
        "copies": digest(copies[i : i + 65536] for i in range(0, len(copies), 65536)),
        "instances": digest(circuit.instances),
        "num_copies": str(len(copies)),
    }


@contextlib.contextmanager
def _eager_stages(names=("s4b", "hcomb", "s5", "s6", "s7"), max_elems: int = 1 << 24):
    """Run the JAX prover's stages after the grand products (the quotient,
    the evaluations, SHPLONK) op by op instead of as jits, with each
    Montgomery product taken in slices of its lanes: XLA:CPU's executables
    for the .t.config's 181 + 30 advice columns passed 29 GB (the quotient)
    and 36 GB (the evaluations) of RSS, and the product's one-hot
    convolution makes a [..., 16, 16, B] temporary, 19 GB eagerly at
    [576, 16, 2^15]. The same values either way (the product is lane by
    lane)."""
    import jax.numpy as jnp

    from halo2_lib_tpu.backend.prover import ProverRuntime
    from halo2_lib_tpu.ops.limbs import DeviceField

    real_jit, real_mul = ProverRuntime.jit, DeviceField._mont_mul_xla

    def sliced_mul(self, a, b):
        shape = jnp.broadcast_shapes(a.shape, b.shape)
        lanes = shape[-1]
        step = max(1, max_elems // max(1, int(np.prod(shape[:-1]))))
        if lanes <= step:
            return real_mul(self, a, b)

        def cut(x, i):
            return x[..., i : i + step] if x.shape[-1] == lanes else x

        return jnp.concatenate(
            [real_mul(self, cut(a, i), cut(b, i)) for i in range(0, lanes, step)], axis=-1)

    def eager(fn):
        def call(*args):
            DeviceField._mont_mul_xla = sliced_mul
            try:
                return fn(*args)
            finally:
                DeviceField._mont_mul_xla = real_mul
        return call

    ProverRuntime.jit = lambda self, name, fn: eager(fn) if name in names else real_jit(self, name, fn)
    try:
        yield
    finally:
        ProverRuntime.jit = real_jit


def freeze_msm(parts=("cases", "t_config", "full")) -> None:
    """msm_digests.json: ("cases") the MSM_CASES builders' config params,
    break points, result and circuit digests; ("t_config") the .t.config
    circuit's, with its SRS (host_srs(13)), vk and seed-0 proof digests
    (keygen on the MOCK builder, the pinned PROVER builder's witness after a
    reseed); ("full") the full config's (k=17, batch 100), then its SRS and
    vk digests. The other parts of an existing file are kept; the file is
    rewritten after each stage with what is known so far."""
    import resource

    from halo2_lib_tpu.ecc import ec as jax_ec
    from halo2_lib_tpu.utils.pinning import pinning_of

    t = time.time()
    path = os.path.join(HERE, "msm_digests.json")
    out = {"rng_seed": MSM_RNG_SEED, "cases": {}}
    if os.path.exists(path):
        with open(path) as f:
            out.update({k: v for k, v in json.load(f).items() if k not in parts})

    def stage(name: str) -> None:
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
            f.write("\n")
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
        print(f"msm: {name} done at {time.time() - t:.1f}s, peak RSS {peak:.2f} GiB", flush=True)

    def shape(builder, circuit) -> dict:
        return {
            "config_params": builder.config_params.to_json(),
            "break_points": builder.break_points(),
            "digests": circuit_digests(circuit),
        }

    for name in MSM_CASES if "cases" in parts else ():
        jax_ec._RNG.seed(MSM_RNG_SEED)
        builder, value = msm_case_circuit(name)
        out["cases"][name] = dict(shape(builder, builder.synthesize()), value=value)
        stage(f"case {name}")

    for key, rel in (("t_config", "bn254/msm_circuit.t.config"), ("full", "bn254/msm_circuit.config")):
        if key not in parts:
            continue
        cfg = load_config(rel)
        jax_ec._RNG.seed(MSM_RNG_SEED)
        builder = msm_circuit(cfg)
        circuit = builder.synthesize()
        out[key] = dict(shape(builder, circuit), config=cfg)
        stage(f"{key} MOCK builder")
        del circuit
        params = host_srs(cfg["degree"])
        out[key]["srs_sha256"] = hashlib.sha256(params.to_halo2_bytes()).hexdigest()
        stage(f"{key} SRS")
        pk = keygen(params, builder)
        out[key]["vk_sha256"] = hashlib.sha256(pk.vk.to_bytes()).hexdigest()
        stage(f"{key} keygen")
        if key == "full":
            break  # no JAX proof at k=17: the k=19 pairing one passed 36 GiB of RSS
        pb = pinning_of(builder).prover_builder()
        jax_ec._RNG.seed(MSM_RNG_SEED)
        msm_witness(pb, cfg)
        with _eager_stages():
            proof = create_proof(params, pk, pb, seed=0)
        assert verify_proof(params, pk.vk, proof)
        out[key].update(proof_sha256=hashlib.sha256(proof).hexdigest(), proof_bytes=len(proof), seed=0)
        stage(f"{key} create_proof")
        del pk, pb, builder, params


# --- the standalone device API (--api) -----------------------------------------------------

API_K, API_EXT, API_KZG_K = 4, 4, 8


def api_values(seed: int, m: int, p: int = FR_BN254.p) -> list[int]:
    """m canonical field values from a numpy seed, 0, 1 and p - 1 among
    them (tests/test_torch_api.py makes the same ones)."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 62, size=(m, 5), dtype=np.int64)
    vals = [sum(int(w) << (62 * i) for i, w in enumerate(row)) % p for row in words]
    for i, v in enumerate((0, 1, p - 1), start=1):
        if i < m:
            vals[i] = v
    return vals


API_POW_EXPONENTS = (0, 1, 2, 5, (1 << 64) + 1, FR_BN254.p - 2,
                     0x2A5F3C9E1B7D4F6081C3E5A7B9D1F3E5C7A9B1D3F5E7C9A1B3D5F7E9C1A3B5D7)


def api_msm_cases() -> dict:
    """name -> (host points, scalars, window bits): the case of
    tests/test_ec_device.py:test_msm (64 points: an identity base, a zero
    scalar, duplicate bases with equal and with different scalars, one-window
    scalars) and random cases of (37, 4) and (128, 8); the points from
    random.Random, seeded from numpy (tests/test_torch_api.py makes the same
    ones)."""
    from halo2_lib_tpu.utils.curves import BN254_G1

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


def _hex_point(pt):
    return None if pt is None else [hex(pt[0]), hex(pt[1])]


def api_digest() -> dict:
    """The JAX package's outputs on the API's inputs (see the module
    docstring); tests/test_torch_api.py computes the same keys with the
    port."""
    import jax.numpy as jnp

    from halo2_lib_tpu.backend.poly import Domain
    from halo2_lib_tpu.ops.ec_device import DeviceCurve
    from halo2_lib_tpu.ops.limbs import DeviceField
    from halo2_lib_tpu.utils.curves import BN254_G1
    from halo2_lib_tpu.utils.fields import FQ_BN254

    def sha(t):
        return hashlib.sha256(np.ascontiguousarray(np.asarray(t)).astype("<u4").tobytes()).hexdigest()

    out = {}
    # Domain at k = 4, extension 4
    dom = Domain(API_K, API_EXT)
    n = dom.n
    c, e, q = api_values(1, n), api_values(2, n), api_values(3, n)
    x = api_values(5, 1)[0]
    C, E = dom.pack(c), dom.pack(e)
    ext = dom.coeff_to_extended(C)
    d = {
        "lagrange_to_coeff": sha(dom.lagrange_to_coeff(E)),
        "coeff_to_lagrange": sha(dom.coeff_to_lagrange(C)),
        "coeff_to_extended": sha(ext),
        "extended_to_coeff": sha(dom.extended_to_coeff(ext)),
        "divide_by_vanishing": sha(dom.divide_by_vanishing(ext)),
        "mul": sha(dom.mul(C, E)),
        "add": sha(dom.add(C, E)),
        "sub": sha(dom.sub(C, E)),
        "rotate_ext_1": sha(dom.rotate_ext(ext, 1)),
        "rotate_ext_-2": sha(dom.rotate_ext(ext, -2)),
        "const_ext": sha(dom.const_ext(5)),
        "const_h": sha(dom.const_h(q[0])),
        "prefix_prod": sha(dom.prefix_prod(jnp.stack([C, E]))),
        "pows_dev_16": sha(dom.pows_dev(x, n)),
        "pows_dev_5": sha(dom.pows_dev(x, 5)),
        "eval_many_at": [hex(v) for v in dom.eval_many_at(jnp.stack([C, E, dom.pack(q)]), x)],
        "eval_many_at_odd": [hex(v) for v in dom.eval_many_at(jnp.stack([C[:, :13]]), x)],
        "eval_coeffs_host": hex(dom.eval_coeffs_host(c, x)),
        "l0_host": hex(dom.l0_host(x)),
    }
    out["domain"] = d
    print("api: domain", flush=True)
    # DeviceField
    f = {}
    for name, F in (("fr", FR_BN254), ("fq", FQ_BN254)):
        df = DeviceField(F)
        a = df.pack(api_values(6, 8, F.p))
        for ex in API_POW_EXPONENTS:
            f[f"pow_{name}_{ex:x}"] = sha(df.pow(a, ex))
        b = df.pack(api_values(6, 4, F.p) + api_values(7, 4, F.p))
        f[f"eq_{name}"] = [bool(v) for v in np.asarray(df.eq(a, b))]
        for shape in ((), 8, (3, 8)):
            f[f"const_{name}_{shape}"] = sha(df.const(F.p - 3, shape))
    out["field"] = f
    print("api: field", flush=True)
    # ParamsKZG at k = 8 (the committed SRS)
    params = ParamsKZG.read(os.path.join(ROOT, "params", f"kzg_bn254_{API_KZG_K}.srs"))
    fr_df = DeviceField(FR_BN254)
    nk = params.n
    p1, p2 = api_values(11, nk), api_values(12, nk)

    def host(pts, sc):
        return BN254_G1.msm([g for g, s in zip(pts, sc) if g], [s for g, s in zip(pts, sc) if g])

    kz = {
        "commit": params.commit(p1),
        "commit_short": params.commit(p1[:100]),
        "commit_lagrange": params.commit_lagrange(p2),
        "commit_lagrange_short": params.commit_lagrange(p2[:37]),
        "commit_dev": params.commit_dev(fr_df.pack(p1[:200]), fr_df),
    }
    kz["commit_many"] = params.commit_many([p1[:64], p2])
    want = {
        "commit": host(params.g, p1), "commit_short": host(params.g, p1[:100]),
        "commit_lagrange": host(params.g_lagrange, p2),
        "commit_lagrange_short": host(params.g_lagrange, p2[:37]),
        "commit_dev": host(params.g, p1[:200]),
        "commit_many": [host(params.g, p1[:64]), host(params.g, p2)],
    }
    assert kz == want, "the JAX commitments differ from the host MSM"
    out["kzg"] = {k: ([_hex_point(v) for v in val] if k == "commit_many" else _hex_point(val))
                  for k, val in kz.items()}
    print("api: kzg", flush=True)
    # DeviceCurve.msm (msm_device) on the MSM cases
    dc = DeviceCurve(DeviceField(BN254_G1.base), BN254_G1)
    m = {}
    for name, (pts, sc, wb) in api_msm_cases().items():
        got = dc.unpack_points(dc.msm(pts, sc, wb))[0]
        assert got == host(pts, sc), f"the JAX MSM {name} differs from the host MSM"
        m[name] = _hex_point(got)
    out["msm"] = m
    return out


def freeze_api() -> None:
    t = time.time()
    out = api_digest()
    with open(os.path.join(HERE, "api_digests.json"), "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(f"api_digests {time.time() - t:.1f}s", flush=True)


def main() -> None:
    if "--large" in sys.argv:
        freeze_ntt((19, 21), "ntt_digests_large.json")
        return
    if "--pairing" in sys.argv:
        freeze_pairing()
        return
    if "--poseidon" in sys.argv:
        freeze_poseidon()
        return
    if "--mxu" in sys.argv:
        freeze_mxu()
        return
    if "--api" in sys.argv:
        freeze_api()
        return
    if "--msm" in sys.argv:
        rest = sys.argv[sys.argv.index("--msm") + 1 :]
        freeze_msm(tuple(rest) or ("cases", "t_config", "full"))
        return
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
