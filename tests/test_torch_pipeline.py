"""The port's phase-0 witness/commit pipelining (backend/pipeline.py) and its
prover warm-up (backend/precompile.py) on the CPU, at k=9.

The pipelined proof must be byte-identical to the plain create_proof: the
same blinding rng stream, the same break-point replay, the same transcript
(tests/test_pipeline.py holds the JAX package to the same). Here it is held
to golden_k9.npz's proof, the JAX package's seed-0 proof of the golden
circuit, which test_torch_prover.py holds the port's plain proof to. The key
is the JAX key carried across (convert.py), so no keygen runs here.
"""

import os
import random
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from halo2_lib_tpu_torch.backend import pipeline, precompile
from halo2_lib_tpu_torch.backend.kzg import ParamsKZG
from halo2_lib_tpu_torch.backend.pipeline import Phase0Pipeline, prove_pipelined
from halo2_lib_tpu_torch.backend.precompile import maybe_warm, warm_prover
from halo2_lib_tpu_torch.backend.protocol import P, usable_row_count
from halo2_lib_tpu_torch.backend.prover import (
    _blind, _flatten_prover_phase, _lag_from_u16, _u16_cols, create_proof,
)
from halo2_lib_tpu_torch.convert import proving_key_from_numpy
from halo2_lib_tpu_torch.core.cells import Existing, Witness
from halo2_lib_tpu_torch.gates.circuit import BaseCircuitBuilder, CircuitBuilderStage
from halo2_lib_tpu_torch.ops.limbs import DeviceField
from halo2_lib_tpu_torch.utils.fields import FR_BN254
from halo2_lib_tpu_torch.utils.pinning import pinning_of
from halo2_lib_tpu_torch.utils.testing import golden_circuit, golden_witness

# One core per test process: the suite runs in parallel workers, and a
# thread pool per worker would oversubscribe the host.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "tests", "data", "torch_goldens")
K = 9


def _witness(b):
    """tests/test_pipeline.py's circuit: 150 products and 15 range checks,
    two advice columns at k=9."""
    rc = b.range_chip()
    gate = rc.gate
    ctx = b.main(0)
    x = ctx.load_witness(3)
    for i in range(150):
        x = gate.mul(ctx, Existing(x), Witness(i + 5))
        if i % 10 == 0:
            a = ctx.load_witness((i * 37) % (1 << 16))
            rc.range_check(ctx, a, 16)
    return b


def _two_contexts(b):
    """_witness, a pause for the watcher, then a second context: its values
    reach the columns only through the watcher's drain."""
    _witness(b)
    time.sleep(0.05)
    gate = b.range_chip().gate
    ctx = b.new_thread(0)
    y = ctx.load_witness(11)
    for i in range(40):
        y = gate.mul(ctx, Existing(y), Witness(i + 2))
    return b


@pytest.fixture(scope="module")
def params():
    return ParamsKZG.read(os.path.join(ROOT, "params", "kzg_bn254_9.srs"), device="cpu")


@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(GOLDENS, "golden_k9.npz"))


@pytest.fixture(scope="module")
def golden_key(golden):
    """The JAX key of the golden circuit, with the port builder's break
    points and config; and its pinning."""
    builder = golden_circuit()
    builder.synthesize()
    pk = proving_key_from_numpy(golden, "cpu")
    pk.break_points, pk.config_params = builder.break_points(), builder.config_params
    return pk, pinning_of(builder)


@pytest.fixture(scope="module")
def warmed(params, golden_key):
    """warm_prover ran on the golden key: the task count it returned."""
    return warm_prover(params, golden_key[0], device="cpu")


def _replay_case(witness_fn):
    """(pipeline key stand-in, pinning) for witness_fn's MOCK builder: the
    pipeline reads only the key's k, column counts and break points."""
    builder = BaseCircuitBuilder.from_stage(CircuitBuilderStage.MOCK).use_k(K)
    builder.set_lookup_bits(8)
    witness_fn(builder)
    builder.calculate_params(minimum_rows=9)
    p = builder.config_params
    p.num_advice_per_phase[0] = max(p.num_advice_per_phase[0], 2)
    p.num_lookup_advice_per_phase[0] = max(p.num_lookup_advice_per_phase[0], 1)
    builder.synthesize()
    na = p.num_advice_per_phase
    vk = SimpleNamespace(k=K, num_advice_per_phase=list(na), num_advice=sum(na))
    return SimpleNamespace(vk=vk, break_points=builder.break_points()), pinning_of(builder)


def test_warm_prover_runs_every_task(warmed, params, golden_key, monkeypatch):
    """tests/test_precompile.py on the port: the warm-up runs its tasks, and
    maybe_warm warms only under HALO2_PRECOMPILE=1."""
    assert warmed >= 8
    calls = []
    monkeypatch.setattr(precompile, "warm_prover", lambda *a: calls.append(a))
    monkeypatch.delenv("HALO2_PRECOMPILE", raising=False)
    assert maybe_warm(params, golden_key[0], "cpu") is False and not calls
    monkeypatch.setenv("HALO2_PRECOMPILE", "1")
    assert maybe_warm(params, golden_key[0], "cpu") is True and len(calls) == 1


def _assert_replay(pipe, pk, pb):
    """The pipeline's columns are flatten_witnesses' columns of the prover
    builder pb, blinded as create_proof blinds them, and uploaded as
    create_proof uploads them."""
    n = 1 << K
    na0 = pk.vk.num_advice_per_phase[0]
    adv, _ = _flatten_prover_phase(pb, 0, na0, 0, usable_row_count(n))
    rng = random.Random(("create-proof-blinding", 0).__repr__())
    expect = [_blind(col, n, rng) for col in adv]
    assert pipe.advice_cols == expect
    assert sum(pipe.groups) == na0
    df = DeviceField(FR_BN254)
    assert torch.equal(pipe.advice_lag(), _lag_from_u16(df, _u16_cols(expect, n), "cpu"))
    assert all(0 <= v < P for col in pipe.advice_cols for v in col)
    return adv


def test_pipelined_proof_matches_plain_and_jax(warmed, params, golden_key, golden):
    """tests/test_pipeline.py's two cases on the golden circuit: after the
    warm-up, the pipelined proof is the plain proof's bytes (golden_k9.npz),
    and the replayed columns are the flattened ones (its second column is
    empty: the plain prover pads it)."""
    pk, pinning = golden_key
    assert pk.vk.num_advice_per_phase[0] >= 2, "want multiple columns"
    pipe = Phase0Pipeline(params, pk, pinning.prover_builder(), device="cpu").run(golden_witness)
    proof = create_proof(params, pk, pipe.builder, device="cpu", phase0=pipe)
    assert proof == bytes(golden["proof"])
    _assert_replay(pipe, pk, golden_witness(pinning.prover_builder()))


def test_pipeline_replay_with_break_points_and_a_drain(params, monkeypatch):
    """tests/test_pipeline.py's circuit (columns cut at a break point), then
    a second context: the watcher consumes the main context in chunks of 64
    values while it grows, the second context's values arrive through the
    drain, and the columns are still the flattened ones."""
    monkeypatch.setattr(pipeline, "CHUNK", 64)
    pk, pinning = _replay_case(_two_contexts)
    pipe = Phase0Pipeline(params, pk, pinning.prover_builder(), device="cpu").run(_two_contexts)
    adv = _assert_replay(pipe, pk, _two_contexts(pinning.prover_builder()))
    assert sum(1 for col in adv if col) >= 2, "want columns cut at a break point"


def test_pipeline_refuses_a_lost_break_point(params, golden_key):
    """A replay that produces fewer columns than its break points give (here
    a break point the witness never reaches) is refused, not padded with
    empty columns."""
    pk, pinning = golden_key
    pipe = Phase0Pipeline(params, pk, pinning.prover_builder(), device="cpu")
    pipe.break_points = pipe.break_points + [10**6]
    pipe._commit_group = lambda group: None
    with pytest.raises(AssertionError, match="break points give"):
        pipe.run(golden_witness)


@pytest.mark.parametrize("other", ["seed", "builder", "device", "params"])
def test_create_proof_refuses_a_foreign_pipeline(params, golden_key, other):
    """create_proof(phase0=) takes the pipeline's columns and blinding only
    for the builder, seed, device and params the pipeline ran with."""
    import copy

    pk, pinning = golden_key
    pb = pinning.prover_builder()
    pipe = Phase0Pipeline(params, pk, pb, seed=0, device="cpu")
    kw = {"seed": 0, "device": "cpu"}
    builder, prm = pb, params
    if other == "seed":
        kw["seed"] = 1
    elif other == "builder":
        builder = pinning.prover_builder()
    elif other == "device":
        kw["device"] = "meta"
    else:
        prm = copy.copy(params)
    with pytest.raises(AssertionError, match=other):
        create_proof(prm, pk, builder, phase0=pipe, **kw)


def test_launch_counts_are_exact_under_threads():
    """The pipeline's worker counts launches beside the caller's thread:
    8 threads, 2000 counts each, at a short switch interval, lose none."""
    import sys
    import threading

    from halo2_lib_tpu_torch.ops import cuda_field as cf

    cf.reset_launches()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [cf._count("mont_mul", 1, ()) for _ in range(2000)])
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert cf.LAUNCHES["mont_mul"] == 8 * 2000
    cf.reset_launches()


def test_pipeline_needs_a_prover_builder(params, golden_key):
    with pytest.raises(AssertionError):
        Phase0Pipeline(params, golden_key[0], golden_circuit(), device="cpu")


def test_pipeline_needs_a_device_without_a_card(params, golden_key):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        Phase0Pipeline(params, golden_key[0], golden_key[1].prover_builder())
