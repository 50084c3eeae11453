"""The port's in-circuit MSM gadgets (halo2_lib_tpu_torch/ecc/: EccChip's
variable_base_msm, its serial multi_scalar_multiply up to 25 points and
pippenger.py's multi_exp_par above, and fixed_base_msm, fixed_base.py's
msm_par) against the JAX package's.

The cases are utils/testing.py's MSM_CASES: tests/test_ecc.py's
test_msm_small, test_msm_with_identity_and_cancellation and
test_fixed_base_msm, and multi_exp_par over 26 points with 16-bit scalars,
at k=14 so that each builds in seconds. make_goldens.py --msm froze the JAX
builders' config params, break points, results and circuit digests into
msm_digests.json, each built after reseeding the JAX ecc/ec.py generator;
the port's generator is reseeded the same way here. The live JAX builds are
the slow test at the end.
"""

import json
import os
import random

import pytest
import torch

from halo2_lib_tpu_torch.backend.mock import MockProver
from halo2_lib_tpu_torch.ecc import ec as port_ec
from halo2_lib_tpu_torch.utils.curves import BN254_G1
from halo2_lib_tpu_torch.utils.pinning import pinning_of
from halo2_lib_tpu_torch.utils.testing import (
    MSM_CASES, circuit_digests, msm_case_circuit, msm_case_inputs, msm_case_witness,
)

# One core per test process: the suite runs in parallel workers.
torch.set_num_threads(1)

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_goldens")


@pytest.fixture(scope="module")
def goldens():
    with open(os.path.join(GOLDENS, "msm_digests.json")) as f:
        return json.load(f)


_BUILT: dict = {}


def built(name: str, seed: int):
    """MSM_CASES[name]'s MOCK builder and synthesized circuit, once a module."""
    if name not in _BUILT:
        port_ec.DEFAULT_RNG.seed(seed)
        b = msm_case_circuit(name)
        _BUILT[name] = (b, b.synthesize())
    return _BUILT[name]


@pytest.mark.parametrize("name", list(MSM_CASES))
def test_msm_case_matches_jax(goldens, name):
    """Config params, break points, every advice, selector, lookup and
    fixed column and the copies equal the JAX builder's; the in-circuit
    result equals the JAX circuit's and the host MSM."""
    want = goldens["cases"][name]
    b, circuit = built(name, goldens["rng_seed"])
    assert b.config_params.to_json() == want["config_params"]
    assert b.break_points() == want["break_points"]
    assert circuit_digests(circuit) == want["digests"]
    pts, scalars = msm_case_inputs(name)
    host = BN254_G1.msm([p for p in pts if p is not None],
                        [s for p, s in zip(pts, scalars) if p is not None])
    assert tuple(want["value"]) == (host if host is not None else (0, 0))


def test_the_cases_take_both_variable_base_paths(goldens):
    """variable_base_msm runs the serial MSM up to 25 points and
    multi_exp_par above: "pippenger" spreads over many contexts."""
    assert [MSM_CASES[n][3] for n in ("serial", "identity", "pippenger")] == [3, 3, 26]
    pool = built("pippenger", goldens["rng_seed"])[0].pool(0)
    assert len(pool.threads) > 20


def test_pinned_prover_builder_replays_multi_exp_par(goldens):
    """The pinned PROVER builder, given an explicit generator seeded as the
    MOCK builder's, fills the same advice columns from its many contexts."""
    b, circuit = built("pippenger", goldens["rng_seed"])
    pb = pinning_of(b).prover_builder()
    msm_case_witness(pb, "pippenger", random.Random(goldens["rng_seed"]))
    assert pb.synthesize().phases[0].columns == circuit.phases[0].columns


def test_mock_prover_accepts_and_catches_a_prank(goldens):
    b, _ = built("pippenger", goldens["rng_seed"])
    k = MSM_CASES["pippenger"][0]
    assert not MockProver.run(k, b).verify()
    ctx = b.pool(0).threads[3]  # a clump's context of multi_exp_par
    cell = ctx.get(len(ctx.advice) // 2)
    old = cell.value
    cell.debug_prank(ctx, old + 1)
    try:
        assert MockProver.run(k, b).verify()
    finally:
        cell.debug_prank(ctx, old)


@pytest.mark.slow
@pytest.mark.parametrize("name", list(MSM_CASES))
def test_msm_case_matches_jax_live(name):
    """The JAX builder of the same case, built here, agrees with the port's
    and with msm_digests.json."""
    import sys

    sys.path.insert(0, GOLDENS)
    from halo2_lib_tpu.ecc import ec as jax_ec
    from make_goldens import MSM_RNG_SEED, msm_case_circuit as jax_case

    jax_ec._RNG.seed(MSM_RNG_SEED)
    jb, value = jax_case(name)
    pb, pc = built(name, MSM_RNG_SEED)
    assert jb.config_params.to_json() == pb.config_params.to_json()
    assert circuit_digests(jb.synthesize()) == circuit_digests(pc)
    assert jb.break_points() == pb.break_points()
