"""The reference's MSM benchmark circuit on the port's builders, against the
JAX package's (configs/bn254/msm_circuit.t.config: k=13, batch 8, the
serial MSM; msm_circuit.config: k=17, batch 100, multi_exp_par), built as
tests/test_configs.py:run_msm_config builds it (utils/testing.py
msm_circuit).

msm_digests.json (make_goldens.py --msm) holds each JAX builder's config
params, break points and circuit digests, built after reseeding the JAX
ecc/ec.py generator, and for the .t.config the JAX SRS, vk and seed-0 proof
digests. The .t.config's columns are held here; its CPU proof (minutes on
one core) and the full-size builder are slow; chip_smoke.py phase 12 proves
both configs on the card.
"""

import json
import os
import random

import pytest
import torch

from halo2_lib_tpu_torch.ecc import ec as port_ec
from halo2_lib_tpu_torch.utils.pinning import pinning_of
from halo2_lib_tpu_torch.utils.testing import (
    MSM_CONFIG, MSM_T_CONFIG, circuit_digests, load_config, msm_circuit, msm_witness,
)

# One core per test process: the suite runs in parallel workers.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "tests", "data", "torch_goldens")


@pytest.fixture(scope="module")
def goldens():
    with open(os.path.join(GOLDENS, "msm_digests.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def t_config(goldens):
    """The .t.config MOCK builder and its synthesized circuit."""
    port_ec.DEFAULT_RNG.seed(goldens["rng_seed"])
    b = msm_circuit(load_config(MSM_T_CONFIG))
    return b, b.synthesize()


def test_configs_are_the_reference_shapes(goldens):
    for key, rel in (("t_config", MSM_T_CONFIG), ("full", MSM_CONFIG)):
        assert load_config(rel) == goldens[key]["config"]
    full = load_config(MSM_CONFIG)
    assert (full["degree"], full["batch_size"], full["window_bits"]) == (17, 100, 4)


def test_t_config_matches_jax(goldens, t_config):
    """Config params, break points, every column and the copies equal the
    JAX builder's (181 advice and 30 lookup-advice columns at k=13)."""
    want = goldens["t_config"]
    b, circuit = t_config
    assert b.config_params.to_json() == want["config_params"]
    assert b.break_points() == want["break_points"]
    assert circuit_digests(circuit) == want["digests"]


@pytest.mark.slow
def test_t_config_proof_matches_jax_on_the_cpu(goldens, t_config):
    """keygen, the pinned PROVER builder's witness and create_proof at seed 0
    on the CPU: the JAX SRS, vk and proof digests; the proof verifies."""
    import hashlib

    from halo2_lib_tpu_torch.backend.keygen import keygen
    from halo2_lib_tpu_torch.backend.kzg import ParamsKZG
    from halo2_lib_tpu_torch.backend.prover import create_proof
    from halo2_lib_tpu_torch.backend.verifier import verify_proof

    want = goldens["t_config"]
    b, circuit = t_config
    params = ParamsKZG.setup(13, device="cpu")
    assert hashlib.sha256(params.to_halo2_bytes()).hexdigest() == want["srs_sha256"]
    pk = keygen(params, b, circuit, device="cpu")
    assert hashlib.sha256(pk.vk.to_bytes()).hexdigest() == want["vk_sha256"]
    pb = pinning_of(b).prover_builder()
    msm_witness(pb, load_config(MSM_T_CONFIG), None, random.Random(goldens["rng_seed"]))
    assert pb.synthesize().phases[0].columns == circuit.phases[0].columns
    proof = create_proof(params, pk, pb, seed=0, device="cpu")
    assert hashlib.sha256(proof).hexdigest() == want["proof_sha256"]
    assert verify_proof(params, pk.vk, proof)


@pytest.mark.slow
def test_full_config_builder_matches_jax(goldens):
    """msm_circuit.config (k=17, batch 100, multi_exp_par over 280
    contexts): config params, break points and circuit digests equal the
    JAX builder's (about 90 s and 4.5 GB on one core)."""
    want = goldens["full"]
    port_ec.DEFAULT_RNG.seed(goldens["rng_seed"])
    b = msm_circuit(load_config(MSM_CONFIG))
    circuit = b.synthesize()
    assert b.config_params.to_json() == want["config_params"]
    assert b.break_points() == want["break_points"]
    assert circuit_digests(circuit) == want["digests"]
