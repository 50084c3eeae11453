"""An instance (public input) column through the port at k=9: vk and proof
bytes equal the JAX package's goldens; the proof verifies against the honest
instances and not against altered ones."""

import os

import numpy as np
from torch_jaxfree import ROOT, jaxfree_instance_run

from halo2_lib_tpu_torch.backend.keygen import VerifyingKey
from halo2_lib_tpu_torch.backend.kzg import ParamsKZG
from halo2_lib_tpu_torch.backend.verifier import verify_proof
from halo2_lib_tpu_torch.utils.fields import FR_BN254
from halo2_lib_tpu_torch.utils.testing import instance_circuit

GOLDENS = os.path.join(ROOT, "tests", "data", "torch_goldens")


def test_instance_circuit_matches_jax(tmp_path_factory):
    """The port's keygen and create_proof ran in the jax-free subprocess of
    torch_jaxfree.py; the bytes are held against the goldens here and the
    proof verified again from the vk's bytes."""
    run = jaxfree_instance_run(tmp_path_factory)
    assert "error" not in run, run.get("error")
    g = np.load(os.path.join(GOLDENS, "instance_k9.npz"))
    vk_bytes, proof = bytes.fromhex(run["vk"]), bytes.fromhex(run["proof"])
    assert vk_bytes == bytes(g["vk"])
    assert proof == bytes(g["proof"])
    params = ParamsKZG.read(os.path.join(ROOT, "params", "kzg_bn254_9.srs"), device="cpu")
    vk = VerifyingKey.from_bytes(vk_bytes)
    _, inst = instance_circuit()
    assert verify_proof(params, vk, proof, inst)
    wrong = [[inst[0][0], (inst[0][1] + 1) % FR_BN254.p]]
    assert not verify_proof(params, vk, proof, wrong)
