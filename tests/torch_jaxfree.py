"""One run of the port with jax made unimportable, shared by the tests that
need it (test_torch_import.py, test_torch_instances.py).

A subprocess, in which jax, the JAX package and the native engine cannot be
imported, takes the instance-column circuit at k=9 through keygen ->
create_proof -> verify_proof on the CPU and reports the vk and proof bytes,
the verdicts and any forbidden module that got loaded. Under pytest-xdist the
report is cached in the session's shared temporary directory behind a file
lock, so the parallel workers pay for one run.
"""

import json
import os
import subprocess
import sys

from filelock import FileLock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "halo2_lib_tpu", "halo2_native")

SCRIPT = r"""
import json, sys
for m in FORBIDDEN:
    sys.modules[m] = None
sys.path.insert(0, ROOT)
import torch
torch.set_num_threads(1)  # one core, as each parallel test worker gets
from halo2_lib_tpu_torch.backend.keygen import keygen
from halo2_lib_tpu_torch.backend.kzg import ParamsKZG
from halo2_lib_tpu_torch.backend.prover import create_proof
from halo2_lib_tpu_torch.backend.verifier import verify_proof
from halo2_lib_tpu_torch.utils.fields import FR_BN254
from halo2_lib_tpu_torch.utils.testing import instance_circuit
# every module of the port, loaded with the others unimportable
import halo2_lib_tpu_torch.backend.mock_device, halo2_lib_tpu_torch.backend.pipeline
import halo2_lib_tpu_torch.backend.precompile, halo2_lib_tpu_torch.poseidon
import halo2_lib_tpu_torch.safe_types, halo2_lib_tpu_torch as h2
import halo2_lib_tpu_torch.parallel, halo2_lib_tpu_torch.parallel.distributed
import halo2_lib_tpu_torch.ops.ntt_mxu
exports = [getattr(h2, name) for name in ("base_test", "keygen", "create_proof", "verify_proof")]

params = ParamsKZG.read(ROOT + "/params/kzg_bn254_9.srs", device="cpu")
builder, inst = instance_circuit()
pk = keygen(params, builder, device="cpu")
builder, inst = instance_circuit()
proof = create_proof(params, pk, builder, instances=inst, seed=0, device="cpu")
wrong = [[inst[0][0], (inst[0][1] + 1) % FR_BN254.p]]
print(json.dumps({
    "vk": pk.vk.to_bytes().hex(),
    "proof": proof.hex(),
    "verifies": verify_proof(params, pk.vk, proof, inst),
    "verifies_wrong_instances": verify_proof(params, pk.vk, proof, wrong),
    "loaded": sorted(
        m for m in sys.modules if m.split(".")[0] in FORBIDDEN and sys.modules[m] is not None
    ),
}))
"""


def _run() -> dict:
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run(
        [sys.executable, "-c", f"ROOT = {ROOT!r}\nFORBIDDEN = {FORBIDDEN!r}\n" + SCRIPT],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT,
    )
    if res.returncode != 0:
        return {"error": res.stderr[-3000:]}
    return json.loads(res.stdout.strip().splitlines()[-1])


def jaxfree_instance_run(tmp_path_factory) -> dict:
    """The subprocess's report (see the module docstring); {"error": ...}
    when it failed."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return _run()
    path = tmp_path_factory.getbasetemp().parent / "torch_jaxfree_k9.json"
    with FileLock(str(path) + ".lock"):
        if not path.is_file():
            path.write_text(json.dumps(_run()))
        return json.loads(path.read_text())
