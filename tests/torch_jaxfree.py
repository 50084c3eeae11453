"""One run of the port with jax made unimportable, shared by the tests that
need it (test_torch_import.py, test_torch_instances.py).

A subprocess, in which jax, the JAX package and the JAX package's native
engine cannot be imported, takes the instance-column circuit at k=9 through
keygen -> create_proof -> verify_proof on the CPU and reports the vk and
proof bytes, the verdicts, any forbidden module that got loaded, how
often the port's own host engine (native.py, built into _build/) emitted a
region and packed columns on the way, and the port's objects and tensors
that the run left in reference cycles (the collector is off throughout). Under pytest-xdist the
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
import gc, json, sys
gc.disable()  # what the run leaves in reference cycles is read at the end
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

# the port's host engine, its calls counted (the hooks look them up per call)
import os
from halo2_lib_tpu_torch import native
engine = native.get_native()
engine_calls = {"emit_region": 0, "pack_limbs16": 0}
def counted(name, fn):
    def call(*args):
        engine_calls[name] += 1
        return fn(*args)
    return call
for name in engine_calls:
    setattr(engine, name, counted(name, getattr(engine, name)))

params = ParamsKZG.read(ROOT + "/params/kzg_bn254_9.srs", device="cpu")
builder, inst = instance_circuit()
pk = keygen(params, builder, device="cpu")
builder, inst = instance_circuit()
proof = create_proof(params, pk, builder, instances=inst, seed=0, device="cpu")
wrong = [[inst[0][0], (inst[0][1] + 1) % FR_BN254.p]]
report = {
    "vk": pk.vk.to_bytes().hex(),
    "proof": proof.hex(),
    "verifies": verify_proof(params, pk.vk, proof, inst),
    "verifies_wrong_instances": verify_proof(params, pk.vk, proof, wrong),
    "engine": engine.__name__,
    "engine_dir": os.path.relpath(os.path.dirname(engine.__file__), ROOT),
    "engine_calls": engine_calls,
    "loaded": sorted(
        m for m in sys.modules if m.split(".")[0] in FORBIDDEN and sys.modules[m] is not None
    ),
}
del params, builder, inst, pk, proof, wrong
gc.set_debug(gc.DEBUG_SAVEALL)
gc.collect()
report["left_to_collector"] = sorted({
    type(o).__qualname__ for o in gc.garbage
    if isinstance(o, torch.Tensor) or type(o).__module__.startswith("halo2_lib")
})
print(json.dumps(report))
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
