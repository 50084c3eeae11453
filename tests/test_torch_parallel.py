"""The port's multi-device layer (halo2_lib_tpu_torch/parallel/) on virtual
CPU meshes, held against the JAX package: tests/test_sharded.py and
tests/test_distributed.py on the port.

A virtual mesh is ``make_mesh(n, device="cpu")``: n shards on the CPU, the
counterpart of the JAX tests' 8-device virtual CPU mesh. The sharded MSM
equals the JAX package's host MSM; the sharded NTT the JAX NTT's digests
(ntt_digests.json) and the port's single-device transform; a mesh proof the
JAX golden proof's bytes. The process-spanning grid runs for real in two CPU
processes joined over gloo.
"""

import ast
import json
import os
import random
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from halo2_lib_tpu_torch.backend.kzg import ParamsKZG
from halo2_lib_tpu_torch.backend.prover import create_proof
from halo2_lib_tpu_torch.backend.verifier import verify_proof
from halo2_lib_tpu_torch.convert import proving_key_from_numpy
from halo2_lib_tpu_torch.ops.ec_device import DeviceCurve
from halo2_lib_tpu_torch.ops.limbs import DeviceField
from halo2_lib_tpu_torch.ops.ntt import CosetNTT, new_ntt
from halo2_lib_tpu_torch.parallel import make_mesh, sharded_msm, sharded_ntt_step
from halo2_lib_tpu_torch.parallel.distributed import (
    MeshDevice, flat_axes, init_distributed, make_global_mesh,
)
from halo2_lib_tpu_torch.parallel.rows import RowLayout
from halo2_lib_tpu_torch.parallel.sharded import Mesh, ShardedNTT
from halo2_lib_tpu_torch.utils.curves import BN254_G1
from halo2_lib_tpu_torch.utils.fields import FR_BN254
from halo2_lib_tpu_torch.utils.testing import golden_circuit

# One core per test process: the suite runs in parallel workers.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "tests", "data", "torch_goldens")
DIST_ENV = ("HALO2_DIST_COORD", "HALO2_DIST_NPROCS", "HALO2_DIST_PROCID")


@pytest.fixture(scope="module")
def dc():
    from halo2_lib_tpu_torch.utils.fields import FQ_BN254

    return DeviceCurve(DeviceField(FQ_BN254), BN254_G1)


@pytest.fixture(scope="module")
def fr():
    return DeviceField(FR_BN254)


def _jax_msm(seed: int, n: int):
    """Points, scalars and their MSM by the JAX package's host curve."""
    from halo2_lib_tpu.utils.curves import BN254_G1 as JG1

    rng = random.Random(seed)
    pts = [JG1.random_point(rng) for _ in range(n)]
    scs = [JG1.random_scalar(rng) for _ in range(n)]
    return pts, scs, JG1.msm(pts, scs)


# --- the mesh ---------------------------------------------------------------------------


def test_make_mesh_virtual_and_card():
    mesh = make_mesh(4, device="cpu")
    assert mesh.axis_names == ("dp",) and mesh.devices.size == 4
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert make_mesh(device="cpu").devices.size == 1
    assert mesh == make_mesh(4, device="cpu") and mesh != make_mesh(2, device="cpu")
    if torch.cuda.is_available():
        assert all(d.index is not None for d in make_mesh().devices.flat)
    else:
        # no card: neither the card mesh nor card devices named by hand
        with pytest.raises(RuntimeError):
            make_mesh()
        with pytest.raises(RuntimeError):
            make_mesh(2, device="cuda")


# --- sharded MSM --------------------------------------------------------------------------


@pytest.mark.parametrize("seed,n,shards", [(31, 24, 8), (55, 16, 4)])
def test_sharded_msm_matches_jax_host_msm(dc, seed, n, shards):
    pts, scs, want = _jax_msm(seed, n)
    assert sharded_msm(dc, pts, scs, make_mesh(shards, device="cpu")) == want


# --- sharded NTT --------------------------------------------------------------------------


def _ntt_inputs(fr, log_n: int):
    """The golden script's two columns (make_goldens.ntt_inputs)."""
    P = FR_BN254.p
    rng = np.random.default_rng(1000 + log_n)
    words = rng.integers(0, 1 << 63, size=(2, 1 << log_n, 4), dtype=np.int64)
    cols = [[sum(int(w) << (63 * i) for i, w in enumerate(el)) % P for el in col] for col in words]
    return torch.stack([fr.pack(c, device="cpu") for c in cols])


def _digest(t):
    import hashlib

    return hashlib.sha256(t.numpy().astype("<u4").tobytes()).hexdigest()


def test_sharded_ntt_matches_jax_digests_and_single_device(fr):
    k = 8
    with open(os.path.join(GOLDENS, "ntt_digests.json")) as f:
        want = json.load(f)[str(k)]
    mesh = make_mesh(8, device="cpu")
    x = _ntt_inputs(fr, k)
    sn, sc = ShardedNTT(fr, k, mesh), ShardedNTT(fr, k, mesh, shift=7)
    fwd, inv = sn.forward(x), sn.inverse(x)
    cfwd, cinv = sc.forward(x), sc.inverse(x)
    assert [_digest(t) for t in (fwd, inv, cfwd, cinv)] == [
        want["forward"], want["inverse"], want["coset_forward"], want["coset_inverse"]
    ]
    single, coset = new_ntt(fr, k, "cpu"), CosetNTT(fr, k, 7, "cpu")
    assert torch.equal(fwd, single.forward(x)) and torch.equal(inv, single.inverse(x))
    assert torch.equal(cfwd, coset.forward(x)) and torch.equal(cinv, coset.inverse(x))
    # round trips, and the JAX entry point's one-column form
    assert torch.equal(sn.inverse(fwd), x) and torch.equal(sc.forward(cinv), x)
    assert torch.equal(sharded_ntt_step(fr, k, mesh, x[0]), single.forward(x[0]))


def test_sharded_ntt_refuses_a_mesh_larger_than_its_rows(fr):
    with pytest.raises(ValueError):
        ShardedNTT(fr, 5, make_mesh(8, device="cpu"))  # n1 = 4 rows


# --- the row layout's cross-shard forms -----------------------------------------------------


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_row_layout_matches_the_plain_torch_calls(fr, shards):
    """Each cross-shard form of parallel/rows.py gives, gathered, what the
    single-device layout gives."""
    gen = torch.Generator().manual_seed(shards)
    x = torch.randint(0, 1 << 16, (3, 16, 64), dtype=torch.int32, generator=gen)
    x[:, 15] &= 0x0FFF  # below p: canonical field elements
    single, sharded = RowLayout("cpu"), RowLayout("cpu", ["cpu"] * shards)
    rows = sharded.shard(x)
    g = sharded.gather
    assert torch.equal(g(rows), x)
    for s in (1, -1, 5, -12, 67):
        assert torch.equal(g(sharded.roll(rows, s)), single.roll(x, s))
    assert torch.equal(g(sharded.pad(rows, 256)), single.pad(x, 256))
    assert torch.equal(sharded.take(rows, 13, 40), single.take(x, 13, 40))
    vals = x[:1, :, :7]
    assert torch.equal(g(sharded.put(rows, 29, vals)), single.put(x, 29, vals))
    wide = single.pad(x[0], 256)
    assert torch.equal(g(sharded.pieces(sharded.shard(wide), 3, 64)), single.pieces(wide, 3, 64))
    fd = sharded.field(fr)
    assert torch.equal(g(fd.prefix_prod(rows)), fr.prefix_prod(x))
    assert torch.equal(sharded.sum_lanes(fr, rows), single.sum_lanes(fr, x))
    fill = fr.one_mont((1,), "cpu")
    assert torch.equal(g(sharded.shift(rows, fill)), single.shift(x, fill))
    assert torch.equal(g(sharded.powers(fr, 5, 64)), single.powers(fr, 5, 64))
    assert torch.equal(g(sharded.rows_below(64, 33)), single.rows_below(64, 33))
    assert torch.equal(g(fd._mont_mul(rows, x[:, :, :1])), fr._mont_mul(x, x[:, :, :1]))
    with pytest.raises(ValueError):
        fd._mont_mul(rows, x)  # a whole plain column beside Rows: not sharded


# --- the prover over a mesh -----------------------------------------------------------------


@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(GOLDENS, "golden_k9.npz"))


@pytest.fixture(scope="module")
def params():
    return ParamsKZG.read(os.path.join(ROOT, "params", "kzg_bn254_9.srs"), device="cpu")


def test_mesh_proof_is_the_golden_proof(params, golden):
    """create_proof over 4 virtual shards: every column sharded on its rows,
    each stage per shard with its cross-shard forms; the proof is the JAX
    package's bytes (golden_k9.npz), which the single-device proof also is
    (tests/test_torch_prover.py)."""
    pk = proving_key_from_numpy(golden, "cpu")
    proof = create_proof(params, pk, golden_circuit(), seed=0, mesh=make_mesh(4, device="cpu"))
    assert proof == bytes(golden["proof"])
    assert verify_proof(params, pk.vk, proof)
    assert pk._runtime.layout.nshards == 4


def test_mesh_proof_refusals(params, golden):
    """Not with the phase-0 pipeline, not on another device than the mesh's,
    not over a mesh that spans processes, not over cards that are absent."""
    pk = proving_key_from_numpy(golden, "cpu")
    mesh = make_mesh(2, device="cpu")
    with pytest.raises(ValueError):
        create_proof(params, pk, golden_circuit(), phase0=object(), mesh=mesh)
    grid = np.empty((2, 2), dtype=object)
    for p in range(2):
        for i in range(2):
            grid[p, i] = MeshDevice(p, 2 * p + i, "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_proof(params, pk, golden_circuit(), mesh=Mesh(grid, ("hosts", "dp")))
    if not torch.cuda.is_available():
        cards = Mesh([torch.device("cuda", 0), torch.device("cuda", 1)], ("dp",))
        with pytest.raises(RuntimeError):
            create_proof(params, pk, golden_circuit(), mesh=cards)


# --- the device guard -----------------------------------------------------------------------


def test_every_kernel_launch_goes_through_the_device_guard():
    """In ops/cuda_field.py only _launch (which enters torch.cuda.device of
    the operands) and load reach the library: a launch from a thread whose
    current card is another would fail or run on the wrong card."""
    path = os.path.join(ROOT, "halo2_lib_tpu_torch", "ops", "cuda_field.py")
    tree = ast.parse(open(path).read(), path)
    callers = set()
    for fn in ast.walk(tree):
        if isinstance(fn, ast.FunctionDef):
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "_lib":
                    callers.add(fn.name)
    assert callers == {"_launch", "load"}, callers
    launch = next(f for f in ast.walk(tree) if isinstance(f, ast.FunctionDef) and f.name == "_launch")
    guards = [ast.unparse(w.items[0].context_expr) for w in ast.walk(launch) if isinstance(w, ast.With)]
    assert guards == ["torch.cuda.device(like.device)"]
    wrappers = {f.name for f in ast.walk(tree) if isinstance(f, ast.FunctionDef)
                and any(getattr(getattr(c, "func", None), "id", None) == "_launch" for c in ast.walk(f))}
    assert len(wrappers) >= 15, wrappers


# --- distributed ----------------------------------------------------------------------------


def test_init_noop_without_env(monkeypatch):
    for k in DIST_ENV:
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() is False
    assert init_distributed("cpu") is False


def test_single_process_mesh_matches_local_and_drives_sharded_msm(dc, monkeypatch):
    for k in DIST_ENV:
        monkeypatch.delenv(k, raising=False)
    mesh = make_global_mesh(device="cpu", n_local=2)
    assert mesh == make_mesh(2, device="cpu")
    assert flat_axes(mesh) == ("dp",)
    pts, scs, want = _jax_msm(55, 16)
    assert sharded_msm(dc, pts, scs, mesh) == want


_GRID_SCRIPT = r"""
import json, sys
sys.path.insert(0, ROOT)
import torch
import torch.distributed as dist
from halo2_lib_tpu_torch.parallel.distributed import flat_axes, init_distributed, make_global_mesh
assert init_distributed("cpu")
mesh = make_global_mesh(device="cpu", n_local=2)
print(json.dumps({
    "shape": list(mesh.devices.shape),
    "axes": list(flat_axes(mesh)),
    "entries": [[e.process_index, e.id, e.device] for e in mesh.devices.flat],
    "again": init_distributed("cpu"),
}))
dist.destroy_process_group()
"""


def test_two_process_grid_over_gloo():
    """The [processes, local devices] grid for real: two CPU processes, each
    with 2 virtual shards, joined over gloo on localhost; each sees the
    whole grid. Joined with a timeout, so a lost peer cannot hang the run."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, HALO2_DIST_COORD=f"127.0.0.1:{port}", HALO2_DIST_NPROCS="2",
                   HALO2_DIST_PROCID=str(rank), OMP_NUM_THREADS="1")
        env.pop("PYTHONPATH", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", f"ROOT = {ROOT!r}\n" + _GRID_SCRIPT], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=150)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    want = [[p, 2 * p + i, "cpu"] for p in range(2) for i in range(2)]
    for o in outs:
        assert o["shape"] == [2, 2] and o["axes"] == ["hosts", "dp"]
        assert o["entries"] == want and o["again"] is True
