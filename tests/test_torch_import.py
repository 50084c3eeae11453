"""The port stands alone: it imports neither jax, nor the JAX package, nor
the JAX package's native C engine, and runs keygen -> create_proof ->
verify_proof with jax made unimportable, through its own host engine."""

import ast
import os

from torch_jaxfree import FORBIDDEN, ROOT, jaxfree_instance_run

PORT = os.path.join(ROOT, "halo2_lib_tpu_torch")


def _port_files():
    out = [os.path.join(ROOT, name) for name in ("chip_smoke.py", "pipeline_probe.py",
                                                 "dft_probe.py")]
    for d, _, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_forbidden_imports():
    files = _port_files()
    assert len(files) > 20
    bad = [
        (os.path.relpath(f, ROOT), m)
        for f in files
        for m in _imports(f)
        if m.split(".")[0] in FORBIDDEN
    ]
    assert not bad, bad


def test_srs_and_pairing_modules_are_walked():
    """The SRS generator and the pairing gadgets are among the files the
    import check walks."""
    walked = {os.path.relpath(f, PORT) for f in _port_files()}
    for rel in ("utils/chacha.py", "backend/kzg.py", "ecc/fields_ext.py", "ecc/pairing.py",
                "ecc/final_exp.py", "utils/testing.py"):
        assert rel in walked, rel


def test_pipeline_mock_and_gadget_modules_are_walked():
    """The pipeline, the device mock, the warm-up, SafeTypes and Poseidon are
    among the files the import check walks (the jax-free run below loads
    each of them too)."""
    walked = {os.path.relpath(f, PORT) for f in _port_files()}
    for rel in ("backend/pipeline.py", "backend/mock_device.py", "backend/precompile.py",
                "safe_types.py", "poseidon/__init__.py", "poseidon/primitives.py",
                "poseidon/spec.py", "poseidon/state.py", "poseidon/hasher.py", "poseidon/chip.py"):
        assert rel in walked, rel


def test_parallel_modules_and_root_scripts_are_walked():
    """The multi-device layer and the port's scripts at the root are among
    the files the import check walks (the jax-free run below loads parallel/
    too)."""
    walked = {os.path.relpath(f, ROOT) for f in _port_files()}
    for rel in ("halo2_lib_tpu_torch/parallel/__init__.py", "halo2_lib_tpu_torch/parallel/sharded.py",
                "halo2_lib_tpu_torch/parallel/distributed.py", "halo2_lib_tpu_torch/parallel/rows.py",
                "chip_smoke.py", "pipeline_probe.py"):
        assert rel in walked, rel


def test_host_engine_loader_is_walked():
    """The host engine's loader is among the files the import check walks
    (the jax-free run below loads and counts the engine)."""
    walked = {os.path.relpath(f, ROOT) for f in _port_files()}
    assert "halo2_lib_tpu_torch/native.py" in walked


def test_ntt_mxu_module_and_probe_are_walked():
    """The digit-plane DFT NTT and its probe script are among the files the
    import check walks (the jax-free run below loads the module too)."""
    walked = {os.path.relpath(f, ROOT) for f in _port_files()}
    assert {"halo2_lib_tpu_torch/ops/ntt_mxu.py", "dft_probe.py"} <= walked


def test_k8_prove_without_jax(tmp_path_factory):
    """keygen -> create_proof -> verify_proof with jax, the JAX package and
    the JAX package's native engine unimportable (the instance-column
    circuit at k=9, whose bytes test_torch_instances.py holds against the
    JAX goldens), the port's own engine emitting its regions and packing its
    columns."""
    run = jaxfree_instance_run(tmp_path_factory)
    assert "error" not in run, run.get("error")
    assert run["verifies"] and not run["verifies_wrong_instances"]
    assert run["loaded"] == []
    assert run["engine"] == "h2t_host_engine" and "halo2_native" in FORBIDDEN
    assert run["engine_dir"] == os.path.join("halo2_lib_tpu_torch", "_build")
    assert run["engine_calls"]["emit_region"] > 0 and run["engine_calls"]["pack_limbs16"] > 0


def test_msm_and_prover_check_modules_are_walked():
    """The in-circuit MSM gadgets, their thread manager and the prover with
    its self-checks and switches are among the files the import check walks."""
    walked = {os.path.relpath(f, PORT) for f in _port_files()}
    for rel in ("ecc/ec.py", "ecc/pippenger.py", "ecc/fixed_base.py", "gates/threads.py",
                "gates/circuit.py", "utils/pinning.py", "backend/pinned.py", "backend/keygen.py",
                "backend/prover.py", "ops/ntt.py", "utils/device.py"):
        assert rel in walked, rel
