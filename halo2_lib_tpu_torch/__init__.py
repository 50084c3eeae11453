"""halo2_lib_tpu_torch: the halo2 (PlonKish/KZG) prover in PyTorch, with its
device kernels written in CUDA C++ for NVIDIA Hopper (sm_90a).

Layout mirrors ``halo2_lib_tpu``: ``core``/``gates`` hold the eDSL (host
code, copied), ``ops`` the device field/NTT/EC arithmetic and the CUDA kernel
bindings, ``backend`` keygen, create_proof and verify_proof. Entry points run
on ``torch.device("cuda")`` unless the caller passes another device.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level re-exports of the main user-facing API."""
    _exports = {
        "BaseCircuitBuilder": ("halo2_lib_tpu_torch.gates.circuit", "BaseCircuitBuilder"),
        "RangeCircuitBuilder": ("halo2_lib_tpu_torch.gates.circuit", "RangeCircuitBuilder"),
        "BaseCircuitParams": ("halo2_lib_tpu_torch.gates.circuit", "BaseCircuitParams"),
        "CircuitBuilderStage": ("halo2_lib_tpu_torch.gates.circuit", "CircuitBuilderStage"),
        "MockProver": ("halo2_lib_tpu_torch.backend.mock", "MockProver"),
        "GateChip": ("halo2_lib_tpu_torch.gates.flex_gate", "GateChip"),
        "RangeChip": ("halo2_lib_tpu_torch.gates.range", "RangeChip"),
        "Context": ("halo2_lib_tpu_torch.core.context", "Context"),
        "gen_srs": ("halo2_lib_tpu_torch.backend.kzg", "gen_srs"),
        "ParamsKZG": ("halo2_lib_tpu_torch.backend.kzg", "ParamsKZG"),
        "keygen": ("halo2_lib_tpu_torch.backend.keygen", "keygen"),
        "create_proof": ("halo2_lib_tpu_torch.backend.prover", "create_proof"),
        "verify_proof": ("halo2_lib_tpu_torch.backend.verifier", "verify_proof"),
        "base_test": ("halo2_lib_tpu_torch.utils.testing", "base_test"),
    }
    if name in _exports:
        import importlib

        module, attr = _exports[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'halo2_lib_tpu_torch' has no attribute {name!r}")
