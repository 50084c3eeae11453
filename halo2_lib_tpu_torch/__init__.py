"""halo2_lib_tpu_torch: the halo2 (PlonKish/KZG) prover in PyTorch, with its
device kernels written in CUDA C++ for NVIDIA Hopper (sm_90a).

Layout mirrors ``halo2_lib_tpu``: ``core``/``gates`` hold the eDSL (host
code, copied), ``ops`` the device field/NTT/EC arithmetic and the CUDA kernel
bindings, ``backend`` keygen, create_proof and verify_proof. Entry points run
on ``torch.device("cuda")`` unless the caller passes another device.
"""

__version__ = "0.1.0"
