"""Kernel launches a proof, by the program's launch counters
(halo2_lib_tpu_torch.ops.cuda_field.LAUNCHES, reset at the window's start)."""


def read(run):
    proofs = run.work.get("proofs")
    launches = run.counters.get("launches")
    return None if not proofs or launches is None else launches / proofs
