"""Warm-up of the prover's device state before the first proof (HALO2_PRECOMPILE=1).

The port of ``halo2_lib_tpu/backend/precompile.py``. The JAX module compiles
the shape-shared XLA executables concurrently up front. The port has no
per-shape compile: its kernels are one library built once by nvcc from
``csrc/`` (hash-keyed in the git-ignored ``_build/``). So the warm-up loads
that library, building it if needed, builds the pk's ProverRuntime (its
tables in Lagrange, coefficient and extended-coset form) and runs each task
of the JAX list once on zeros at the pk's sizes: the NTT both ways, the
coset NTT both ways, the u16 upload conversion, a commit on each basis and
the batch inversion. That puts the library, the twiddle and coset tables,
the SRS bases and the runtime on the card before the first proof.

Usage: ``maybe_warm(params, pk)`` before the first proof when the
environment sets HALO2_PRECOMPILE=1, or ``warm_prover`` directly.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops import cuda_field as cf
from ..ops.limbs import N_LIMBS
from ..utils.device import resolve_device
from .prover import _lag_from_u16, runtime_for


def warm_prover(params, pk, device=None, max_workers: int | None = None) -> int:
    """Load the kernels and run each of the prover's shared device tasks once
    for (params, pk) on `device` (the CUDA card unless the caller asks for
    another). The tasks run in order on the caller's thread: with no
    per-shape compile to overlap, threads would only serialize the same
    launches, so `max_workers` (the JAX signature's) is accepted and unused.
    Returns the number of tasks run; repeating a call is cheap."""
    device = resolve_device(device)
    if device.type == "cuda":
        cf.load()
    with torch.inference_mode():
        rt = runtime_for(params, pk, device)
        dom, df, n = rt.dom, rt.df, rt.n
        ntt, coset = dom.ntt(device), dom.coset_ntt(device)
        zeros = lambda m: torch.zeros((1, N_LIMBS, m), dtype=torch.int32, device=device)
        zn, ze = zeros(n), zeros(dom.n_ext)

    tasks = [
        lambda: ntt.forward_cols(zn),
        lambda: ntt.inverse_cols(zn),
        lambda: coset.forward_cols(ze),
        lambda: coset.inverse_cols(ze),
        lambda: _lag_from_u16(df, np.zeros((1, n, N_LIMBS), np.uint16), device),
        lambda: params.commit_columns(df, zn, rt.tables["lagA"]),
        lambda: params.commit_columns(df, zn, rt.tables["monoA"]),
        lambda: df._batch_inv(zeros(n)),
    ]

    with torch.inference_mode():
        for task in tasks:
            task()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return len(tasks)


def maybe_warm(params, pk, device=None) -> bool:
    """Environment-gated entry: warms iff HALO2_PRECOMPILE=1."""
    if os.environ.get("HALO2_PRECOMPILE") != "1":
        return False
    warm_prover(params, pk, device)
    return True
