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

With a mesh (``warm_prover(..., mesh=...)``, parallel/sharded.py) the
warm-up builds the pk's mesh runtime, its tables sharded on their rows, and
runs the same tasks through the sharded NTT, upload and commit.

Usage: ``maybe_warm(params, pk)`` before the first proof when the
environment sets HALO2_PRECOMPILE=1, or ``warm_prover`` directly.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops import cuda_field as cf
from ..ops.limbs import N_LIMBS
from ..parallel.sharded import shard_devices
from ..utils.device import resolve_device
from .prover import runtime_for


def warm_prover(params, pk, device=None, max_workers: int | None = None, mesh=None) -> int:
    """Load the kernels and run each of the prover's shared device tasks once
    for (params, pk) on `device` (the CUDA card unless the caller asks for
    another), or over `mesh` (its runtime built and cached on the pk, as
    create_proof(mesh=...) uses it). The tasks run in order on the caller's
    thread: with no per-shape compile to overlap, threads would only
    serialize the same launches, so `max_workers` (the JAX signature's) is
    accepted and unused. Returns the number of tasks run; repeating a call
    is cheap."""
    devices = (resolve_device(device),) if mesh is None else tuple(dict.fromkeys(shard_devices(mesh)))
    if any(d.type == "cuda" for d in devices):
        cf.load()
    with torch.inference_mode():
        rt = runtime_for(params, pk, devices[0], mesh)
        L, n, n_ext = rt.layout, rt.n, rt.dom.n_ext
        zn, ze = L.zeros(1, n), L.zeros(1, n_ext)

    tasks = [
        lambda: rt.ntt.forward_cols(zn),
        lambda: rt.ntt.inverse_cols(zn),
        lambda: rt.coset.forward_cols(ze),
        lambda: rt.coset.inverse_cols(ze),
        lambda: L.upload(rt.df, np.zeros((1, n, N_LIMBS), np.uint16)),
        lambda: rt.commit(zn, "lagA"),
        lambda: rt.commit(zn, "monoA"),
        lambda: rt.fd._batch_inv(zn),
    ]

    with torch.inference_mode():
        for task in tasks:
            task()
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    return len(tasks)


def maybe_warm(params, pk, device=None, mesh=None) -> bool:
    """Environment-gated entry: warms iff HALO2_PRECOMPILE=1."""
    if os.environ.get("HALO2_PRECOMPILE") != "1":
        return False
    warm_prover(params, pk, device, None, mesh)
    return True
