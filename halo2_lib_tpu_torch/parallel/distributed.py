"""Joining several processes, and the mesh that spans them.

The port of ``halo2_lib_tpu/parallel/distributed.py``. The JAX module joins
hosts with ``jax.distributed.initialize`` and builds a process-spanning
``jax.sharding.Mesh``: its leading axis spans processes, the trailing one
each process's local devices. Here ``torch.distributed`` joins the processes
(NCCL between cards, gloo when the caller asks for the CPU), and
``make_global_mesh`` builds the same [processes, local devices] grid from an
all-gather of each process's devices. The sharded work of parallel/sharded.py
and the prover drive one process's one-axis mesh; a grid that spans
processes is not driven through the prover (ROADMAP Queue 3).

A single process takes the same path with nothing to join:
``init_distributed()`` is a no-op unless the HALO2_DIST_* triple is set, and
``make_global_mesh`` is then the local one-axis mesh.

Env contract (one setting per process):
  HALO2_DIST_COORD   coordinator address host:port (process 0's address)
  HALO2_DIST_NPROCS  total process count
  HALO2_DIST_PROCID  this process's index (0-based)
"""

from __future__ import annotations

import datetime
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .sharded import Mesh, make_mesh

# how long joining the group and its first collectives wait for the others
JOIN_TIMEOUT = datetime.timedelta(seconds=120)


class MeshDevice(NamedTuple):
    """An entry of a process-spanning mesh: the process that drives the
    device, the device's global id (process-major, as JAX numbers them) and
    its name in that process."""

    process_index: int
    id: int
    device: str


def init_distributed(device=None) -> bool:
    """Join the multi-process job iff the HALO2_DIST_* env triple is set:
    NCCL, or gloo when `device` is the CPU. Returns True when running
    multi-process (the group joined, now or before), False for the
    single-process path. Idempotent."""
    coord = os.environ.get("HALO2_DIST_COORD")
    nprocs = os.environ.get("HALO2_DIST_NPROCS")
    procid = os.environ.get("HALO2_DIST_PROCID")
    if not (coord and nprocs and procid):
        return False
    if not dist.is_initialized():
        cpu = device is not None and torch.device(device).type == "cpu"
        if not cpu and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for NCCL: pass device='cpu' to join over gloo")
        dist.init_process_group(
            "gloo" if cpu else "nccl",
            init_method=f"tcp://{coord}",
            world_size=int(nprocs),
            rank=int(procid),
            timeout=JOIN_TIMEOUT,
        )
    return True


def make_global_mesh(ici_axis: str = "dp", dcn_axis: str = "hosts", device=None,
                     n_local: int | None = None) -> Mesh:
    """Process-spanning mesh: [processes, local devices].

    Several processes: a 2-D mesh whose rows are processes, each entry a
    MeshDevice (every process must bring as many devices). One process: the
    local one-axis mesh, ``make_mesh(n_local, ici_axis, device)`` (the
    visible cards, or `n_local` virtual shards on `device`), so every caller
    is mesh-shape agnostic."""
    init_distributed(device)
    local = make_mesh(n_local, ici_axis, device)
    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return local
    nproc, rank = dist.get_world_size(), dist.get_rank()
    per_host = local.size
    mine = [(rank, rank * per_host + i, str(d)) for i, d in enumerate(local.devices.flat)]
    everyone: list = [None] * nproc
    dist.all_gather_object(everyone, mine)
    if any(len(e) != per_host for e in everyone):
        raise ValueError(f"processes bring {[len(e) for e in everyone]} devices; a grid needs equal rows")
    grid = np.empty((nproc, per_host), dtype=object)
    for entries in everyone:
        for pi, did, name in entries:
            grid[pi, did % per_host] = MeshDevice(pi, did, name)
    return Mesh(grid, (dcn_axis, ici_axis))


def flat_axes(mesh: Mesh) -> tuple[str, ...]:
    """The mesh's axis names, for work that shards rows over every axis at
    once (single- and multi-process meshes alike)."""
    return tuple(mesh.axis_names)
