"""Multi-device proving: the mesh, the sharded MSM and NTT (parallel/sharded.py),
the row-sharded prover layout (parallel/rows.py) and the process-spanning
mesh (parallel/distributed.py)."""

from .sharded import make_mesh, sharded_msm, sharded_ntt_step

__all__ = ["sharded_msm", "sharded_ntt_step", "make_mesh"]
