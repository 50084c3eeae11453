#!/usr/bin/env python3
"""Time the ECDSA k=15 bench region plain against pipelined, on one NVIDIA card.

    python3 pipeline_probe.py [--rounds N]

bench.py's warm e2e region (the pinned prover builder, the witness, then
create_proof, on a cached key) in five modes, each round in a rotated order
so that no mode always runs first:

- plain:            the witness, then create_proof;
- pipelined:        backend/pipeline.py's Phase0Pipeline around the witness;
- switch 0.001 / switch 0.0002: the same with sys.setswitchinterval set to
                    that many seconds (Python's default is 0.005) for the run;
- per-column:       the pipeline's worker committing one column per
                    commit_columns call instead of every finished column.

Each pipelined run also records its commit calls: start (seconds after the
run began), duration (host clock, the side stream synchronized at the
call's end) and columns, and the second at which the witness returned.
Every proof must equal the JAX package's ECDSA k=15 digest
(tests/data/torch_goldens/ecdsa_k15.json). One JSON line per run, then the
median, least and largest e2e seconds per mode. Exits non-zero without a
CUDA card.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
MODES = ["plain", "pipelined", "switch 0.001", "switch 0.0002", "per-column"]


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("pipeline_probe: no CUDA device", file=sys.stderr)
        sys.exit(2)
    rounds = int(sys.argv[sys.argv.index("--rounds") + 1]) if "--rounds" in sys.argv else 5
    sys.path.insert(0, HERE)
    from halo2_lib_tpu_torch.backend.keygen import keygen
    from halo2_lib_tpu_torch.backend.kzg import ParamsKZG
    from halo2_lib_tpu_torch.backend.pipeline import Phase0Pipeline
    from halo2_lib_tpu_torch.backend.precompile import warm_prover
    from halo2_lib_tpu_torch.backend.prover import create_proof
    from halo2_lib_tpu_torch.ops import cuda_field as cf
    from halo2_lib_tpu_torch.utils.pinning import pinning_of
    from halo2_lib_tpu_torch.utils.testing import ecdsa_circuit, ecdsa_inputs, ecdsa_witness

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    dev = torch.device("cuda")
    t = time.time()
    cf.build()
    cf.load()
    params = ParamsKZG.read(os.path.join(HERE, "params", "kzg_bn254_15.srs"), device=dev)
    rng = random.Random(0x5EC0)  # the JAX package's seed, as chip_smoke.py phase 4b
    ebuilder = ecdsa_circuit(15, 14, rng=rng)
    epk = keygen(params, ebuilder, device=dev)
    pinning = pinning_of(ebuilder)
    state = rng.getstate()  # the prover witness's draws start here
    with open(os.path.join(HERE, "tests", "data", "torch_goldens", "ecdsa_k15.json")) as f:
        want = json.load(f)["proof_sha256"]
    print(f"set-up (build, SRS, keygen) {time.time() - t:.3f}s", flush=True)

    class Timed(Phase0Pipeline):
        """Phase0Pipeline recording each commit call; per_column commits one
        column a call."""

        per_column = False

        def _commit_group(self, group):
            t0 = time.time()
            super()._commit_group(group)
            torch.cuda.current_stream(self.device).synchronize()
            self.calls.append([round(t0 - self.t0, 4), round(time.time() - t0, 4), len(group)])

        def _run_worker(self):
            if not self.per_column:
                return super()._run_worker()
            while (item := self._cols.get()) is not None:
                self._commit_group([item])

    def run(mode: str):
        r = random.Random()
        r.setstate(state)
        pb = pinning.prover_builder()
        torch.cuda.synchronize()
        old = sys.getswitchinterval()
        if mode.startswith("switch"):
            sys.setswitchinterval(float(mode.split()[1]))
        try:
            t0 = time.time()
            out = {"mode": mode}
            if mode == "plain":
                ecdsa_witness(pb, ecdsa_inputs(), r)
                out["witness_s"] = round(time.time() - t0, 4)
                proof = create_proof(params, epk, pb, seed=0, device=dev)
            else:
                pipe = Timed(params, epk, pb, device=dev)
                pipe.t0, pipe.calls, pipe.per_column = t0, [], mode == "per-column"
                ends = []

                def witness(b):
                    ecdsa_witness(b, ecdsa_inputs(), r)
                    ends.append(time.time() - t0)

                pipe.run(witness)
                out["witness_s"] = round(ends[0], 4)
                out["witness_and_pipeline_s"] = round(time.time() - t0, 4)
                out["commit_calls"] = pipe.calls
                proof = create_proof(params, epk, pb, seed=0, device=dev, phase0=pipe)
            torch.cuda.synchronize()
            out["e2e_s"] = round(time.time() - t0, 4)
        finally:
            sys.setswitchinterval(old)
        if hashlib.sha256(proof).hexdigest() != want:
            raise AssertionError(f"{mode}: the proof is not the JAX ECDSA digest's")
        return out

    warm_prover(params, epk, device=dev)
    run("plain")  # the runtime's tables and the allocator's blocks, once
    e2e = {m: [] for m in MODES}
    for i in range(rounds):
        for mode in MODES[i % len(MODES):] + MODES[: i % len(MODES)]:
            out = run(mode)
            e2e[mode].append(out["e2e_s"])
            print(json.dumps(out), flush=True)
    for mode in MODES:
        v = e2e[mode]
        print(f"{mode}: e2e median {statistics.median(v)}s, least {min(v)}s, largest {max(v)}s "
              f"over {len(v)} runs", flush=True)
    print(json.dumps({"ok": True, "rounds": rounds, "e2e_s": e2e}), flush=True)


if __name__ == "__main__":
    main()
