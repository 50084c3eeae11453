"""A halo2 proving service: a closed loop of one client asking for a proof
of the configuration's circuit on a fresh input each time.

Set-up reads the SRS file, builds the circuit on a MOCK builder (its random
points drawn from the configuration's ``rng_seed``, as the JAX package's
goldens were made), runs keygen and ``warm_prover``, makes one warm proof of
the circuit's golden input, and makes the pool of inputs from the seed
(``circuits/<name>.py``). Each request builds the pinned prover builder,
runs the witness on the next input and calls ``create_proof`` on the plain
path; the proof's bytes come back to the host. ``timings=`` is passed only
under a trace, since its stage ends synchronise the card.

The reference (``reference/proofs.py``: a frozen copy of the verifier) then
checks a sample of the window's proofs drawn from the seed, with the last
one, against the verifying key, whose bytes must hash to the digest the JAX
package gave for this circuit, as the warm proof's bytes must; and no proof
may repeat an earlier one.

Controls (never in a measured run): "other_srs" proves the window's
requests against an SRS of another tau (``ParamsKZG.setup(k, seed=7)``)
with the same key, so every commitment the proof carries is of the wrong
bases; "prank" adds 1 to one witness cell after the witness, so the
program is asked to prove an unsatisfied circuit (it raises: no answer
comes). Faults: "altered" flips a bit of each proof where it is made,
"unchanged" returns the first proof again.
"""

from __future__ import annotations

import hashlib
import os
import random

import torch

from benchmark.harness.cells import circuit_module
from benchmark.harness.traffic import derive_seed
from benchmark.reference.proofs import ProofChecker

PROVER_STAGES_AFTER = "runtime"  # stages after it run on the card (commits ... shplonk)


class System:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.config
        self.dev = ctx.device
        self.run = None
        self.proofs: list[bytes] = []

    def setup(self) -> None:
        from halo2_lib_tpu_torch.backend.keygen import keygen
        from halo2_lib_tpu_torch.backend.kzg import ParamsKZG
        from halo2_lib_tpu_torch.backend.precompile import warm_prover
        from halo2_lib_tpu_torch.backend.prover import create_proof
        from halo2_lib_tpu_torch.ops import cuda_field
        from halo2_lib_tpu_torch.utils.pinning import pinning_of

        cfg, dev = self.cfg, self.dev
        self.create_proof = create_proof
        self.cuda_field = cuda_field
        circ_cfg = cfg["circuit"]
        self.circuit = circuit_module(self.ctx.cell.bench_dir, circ_cfg["name"])
        phase = self.ctx.phase
        with phase("srs"):
            self.params = ParamsKZG.read(os.path.join(self.ctx.cell.root, cfg["srs_file"]), device=dev)
        rng = random.Random(int(circ_cfg["rng_seed"]))
        with phase("mock witness"):
            builder = self.circuit.mock_builder(circ_cfg, rng)
        with phase("keygen"):
            self.pk = keygen(self.params, builder, device=dev)
        self.vk_bytes = self.pk.vk.to_bytes()
        self.pinning = pinning_of(builder)
        del builder
        with phase("warm_prover"):
            warm_prover(self.params, self.pk, dev)
        with phase("warm proof"):
            pb = self.pinning.prover_builder()
            self.circuit.witness(circ_cfg, pb, self.circuit.golden_input(circ_cfg), rng)
            self.golden_proof = create_proof(self.params, self.pk, pb, seed=int(cfg["golden"]["proof_seed"]),
                                             device=dev)
        with phase("inputs"):
            self.inputs = self.circuit.make_inputs(circ_cfg, self.ctx.seed, int(self.ctx.traffic["pool"]))
        self.prove_params = self.params
        if self.ctx.control == "other_srs":
            self.prove_params = ParamsKZG.setup(self.params.k, seed=7, device=dev)
            warm_prover(self.prove_params, self.pk, dev)
        elif self.ctx.control not in (None, "prank"):
            raise ValueError(f"halo2_prover: unknown control {self.ctx.control!r}")

    def request(self, i: int, index: int) -> None:
        rec = self.ctx.recorder
        rng = random.Random(derive_seed(self.ctx.seed, "witness", i))
        with rec.span("witness"):
            pb = self.pinning.prover_builder()
            self.circuit.witness(self.cfg["circuit"], pb, self.inputs[index], rng)
        if self.ctx.control == "prank":
            ctx = pb.main(0)
            j = len(ctx.advice) // 2
            ctx.advice[j] = int(ctx.advice[j]) + 1
        timings = {} if self.ctx.tracing else None
        if i == 0:
            self.cuda_field.reset_launches()
        with rec.span("create_proof"):
            proof = self.create_proof(self.prove_params, self.pk, pb, seed=derive_seed(self.ctx.seed, "proof", i),
                                      device=self.dev, timings=timings)
        if self.ctx.fault == "altered":
            proof = bytes([proof[0] ^ 1]) + proof[1:]
        elif self.ctx.fault == "unchanged" and self.proofs:
            proof = self.proofs[0]
        self.proofs.append(proof)
        if timings:
            names = list(timings)
            after = names[names.index(PROVER_STAGES_AFTER) + 1 :] if PROVER_STAGES_AFTER in names else []
            for name in names:
                rec.add("stage." + name, timings[name])
            rec.add("device_stages", sum(timings[n] for n in after))
        rec.counters["launches"] = float(sum(self.cuda_field.LAUNCHES.values()))
        self.run.add_work("proofs", 1)

    def drain(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def release(self) -> None:
        for name in ("pk", "params", "prove_params", "pinning"):
            self.__dict__.pop(name, None)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, run) -> list:
        golden = self.cfg["golden"]
        checker = ProofChecker(self.vk_bytes)
        n = len(self.proofs)
        rng = random.Random(derive_seed(self.ctx.seed, "proof-sample"))
        size = min(n, int(self.ctx.traffic.get("check_sample", 4)))
        sample = set(rng.sample(range(n), size)) | {n - 1} if n else set()
        rejected = sum(not checker.verifies(self.proofs[j]) for j in sorted(sample))
        repeated = n - len({hashlib.sha256(p).digest() for p in self.proofs})
        warm_digest = hashlib.sha256(self.golden_proof).hexdigest()
        return [
            ("vk_digest_differs", int(checker.vk_sha256 != golden["vk_sha256"]), 0),
            ("warm_proof_digest_differs", int(warm_digest != golden["proof_sha256"]), 0),
            ("proofs_rejected", rejected, 0),
            ("proofs_repeated", repeated, 0),
        ]
