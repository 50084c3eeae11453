"""The port's bn254 KZG commitment and NTT API as a service: a closed loop
of calls on a pool of inputs made on the card from the seed.

Traffic ``op``:
- ``commit``: ``ParamsKZG.commit_columns`` (the prover's commit path) of
  ``columns`` Montgomery columns of 2^``k`` points against the ``basis``
  ("lagrange" or "monomial") of ``gen_srs(k)``, each result copied to the
  host as a transcript takes it. Work: columns x points, in "points".
- ``ntt``: ``new_ntt(fr, log_n)``'s forward then inverse transform of
  ``columns`` columns, outputs kept on the card, one synchronisation at the
  window's end. Work: 2 x columns x 2^log_n, in "elems".

The reference (``reference/kzg.py``, ``reference/ntt.py``) then checks every
commitment the window returned, and a sample of transforms drawn from the
seed together with the window's last one.

Controls and faults (``--control``, ``--fault``; never in a measured run):
control "truncate" hands the program each input with its top 128 bits
cleared (a lower precision of the same elements) while the reference judges
against the full inputs; fault "altered" flips a bit of each answer where it
is made, "unchanged" returns the first answer again (for a transform: its
input), "half" commits only the first half of a call's columns.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from benchmark.harness.traffic import derive_seed
from benchmark.reference.kzg import Committer, packed_points
from benchmark.reference.ntt import TransformCheck
from benchmark.roofline import msm_work, ntt_work, roofline_s

LIMBS = 16
TOP_LIMB = 0x3064  # r >> 240: values drawn below it are below r
NTT_SAMPLE_FROM = 64  # the sampled transform is one of the first this many


def random_fr(gen: torch.Generator, shape: tuple, device) -> torch.Tensor:
    """int32 [..., 16, m] limbs of elements below r, uniform 16-bit limbs
    under a top limb below r's."""
    x = torch.randint(0, 1 << 16, shape, generator=gen, device=device, dtype=torch.int32)
    x[..., LIMBS - 1, :] = torch.randint(0, TOP_LIMB, shape[:-2] + shape[-1:], generator=gen,
                                         device=device, dtype=torch.int32)
    return x


class System:
    def __init__(self, ctx):
        self.ctx = ctx
        self.tr = ctx.traffic
        self.dev = ctx.device
        self.run = None
        self.results: list = []
        self.kept: dict = {}

    # --- set-up ----------------------------------------------------------------------
    def setup(self) -> None:
        from halo2_lib_tpu_torch.ops.limbs import DeviceField
        from halo2_lib_tpu_torch.utils.fields import FR_BN254

        tr, dev = self.tr, self.dev
        self.op = tr["op"]
        self.fr_df = DeviceField(FR_BN254)
        gen = torch.Generator(device=dev)
        gen.manual_seed(derive_seed(self.ctx.seed, "inputs"))
        C, P = int(tr["columns"]), int(tr["pool"])
        if self.op == "commit":
            from halo2_lib_tpu_torch.backend.kzg import gen_srs

            self.k = int(tr["k"])
            self.m = 1 << self.k
            self.lagrange = tr["basis"] == "lagrange"
            with self.ctx.phase("srs"):
                self.params = gen_srs(self.k, device=dev)
                self.bases = (self.params.affine_lagrange_bases(dev) if self.lagrange
                              else self.params.affine_bases(dev))
            self.work = msm_work(C, self.m)
        elif self.op == "ntt":
            from halo2_lib_tpu_torch.ops.ntt import new_ntt

            self.log_n = int(tr["log_n"])
            self.m = 1 << self.log_n
            with self.ctx.phase("ntt tables"):
                self.ntt = new_ntt(self.fr_df, self.log_n, dev)
            self.work = ntt_work(C, self.log_n) * 2
            rng = random.Random(derive_seed(self.ctx.seed, "ntt-sample"))
            self.sample_i = rng.randrange(NTT_SAMPLE_FROM)
        else:
            raise ValueError(f"kzg_api: unknown op {self.op!r}")
        self.C = C
        with self.ctx.phase("inputs"):
            self.pool = random_fr(gen, (P, C, LIMBS, self.m), dev)
        self.inputs = self.pool
        if self.ctx.control == "truncate":
            self.inputs = self.pool.clone()
            self.inputs[:, :, LIMBS // 2 :, :] = 0
        elif self.ctx.control is not None:
            raise ValueError(f"kzg_api: unknown control {self.ctx.control!r}")
        # warm-up: every shape the window sends is this one call's
        with self.ctx.phase("warm-up"):
            self.request(-1, 0)
            self.drain()
        self.results.clear()
        self.kept.clear()

    # --- the window ----------------------------------------------------------------------
    def request(self, i: int, index: int) -> None:
        rec = self.ctx.recorder
        fault = self.ctx.fault
        if self.op == "commit":
            cols = self.inputs[index]
            if fault == "half":
                cols = cols[: max(1, self.C // 2)]
            with rec.span("commit"):
                out = self.params.commit_columns(self.fr_df, cols, self.bases)
                if fault == "altered":
                    out[0, 0] ^= 1
                if fault == "unchanged":
                    out = self.__dict__.setdefault("first_out", out)
                with rec.span("to_host"):
                    host = out.cpu().numpy()
            self.results.append((index, host))
            units = ("points", self.C * self.m)
            layer = "msm"
        else:
            x = self.inputs[index]
            with rec.span("dispatch"):
                y = x.clone() if fault == "unchanged" else self.ntt.forward(x)
                if fault == "altered":
                    y[..., 0, 0] ^= 1
                z = self.ntt.inverse(y)
            self.kept["last"] = (index, y, z)
            if i == self.sample_i:
                self.kept["sample"] = (index, y, z)
            units = ("elems", 2 * self.C * self.m)
            layer = "ntt"
        if i >= 0:  # warm-up calls are not the window's work
            self.run.add_work(*units)
            self.run.add_roofline(layer, roofline_s(self.work))

    def drain(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    # --- after the window ------------------------------------------------------------------
    def release(self) -> None:
        """Copy what the reference reads to the host and free the program's
        state and its device memory."""
        self.pool_host = self.pool.cpu().numpy()
        self.kept = {k: (idx, y.cpu().numpy(), z.cpu().numpy()) for k, (idx, y, z) in self.kept.items()}
        for name in ("params", "bases", "ntt", "pool", "inputs", "first_out", "fr_df"):
            self.__dict__.pop(name, None)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, run) -> list:
        if self.op == "commit":
            ref = Committer(self.k, self.lagrange, self.dev)
            want = {idx: ref.commit(self.pool_host[idx]) for idx in sorted({i for i, _ in self.results})}
            wrong = 0
            for idx, host in self.results:
                got = packed_points(host)
                wrong += sum(a != b for a, b in zip(got, want[idx])) + abs(len(want[idx]) - len(got))
            return [("commitments_wrong", wrong, 0)]
        z = random.Random(derive_seed(self.ctx.seed, "ntt-check")).randrange(2, 1 << 250)
        ref = TransformCheck(self.log_n, z, self.dev)
        wrong = 0
        for idx, y, x_back in self.kept.values():
            x = self.pool_host[idx]
            wrong += ref.forward_mismatches(x, y) + ref.inverse_mismatches(x, x_back)
        return [("transforms_wrong", wrong, 0), ("transforms_checked_below_one", int(not self.kept), 0)]
