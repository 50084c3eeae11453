"""Phase-0 witness/commit pipelining: overlap the witness with column commits.

The port of ``halo2_lib_tpu/backend/pipeline.py``. The end-to-end proving
time includes witness regeneration (host Python) followed by the phase-0
advice flatten, upload and commit. Here the commit runs WHILE the witness
closure is still executing: a watcher thread replays the pinned break-point
schedule over the growing main Context, and every column that completes is
padded, blinded, uploaded and committed by a worker thread on a second CUDA
stream (the same ``ParamsKZG.commit_columns`` kernels as the plain prover:
Pippenger at k >= 11, ``commit_dbl_add`` below). By the time the closure
returns, all but the tail columns are done.

Grouping: the worker takes every column that finished while it was busy in
one ``commit_columns`` call, so a fast witness gives wide MSMs and a slow one
one column a call without waiting.

Determinism: blinding values are pre-drawn from the rng stream create_proof
would use (create_proof then skips the same draws), the replay duplicates
boundary cells as ``threads.flatten_witnesses`` does, and commitments are
affine points whatever the grouping, so the pipelined proof is byte-identical
to the plain one (tests/test_torch_pipeline.py).

Scope: phase-0 advice of a PROVER-stage builder on one device. The watcher
consumes values from the main context only while it is the only context;
later contexts are drained after the closure returns (the same flat-stream
order either way).
"""

from __future__ import annotations

import queue
import random as _random
import threading
import time as _time
from contextlib import nullcontext

import torch

from ..gates.threads import batch_evaluate
from ..utils.device import resolve_device
from .keygen import BLINDING_FACTORS
from .protocol import P
from .poly import domain as get_domain
from .prover import _lag_from_u16, _u16_cols, create_proof

# values the watcher takes from the main context at a time
CHUNK = 4096


class Phase0Pipeline:
    """Collects pipelined phase-0 results for create_proof(phase0=...)."""

    def __init__(self, params, pk, builder, seed: int = 0, device=None):
        assert builder.witness_gen_only(), "pipeline needs a PROVER-stage builder"
        self.device = resolve_device(device)
        vk = pk.vk
        self.params = params
        self.builder = builder
        self.seed = seed
        self.n = 1 << vk.k
        self.na0 = (vk.num_advice_per_phase or [vk.num_advice])[0]
        self.break_points = list(pk.break_points[0]) if pk.break_points else []
        # the field and the Lagrange bases are on the device before the side
        # stream starts (it only reads them)
        self.df = get_domain(vk.k).df
        self.bases = params.affine_lagrange_bases(self.device)
        # pre-draw the phase-0 advice blinding in create_proof's rng order
        rng = _random.Random(("create-proof-blinding", seed).__repr__())
        self.blinds = [
            [rng.randrange(P) for _ in range(BLINDING_FACTORS)] for _ in range(self.na0)
        ]
        # results, by column
        self.advice_cols: list = [None] * self.na0
        self._lag: list = [None] * self.na0
        self._com: list = [None] * self.na0
        self.groups: list[int] = []  # columns per commit call, in order
        self._ncols_seen = 0
        self._cols: queue.Queue = queue.Queue()
        self._done = threading.Event()
        self._error: Exception | None = None
        self._side = None
        if self.device.type == "cuda":
            self._side = torch.cuda.Stream(self.device)
            # the side stream sees every tensor the caller's stream made
            self._side.wait_stream(torch.cuda.current_stream(self.device))

    # --- column sink (worker thread) ------------------------------------------------
    def _commit_group(self, group: list[tuple[int, list[int]]]) -> None:
        n = self.n
        cols = []
        for c, vals in group:
            out = list(vals) + [0] * (n - len(vals))
            out[n - BLINDING_FACTORS :] = self.blinds[c]
            self.advice_cols[c] = out
            cols.append(out)
        lag = _lag_from_u16(self.df, _u16_cols(cols, n), self.device)
        com = self.params.commit_columns(self.df, lag, self.bases)
        for i, (c, _) in enumerate(group):
            self._lag[c], self._com[c] = lag[i : i + 1], com[i : i + 1]
        self.groups.append(len(group))

    def _run_worker(self) -> None:
        while True:
            item = self._cols.get()
            if item is None:
                return
            group = [item]
            while True:
                try:
                    nxt = self._cols.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self._cols.put(None)
                    break
                group.append(nxt)
            self._commit_group(group)

    def _guarded(self, fn):
        """Run fn in a thread: under inference mode and on the side stream,
        keeping its exception for run() to raise on the caller's thread."""

        def body():
            on_side = torch.cuda.stream(self._side) if self._side is not None else nullcontext()
            try:
                with torch.inference_mode(), on_side:
                    fn()
            except Exception as e:
                self._error = self._error or e

        return threading.Thread(target=body, daemon=True)

    # --- incremental break-point replay (watcher thread) ----------------------------
    def _run_watcher(self) -> None:
        pm = self.builder.core.phase_manager[0]
        field = self.builder.field
        bps = iter(self.break_points)
        bp = next(bps, None)
        col_vals: list[int] = []
        col_idx = 0
        row_offset = 0
        consumed = 0  # values consumed from threads[0]

        def feed(values):
            nonlocal bp, col_vals, col_idx, row_offset
            for value in values:
                col_vals.append(value)
                if bp == row_offset:
                    bp = next(bps, None)
                    row_offset = 0
                    done_col, col_vals = col_vals, [value]
                    self._cols.put((col_idx, done_col))
                    col_idx += 1
                row_offset += 1

        while not self._done.is_set():
            threads = pm.threads
            if threads and len(threads) == 1:
                avail = len(threads[0].advice)
                if avail - consumed >= CHUNK:
                    feed(batch_evaluate(threads[0].advice[consumed:avail], field))
                    consumed = avail
                    continue
            _time.sleep(0.002)

        # drain: finish threads[0], then any later contexts, then the tail
        threads = pm.threads
        if threads:
            feed(batch_evaluate(threads[0].advice[consumed:], field))
            for ctx in threads[1:]:
                feed(batch_evaluate(ctx.advice, field))
        if col_vals or col_idx == 0:
            self._cols.put((col_idx, col_vals))
            col_idx += 1
        self._ncols_seen = col_idx
        # columns past the last break point are empty, as the plain prover
        # pads them (prover._flatten_prover_phase)
        for c in range(col_idx, self.na0):
            self._cols.put((c, []))

    # --- run ----------------------------------------------------------------------------
    def run(self, witness_fn) -> "Phase0Pipeline":
        """witness_fn(builder) in the calling thread, columns committed as
        they complete; returns self (pass as create_proof(phase0=...))."""
        worker = self._guarded(self._run_worker)
        watcher = self._guarded(self._run_watcher)
        worker.start()
        watcher.start()
        try:
            witness_fn(self.builder)
        finally:
            self._done.set()
            watcher.join()
            self._cols.put(None)
            worker.join()
        if self._error is not None:
            raise self._error
        # the plain prover's flatten gives one column per break point and one
        # more, the config's columns at most (prover._flatten_prover_phase)
        want = min(self.na0, len(self.break_points) + 1)
        assert self._ncols_seen == want, (
            f"pipelined replay produced {self._ncols_seen} columns, break points give {want}"
        )
        assert all(v is not None for v in self.advice_cols)
        if self._side is not None:
            # the caller's stream reads what the side stream wrote, and the
            # allocator must not hand those blocks back to the side stream
            # before the caller's stream is done with them
            main = torch.cuda.current_stream(self.device)
            main.wait_stream(self._side)
            for t in self._lag + self._com:
                t.record_stream(main)
        return self

    def advice_lag(self) -> torch.Tensor:
        """int32[na0, 16, n] Montgomery-Lagrange phase-0 advice."""
        return torch.cat(self._lag, dim=0)

    def commits(self) -> torch.Tensor:
        """int32[na0, 33] packed affine commitments, in column order."""
        return torch.cat(self._com, dim=0)


def prove_pipelined(params, pk, builder, witness_fn, seed: int = 0, device=None,
                    **kw) -> bytes:
    """Run witness_fn while phase-0 columns are blinded, uploaded and
    committed in the background, then create_proof with the precomputed
    phase-0 payload."""
    pipe = Phase0Pipeline(params, pk, builder, seed, device).run(witness_fn)
    return create_proof(params, pk, builder, seed=seed, device=device, phase0=pipe, **kw)
