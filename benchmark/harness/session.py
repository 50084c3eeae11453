"""One run of one cell: set-up, the measured window, the metrics, the
comparison with the reference, and the result line.

A system module (``systems/<config's system>.py``) has a ``System(ctx)``
with ``setup()`` (build, load, make the inputs from the seed, warm up
every shape the cell sends), ``request(i, index)`` (one request of the
closed loop, for pool entry `index`), ``drain()`` (wait for what the
window dispatched), ``release()`` (free the program's state once the
window is read) and ``check(run)`` (the reference's comparison: a list of
(name, number, limit), correct when every number is at most its limit).
It records the work it completed in ``run.work`` and the roofline seconds
of that work in ``run.roofline_s``.
"""

from __future__ import annotations

import gc
import subprocess
import sys
import time
import traceback
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

from . import cells, profiling, traffic
from .recorder import Recorder


@dataclass
class Context:
    cell: cells.Cell
    seed: int
    device: torch.device
    recorder: Recorder
    control: str | None = None
    fault: str | None = None

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    @property
    def tracing(self) -> bool:
        return self.recorder.tracing

    @contextmanager
    def phase(self, name: str):
        """A step of set-up, its seconds on standard error (what set-up
        spends, for the PR that shortens it)."""
        t0 = time.perf_counter()
        yield
        print(f"setup {name}: {time.perf_counter() - t0:.3f} s", file=sys.stderr)


@dataclass
class Run:
    """What a run measured; each metric's reader takes its number from here."""

    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    work: dict = field(default_factory=dict)  # unit -> amount completed in the window
    roofline_s: dict = field(default_factory=dict)  # layer -> roofline seconds of that work
    spans: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    trace: profiling.DeviceTrace | None = None

    def add_work(self, unit: str, amount: float) -> None:
        self.work[unit] = self.work.get(unit, 0) + amount

    def add_roofline(self, layer: str, seconds: float) -> None:
        self.roofline_s[layer] = self.roofline_s.get(layer, 0.0) + seconds


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class GcWatch:
    """Counts the interpreter's garbage collections in the window and the
    seconds they take (a reading only: the collector runs as it would)."""

    def __init__(self):
        self.seconds = [0.0, 0.0, 0.0]
        self.counts = [0, 0, 0]
        self._t0 = 0.0

    def _callback(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            g = info["generation"]
            self.seconds[g] += time.perf_counter() - self._t0
            self.counts[g] += 1

    def __enter__(self):
        gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._callback)

    def __str__(self) -> str:
        return "gc " + ", ".join(f"gen{g} {c} x {s:.3f} s" for g, (c, s) in enumerate(zip(self.counts, self.seconds)))


def card_line(device: torch.device) -> str:
    """The card's name and power limit, as nvidia-smi reads them: a card
    set below 700 W runs slower under load."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--id={device.index or 0}", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip() or out.stderr.strip()


def run_cell(cell: cells.Cell, seed: int, seconds: float, trace: bool, device: torch.device,
             t_start: float, control: str | None = None, fault: str | None = None) -> dict:
    print(f"setup imports: {time.time() - t_start:.3f} s", file=sys.stderr)
    rec = Recorder(trace)
    ctx = Context(cell, seed, device, rec, control, fault)
    system = cells.system_module(cell.bench_dir, cell.config["system"]).System(ctx)
    run = Run()
    system.run = run
    system.setup()
    _sync(device)
    rec.clear()
    run.work.clear()
    run.roofline_s.clear()
    run.setup_s = time.time() - t_start

    order = traffic.request_order(cell.traffic, seed)
    least = int(cell.traffic.get("min_requests", 1))

    def window() -> None:
        t0 = time.perf_counter()
        i = 0
        while True:
            index = next(order)
            run.attempted += 1
            try:
                system.request(i, index)
            except Exception:  # a request that raises never answers: counted, and the run goes on
                run.failed += 1
                if run.failed == 1:
                    traceback.print_exc(file=sys.stderr)
            i += 1
            if time.perf_counter() - t0 >= seconds and run.attempted >= least:
                break
        system.drain()
        run.window_s = time.perf_counter() - t0

    gc_watch = GcWatch()
    with gc_watch:
        if trace:
            _, run.trace = profiling.traced(window)
        else:
            window()
    run.spans = dict(rec.spans)
    run.counters = dict(rec.counters)

    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = cells.metric_reader(cell.bench_dir, m.name)(run)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    dev = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0,
    }
    if trace:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s

    card = card_line(device)
    done = run.attempted - run.failed
    print(f"setup_s {run.setup_s:.3f}; window {run.window_s:.3f} s, {done} of {run.attempted} requests "
          f"completed; work {run.work}; spans (mean s, count) "
          + ", ".join(f"{k} {sum(v) / len(v):.4f} {len(v)}" for k, v in run.spans.items() if v)
          + f"; {gc_watch}", file=sys.stderr)
    system.release()
    t_check = time.time()
    checks = system.check(run) + [("failed_requests", run.failed, 0),
                                  ("requests_completed_below_one", int(done < 1), 0)]
    correct = all(value <= limit for _, value, limit in checks)
    print(f"card: {card}; reference check {time.time() - t_check:.3f} s", file=sys.stderr)
    for name, value, limit in checks:
        print(f"check {name}: {value} (limit {limit})", file=sys.stderr)

    result = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": dev, "card": card}
    if trace:
        result["breakdown"] = {"device_ops": run.trace.device_ops, "idle_gaps": run.trace.idle_gaps}
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    return result
