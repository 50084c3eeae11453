"""Spans and counters the benchmark records around its calls into the
program's layers (host clock), and the profiler labels it sets there."""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext

import torch


class Recorder:
    def __init__(self, tracing: bool):
        self.tracing = tracing
        self.spans: dict[str, list[float]] = defaultdict(list)
        self.counters: dict[str, float] = defaultdict(float)

    @contextmanager
    def span(self, name: str):
        """Time a block by the host clock; under a trace, also label it
        ``bench.<name>`` on the profiler's timeline."""
        label = torch.profiler.record_function("bench." + name) if self.tracing else nullcontext()
        t0 = time.perf_counter()
        with label:
            yield
        self.spans[name].append(time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        self.spans[name].append(seconds)

    def clear(self) -> None:
        self.spans.clear()
        self.counters.clear()
