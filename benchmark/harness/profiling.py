"""The measured window under torch.profiler, reduced to the device's busy
time, its operations by name and its idle gaps by what the host was doing.

Device time is the union of the intervals in which a kernel, a copy or a
memset ran on the card, within the benchmark's own ``bench.window`` label
(the labels' own device-side spans are not device work). An idle gap's time is
split over the innermost host operations or benchmark labels open on the
benchmark's thread during it (read every millisecond); gaps shorter than
``SHORT_GAP_S`` are summed under one name, since they are the launches
between back-to-back kernels. Kernel names are cut at their argument list.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.profiler import ProfilerActivity, profile, record_function

SHORT_GAP_S = 10e-6
SHORT_GAP_NAME = "gaps under 10 us (launches)"
TOP = 10
SCAN_BACK = 4000
SAMPLE_S = 1e-3  # a long gap is split over what the host did, read every millisecond
MAX_SAMPLES = 1000


@dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    device_ops: list = field(default_factory=list)  # [[name, seconds]], longest first
    idle_gaps: list = field(default_factory=list)  # [[host activity, seconds]], longest first
    device_events: int = 0


def traced(fn):
    """Run fn() inside a CPU + CUDA profile; return (its result, DeviceTrace)."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("bench.window"):
            out = fn()
    return out, reduce_events(prof.profiler.kineto_results.events())


def reduce_events(events) -> DeviceTrace:
    cuda = torch.autograd.DeviceType.CUDA
    window = None
    host, device = [], []
    for ev in events:
        start, dur, name = ev.start_ns(), ev.duration_ns(), ev.name()
        if ev.device_type() == cuda:
            if not (ev.is_user_annotation() or name.startswith("bench.")):
                device.append((start, start + dur, short_name(name)))
        else:
            if name == "bench.window":
                window = (start, start + dur)
                thread = ev.start_thread_id()
            host.append((start, start + dur, name, ev.start_thread_id()))
    if window is None:
        raise RuntimeError("profile: no bench.window label in the trace")
    host = [(a, b, n) for a, b, n, t in host if t == thread]
    w0, w1 = window
    device = sorted((max(a, w0), min(b, w1), n) for a, b, n in device if b > w0 and a < w1)
    by_name: dict[str, float] = defaultdict(float)
    merged: list[list[int]] = []
    for a, b, n in device:
        by_name[n] += (b - a) * 1e-9
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) * 1e-9

    host.sort()
    starts = [h[0] for h in host]
    gaps: dict[str, float] = defaultdict(float)
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        dur = (g1 - g0) * 1e-9
        if dur <= 0:
            continue
        if dur < SHORT_GAP_S:
            gaps[SHORT_GAP_NAME] += dur
            continue
        # what the host did during the gap: the innermost open event at
        # evenly spaced instants of it
        samples = max(1, min(MAX_SAMPLES, int(dur / SAMPLE_S)))
        for j in range(samples):
            t = g0 + (g1 - g0) * (2 * j + 1) // (2 * samples)
            gaps[_open_at(host, starts, t)] += dur / samples
    return DeviceTrace(
        window_s=(w1 - w0) * 1e-9,
        busy_s=busy,
        device_ops=[[n, s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        idle_gaps=[[n, s] for n, s in sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]],
        device_events=len(device),
    )


def short_name(name: str, limit: int = 120) -> str:
    """A kernel's name without its argument list."""
    cut = name.find("(")
    return (name if cut <= 0 else name[:cut])[:limit]


def _open_at(host, starts, t) -> str:
    """The innermost host event open at time t: of those that started by t
    and end after it, the one that started last."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - SCAN_BACK), -1):
        a, b, n = host[j]
        if b > t and n != "bench.window":
            return n
    return "host (no operation open)"
