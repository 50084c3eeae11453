"""Device selection and stage timing for the port's entry points."""

from __future__ import annotations

import time

import torch


def resolve_device(device=None) -> torch.device:
    """`device`, or the CUDA card when none is given, always indexed
    (``cuda`` becomes ``cuda:<current>``), so that the per-device caches see
    one name for one card. There is no silent CPU fallback: without a card
    the caller must ask for the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the port on the CPU"
        )
    return device if device.index is not None else torch.device("cuda", torch.cuda.current_device())


def stage_end(label: str, t0: float, device, timings: dict | None) -> float:
    """Close a stage: when timing, wait for its device work (on each device
    of a tuple of them) and record its seconds under `label` (without
    `timings` the device runs ahead). Returns the next stage's start."""
    if timings is None:
        return t0
    for d in device if isinstance(device, tuple) else (device,):
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    now = time.time()
    timings[label] = now - t0
    return now
