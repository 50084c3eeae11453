"""Device selection and stage timing for the port's entry points."""

from __future__ import annotations

import time

import torch


def resolve_device(device=None) -> torch.device:
    """`device`, or the CUDA card when none is given. There is no silent CPU
    fallback: without a card the caller must ask for the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the port on the CPU"
        )
    return torch.device("cuda")


def stage_end(label: str, t0: float, device, timings: dict | None) -> float:
    """Close a stage: when timing, wait for its device work and record its
    seconds under `label` (without `timings` the device runs ahead).
    Returns the next stage's start."""
    if timings is None:
        return t0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    now = time.time()
    timings[label] = now - t0
    return now
