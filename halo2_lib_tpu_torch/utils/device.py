"""Device selection and stage timing for the port's entry points."""

from __future__ import annotations

import os
import sys
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


def stage_end(label: str, t0: float, device, timings: dict | None, tag: str | None = None) -> float:
    """Close a stage: when timing, wait for its device work (on each device
    of a tuple of them) and record its seconds under `label` (without
    `timings` the device runs ahead). With HALO2_PROVER_DEBUG=1 a stage of
    an entry point that names itself by `tag` ("prover", "keygen") also
    prints ``[tag] label: seconds`` to stderr, as the JAX package does.
    Returns the next stage's start."""
    debug = tag is not None and os.environ.get("HALO2_PROVER_DEBUG") == "1"
    if timings is None and not debug:
        return t0
    for d in device if isinstance(device, tuple) else (device,):
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    now = time.time()
    if timings is not None:
        timings[label] = now - t0
    if debug:
        print(f"[{tag}] {label}: {now - t0:.2f}s", file=sys.stderr, flush=True)
    return now
