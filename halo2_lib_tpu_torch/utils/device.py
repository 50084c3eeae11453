"""Device selection for the port's entry points."""

from __future__ import annotations

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
