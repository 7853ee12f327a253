"""The port's device rule: CUDA unless the caller names the CPU, and
CUDA raises where it is absent (nothing falls back to the CPU)."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA where CUDA is
    absent and for device types other than ``cpu`` and ``cuda``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{dev} requested but CUDA is not available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev
