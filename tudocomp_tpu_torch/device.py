"""The port's device rule: CUDA unless the caller names the CPU, and
CUDA raises where it is absent (nothing falls back to the CPU).

Also the port's one seam for host<->device copies: :func:`upload` and
:func:`download`. Each opens the phase it is given (``tbc2.upload``,
``bwt.download``, ...), whose ``bytes`` and ``pinned`` counters the
benchmark's copy rates read."""

from __future__ import annotations

import numpy as np
import torch

from tudocomp_tpu_torch.stats import StatPhase


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA where CUDA is
    absent and for device types other than ``cpu`` and ``cuda``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{dev} requested but CUDA is not available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def upload(phase: str, *host: np.ndarray, device) -> list[torch.Tensor]:
    """Each host array of ``host`` copied to ``device``, inside the phase
    ``phase``. The arrays must be writable; a contiguous one is not
    copied on the host."""
    with StatPhase(phase) as up:
        up.log_copy(*host)
        return [torch.from_numpy(np.ascontiguousarray(h)).to(device)
                for h in host]


def download(phase: str, *tensors: torch.Tensor,
             head: int = 0) -> list[torch.Tensor]:
    """Each tensor of ``tensors`` copied to a new host tensor, inside the
    phase ``phase``. With ``head``, the one tensor's copy lands ``head``
    elements into a 1-D host tensor that much longer, whose first
    ``head`` elements the caller fills (a header before a payload)."""
    with StatPhase(phase) as down:
        if not head:
            host = [t.cpu() for t in tensors]
            down.log_copy(*host)
            return host
        (t,) = tensors
        host = torch.empty(head + t.numel(), dtype=t.dtype)
        body = host[head:]
        body.copy_(t)
        down.log_copy(body)
        return [host]
