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


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def _stage(h: np.ndarray) -> torch.Tensor:
    """``h`` copied into a page-locked block of torch's caching host
    allocator, which hands the same mapped pages to the next block of
    that size once this one is freed. One numpy copy: on the H100's
    host, threads (started a call) cost more than they save."""
    block = torch.empty(h.shape, dtype=_torch_dtype(h.dtype),
                        pin_memory=True)
    block.numpy()[...] = h
    return block


def upload(phase: str, *host: np.ndarray, device) -> list[torch.Tensor]:
    """Each host array of ``host`` copied to ``device``, inside the phase
    ``phase``. Read-only views (``np.frombuffer`` of ``bytes``) are
    fine. On CUDA each array is copied once into a pinned block
    (:func:`_stage`) and from there to the card; the copy ends before
    the block is freed. On the CPU a writable contiguous array is not
    copied; any other is copied once."""
    with StatPhase(phase) as up:
        if device.type != "cuda":
            host = [np.ascontiguousarray(h) if h.flags.writeable
                    else h.copy() for h in host]
            up.log_copy(*host)
            return [torch.from_numpy(h).to(device) for h in host]
        staged = [_stage(h) for h in host]
        up.log_copy(*staged)
        return [block.to(device) for block in staged]


def download(phase: str, *tensors: torch.Tensor,
             head: int = 0) -> list[torch.Tensor]:
    """Each tensor of ``tensors`` copied to a host tensor, inside the
    phase ``phase``. With ``head``, the one tensor's copy lands ``head``
    elements into a 1-D host tensor that much longer, whose first
    ``head`` elements the caller fills (a header before a payload). A
    CUDA tensor lands in a page-locked block of torch's caching host
    allocator: the caller copies out what it keeps and lets the tensor
    go, so the next call of that size reuses the block. A CPU tensor
    without ``head`` is returned as it is."""
    with StatPhase(phase) as down:
        if not head:
            host = [torch.empty(t.shape, dtype=t.dtype,
                                pin_memory=True).copy_(t) if t.is_cuda
                    else t for t in tensors]
            down.log_copy(*host)
            return host
        (t,) = tensors
        host = torch.empty(head + t.numel(), dtype=t.dtype,
                           pin_memory=t.is_cuda)
        body = host[head:]
        body.copy_(t)
        down.log_copy(body)
        return [host]
