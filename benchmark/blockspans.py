"""The block container's own share of each block, read from the trace.

``compressors/blocks.py`` runs every block inside one phase,
``blocks.compress_block`` or ``blocks.decompress_block``: a fresh inner
compressor, the escape, the inner chain's own phases, the frame. The
readers here take the window's ranges of such a phase and return
``None`` where the window holds none (a program without these phases).
"""

from __future__ import annotations

import numpy as np

from benchmark.spans import in_window
from benchmark.trace import Cover

#: CUDA runtime calls in which the host waits for the device; torch's
#: blocking ``.cpu()``, ``.item()`` and ``int(tensor)`` each end in one
#: ``cudaStreamSynchronize``
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")


def blocks(trace, name: str) -> list:
    """The window's ``(start, end)`` ranges of the phase ``name``."""
    return [(a, b) for _, a, b in in_window(
        trace, [(None, a, b) for a, b in trace.spans.get(name, ())])]


def _inside(ranges, starts, ends) -> np.ndarray:
    """Which of ``ranges`` lie inside one of the sorted, disjoint
    ``[starts, ends]``."""
    r = np.asarray(ranges, np.float64).reshape(-1, 2)
    i = np.searchsorted(starts, r[:, 0], side="right") - 1
    ok = i >= 0
    j = np.maximum(i, 0)
    return ok & (r[:, 0] >= starts[j]) & (r[:, 1] <= ends[j])


def own_ms(trace, name: str):
    """Milliseconds a block that no other range inside the block covers:
    the container's own work (the inner compressor's instantiation, the
    frame, the glue between the inner phases), over the window's blocks."""
    got = blocks(trace, name)
    if not got:
        return None
    starts = np.array([a for a, _ in got])
    ends = np.array([b for _, b in got])
    inner = []
    for other, ranges in trace.spans.items():
        if other != name and ranges:
            keep = _inside(ranges, starts, ends)
            inner += [r for r, k in zip(ranges, keep) if k]
    cover = Cover(inner)
    own = sum(b - a - cover.within(a, b) for a, b in got)
    return own / len(got) * 1e3


def syncs(trace, name: str):
    """Host waits for the device (``SYNCS``) that start inside the
    window's blocks, over the number of blocks."""
    got = blocks(trace, name)
    if not got:
        return None
    starts = np.array([a for a, _ in got])
    ends = np.array([b for _, b in got])
    waits = [(a, a) for a, _, n in trace.host if n in SYNCS]
    n = int(_inside(waits, starts, ends).sum()) if waits else 0
    return n / len(got)
