"""Multi-process orchestration on ``torch.distributed``.

Counterpart of ``tudocomp_tpu/parallel/distributed.py``. One process per
device (``parallel/mesh.py``): :func:`initialize` joins the process
group, each process feeds its own shard of the segment batch (input I/O
stays host-local), the encode's only collective is the 1 KiB histogram
``all_reduce``, and each process frames its own segments, so the
container is its header followed by every process's pieces in global
order (:func:`compress_distributed`).
"""

from __future__ import annotations

from datetime import timedelta

import numpy as np
import torch.distributed as dist

from tudocomp_tpu_torch.ops.hufdec import SEG
from tudocomp_tpu_torch.parallel.mesh import Mesh

#: how long a collective waits for the other ranks before it raises
TIMEOUT = timedelta(minutes=5)


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, *, backend: str = "nccl") -> None:
    """``init_process_group`` over ``tcp://coordinator_address`` (rank
    ``process_id`` of ``num_processes``); a no-op for one process.
    ``backend``: ``nccl`` for CUDA ranks, ``gloo`` for CPU ranks or for
    several ranks on one card."""
    if num_processes in (None, 1):
        return
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id, timeout=TIMEOUT,
    )


def compress_distributed(codec, mesh: Mesh, local_rows: np.ndarray,
                         local_lens: np.ndarray, orig_len: int):
    """The codec's stages on this process's contiguous slice of the
    global segment batch (``local_rows u8[n, SEG]``, ``local_lens``; the
    slices in rank order make the batch, padded rows with length 0),
    with the histogram summed over the mesh, so every process builds the
    same table without further traffic.

    Returns ``(prefix, pieces)``: ``prefix`` is ``MAGIC + vbyte(len(
    header)) + header``, ``pieces`` the ordered ``(global_segment_start,
    frame_bytes)`` of this process's segments below ``orig_len``.
    ``prefix`` followed by every process's pieces in global order is
    ``codec.compress(data)`` byte for byte."""
    nseg = -(-orig_len // SEG)
    # the global index of this process's first segment
    first = sum(mesh.all_gather(int(local_rows.shape[0]))[: mesh.rank])
    # padded rows (length 0) feed no histogram and frame nothing
    take = max(0, min(local_rows.shape[0], nseg - first))
    sampled = codec.sample_rule(nseg)
    stage1, hist = codec.rle(local_rows[:take], local_lens[:take],
                             first=first, sampled=sampled)
    mesh.all_reduce(hist)
    table, tables = codec.table(hist, sampled)
    frames = codec.frames(codec.huff(stage1, tables))
    return codec.prefix(orig_len, table), [(first, frames)] if take else []
