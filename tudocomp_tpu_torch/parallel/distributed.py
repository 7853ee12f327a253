"""Multi-process orchestration on ``torch.distributed``.

Counterpart of ``tudocomp_tpu/parallel/distributed.py``. One process per
device (``parallel/mesh.py``): :func:`initialize` joins the process
group, each process feeds its own shard of the segment batch
(:func:`global_block_batch`; input I/O stays host-local), the encode's
only collective is the 1 KiB histogram ``all_reduce``, and each process
frames its own segments (:func:`gather_frames_host_local`), so the
container is its header followed by every process's pieces in global
order (:func:`compress_distributed`).
"""

from __future__ import annotations

from datetime import timedelta

import numpy as np
import torch.distributed as dist

from tudocomp_tpu_torch.models.blockcodec import SEG, _upload, device_tables
from tudocomp_tpu_torch.parallel.mesh import Mesh
from tudocomp_tpu_torch.parallel.pipeline import (
    sharded_huff_stage, sharded_rle_stage,
)

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


def global_block_batch(mesh: Mesh, local_blocks: np.ndarray,
                       local_lengths: np.ndarray):
    """This process's shard of a block batch on its device: ``(blocks,
    lengths, first)``, ``first`` the global index of its first block
    (the sum of the lower ranks' counts, from an ``all_gather``)."""
    counts = mesh.all_gather(int(local_blocks.shape[0]))
    return (_upload(local_blocks, mesh.device),
            _upload(local_lengths, mesh.device), sum(counts[: mesh.rank]))


def gather_frames_host_local(rows, first_index: int) -> list:
    """This process's rows of a sharded result on the host, as ordered
    ``(first_index, rows)`` pieces (none for an empty shard). Each
    process then writes its own byte range of the container or ships
    its pieces to process 0."""
    if rows.shape[0] == 0:
        return []
    return [(first_index, rows.cpu().numpy())]


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
    rows, lens, first = global_block_batch(mesh, local_rows, local_lens)
    sampled = codec.sample_rule(nseg)
    sel, counts, rle_raw, hist = sharded_rle_stage(
        mesh, rows, lens, offset=codec.offset, sample=sampled,
        global_base=first, batch=codec.batch_lanes)
    table = codec._table_from_hist(hist.cpu().numpy(), sampled)
    t = device_tables(table, mesh.device)
    words, bits, huff_raw = sharded_huff_stage(
        mesh, sel, counts, t["sym_code"], t["sym_len"],
        batch=codec.batch_lanes)
    pieces = []
    for (start, c), (_, rr), (_, hr), (_, w), (_, b) in zip(*(
        gather_frames_host_local(x, first)
        for x in (counts, rle_raw, huff_raw, words, bits)
    )):
        take = max(0, min(c.shape[0], nseg - start))
        if take:
            pieces.append((start, codec._frames(c[:take], rr[:take],
                                                hr[:take],
                                                w[:take].view(np.uint32),
                                                b[:take])))
    return codec._prefix(orig_len, table), pieces
