"""Sharded TBC2 pipeline: every rank encodes or decodes its range of
segments on its own device, and rank 0 writes the container.

Counterpart of ``tudocomp_tpu/parallel/pipeline.py``. Each function is
called on every rank of the mesh's process group with the same
arguments (SPMD, ``parallel/mesh.py``); results that the JAX function
returns to its controller come back on rank 0, ``None`` elsewhere.

- Encode: each rank runs ``BlockCodec``'s stages on its range of
  segments: ``rle`` (the histogram rows picked by GLOBAL segment index,
  so no shard needs padding to a multiple of the 1-in-8 sample), one
  ``all_reduce`` of the i64[256] histogram (the only collective on the
  encode path), ``table`` from the same sum on every rank, ``huff`` and
  ``frames``; rank 0 gathers the frames and writes the header. The
  container is byte-identical to ``BlockCodec.compress`` at every world
  size.
- Decode: every rank parses the container and decodes its range with
  ``BlockCodec.decode`` (K4); the bytes are gathered to rank 0.
- :func:`factorize_blocks_sharded`: the exact device LZ77 of
  ``ops/lzss.py`` on each rank's blocks; triples gathered to rank 0.
- :func:`compress_sharded_resumable`: the same encode, batch by batch,
  with a journal in the JAX package's format; rank 0 alone reads and
  writes the journal and the container.

JAX's ``build_feed``/``needed_steps``/``snap_steps`` have no counterpart:
K4 reads each payload in place and has no step schedule.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from tudocomp_tpu_torch.device import download, upload
from tudocomp_tpu_torch.models import blockcodec as bc
from tudocomp_tpu_torch.ops.hufdec import SEG
from tudocomp_tpu_torch.ops.lzss import _match_exact_device, commit_walk
from tudocomp_tpu_torch.parallel.mesh import Mesh


def compress_sharded(codec, mesh: Mesh, data: bytes) -> bytes | None:
    """The container of ``BlockCodec.compress(data)``, encoded over the
    mesh: on rank 0 the container, ``None`` elsewhere. ``codec.timings``
    holds this rank's host-clock seconds: ``encode`` (its split and
    stages with their transfers, the ``all_reduce`` included),
    ``frames`` (its frames) and ``gather`` (the frames to rank 0)."""
    if len(data) == 0:
        return codec.prefix(0, None) if mesh.rank == 0 else None
    t0 = time.perf_counter()
    nseg = -(-len(data) // SEG)
    sampled = codec.sample_rule(nseg)
    lo, hi = mesh.segment_range(nseg)
    rows, lens = codec.split_segments(memoryview(data)[lo * SEG: hi * SEG])
    stage1, hist = codec.rle(rows, lens, first=lo, sampled=sampled)
    del rows, lens
    mesh.all_reduce(hist)
    table, tables = codec.table(hist, sampled)
    batches = codec.huff(stage1, tables)
    t1 = time.perf_counter()
    frames = codec.frames(batches)
    del batches
    t2 = time.perf_counter()
    pieces = mesh.gather(frames)
    codec.timings = {"encode": t1 - t0, "frames": t2 - t1,
                     "gather": time.perf_counter() - t2}
    if pieces is None:
        return None
    return codec.prefix(len(data), table) + b"".join(pieces)


def decompress_sharded(codec, mesh: Mesh, data: bytes) -> bytes | None:
    """Inverse of :func:`compress_sharded`: every rank parses ``data``
    and decodes its range of segments with K4; the bytes in order on
    rank 0, ``None`` elsewhere. ``codec.timings``: ``parse``, ``decode``
    (this rank's K4 with its transfers) and ``gather``."""
    t0 = time.perf_counter()
    (table, offset, orig_len, counts, flags, poff,
     pbytes) = codec.parse(data)
    # the whole container on every rank, so that all ranks refuse alike
    codec.check_frames(data, counts, poff, pbytes)
    t1 = time.perf_counter()
    lo, hi = mesh.segment_range(counts.shape[0])
    mine = codec.decode(
        data, counts[lo:hi], flags[lo:hi], poff[lo:hi], pbytes[lo:hi],
        table, offset=offset,
        orig_len=max(0, min(hi * SEG, orig_len) - lo * SEG))
    t2 = time.perf_counter()
    parts = mesh.gather(mine)
    codec.timings = {"parse": t1 - t0, "decode": t2 - t1,
                     "gather": time.perf_counter() - t2}
    return None if parts is None else b"".join(parts)


def factorize_blocks_sharded(mesh: Mesh, blocks: np.ndarray,
                             threshold: int, max_len: int = 512):
    """Exact device LZ77 of each row of ``blocks u8[B, n]`` (independent
    texts), the rows split over the mesh: each rank runs the exact
    matcher on its blocks on its device and the host commit walk; on
    rank 0 the per-block ``(pos, src, len)`` triples in block order,
    ``None`` elsewhere. No collective but the gather."""
    b, n = blocks.shape
    if n > 1 << 24:
        # the same limit as factorize_device and the JAX matcher
        raise ValueError(
            "exact device matcher requires block length <= 2**24"
        )
    ml = min(max_len, max(4, n - 1))
    lo, hi = mesh.segment_range(b)
    mine = []
    for i in range(lo, hi):
        (text,) = upload("lzss.upload",
                         np.ascontiguousarray(blocks[i], np.uint8),
                         device=mesh.device)
        cand, length = download(
            "lzss.download", *_match_exact_device(text, max_len=ml))
        mine.append(commit_walk(cand.numpy().astype(np.int64),
                                length.numpy().astype(np.int64),
                                threshold))
    parts = mesh.gather(mine)
    return None if parts is None else [f for part in parts for f in part]


# --- journaled, restartable sharded compression -----------------------------

JOURNAL_MAGIC = "TBCJ1"


def _journal_path(dst_path: str) -> str:
    return dst_path + ".journal"


def _read_journal(jpath: str, head: list):
    """``(hist, last journaled batch, container end)`` from a journal
    whose first line is ``head``; ``(None, -1, None)`` when it is absent
    or was written for another input or batch size."""
    hist, done_upto, data_end = None, -1, None
    if not os.path.exists(jpath):
        return hist, done_upto, data_end
    with open(jpath) as jf:
        lines = [ln.strip() for ln in jf if ln.strip()]
    if not lines or lines[0].split() != head:
        return hist, done_upto, data_end
    for ln in lines[1:]:
        parts = ln.split()
        if parts[0] == "HIST":
            hist = np.frombuffer(bytes.fromhex(parts[1]), np.int64).copy()
        elif parts[0] == "BATCH":
            done_upto = int(parts[1])
            data_end = int(parts[2])
        elif parts[0] == "HEADER":
            data_end = int(parts[1])
    return hist, done_upto, data_end


def _append_line(path: str, line: str, mode: str = "a") -> None:
    with open(path, mode) as f:
        f.write(line)
        f.flush()
        os.fsync(f.fileno())


def compress_sharded_resumable(codec, mesh: Mesh, src_path: str,
                               dst_path: str, *,
                               batch_segments: int | None = None,
                               resume: bool = False) -> int | None:
    """Sharded TBC2 compression of the file ``src_path`` into
    ``dst_path``, batch by batch, with a journal (``dst_path +
    ".journal"``) that lets a killed job resume.

    The journal is line for line the JAX package's: ``TBCJ1 nseg
    orig_len batch``, ``HIST <hex of i64[256]>`` (pass 1's histogram, so
    a resumed job rebuilds the same table), ``HEADER end`` and ``BATCH i
    end`` after each batch's frames are durably appended. A rerun with
    ``resume=True`` truncates the container to the last journaled end
    and goes on. ``batch_segments`` rounds up to a multiple of ``world *
    8`` as in JAX, so a journal written by either package resumes in the
    other at the same world size. Pass 1 stops at ``HIST_SEGS`` when
    sampling.

    Every rank reads its own share of each batch from ``src_path`` and
    encodes it; rank 0 alone reads and writes the journal and the
    container, and returns the container's size (``None`` elsewhere).
    The bytes equal ``compress_sharded``'s. ``TDC_CRASH_AFTER_BATCH=k``
    makes rank 0 leave with ``os._exit(17)`` after appending batch k's
    frames and before journaling them (the worst tear point).
    """
    orig_len = os.path.getsize(src_path)
    nseg = -(-orig_len // SEG)
    unit = mesh.size * 8
    if batch_segments is None:
        batch_segments = max(unit, (4096 // unit) * unit)
    batch_segments = -(-batch_segments // unit) * unit
    n_batches = max(1, -(-nseg // batch_segments))
    share = batch_segments // mesh.size
    sampled = codec.sample_rule(nseg)
    jpath = _journal_path(dst_path)
    head = [JOURNAL_MAGIC, str(nseg), str(orig_len), str(batch_segments)]
    writer = mesh.rank == 0

    hist, done_upto, data_end = None, -1, None
    if writer and resume:
        hist, done_upto, data_end = _read_journal(jpath, head)
    hist, done_upto = mesh.broadcast((hist, done_upto))

    def read_share(bi: int):
        lo = min(bi * batch_segments + mesh.rank * share, nseg)
        hi = min(lo + share, (bi + 1) * batch_segments, nseg)
        with open(src_path, "rb") as f:
            f.seek(lo * SEG)
            raw = f.read(max(0, min(hi * SEG, orig_len) - lo * SEG))
        return (lo, *codec.split_segments(raw))

    if hist is None:
        # pass 1: the histogram; with sampling only batches that meet
        # [0, HIST_SEGS) add to it, so the pass ends early
        acc = torch.zeros(256, dtype=torch.int64, device=mesh.device)
        for bi in range(n_batches):
            if sampled and bi * batch_segments >= bc.HIST_SEGS:
                break
            lo, rows, lens = read_share(bi)
            acc += codec.rle(rows, lens, first=lo, sampled=sampled)[1]
        mesh.all_reduce(acc)
        hist = download("tbc2.download", acc)[0].numpy()
        if writer:
            _append_line(jpath, f"{' '.join(head)}\n"
                         f"HIST {hist.astype(np.int64).tobytes().hex()}\n",
                         "w")
        done_upto, data_end = -1, None

    table, tables = codec.table(hist, sampled)
    if writer and data_end is None:
        with open(dst_path, "wb") as f:
            f.write(codec.prefix(orig_len, table))
            f.flush()
            os.fsync(f.fileno())
            data_end = f.tell()
        _append_line(jpath, f"HEADER {data_end}\n")

    crash_after = os.environ.get("TDC_CRASH_AFTER_BATCH")
    f = open(dst_path, "r+b") if writer else None
    try:
        if writer:
            f.truncate(data_end)  # drop torn frames past the journal point
            f.seek(data_end)
        for bi in range(done_upto + 1, n_batches):
            lo, rows, lens = read_share(bi)
            stage1 = codec.rle(rows, lens, first=lo, sampled=sampled,
                               hist=False)[0]
            pieces = mesh.gather(codec.frames(codec.huff(stage1, tables)))
            if not writer:
                continue
            f.write(b"".join(pieces))
            f.flush()
            os.fsync(f.fileno())
            if crash_after is not None and bi == int(crash_after):
                os._exit(17)  # test hook: die before journaling
            data_end = f.tell()
            _append_line(jpath, f"BATCH {bi} {data_end}\n")
        if writer:
            f.truncate(data_end)
    finally:
        if f is not None:
            f.close()
    if not writer:
        return None
    os.remove(jpath)
    return data_end
