"""Sharded TBC2 pipeline: every rank encodes or decodes its range of
segments on its own device, and rank 0 writes the container.

Counterpart of ``tudocomp_tpu/parallel/pipeline.py``. Each function is
called on every rank of the mesh's process group with the same
arguments (SPMD, ``parallel/mesh.py``); results that the JAX function
returns to its controller come back on rank 0, ``None`` elsewhere.

- Encode: each rank splits and uploads its range (:func:`shard_segments`)
  and runs the codec's stages on it in batches of ``codec.batch_lanes``
  segments, as ``BlockCodec.encode`` does: K1's select entry and K3's
  rows entry (:func:`sharded_rle_stage`), one ``all_reduce`` of the
  i64[256] histogram (the only collective on the encode path), the
  canonical table built on every rank from the same sum, K2's select
  entry (:func:`sharded_huff_stage`). Each rank assembles its own frames
  with ``BlockCodec._frames``; rank 0 gathers them and writes the header.
  The container is byte-identical to ``BlockCodec.compress`` at every
  world size: the histogram rows are picked by GLOBAL segment index
  (``BlockCodec._hist_rows``), so no shard needs padding to a multiple
  of the 1-in-8 sample.
- Decode: every rank parses the container and decodes its range with K4
  (:func:`sharded_decode_stage`); the bytes are gathered to rank 0.
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

from tudocomp_tpu_torch.models import blockcodec as bc
from tudocomp_tpu_torch.models.blockcodec import (
    BATCH_LANES, BlockCodec, _upload, device_tables, huff_stage,
    rle_stage,
)
from tudocomp_tpu_torch.ops.hufdec import SEG, decode_segments
from tudocomp_tpu_torch.ops.lzss import _match_exact_device, commit_walk
from tudocomp_tpu_torch.ops.segpack import STREAM_WORDS
from tudocomp_tpu_torch.parallel.mesh import Mesh


def shard_segments(mesh: Mesh, data) -> tuple[int, torch.Tensor,
                                               torch.Tensor]:
    """This rank's range of ``data``'s 2 KiB segments, split as
    ``BlockCodec.split_segments`` splits the whole and uploaded to the
    rank's device: ``(lo, rows u8[n, SEG], lens i32[n])``, ``lo`` the
    global index of its first segment."""
    lo, hi = mesh.segment_range(-(-len(data) // SEG))
    rows, lens = BlockCodec.split_segments(
        memoryview(data)[lo * SEG: hi * SEG])
    return lo, _upload(rows, mesh.device), _upload(lens, mesh.device)


def _batches(n: int, batch: int):
    return [(lo, min(lo + batch, n)) for lo in range(0, n, batch)]


def _cat(parts: list, empty) -> tuple:
    """Per-batch stage outputs joined along the segment axis (the
    ``empty`` tensors when there is no batch)."""
    if not parts:
        return empty
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat(col) for col in zip(*parts))


def sharded_rle_stage(mesh: Mesh, seg_rows, seg_lens, *, offset: int,
                      sample: bool = False, hist: bool = True,
                      global_base: int = 0, batch: int = BATCH_LANES):
    """Stage 1 on this rank's segments ``seg_rows u8[n, SEG]`` (global
    indices from ``global_base``): ``rle_stage`` in batches of ``batch``
    segments, each adding the rows ``BlockCodec._hist_rows`` picks by
    global index (the 1-in-8 sample of the first ``HIST_SEGS`` segments
    when ``sample``) into one i64[256] histogram, summed over the mesh.

    Returns ``(sel i32[n, 512], counts i32[n], rle_raw bool[n], hist)``:
    ``hist`` is the mesh-wide histogram on every rank, or ``None`` with
    ``hist=False`` (no histogram work and no collective: every rank must
    pass the same ``hist``)."""
    dev = seg_rows.device
    acc = torch.zeros(256, dtype=torch.int64, device=dev) if hist else None
    parts = []
    for lo, hi in _batches(seg_rows.shape[0], batch):
        rows = (BlockCodec._hist_rows(global_base + lo, global_base + hi,
                                      sample) if hist else None)
        parts.append(rle_stage(seg_rows[lo:hi], seg_lens[lo:hi],
                               offset=offset, hist_rows=rows,
                               hist=acc)[:3])
    sel, counts, rle_raw = _cat(parts, (
        torch.zeros(0, STREAM_WORDS, dtype=torch.int32, device=dev),
        torch.zeros(0, dtype=torch.int32, device=dev),
        torch.zeros(0, dtype=torch.bool, device=dev)))
    if hist:
        mesh.all_reduce(acc)
    return sel, counts, rle_raw, acc


def sharded_huff_stage(mesh: Mesh, rows, counts, sym_code, sym_len, *,
                       batch: int = BATCH_LANES):
    """Stage 2 on this rank's streams: ``huff_stage`` in batches of
    ``batch`` segments under the mesh-wide table; no collective.
    Returns ``(words i32[n, 512], bits i32[n], huff_raw bool[n])``."""
    dev = rows.device
    parts = [huff_stage(rows[lo:hi], counts[lo:hi], sym_code, sym_len)
             for lo, hi in _batches(rows.shape[0], batch)]
    return _cat(parts, (
        torch.zeros(0, STREAM_WORDS, dtype=torch.int32, device=dev),
        torch.zeros(0, dtype=torch.int32, device=dev),
        torch.zeros(0, dtype=torch.bool, device=dev)))


def _encode_frames(codec, mesh: Mesh, rows, lens, lo: int, sampled: bool,
                   tables=None):
    """Both stages on this rank's ``rows`` (global index ``lo`` first)
    and its frames. ``tables`` (``device_tables``) fixes the code and
    skips the histogram; ``None`` builds the table from the mesh-wide
    histogram. Returns ``(frames, table or None, encode seconds, frames
    seconds)``."""
    t0 = time.perf_counter()
    sel, counts, rle_raw, hist = sharded_rle_stage(
        mesh, rows, lens, offset=codec.offset, sample=sampled,
        hist=tables is None, global_base=lo, batch=codec.batch_lanes)
    table = None
    if tables is None:
        table = codec._table_from_hist(hist.cpu().numpy(), sampled)
        tables = device_tables(table, mesh.device)
    words, bits, huff_raw = sharded_huff_stage(
        mesh, sel, counts, tables["sym_code"], tables["sym_len"],
        batch=codec.batch_lanes)
    c, rr, hr, w, b = (t.cpu().numpy() for t in (counts, rle_raw,
                                                 huff_raw, words, bits))
    t1 = time.perf_counter()
    frames = (codec._frames(c, rr, hr, w.view(np.uint32), b)
              if rows.shape[0] else b"")
    return frames, table, t1 - t0, time.perf_counter() - t1


def compress_sharded(codec, mesh: Mesh, data: bytes) -> bytes | None:
    """The container of ``BlockCodec.compress(data)``, encoded over the
    mesh: on rank 0 the container, ``None`` elsewhere. ``codec.timings``
    holds this rank's host-clock seconds: ``encode`` (its stages with
    their transfers, the ``all_reduce`` included), ``frames`` (its
    ``_frames``) and ``gather`` (the frames to rank 0)."""
    if len(data) == 0:
        return codec._assemble_empty() if mesh.rank == 0 else None
    nseg = -(-len(data) // SEG)
    lo, rows, lens = shard_segments(mesh, data)
    frames, table, t_enc, t_frames = _encode_frames(
        codec, mesh, rows, lens, lo, codec.sample_rule(nseg))
    del rows, lens
    t0 = time.perf_counter()
    pieces = mesh.gather(frames)
    codec.timings = {"encode": t_enc, "frames": t_frames,
                     "gather": time.perf_counter() - t0}
    if pieces is None:
        return None
    return codec._prefix(len(data), table) + b"".join(pieces)


def _check_frames(data: bytes, counts, poff, pbytes) -> None:
    """Raise on frames K4 must not decode: a count past ``SEG`` or a
    payload past the container."""
    if counts.size and (counts.max() > SEG
                        or np.any(poff + pbytes > len(data))):
        raise ValueError("malformed TBC2 frames")


def sharded_decode_stage(mesh: Mesh, data: bytes, poff, pbytes, counts,
                         flags, table, *, offset: int,
                         orig_len: int) -> bytes:
    """K4 (``ops/hufdec.py:decode_segments``) on one rank's range of a
    parsed container ``data``: ``poff``/``pbytes``/``counts``/``flags``
    are the range's rows of ``BlockCodec._parse``, ``orig_len`` its
    output bytes. Only the range's payload bytes are uploaded. Returns
    the decoded bytes (empty for an empty range, without a launch)."""
    if counts.shape[0] == 0:
        return b""
    _check_frames(data, counts, poff, pbytes)
    start = int(poff.min())
    end = int((poff + pbytes).max())
    dev = mesh.device
    t = device_tables(table, dev)
    out = decode_segments(
        _upload(np.frombuffer(data, np.uint8)[start:end].copy(), dev),
        _upload((poff - start).astype(np.int64), dev),
        _upload(pbytes.astype(np.int64), dev),
        _upload(counts.astype(np.int32), dev),
        _upload(flags.astype(np.uint8), dev),
        t["thresh"], t["offs"], t["symbols"],
        offset=offset, orig_len=orig_len, fast=t["fast"],
    )
    return out.cpu().numpy().tobytes()


def decompress_sharded(codec, mesh: Mesh, data: bytes) -> bytes | None:
    """Inverse of :func:`compress_sharded`: every rank parses ``data``
    and decodes its range of segments with K4; the bytes in order on
    rank 0, ``None`` elsewhere. ``codec.timings``: ``parse``, ``decode``
    (this rank's K4 with its transfers) and ``gather``."""
    t0 = time.perf_counter()
    (table, offset, orig_len, counts, flags, poff,
     pbytes) = codec._parse(data)
    _check_frames(data, counts, poff, pbytes)  # on every rank alike
    t1 = time.perf_counter()
    lo, hi = mesh.segment_range(counts.shape[0])
    mine = sharded_decode_stage(
        mesh, data, poff[lo:hi], pbytes[lo:hi], counts[lo:hi],
        flags[lo:hi], table, offset=offset,
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
        text = _upload(np.ascontiguousarray(blocks[i], np.uint8),
                       mesh.device)
        cand, length = _match_exact_device(text, max_len=ml)
        mine.append(commit_walk(cand.cpu().numpy().astype(np.int64),
                                length.cpu().numpy().astype(np.int64),
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
        rows, lens = BlockCodec.split_segments(raw)
        return lo, _upload(rows, mesh.device), _upload(lens, mesh.device)

    if hist is None:
        # pass 1: the histogram; with sampling only batches that meet
        # [0, HIST_SEGS) add to it, so the pass ends early
        acc = torch.zeros(256, dtype=torch.int64, device=mesh.device)
        for bi in range(n_batches):
            if sampled and bi * batch_segments >= bc.HIST_SEGS:
                break
            lo, rows, lens = read_share(bi)
            acc += sharded_rle_stage(
                mesh, rows, lens, offset=codec.offset, sample=sampled,
                global_base=lo, batch=codec.batch_lanes)[3]
        hist = acc.cpu().numpy()
        if writer:
            _append_line(jpath, f"{' '.join(head)}\n"
                         f"HIST {hist.astype(np.int64).tobytes().hex()}\n",
                         "w")
        done_upto, data_end = -1, None

    table = codec._table_from_hist(hist, sampled)
    tables = device_tables(table, mesh.device)
    if writer and data_end is None:
        with open(dst_path, "wb") as f:
            f.write(codec._prefix(orig_len, table))
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
            frames = _encode_frames(codec, mesh, rows, lens, lo, sampled,
                                    tables)[0]
            pieces = mesh.gather(frames)
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
