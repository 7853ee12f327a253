"""TBC2 flagship codec on torch: segment-parallel RLE + one canonical
Huffman table, encoded and decoded on the device the caller names.

Counterpart of ``tudocomp_tpu/models/blockcodec.py``; the container
format (described there) is the state the two packages share, and a
container from either package decodes in the other. Per 2048-byte
segment:

- ``rle_stage``: RLE pack with the ``rle_raw`` escape (RLE would
  expand: keep the input bytes) in one kernel (K1's select entry), and
  the table histogram (K3, reading the rows in place) over a 1-in-8
  sample of the first ``HIST_SEGS`` segments;
- the host builds the canonical table (``coders/huffman.py``);
- ``huff_stage``: Huffman pack and the ``huff_raw`` escape (coding
  would not shrink: keep the stream bytes) in one kernel (K2's select
  entry);
- the frames: K8 (``ops/frames.py``; its plain torch version on the
  CPU) writes every segment's frame at its scanned offset on the
  device, and only the frames come to the host.

Decode parses the frames with the port's host library
(``native.py``) and decodes every segment in one launch of K4
(``ops/hufdec.py``), or on host cores (:meth:`BlockCodec.decompress`).
The container bytes do not depend on ``batch_lanes``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tudocomp_tpu_torch import native
from tudocomp_tpu_torch.coders.huffman import HuffmanTable
from tudocomp_tpu_torch.device import download, resolve_device, upload
from tudocomp_tpu_torch.io.bitio import BitReader, BitWriter
from tudocomp_tpu_torch.ops.frames import frame_layout, pack_batches
from tudocomp_tpu_torch.ops.hist import histogram_rows
from tudocomp_tpu_torch.ops.hufdec import SEG, decode_segments, decoder_tables
from tudocomp_tpu_torch.ops.segpack import (
    huffman_select_segments, rle_select_segments,
)
from tudocomp_tpu_torch.stats import StatPhase
from tudocomp_tpu_torch.utils.vbyte import read_vbyte, write_vbyte

MAGIC = b"TBC2"

#: segments per device batch (16 MiB of input per batch)
BATCH_LANES = 8192

#: table-histogram cap (segments): when sampling is on, only segments
#: below HIST_SEGS feed the 1-in-8 histogram, so the table depends on
#: the first 16 MiB alone
HIST_SEGS = 8192


def device_tables(table: HuffmanTable | None, device) -> dict:
    """The codec's Huffman state as tensors on ``device``: ``sym_code``
    and ``sym_len`` (i32[256]) for encode, ``thresh``/``offs`` (i32[16])
    and ``symbols`` (u8[256]) for decode. ``None`` gives the identity
    code (8 bits per byte: every segment takes ``huff_raw``)."""
    if table is None:
        code = np.arange(256, dtype=np.int32)
        length = np.full(256, 8, np.int32)
    else:
        code = table.sym_code.astype(np.int32)
        length = table.sym_len.astype(np.int32)
    arrays = {"sym_code": code, "sym_len": length, **decoder_tables(table)}
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def rle_stage(seg_rows, seg_lens, *, offset: int, hist_rows: slice | None,
              hist: torch.Tensor | None = None):
    """Stage 1 on a batch ``seg_rows u8[NC, SEG]``, ``seg_lens i32[NC]``.

    Returns ``(sel i32[NC, 512], counts i32[NC], rle_raw bool[NC],
    hist)``: the big-endian words of the escape-selected stream (the
    RLE stream, or the input bytes where RLE would expand), its length,
    the escape flag, and the i64[256] histogram ``hist`` (a new one when
    ``None``) with the selected streams of the rows ``hist_rows`` added
    in (``None``: no histogram, and ``hist`` is returned as given). Bytes
    past ``seg_lens`` never reach ``sel``."""
    sel, counts, rle_raw = rle_select_segments(seg_rows, seg_lens,
                                               offset=offset)
    if hist_rows is not None:
        if hist is None:
            hist = torch.zeros(256, dtype=torch.int64, device=sel.device)
        histogram_rows(sel, counts, hist_rows, hist)
    return sel, counts, rle_raw, hist


def huff_stage(sel_words, counts, sym_code, sym_len):
    """Stage 2: Huffman pack plus the ``huff_raw`` escape (payload =
    the stream bytes whenever coding would not strictly shrink them), in
    one kernel (K2's select entry).
    Returns ``(words i32[NC, 512], bits i32[NC], huff_raw bool[NC])``."""
    return huffman_select_segments(sel_words, counts, sym_code, sym_len)


class BlockCodec:
    """The codec, in stages that every caller runs: ``compress`` is
    split -> :meth:`rle` -> :meth:`table` -> :meth:`huff` ->
    :meth:`frames` on one device, and ``parallel/`` runs the same stages
    on each rank's range of segments, with the histogram summed over the
    mesh between ``rle`` and ``table``. Decode is :meth:`parse` ->
    :meth:`decode`. ``device`` defaults to CUDA, which runs the kernels
    and raises where CUDA is absent; ``device="cpu"`` runs their plain
    versions."""

    def __init__(self, *, device="cuda", offset: int = 0,
                 batch_lanes: int = BATCH_LANES,
                 min_code_len: int | None = None):
        self.device = resolve_device(device)
        self.offset = offset
        self.batch_lanes = batch_lanes
        self.min_code_len = min_code_len
        #: host-clock seconds of the last call's stages: ``encode``
        #: (device stages, transfers included), ``assemble``, ``parse``
        #: and ``decode`` (device decode, transfers included)
        self.timings: dict[str, float] = {}

    # -- encode --------------------------------------------------------------

    @staticmethod
    def segment_lens(n: int) -> np.ndarray:
        """``i32[ceil(n / SEG)]``: the byte count of each segment of an
        ``n``-byte input (``SEG`` but the last)."""
        nseg = -(-n // SEG)
        lens = np.clip(n - SEG * np.arange(nseg, dtype=np.int64), 0, SEG)
        return lens.astype(np.int32)

    @classmethod
    def split_segments(cls, data: bytes):
        n = len(data)
        lens = cls.segment_lens(n)
        arr = np.zeros((lens.shape[0], SEG), np.uint8)
        arr.reshape(-1)[:n] = np.frombuffer(data, np.uint8)
        return arr, lens

    @staticmethod
    def sample_rule(nseg: int) -> bool:
        """Histogram sampling (1-in-8 segments) kicks in at 64 segments;
        below that the exact histogram is cheap."""
        return nseg >= 64

    @staticmethod
    def hist_rows(lo: int, hi: int, sampled: bool) -> slice | None:
        """Rows of the global segments ``[lo, hi)`` that feed the
        histogram: all of them, or (sampled) the global segments
        ``[0:HIST_SEGS:8]``; ``None`` where none does."""
        if not sampled:
            return slice(0, hi - lo)
        start, stop = -lo % 8, min(hi, HIST_SEGS) - lo
        return slice(start, stop, 8) if stop > start else None

    def rle(self, rows, lens, *, first: int = 0, sampled: bool,
            hist: bool = True):
        """Stage 1 on the host segments ``lens i32[n]`` (global segment
        ``first`` first) whose bytes ``rows`` holds: as rows ``u8[n,
        SEG]`` split as :meth:`split_segments` splits, or flat, the
        input itself (``u8[m]``, ``lens`` of :meth:`segment_lens`).
        Each batch of ``batch_lanes`` segments is uploaded as it lies in
        ``rows``, the flat input's short last segment padded with zeros
        on the device, then K1's select entry runs with K3 adding the
        rows :meth:`hist_rows` picks by global index. Returns ``(stage1,
        hist)``: per batch its ``(sel, counts, rle_raw)`` on the device,
        and the i64[256] histogram on the device (``None`` with
        ``hist=False``: no histogram work)."""
        acc = (torch.zeros(256, dtype=torch.int64, device=self.device)
               if hist else None)
        flat = rows.reshape(-1)
        stage1 = []
        for lo in range(0, lens.shape[0], self.batch_lanes):
            hi = min(lo + self.batch_lanes, lens.shape[0])
            seg_bytes, seg_lens = upload(
                "tbc2.upload", flat[lo * SEG: hi * SEG], lens[lo:hi],
                device=self.device)
            picked = (self.hist_rows(first + lo, first + hi, sampled)
                      if hist else None)
            with StatPhase("tbc2.rle"):
                short = (hi - lo) * SEG - seg_bytes.shape[0]
                if short:
                    seg_bytes = torch.nn.functional.pad(seg_bytes,
                                                        (0, short))
                stage1.append(rle_stage(seg_bytes.view(hi - lo, SEG),
                                        seg_lens, offset=self.offset,
                                        hist_rows=picked, hist=acc)[:3])
            # free the batch's input before the next one is uploaded
            del seg_bytes, seg_lens
        return stage1, acc

    def table(self, hist, sampled: bool):
        """The canonical table of the (summed) histogram ``hist``, a
        tensor or a host array: ``(table, tables)``, the
        ``HuffmanTable`` (``None``: one symbol or none) and its
        :func:`device_tables`."""
        with StatPhase("tbc2.table"):
            if isinstance(hist, torch.Tensor):
                hist = hist.cpu().numpy()
            hist = np.asarray(hist, np.int64)
            if sampled:
                hist = hist + 1  # sampled histogram: keep all bytes encodable
            table = None
            if (hist > 0).sum() > 1:
                table = HuffmanTable.from_counts(
                    hist, max_len=16, min_len=self._min_code_len())
            return table, device_tables(table, self.device)

    def huff(self, stage1: list, tables: dict) -> list:
        """Stage 2 on each batch of :meth:`rle`'s ``stage1`` under
        ``tables``: K2's select entry, each batch's stream words freed
        once K2 has read them. Returns per batch its ``(counts, rle_raw,
        huff_raw, words, bits)`` on the device."""
        batches = []
        for i, (sel, counts, rle_raw) in enumerate(stage1):
            with StatPhase("tbc2.huff"):
                words, bits, huff_raw = huff_stage(
                    sel, counts, tables["sym_code"], tables["sym_len"])
            stage1[i] = None
            batches.append((counts, rle_raw, huff_raw, words, bits))
        return batches

    def frames(self, batches: list, prefix: bytes = b"") -> bytes:
        """``prefix`` followed by the frames of :meth:`huff`'s
        ``batches``: the frames' layout on the device (one small read:
        their total bytes and the two escape counts), K8 a batch (its
        plain version on the CPU), then one download of the frames into
        the buffer that holds ``prefix``. Logs ``segments``, ``rle_raw``,
        ``huff_raw`` and ``on_device`` into the caller's open phase."""
        if not batches:
            return bytes(prefix)
        counts, rle_raw, huff_raw, words, bits = zip(*batches)
        with StatPhase("tbc2.scan"):
            meta1, pbytes, offs, head = frame_layout(
                *(torch.cat(x) for x in (counts, rle_raw, huff_raw, bits)))
            total, n_rle_raw, n_huff_raw = head.tolist()
        with StatPhase("tbc2.pack"):
            body = pack_batches(words, meta1, pbytes, offs, total)
        (host,) = download("tbc2.download", body, head=len(prefix))
        buf = host.numpy()
        buf[:len(prefix)] = np.frombuffer(prefix, np.uint8)
        StatPhase.log("segments", meta1.shape[0])
        StatPhase.log("rle_raw", n_rle_raw)
        StatPhase.log("huff_raw", n_huff_raw)
        StatPhase.log("on_device", int(self.device.type == "cuda"))
        return buf.tobytes()

    def compress(self, data: bytes) -> bytes:
        """The container of ``data``: the frames are built on the
        codec's device and only they are downloaded."""
        if len(data) == 0:
            return self.prefix(0, None)
        with StatPhase("tbc2.encode") as enc:
            with StatPhase("tbc2.split"):
                flat = np.frombuffer(data, np.uint8)
                lens = self.segment_lens(len(data))
            enc.log_stat("bytes_in", len(data))
            enc.log_stat("segments", lens.shape[0])
            sampled = self.sample_rule(lens.shape[0])
            stage1, hist = self.rle(flat, lens, sampled=sampled)
            del flat, lens
            table, tables = self.table(hist, sampled)
            batches = self.huff(stage1, tables)
        self.timings = {"encode": enc.seconds}
        with StatPhase("tbc2.assemble") as phase:
            out = self.frames(batches, self.prefix(len(data), table))
            phase.log_stat("bytes_in", len(data))
            phase.log_stat("bytes_out", len(out))
        self.timings["assemble"] = phase.seconds
        return out

    def _min_code_len(self) -> int:
        # min 3 keeps the JAX package's lockstep decode schedule valid
        # for containers written here; settable up to 8. TDC_MIN_CODE_LEN
        # overrides the option, as it does in the JAX package, so both
        # packages write the same container under the same environment
        env = os.environ.get("TDC_MIN_CODE_LEN")
        if env is not None:
            mn = int(env)
        elif self.min_code_len is not None:
            mn = int(self.min_code_len)
        else:
            mn = 3
        return min(max(mn, 3), 8)

    def _header(self, orig_len: int, table) -> bytes:
        head = BitWriter()
        head.write_compressed_int(SEG)
        head.write_compressed_int(self.offset)
        head.write_compressed_int(orig_len)
        if table is None:
            head.write_bit(0)
        else:
            head.write_bit(1)
            table.write(head)
        return head.getvalue()

    def prefix(self, orig_len: int, table) -> bytes:
        """``MAGIC + vbyte(len(header)) + header``: the container up to
        its frames (the whole container of an empty input)."""
        out = bytearray(MAGIC)
        header = self._header(orig_len, table)
        write_vbyte(out, len(header))
        out += header
        return bytes(out)

    # -- decode --------------------------------------------------------------

    def parse(self, data: bytes):
        """The container's header and frames: ``(table, offset,
        orig_len, counts, flags, poff, pbytes)``, one row a segment."""
        with StatPhase("tbc2.parse") as phase:
            if data[:4] != MAGIC:
                raise ValueError("bad magic")
            header_len, pos = read_vbyte(data, 4)
            head = BitReader(data[pos : pos + header_len])
            pos += header_len
            if head.read_compressed_int() != SEG:
                raise ValueError("unsupported segment size")
            offset = head.read_compressed_int()
            orig_len = head.read_compressed_int()
            table = HuffmanTable.read(head) if head.read_bit() else None
            nseg = -(-orig_len // SEG)
            counts, flags, poff, pbytes = native.tbc2_parse(data, pos, nseg)
            phase.log_stat("bytes_in", len(data))
            phase.log_stat("segments", nseg)
        self.timings = {"parse": phase.seconds}
        return table, offset, orig_len, counts, flags, poff, pbytes

    @staticmethod
    def check_frames(data: bytes, counts, poff, pbytes) -> None:
        """Raise on parsed frames K4 must not decode: a count past
        ``SEG`` or a payload past the container ``data``."""
        if counts.size and (counts.max() > SEG
                            or np.any(poff + pbytes > len(data))):
            raise ValueError("malformed TBC2 frames")

    def decode(self, data: bytes, counts, flags, poff, pbytes, table, *,
               offset: int, orig_len: int) -> bytes:
        """K4 on a range of :meth:`parse`'s rows of the container
        ``data`` (``orig_len``: the range's output bytes), after
        :meth:`check_frames`. Only the range's payload bytes are
        uploaded. Returns the decoded bytes (empty for an empty range,
        without a launch)."""
        self.check_frames(data, counts, poff, pbytes)
        if counts.shape[0] == 0:
            return b""
        start = int(poff.min())
        end = int((poff + pbytes).max())
        t = device_tables(table, self.device)
        host = (np.frombuffer(data, np.uint8)[start:end],
                (poff - start).astype(np.int64), pbytes.astype(np.int64),
                counts.astype(np.int32), flags.astype(np.uint8))
        args = upload("tbc2.upload", *host, device=self.device)
        del host
        out = decode_segments(
            *args, t["thresh"], t["offs"], t["symbols"],
            offset=offset, orig_len=orig_len, fast=t["fast"],
        )
        (out,) = download("tbc2.download", out)
        return out.numpy().tobytes()

    def decompress(self, data: bytes) -> bytes:
        """Host decode on CPU cores with the port's host library."""
        (table, offset, orig_len, counts, flags, poff,
         pbytes) = self.parse(data)
        if orig_len == 0:
            return b""
        return native.tbc2_decode(data, counts, flags, poff, pbytes,
                                  orig_len, SEG, table, offset)

    def decompress_device(self, data: bytes) -> bytes:
        """Parse on the host, then decode every segment with K4."""
        (table, offset, orig_len, counts, flags, poff,
         pbytes) = self.parse(data)
        if orig_len == 0:
            return b""
        with StatPhase("tbc2.decode") as phase:
            out = self.decode(data, counts, flags, poff, pbytes, table,
                              offset=offset, orig_len=orig_len)
            phase.log_stat("bytes_out", len(out))
        self.timings["decode"] = phase.seconds
        return out
