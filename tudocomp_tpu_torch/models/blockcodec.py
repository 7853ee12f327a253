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
- the frames: on CUDA, K8 (``ops/frames.py``) writes every segment's
  frame at its scanned offset on the card, and only the frames come to
  the host; on the CPU, numpy places them (as the JAX package does).

Decode parses the frames with the port's host library
(``native.py``) and decodes every segment in one launch of K4
(``ops/hufdec.py``), or on host cores (:meth:`BlockCodec.decompress`).
The container bytes do not depend on ``batch_lanes``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from tudocomp_tpu_torch import native
from tudocomp_tpu_torch.coders.huffman import HuffmanTable
from tudocomp_tpu_torch.device import resolve_device
from tudocomp_tpu_torch.io.bitio import BitReader, BitWriter
from tudocomp_tpu_torch.ops.frames import (
    frame_layout, frames_host, pack_batches,
)
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


@dataclass
class Encoded:
    """Device-stage results of one input, on the host: what the
    container is assembled from."""

    orig_len: int
    hist: np.ndarray       # i64[256] sampled table histogram (before +1)
    table: HuffmanTable | None
    counts: np.ndarray     # i32[nseg] stream bytes per segment
    rle_raw: np.ndarray    # bool[nseg]
    huff_raw: np.ndarray   # bool[nseg]
    words: np.ndarray      # u32[nseg, 512] payload words
    bits: np.ndarray       # i32[nseg] payload bits


def _upload(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


class BlockCodec:
    """Host orchestration: split -> device encode -> container assembly,
    and parse -> device decode. ``device`` defaults to CUDA, which runs
    the kernels and raises where CUDA is absent; ``device="cpu"`` runs
    their plain versions."""

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
    def split_segments(data: bytes):
        n = len(data)
        nseg = -(-n // SEG)
        arr = np.zeros((nseg, SEG), np.uint8)
        arr.reshape(-1)[:n] = np.frombuffer(data, np.uint8)
        lens = np.clip(n - SEG * np.arange(nseg, dtype=np.int64), 0, SEG)
        return arr, lens.astype(np.int32)

    @staticmethod
    def sample_rule(nseg: int) -> bool:
        """Histogram sampling (1-in-8 segments) kicks in at 64 segments;
        below that the exact histogram is cheap."""
        return nseg >= 64

    @staticmethod
    def _hist_rows(lo: int, hi: int, sampled: bool) -> slice | None:
        """Rows of batch ``[lo, hi)`` that feed the histogram: all of
        them, or (sampled) the global segments ``[0:HIST_SEGS:8]``."""
        if not sampled:
            return slice(0, hi - lo)
        start, stop = -lo % 8, min(hi, HIST_SEGS) - lo
        return slice(start, stop, 8) if stop > start else None

    def _stages(self, data: bytes, phase):
        """The device stages over ``data``, inside the caller's
        ``tbc2.encode`` phase. Returns ``(hist, table, batches)``: the
        sampled histogram (host), the table, and per batch its ``(counts,
        rle_raw, huff_raw, words, bits)`` on the device."""
        dev = self.device
        with StatPhase("tbc2.split"):
            seg_rows, seg_lens = self.split_segments(data)
        nseg = seg_rows.shape[0]
        phase.log_stat("bytes_in", len(data))
        phase.log_stat("segments", nseg)
        sampled = self.sample_rule(nseg)
        hist = torch.zeros(256, dtype=torch.int64, device=dev)
        stage1 = []
        for lo in range(0, nseg, self.batch_lanes):
            hi = min(lo + self.batch_lanes, nseg)
            with StatPhase("tbc2.upload") as up:
                up.log_copy(seg_rows[lo:hi], seg_lens[lo:hi])
                batch = (_upload(seg_rows[lo:hi], dev),
                         _upload(seg_lens[lo:hi], dev))
            with StatPhase("tbc2.rle"):
                stage1.append(rle_stage(
                    *batch, offset=self.offset,
                    hist_rows=self._hist_rows(lo, hi, sampled), hist=hist,
                )[:3])
            # free the batch's input before the next one is uploaded
            del batch
        with StatPhase("tbc2.table"):
            hist_np = hist.cpu().numpy()
            table = self._table_from_hist(hist_np, sampled)
            t = device_tables(table, dev)
        batches = []
        for i, (sel, counts, rle_raw) in enumerate(stage1):
            with StatPhase("tbc2.huff"):
                words, bits, huff_raw = huff_stage(sel, counts, t["sym_code"],
                                                   t["sym_len"])
            # K2 has read the batch's stream words: free them
            stage1[i] = None
            batches.append((counts, rle_raw, huff_raw, words, bits))
        return hist_np, table, batches

    def encode(self, data: bytes) -> Encoded:
        """Run the device stages over ``data`` and bring their results
        to the host."""
        if not data:
            raise ValueError("encode needs a non-empty input")
        with StatPhase("tbc2.encode") as phase:
            hist, table, batches = self._stages(data, phase)
            with StatPhase("tbc2.download") as down:
                host = [torch.cat(p).cpu() for p in zip(*batches)]
                down.log_copy(*host)
            counts, rle_raw, huff_raw, words, bits = (h.numpy() for h in host)
        self.timings = {"encode": phase.seconds}
        return Encoded(
            orig_len=len(data), hist=hist, table=table, counts=counts,
            rle_raw=rle_raw, huff_raw=huff_raw, words=words.view(np.uint32),
            bits=bits,
        )

    def compress(self, data: bytes) -> bytes:
        """The container of ``data``. On CUDA the frames are built on the
        card (K8) and only they are downloaded; on the CPU the stages'
        results come to the host and numpy places them."""
        if len(data) == 0:
            return self._assemble_empty()
        on_device = self.device.type == "cuda"
        if on_device:
            with StatPhase("tbc2.encode") as enc:
                _, table, batches = self._stages(data, enc)
            self.timings = {"encode": enc.seconds}
        else:
            e = self.encode(data)
        with StatPhase("tbc2.assemble") as phase:
            if on_device:
                out, nseg, n_rle_raw, n_huff_raw = self._assemble_on_card(
                    len(data), table, batches)
            else:
                out = self._assemble(e.orig_len, e.table, e.counts,
                                     e.rle_raw, e.huff_raw, e.words, e.bits)
                nseg = e.counts.shape[0]
                n_rle_raw, n_huff_raw = e.rle_raw.sum(), e.huff_raw.sum()
            phase.log_stat("bytes_in", len(data))
            phase.log_stat("bytes_out", len(out))
            phase.log_stat("segments", nseg)
            phase.log_stat("rle_raw", int(n_rle_raw))
            phase.log_stat("huff_raw", int(n_huff_raw))
            phase.log_stat("on_device", int(on_device))
        self.timings["assemble"] = phase.seconds
        return out

    def _assemble_on_card(self, orig_len: int, table, batches):
        """The container from the stages' device results ``batches``:
        the frames' layout (one small read: their total bytes and the two
        escape counts), K8 a batch, then one download of the frames into
        the buffer that holds the prefix. Returns ``(container, segments,
        rle_raw segments, huff_raw segments)``."""
        counts, rle_raw, huff_raw, words, bits = zip(*batches)
        prefix = self._prefix(orig_len, table)
        with StatPhase("tbc2.scan"):
            meta1, pbytes, offs, head = frame_layout(
                *(torch.cat(x) for x in (counts, rle_raw, huff_raw, bits)))
            total, n_rle_raw, n_huff_raw = head.tolist()
        with StatPhase("tbc2.pack"):
            frames = pack_batches(words, meta1, pbytes, offs, total)
        with StatPhase("tbc2.download") as down:
            host = torch.empty(len(prefix) + total, dtype=torch.uint8)
            body = host[len(prefix):]
            body.copy_(frames)
            down.log_copy(body)
        buf = host.numpy()
        buf[:len(prefix)] = np.frombuffer(prefix, np.uint8)
        return buf.tobytes(), meta1.shape[0], n_rle_raw, n_huff_raw

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

    def _table_from_hist(self, hist, sampled: bool):
        hist = np.asarray(hist, np.int64)
        if sampled:
            hist = hist + 1  # sampled histogram: keep all bytes encodable
        if (hist > 0).sum() <= 1:
            return None
        return HuffmanTable.from_counts(
            hist, max_len=16, min_len=self._min_code_len()
        )

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

    def _prefix(self, orig_len: int, table) -> bytes:
        """``MAGIC + vbyte(len(header)) + header``: the container up to
        its frames."""
        out = bytearray(MAGIC)
        header = self._header(orig_len, table)
        write_vbyte(out, len(header))
        out += header
        return bytes(out)

    def _assemble_empty(self) -> bytes:
        return self._prefix(0, None)

    def _assemble(self, orig_len, table, counts, rleraw, hraw, words,
                  bits) -> bytes:
        return self._prefix(orig_len, table) + self._frames(
            counts, rleraw, hraw, words, bits)

    #: the frames of host arrays (numpy): the CPU route, and the one the
    #: sharded callers in ``parallel/`` take
    _frames = staticmethod(frames_host)

    # -- decode --------------------------------------------------------------

    def _parse(self, data: bytes):
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

    def decompress(self, data: bytes) -> bytes:
        """Host decode on CPU cores with the port's host library."""
        (table, offset, orig_len, counts, flags, poff,
         pbytes) = self._parse(data)
        if orig_len == 0:
            return b""
        return native.tbc2_decode(data, counts, flags, poff, pbytes,
                                  orig_len, SEG, table, offset)

    def decompress_device(self, data: bytes) -> bytes:
        """Parse on the host, then decode every segment with K4."""
        (table, offset, orig_len, counts, flags, poff,
         pbytes) = self._parse(data)
        if orig_len == 0:
            return b""
        with StatPhase("tbc2.decode") as phase:
            if counts.max() > SEG or np.any(poff + pbytes > len(data)):
                raise ValueError("malformed TBC2 frames")
            dev = self.device
            t = device_tables(table, dev)
            host = (np.frombuffer(data, np.uint8).copy(),
                    poff.astype(np.int64), pbytes.astype(np.int64),
                    counts.astype(np.int32), flags.astype(np.uint8))
            with StatPhase("tbc2.upload") as up:
                up.log_copy(*host)
                args = [_upload(a, dev) for a in host]
            del host
            out = decode_segments(
                *args, t["thresh"], t["offs"], t["symbols"],
                offset=offset, orig_len=orig_len, fast=t["fast"],
            )
            with StatPhase("tbc2.download") as down:
                out = out.cpu()
                down.log_copy(out)
            out = out.numpy().tobytes()
            phase.log_stat("bytes_out", len(out))
        self.timings["decode"] = phase.seconds
        return out
