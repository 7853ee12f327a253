"""Per-segment packers: K1 (RLE pack) and K2 (Huffman pack).

Counterparts of ``tudocomp_tpu/ops/segpack_pallas.py``:
``rle_pack_segments_w4`` (:1180) and ``huffman_pack_segments_w4``
(:1238), with the w4 contract kept at the public functions: streams
travel between stages as big-endian u32 words, ``[NC, 512]`` per batch
(held as int32). :func:`rle_select_segments` is K1 with the codec's
``rle_raw`` escape select fused in (``rle_stage`` in
``models/blockcodec.py``), and :func:`huffman_select_segments` K2 with
the ``huff_raw`` one (``huff_stage``). Each wrapper launches its
hand-written CUDA kernel (``csrc/rle_pack.cu``, ``csrc/huff_pack.cu``)
on CUDA tensors and runs its plain torch version on CPU tensors; there
is no other route.
"""

from __future__ import annotations

import torch

from tudocomp_tpu_torch import _build
from tudocomp_tpu_torch.ops.bitpack import as_i32
from tudocomp_tpu_torch.ops.rle import (
    MAX_OFFSET, be_words_from_bytes, bytes_from_words, rle_segment_tokens,
)

SEG = 2048            # input bytes per segment
STREAM_WORDS = 512    # stream words kept per segment (SEG_CAP // 4)


def _check_offset(offset: int) -> None:
    if not 0 <= offset <= MAX_OFFSET:
        raise ValueError(f"RLE offset must lie in 0..{MAX_OFFSET}: {offset}")


def rle_pack_segments(rows: torch.Tensor, lens: torch.Tensor, *,
                      offset: int = 0):
    """K1: per-segment RLE of ``rows u8[NC, 2048]`` masked to
    ``lens i32[NC]``. Returns ``(words i32[NC, 512], rle_lens i32[NC])``:
    the stream's first 2048 bytes as big-endian words, zero past the
    stream, and the FULL stream length (which may exceed 2048; the
    caller's ``rle_raw`` escape needs it)."""
    _check_rle_args(rows, lens, offset)
    if not _build.on_cuda(rows, lens):
        return rle_pack_segments_plain(rows, lens, offset=offset)
    nc = rows.shape[0]
    words = torch.empty(nc, STREAM_WORDS, dtype=torch.int32,
                        device=rows.device)
    rle_lens = torch.empty(nc, dtype=torch.int32, device=rows.device)
    if nc:
        _build.launch(
            "tdc_rle_pack", rows.data_ptr(), lens.data_ptr(),
            words.data_ptr(), rle_lens.data_ptr(), nc, offset,
            device=rows.device,
        )
        rle_pack_segments.launches += 1
    return words, rle_lens


rle_pack_segments.launches = 0


def _check_rle_args(rows, lens, offset: int) -> None:
    _check_offset(offset)
    nc = rows.shape[0]
    _build.check(rows, torch.uint8, (nc, SEG), "rows")
    _build.check(lens, torch.int32, (nc,), "lens")
    _build.check_aligned(rows, "rows", 8)


def rle_select_segments(rows: torch.Tensor, lens: torch.Tensor, *,
                        offset: int = 0):
    """K1 with the ``rle_raw`` escape select: per segment of ``rows
    u8[NC, 2048]`` masked to ``lens i32[NC]``, the RLE stream, or the
    segment's own bytes where the stream would be longer than ``lens``.
    Returns ``(sel i32[NC, 512], counts i32[NC], rle_raw bool[NC])``:
    the selected stream as big-endian words, zero past ``counts`` (the
    RLE stream's length, or ``lens`` on the escape), and the escape
    flag."""
    _check_rle_args(rows, lens, offset)
    if not _build.on_cuda(rows, lens):
        return rle_select_segments_plain(rows, lens, offset=offset)
    nc = rows.shape[0]
    sel = torch.empty(nc, STREAM_WORDS, dtype=torch.int32,
                      device=rows.device)
    counts = torch.empty(nc, dtype=torch.int32, device=rows.device)
    rle_raw = torch.empty(nc, dtype=torch.bool, device=rows.device)
    if nc:
        _build.launch(
            "tdc_rle_select", rows.data_ptr(), lens.data_ptr(),
            sel.data_ptr(), counts.data_ptr(), rle_raw.data_ptr(), nc,
            offset, device=rows.device,
        )
        rle_select_segments.launches += 1
    return sel, counts, rle_raw


rle_select_segments.launches = 0


def rle_select_segments_plain(rows, lens, *, offset: int = 0):
    """Plain torch K1 + select: :func:`rle_pack_segments_plain`, then
    the input's own words where the stream is longer than ``lens``. The
    rows are masked to ``lens`` first, as ``split_segments`` pads them,
    so the result never depends on the padding."""
    words, rle_lens = rle_pack_segments_plain(rows, lens, offset=offset)
    rle_raw = rle_lens > lens
    live = (torch.arange(SEG, device=rows.device)[None, :]
            < lens[:, None])
    own = be_words_from_bytes(torch.where(live, rows, 0))
    sel = torch.where(rle_raw[:, None], own, words)
    return sel, torch.where(rle_raw, lens, rle_lens), rle_raw


def rle_pack_segments_plain(rows, lens, *, offset: int = 0):
    """Plain torch K1: the token contract (``ops/rle.py``), an
    exclusive cumsum of token sizes, and a scatter of token bytes."""
    _check_offset(offset)
    nc = rows.shape[0]
    tok, nbytes = rle_segment_tokens(rows, lens, offset)
    start = torch.cumsum(nbytes, dim=1) - nbytes
    out = torch.zeros(nc, SEG, dtype=torch.uint8, device=rows.device)
    for k in range(4):
        dest = start + k
        r, c = torch.nonzero((nbytes > k) & (dest < SEG), as_tuple=True)
        out[r, dest[r, c]] = tok[r, c, k].to(torch.uint8)
    return be_words_from_bytes(out), nbytes.sum(dim=1).to(torch.int32)


def huffman_pack_segments(words: torch.Tensor, counts: torch.Tensor,
                          sym_code: torch.Tensor, sym_len: torch.Tensor):
    """K2: per segment, the canonical codes (<= 16 bits) of the first
    ``counts[c]`` bytes of the stream ``words i32[NC, 512]``, packed
    MSB-first. Returns ``(words i32[NC, 512], bits i32[NC])``: the first
    512 packed words and the FULL bit count. Keeping 512 words is exact
    for the codec: a segment whose bits exceed 16384 >= 8 * count takes
    the ``huff_raw`` escape, which discards the packed words."""
    _check_huff_args(words, counts, sym_code, sym_len)
    if not _build.on_cuda(words, counts, sym_code, sym_len):
        return huffman_pack_segments_plain(words, counts, sym_code, sym_len)
    nc = words.shape[0]
    out = torch.empty(nc, STREAM_WORDS, dtype=torch.int32,
                      device=words.device)
    bits = torch.empty(nc, dtype=torch.int32, device=words.device)
    if nc:
        _build.launch(
            "tdc_huff_pack", words.data_ptr(), counts.data_ptr(),
            sym_code.data_ptr(), sym_len.data_ptr(), out.data_ptr(),
            bits.data_ptr(), nc, device=words.device,
        )
        huffman_pack_segments.launches += 1
    return out, bits


huffman_pack_segments.launches = 0


def _check_huff_args(words, counts, sym_code, sym_len) -> None:
    nc = words.shape[0]
    _build.check(words, torch.int32, (nc, STREAM_WORDS), "words")
    _build.check(counts, torch.int32, (nc,), "counts")
    _build.check(sym_code, torch.int32, (256,), "sym_code")
    _build.check(sym_len, torch.int32, (256,), "sym_len")


def huffman_select_segments(words: torch.Tensor, counts: torch.Tensor,
                            sym_code: torch.Tensor, sym_len: torch.Tensor):
    """K2 with the ``huff_raw`` escape select: per segment, the packed
    codes of :func:`huffman_pack_segments`, or the stream ``words``
    themselves where the codes would not shrink them (``bits >= 8 *
    counts``). Returns ``(words i32[NC, 512], bits i32[NC], huff_raw
    bool[NC])``: the payload words, its bits (``8 * counts`` on the
    escape) and the escape flag."""
    _check_huff_args(words, counts, sym_code, sym_len)
    if not _build.on_cuda(words, counts, sym_code, sym_len):
        return huffman_select_segments_plain(words, counts, sym_code,
                                             sym_len)
    nc = words.shape[0]
    out = torch.empty(nc, STREAM_WORDS, dtype=torch.int32,
                      device=words.device)
    bits = torch.empty(nc, dtype=torch.int32, device=words.device)
    huff_raw = torch.empty(nc, dtype=torch.bool, device=words.device)
    if nc:
        _build.launch(
            "tdc_huff_select", words.data_ptr(), counts.data_ptr(),
            sym_code.data_ptr(), sym_len.data_ptr(), out.data_ptr(),
            bits.data_ptr(), huff_raw.data_ptr(), nc, device=words.device,
        )
        huffman_select_segments.launches += 1
    return out, bits, huff_raw


huffman_select_segments.launches = 0


def huffman_select_segments_plain(words, counts, sym_code, sym_len):
    """Plain torch K2 + select: :func:`huffman_pack_segments_plain`,
    then the input words where ``bits >= 8 * counts``."""
    packed, bits = huffman_pack_segments_plain(words, counts, sym_code,
                                               sym_len)
    huff_raw = bits >= counts * 8
    out = torch.where(huff_raw[:, None], words, packed)
    return out, torch.where(huff_raw, counts * 8, bits), huff_raw


def huffman_pack_segments_plain(words, counts, sym_code, sym_len):
    """Plain torch K2: table lookup, then :func:`pack_rows`."""
    _, _, code, ln = huffman_terms(words, counts, sym_code, sym_len)
    return pack_rows(code, ln, STREAM_WORDS), ln.sum(dim=1).to(torch.int32)


def huffman_terms(words, counts, sym_code, sym_len):
    """K2's table lookup, per position of each segment: ``(sym, live,
    code, ln)``, all int64 or bool ``[NC, 2048]``; ``code`` and ``ln``
    are 0 past ``counts``."""
    sym = bytes_from_words(words, SEG).long()
    live = (torch.arange(SEG, device=words.device)[None, :]
            < counts.long()[:, None])
    ln = torch.where(live, sym_len.long().clamp(0, 16)[sym], 0)
    code = sym_code.long()[sym] & ((1 << ln) - 1)
    return sym, live, code, ln


def pack_rows(code, ln, width: int):
    """Each row's codes (int64, ``ln <= 32`` bits, masked) packed
    MSB-first at the exclusive cumsum of ``ln``; the first ``width``
    words as int32. Each code's (at most two) word parts are
    scatter-added: their bit ranges are disjoint, so adding them is
    OR-ing them."""
    off = torch.cumsum(ln, dim=1) - ln
    w0 = off >> 5
    sh = 32 - (off & 31) - ln  # in [-31, 32]
    part1 = torch.where(sh >= 0, code << sh.clamp(min=0),
                        code >> (-sh).clamp(min=0))
    spill = torch.where(sh < 0, code << (32 + sh).clamp(max=32), 0)
    acc = torch.zeros(code.shape[0], width + 2, dtype=torch.int64,
                      device=code.device)
    # parts past the kept words land in the two discarded columns
    acc.scatter_add_(1, w0.clamp(max=width), part1)
    acc.scatter_add_(1, (w0 + 1).clamp(max=width + 1), spill & 0xFFFFFFFF)
    return as_i32(acc[:, :width])
