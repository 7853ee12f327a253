"""K4: TBC2 segment decode (canonical Huffman fused with the RLE parse).

Counterpart of ``tudocomp_tpu/ops/hufdec_jax.py`` (``decoder_tables``
:125, ``build_feed`` :96, ``expand_records`` :319, semantics of
``decode_segments`` :193) and ``hufdec_pallas.decode_segments_pallas``
(:223). The TPU decoders run thousands of segments in lockstep over a
fixed feed layout with static step buckets; here each segment decodes
straight from the container bytes at ``poff``/``pbytes`` and writes its
output bytes in place, so the feed, the step buckets, the payload sort
and the record arrays are gone. Only the decoded bytes are held to the
reference.

Per segment: ``counts`` symbols, each of canonical length
``1 + #{l : window16 < thresh[l]}`` (capped at 16) and value
``symbols[prefix + offs[len - 1]]``; ``huff_raw`` segments hold 8-bit
verbatim symbols. The symbols then run through the reference RLE record
machine (``hufdec_pallas.py:146-177``), which ``rle_raw`` segments
bypass (every symbol is one output byte). The kernel resolves codes of
at most ``FAST_BITS`` bits with one lookup in :func:`fast_decode_table`,
built on the host beside the thresholds.
"""

from __future__ import annotations

import numpy as np
import torch

from tudocomp_tpu_torch import _build

SEG = 2048  # output bytes per segment

#: window bits of the one-lookup decode table (codes of at most this
#: many bits resolve with one load; longer ones take the thresholds)
FAST_BITS = 10


def decoder_tables(table) -> dict:
    """Decode-side arrays of a ``HuffmanTable`` (or ``None``): ``thresh``
    i32[16] (16-bit-scaled firstcode thresholds, non-increasing),
    ``offs`` i32[16] (symbol index = prefix + offs[len - 1]),
    ``symbols`` u8[256] (the canonically sorted symbols, zero padded)
    and ``fast`` i16[1024], their :func:`fast_decode_table`. ``None``
    (no table: every segment is ``huff_raw``) gives zero thresholds."""
    thresh = np.zeros(16, np.int64)
    offs = np.zeros(16, np.int64)
    symbols = np.zeros(256, np.uint8)
    if table is None:
        return _with_fast(thresh, offs, symbols)
    longest = table.longest
    if not 1 <= longest <= 16:
        raise ValueError(f"device decode needs code lengths <= 16: {longest}")
    fc = table.firstcode  # fc[l-1] = first code of length l
    for l in range(1, longest + 1):
        thresh[l - 1] = int(fc[l - 1]) << (16 - l)
    if np.any(np.diff(thresh) > 0):
        raise ValueError(f"thresholds not monotone: {thresh}")
    start_of_len = np.concatenate([[0], np.cumsum(table.numl)])
    for l in range(1, longest + 1):
        offs[l - 1] = start_of_len[l - 1] - int(fc[l - 1])
    symbols[: table.symbols.size] = table.symbols
    return _with_fast(thresh, offs, symbols)


def _with_fast(thresh, offs, symbols) -> dict:
    arrays = {"thresh": thresh.astype(np.int32),
              "offs": offs.astype(np.int32), "symbols": symbols}
    fast = fast_decode_table(*(torch.from_numpy(a) for a in arrays.values()))
    return {**arrays, "fast": fast.numpy()}


def fast_decode_table(thresh, offs, symbols) -> torch.Tensor:
    """K4's one-lookup table: for each ``FAST_BITS``-bit window prefix
    ``p``, ``symbol | length << 8`` (i16) when every 16-bit window that
    starts with ``p`` has the same code length under the threshold
    compare and that length is at most ``FAST_BITS``; else 0 (decode the
    window with the thresholds). The length is a non-increasing function
    of the window, so equal lengths at the prefix's lowest and highest
    window hold for all windows between, whatever ``thresh`` is."""
    tail = 16 - FAST_BITS
    lo = torch.arange(1 << FAST_BITS, device=thresh.device) << tail
    t = thresh.long()

    def length(win):
        return (1 + (win[:, None] < t[None, :]).sum(dim=1)).clamp(max=16)

    ln = length(lo)
    ok = (ln == length(lo | ((1 << tail) - 1))) & (ln <= FAST_BITS)
    idx = ((lo >> (16 - ln)) + offs.long()[ln - 1]).clamp(0, 255)
    return torch.where(ok, symbols.long()[idx] | (ln << 8), 0).to(torch.int16)


def decode_segments(flat, poff, pbytes, counts, flags, thresh, offs,
                    symbols, *, offset: int, orig_len: int, fast=None):
    """Decode every segment of a parsed TBC2 container.

    ``flat u8[N]``: the container; ``poff``/``pbytes`` i64[nseg]: each
    payload's offset and size in it; ``counts`` i32[nseg] symbols per
    segment (at most SEG); ``flags`` u8[nseg] (bit 0 ``huff_raw``, bit 1
    ``rle_raw``); ``thresh``/``offs`` i32[16], ``symbols`` u8[256] and
    ``fast`` i16[1024] from :func:`decoder_tables` (``None``: made here
    by :func:`fast_decode_table`). Returns the ``u8[orig_len]`` output:
    segment ``c`` at ``c * SEG``, zero past a segment that decodes short;
    payload bytes past ``pbytes`` (or past ``flat``) read as zero. CUDA
    tensors launch ``csrc/hufdec.cu``; CPU tensors take
    :func:`decode_segments_plain`, which needs no ``fast`` table.
    """
    nseg = counts.shape[0]
    _build.check(flat, torch.uint8, (flat.shape[0],), "flat")
    _build.check(poff, torch.int64, (nseg,), "poff")
    _build.check(pbytes, torch.int64, (nseg,), "pbytes")
    _build.check(counts, torch.int32, (nseg,), "counts")
    _build.check(flags, torch.uint8, (nseg,), "flags")
    _build.check(thresh, torch.int32, (16,), "thresh")
    _build.check(offs, torch.int32, (16,), "offs")
    _build.check(symbols, torch.uint8, (256,), "symbols")
    if not 0 <= orig_len <= nseg * SEG:
        raise ValueError(f"orig_len {orig_len} does not fit {nseg} segments")
    tensors = (flat, poff, pbytes, counts, flags, thresh, offs, symbols)
    if not _build.on_cuda(*tensors):
        return decode_segments_plain(*tensors, offset=offset,
                                     orig_len=orig_len)
    if fast is None:
        fast = fast_decode_table(thresh, offs, symbols)
    _build.check(fast, torch.int16, (1 << FAST_BITS,), "fast")
    tensors += (fast,)
    # the kernel writes every byte of [0, orig_len)
    out = torch.empty(nseg * SEG, dtype=torch.uint8, device=flat.device)
    if nseg:
        _build.launch(
            "tdc_hufdec", *(t.data_ptr() for t in tensors), out.data_ptr(),
            nseg, flat.shape[0], orig_len, offset, device=flat.device,
        )
        decode_segments.launches += 1
    return out[:orig_len]


decode_segments.launches = 0


def build_feed(flat, poff, pbytes, width: int) -> torch.Tensor:
    """Ragged payload gather: row c holds ``flat[poff[c]:][:pbytes[c]]``
    zero padded to ``width`` bytes (the JAX decoders' feed, as bytes);
    like K4, it reads nothing outside ``flat``."""
    n = flat.shape[0]
    start = poff.clamp(0, n)
    nb = torch.minimum(pbytes.clamp(min=0), n - start)
    j = torch.arange(width, device=flat.device)
    live = j[None, :] < nb[:, None]
    src = (start[:, None] + j[None, :]).clamp(0, max(n - 1, 0))
    return torch.where(live, flat[src], 0)


def expand_records(chars, ends, out_lens) -> torch.Tensor:
    """Records ``(char, cumulative end)`` per slot -> ``u8[nseg * SEG]``:
    segment c's bytes at ``c * SEG``, its ends clipped to its real length
    (``out_lens``), zeros past a segment that decodes short."""
    nseg = chars.shape[0]
    ends = torch.minimum(ends, out_lens[:, None])
    prev = torch.cat([torch.zeros_like(ends[:, :1]), ends[:, :-1]], dim=1)
    deltas = (ends - prev).clamp(min=0).reshape(-1)
    first = prev + SEG * torch.arange(nseg, device=chars.device)[:, None]
    # each byte: its record's first output position + its place in it
    within = (torch.arange(int(deltas.sum()), device=chars.device)
              - torch.repeat_interleave(torch.cumsum(deltas, 0) - deltas,
                                        deltas))
    out = torch.zeros(nseg * SEG, dtype=torch.uint8, device=chars.device)
    out[torch.repeat_interleave(first.reshape(-1), deltas) + within] = (
        torch.repeat_interleave(chars.reshape(-1), deltas).to(torch.uint8))
    return out


def decode_segments_plain(flat, poff, pbytes, counts, flags, thresh, offs,
                          symbols, *, offset: int, orig_len: int):
    """Plain torch K4: vectorised over segments, one Python step per
    symbol slot, emitting ``(char, end)`` records like the JAX scan, then
    placing each segment's bytes at ``c * SEG``."""
    nseg = counts.shape[0]
    dev = flat.device
    counts = counts.long().clamp(0, SEG)
    n_slots = int(counts.max()) if nseg else 0
    # the widest read: 16-bit codes for every symbol, and a 3-byte window
    width = 2 * n_slots + 3
    feed = build_feed(flat, poff, pbytes, width).long()
    raw = (flags & 1).bool()
    rleraw = (flags & 2).bool()
    thresh, offs, symbols = thresh.long(), offs.long(), symbols.long()
    rows = torch.arange(nseg, device=dev)
    zero = torch.zeros(nseg, dtype=torch.int64, device=dev)
    pos, vb_pend, vb_char, vb_acc, out_end = (zero,) * 5
    armed = zero - 1
    chars = torch.zeros(nseg, n_slots, dtype=torch.int64, device=dev)
    ends = torch.zeros(nseg, n_slots, dtype=torch.int64, device=dev)
    for i in range(n_slots):
        valid = counts > i
        q = pos >> 3
        b24 = ((feed[rows, q] << 16) | (feed[rows, q + 1] << 8)
               | feed[rows, q + 2])
        win = (b24 >> (8 - (pos & 7))) & 0xFFFF
        ln = (1 + (win[:, None] < thresh[None, :]).sum(dim=1)).clamp(max=16)
        ln = torch.where(raw, 8, ln)
        idx = ((win >> (16 - ln)) + offs[ln - 1]).clamp(0, 255)
        byte = torch.where(raw, win >> 8, symbols[idx])
        pos = pos + torch.where(valid, ln, 0)
        # RLE record machine: armed char, vbyte of at most 3 bytes
        is_vb = vb_pend > 0
        new_acc = vb_acc | ((byte & 0x7F) << (7 * (vb_pend - 1).clamp(min=0)))
        cont = (byte & 0x80) != 0
        trig = ~is_vb & (byte == armed) & ~rleraw
        delta = torch.where(
            is_vb, torch.where(cont, 0, new_acc - offset + 1),
            torch.where(trig, 0, 1),
        )
        delta = torch.where(valid, delta.clamp(0, SEG), 0)
        chars[:, i] = torch.where(is_vb, vb_char, byte)
        vb_pend = torch.where(
            valid,
            torch.where(is_vb, torch.where(cont, (vb_pend + 1).clamp(max=3),
                                           0), trig.long()),
            vb_pend,
        )
        vb_char = torch.where(valid & trig, byte, vb_char)
        vb_acc = torch.where(valid, torch.where(is_vb & cont, new_acc, 0),
                             vb_acc)
        armed = torch.where(valid & ~is_vb, byte, armed)
        out_end = (out_end + delta).clamp(max=SEG)
        ends[:, i] = out_end
    # output bytes per segment: SEG except for the short last one
    out_lens = (orig_len - SEG * rows).clamp(0, SEG)
    return expand_records(chars, ends, out_lens)[:orig_len]
