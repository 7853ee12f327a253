"""The TBC2 container, worked out plainly from the input bytes.

TBC2 splits its input into 2048-byte segments and writes:

    "TBC2" | vbyte(header length) | header | one frame a segment

- header (a finished bit stream): compressed_int(2048),
  compressed_int(offset), compressed_int(input length), a bit for "has
  a Huffman table", the table (``huffman.py``);
- a segment's stream is its RLE (a run of ``r >= 2`` equal bytes ``c``
  gives ``c, c, vbyte(r - 2 + offset)``; a lone byte stays itself),
  unless that is longer than the segment: then (``rle_raw``) the stream
  is the segment's bytes;
- the table comes from a histogram of the streams' bytes: of every 8th
  segment among the first 8192 (segments 0, 8, 16, ...) where the input
  has at least 64 segments, with one added to every byte value's count,
  and of every segment below that; at most one byte value counted means
  no table (every stream is then kept as it is). Codes are at least
  ``min_code_len`` (3) and at most 16 bits long;
- a segment's payload is its stream's codes, packed most significant
  bit first, unless they take as many bits as the stream or more: then
  (``huff_raw``) the payload is the stream's bytes;
- a frame is vbyte(stream length << 2 | rle_raw << 1 | huff_raw),
  vbyte(payload bytes), the payload.

Everything runs as whole-tensor operations on the device it is given,
in blocks of segments, so that the reference fits beside nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import format as fmt
from benchmark.reference.huffman import Table

MAGIC = b"TBC2"
SEG = 2048
#: the table's histogram samples every STRIDE-th of the first HIST_SEGS
#: segments where the input has SAMPLE_MIN segments or more
HIST_SEGS, STRIDE, SAMPLE_MIN = 8192, 8, 64
MAX_LEN = 16
#: segments a block of the reference's own work (any value gives the
#: same bytes)
BLOCK = 8192

_I64 = torch.int64


def _vbyte2(v):
    """vbyte of ``v < 2**14``: ``(first byte, second byte, bytes)``."""
    two = v >= 128
    return (torch.where(two, (v & 0x7F) | 0x80, v), v >> 7,
            1 + two.to(_I64))


def streams(rows, lens, offset: int):
    """Per segment (``rows u8[B, SEG]``, valid to ``lens i64[B]``): the
    stream bytes (``u8[B, SEG]``, zero past the count), its length and
    the ``rle_raw`` flag."""
    b = rows.shape[0]
    dev = rows.device
    a = rows.to(_I64)
    j = torch.arange(SEG, device=dev)
    live = j < lens[:, None]
    starts = torch.ones_like(live)
    starts[:, 1:] = a[:, 1:] != a[:, :-1]
    starts |= ~live
    run_start = torch.cummax(torch.where(starts, j, 0), dim=1).values
    last = torch.ones_like(live)
    last[:, :-1] = starts[:, 1:]
    last &= live
    run = j - run_start + 1
    b0, b1, nv = _vbyte2((run - 2 + offset).clamp(min=0))
    size = torch.where(run >= 2, 2 + nv, 1) * last
    length = size.sum(1)
    rle_raw = length > lens
    at = torch.cumsum(size, 1) - size
    out = torch.zeros(b, SEG + 4, dtype=torch.uint8, device=dev)
    flat = out.view(-1)
    row = torch.arange(b, device=dev)[:, None] * (SEG + 4)
    for k, value in enumerate((a, a, b0, b1)):
        m = size > k
        flat[(row + (at + k).clamp(max=SEG + 3))[m]] = value[m].to(
            torch.uint8)
    own = torch.where(live, rows, 0)
    stream = torch.where(rle_raw[:, None], own, out[:, :SEG])
    count = torch.where(rle_raw, lens, length)
    stream = torch.where(j < count[:, None], stream, 0)
    return stream, count, rle_raw


def payloads(stream, count, code, length):
    """Per segment: the payload bytes (``u8[B, SEG]``), their number
    and the ``huff_raw`` flag, for the codes ``code``/``length`` (i64
    [256] on the stream's device)."""
    dev = stream.device
    j = torch.arange(SEG, device=dev)
    sym = stream.to(_I64)
    live = j < count[:, None]
    ln = length[sym] * live
    cd = code[sym] * live
    bits = ln.sum(1)
    huff_raw = bits >= 8 * count
    at = torch.cumsum(ln, 1) - ln
    window = cd << (24 - (at & 7) - ln)  # the code in a 3-byte window
    acc = torch.zeros(stream.shape[0], SEG + 3, dtype=_I64, device=dev)
    for k in range(3):
        acc.scatter_add_(1, ((at >> 3) + k).clamp(max=SEG + 2),
                         (window >> (16 - 8 * k)) & 0xFF)
    packed = acc[:, :SEG].to(torch.uint8)
    payload = torch.where(huff_raw[:, None], stream, packed)
    return payload, torch.where(huff_raw, count, (bits + 7) // 8), huff_raw


def frames(count, rle_raw, payload, pbytes, huff_raw) -> torch.Tensor:
    """The segments' frames, concatenated (u8[])."""
    dev = payload.device
    m1a, m1b, l1 = _vbyte2(count * 4 + rle_raw.to(_I64) * 2
                           + huff_raw.to(_I64))
    m2a, m2b, l2 = _vbyte2(pbytes)
    two = l1 == 2
    prefix = torch.stack([m1a, torch.where(two, m1b, m2a),
                          torch.where(two, m2a, m2b),
                          torch.where(two, m2b, 0)], dim=1).to(torch.uint8)
    head = (l1 + l2)[:, None]
    whole = torch.cat([prefix, payload], dim=1)
    j = torch.arange(SEG + 4, device=dev)[None, :]
    row = whole.gather(1, torch.where(j < head, j, 4 + j - head)
                       .clamp(max=SEG + 3))
    return row[j < head + pbytes[:, None]]


def segments(data: bytes, device):
    """``(rows u8[nseg, SEG], lens i64[nseg])`` of ``data`` on
    ``device``, zero padded."""
    n = len(data)
    nseg = -(-n // SEG)
    flat = torch.zeros(nseg * SEG, dtype=torch.uint8, device=device)
    flat[:n] = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(
        device)
    lens = (n - SEG * torch.arange(nseg, device=device)).clamp(0, SEG)
    return flat.view(nseg, SEG), lens


def table(rows, lens, offset: int, min_code_len: int,
          exact_hist: bool = False):
    """The Huffman table (``None`` where there is none). ``exact_hist``
    counts every segment: not the format's table (the control)."""
    nseg = rows.shape[0]
    sampled = nseg >= SAMPLE_MIN
    if sampled and not exact_hist:
        pick = torch.arange(0, min(nseg, HIST_SEGS), STRIDE,
                            device=rows.device)
    else:
        pick = torch.arange(nseg, device=rows.device)
    hist = torch.zeros(256, dtype=_I64, device=rows.device)
    for lo in range(0, pick.numel(), BLOCK):
        at = pick[lo : lo + BLOCK]
        stream, count, _ = streams(rows[at], lens[at], offset)
        live = torch.arange(SEG, device=rows.device) < count[:, None]
        hist += torch.bincount(stream[live].to(_I64), minlength=256)
    hist = hist.cpu().numpy()
    if sampled:
        hist = hist + 1
    if (hist > 0).sum() <= 1:
        return None
    return Table(hist, MAX_LEN, min(max(min_code_len, 3), 8))


def compress(data: bytes, device, *, offset: int = 0, min_code_len: int = 3,
             exact_hist: bool = False) -> bytes:
    """The TBC2 container of ``data``."""
    rows, lens = segments(data, device)
    tab = table(rows, lens, offset, min_code_len, exact_hist)
    if tab is None:  # 8-bit identity codes: every payload is raw
        code = torch.arange(256, device=device)
        length = torch.full((256,), 8, dtype=_I64, device=device)
    else:
        code = torch.from_numpy(tab.code).to(device)
        length = torch.from_numpy(tab.length).to(device)
    body = []
    for lo in range(0, rows.shape[0], BLOCK):
        stream, count, rle_raw = streams(rows[lo : lo + BLOCK],
                                         lens[lo : lo + BLOCK], offset)
        payload, pbytes, huff_raw = payloads(stream, count, code, length)
        body.append(frames(count, rle_raw, payload, pbytes,
                           huff_raw).cpu().numpy().tobytes())
    bits = fmt.Bits()
    bits.compressed_int(SEG)
    bits.compressed_int(offset)
    bits.compressed_int(len(data))
    bits.bit(tab is not None)
    if tab is not None:
        tab.write(bits)
    header = bits.finish()
    return MAGIC + fmt.vbyte(len(header)) + header + b"".join(body)


def _compressed_ints(header: bytes, count: int) -> list[int]:
    """The first ``count`` compressed_ints of a finished bit stream."""
    bits = np.unpackbits(np.frombuffer(header, np.uint8))
    pos, out = 0, []
    for _ in range(count):
        value = shift = 0
        while True:
            more = bits[pos]
            group = int(np.packbits(np.concatenate(
                [[0], bits[pos + 1 : pos + 8]]))[0])
            pos += 8
            value |= group << shift
            shift += 7
            if not more:
                break
        out.append(value)
    return out


def payload_bytes(container: bytes) -> tuple[int, int]:
    """``(input length, total payload bytes)`` read from a container's
    header and frames."""
    if container[:4] != MAGIC:
        raise ValueError("not a TBC2 container")
    hlen, pos = fmt.read_vbyte(container, 4)
    seg, _, n = _compressed_ints(container[pos : pos + hlen], 3)
    pos += hlen
    total = 0
    for _ in range(-(-n // seg)):
        _, pos = fmt.read_vbyte(container, pos)
        pb, pos = fmt.read_vbyte(container, pos)
        total += pb
        pos += pb
    return n, total
