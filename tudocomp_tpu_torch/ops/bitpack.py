"""Variable-length bit packing in plain torch: the universal output op.

Counterpart of ``tudocomp_tpu/ops/bitpack.py``. Encoders produce token
arrays ``(values, lens)`` — ``lens[i]`` MSB-first bits of ``values[i]``,
``lens <= 32`` — and :func:`pack_tokens` packs them into big-endian u32
words: an exclusive cumsum of ``lens`` gives each token its bit offset,
each token splits into a part for its word and a spill into the next,
and a scatter-add places the parts (bit ranges are disjoint, so adding
is OR-ing). Zero-length tokens contribute nothing, so fixed-shape
padding is "pad with ``lens == 0``". The host specification is
``io/bitio.py:pack_tokens``.

u32 values and words are held as int32 tensors of the same bit pattern
(:func:`as_i32`); the math runs in int64.
"""

from __future__ import annotations

import numpy as np
import torch

from tudocomp_tpu_torch.io.bitio import finalize_stream

_M32 = 0xFFFFFFFF


def as_i32(x: torch.Tensor) -> torch.Tensor:
    """u32 values held in int64 -> int32 tensor of the same bit pattern."""
    x = x & _M32
    return (x - ((x >> 31) << 32)).to(torch.int32)


def bits_for_u32(v: torch.Tensor) -> torch.Tensor:
    """Bits needed for each u32 value (``bits_for(0) == 1``), as int32."""
    v = v.long() & _M32
    out = torch.zeros_like(v)
    for shift in (16, 8, 4, 2, 1):
        m = v >= (1 << shift)
        out = out + torch.where(m, shift, 0)
        v = torch.where(m, v >> shift, v)
    return (out + 1).to(torch.int32)


def pack_tokens(values: torch.Tensor, lens: torch.Tensor):
    """Pack one stream of tokens ``values, lens [N]`` (lens <= 32) into
    big-endian u32 words. Returns ``(words i32[N+1], total_bits i32)``:
    ``N+1`` words always suffice, since the total is at most ``32 * N``
    bits. Counterpart of ``pack_tokens_device``."""
    n = values.shape[0]
    words = torch.zeros(n + 1, dtype=torch.int64, device=values.device)
    if n == 0:
        return as_i32(words), torch.zeros((), dtype=torch.int32,
                                           device=values.device)
    lens = lens.long()
    mask = torch.where(lens >= 32, _M32, (1 << lens.clamp(max=31)) - 1)
    v = values.long() & mask
    ends = torch.cumsum(lens, dim=0)
    offs = ends - lens
    sh = 32 - (offs & 31) - lens  # in [-31, 32]
    rsh = (-sh).clamp(0, 31)
    part1 = torch.where(sh >= 0, v << sh.clamp(0, 31), v >> rsh)
    spill = torch.where(sh < 0, ((v & ((1 << rsh) - 1)) << (32 - rsh)) & _M32,
                        0)
    w0 = offs >> 5
    # a zero-length token at the very end may sit on word N: it adds 0
    words.scatter_add_(0, w0.clamp(max=n), part1)
    words.scatter_add_(0, (w0 + 1).clamp(max=n), spill)
    return as_i32(words), ends[-1].to(torch.int32)


def unpack_fixed(words: torch.Tensor, start_bit, width: int,
                 count: int) -> torch.Tensor:
    """Read ``count`` consecutive ``width``-bit ints (1 <= width <= 32)
    from big-endian u32 ``words`` (int32 bit patterns), starting at bit
    ``start_bit``. Returns int64 values. ``words`` needs one word of slack
    past the last read."""
    offs = int(start_bit) + torch.arange(
        count, dtype=torch.int64, device=words.device) * width
    w0 = offs >> 5
    bitpos = offs & 31
    w = words.long() & _M32
    hi = w[w0]
    lo = w[(w0 + 1).clamp(max=words.shape[0] - 1)]
    merged = ((hi << bitpos) | torch.where(bitpos > 0, lo >> (32 - bitpos),
                                           0)) & _M32
    return merged >> (32 - width) if width < 32 else merged


def words_to_stream(words, total_bits: int) -> bytes:
    """Host: trim big-endian words to the payload and finalize."""
    total_bits = int(total_bits)
    if isinstance(words, torch.Tensor):
        words = words.cpu().numpy()
    payload = (
        np.asarray(words).view(np.uint32)
        .astype(">u4")
        .view(np.uint8)[: (total_bits + 7) // 8]
    )
    return finalize_stream(payload, total_bits)


def stream_to_words(payload: np.ndarray) -> np.ndarray:
    """Host: payload bytes -> big-endian uint32 words (padded with slack)."""
    payload = np.asarray(payload, dtype=np.uint8)
    pad = (-payload.size) % 4 + 4  # alignment + one word of slack
    padded = np.concatenate([payload, np.zeros(pad, np.uint8)])
    return padded.view(">u4").astype(np.uint32)
