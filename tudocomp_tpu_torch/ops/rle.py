"""RLE token contracts and stream-word helpers (plain torch).

Counterpart of ``tudocomp_tpu/ops/rle_jax.py`` (``vbyte2_token``,
``rle_tokens``, ``rle_encode_device``, ``bytes_from_words``) and
``segpack_pallas.be_words_from_bytes``. Format: a run of ``n >= 2``
equal bytes becomes char, char, vbyte(n - 2 + offset); a single byte
stays verbatim (``compressors/rle.py:rle_encode`` is the oracle). Runs
are cut into pieces of at most ``RUN_CAP`` bytes; a continuation piece
of length L emits the char once and vbyte(L - 1 + offset), which the
reference decoder expands to L copies because it keeps the char armed.
Every piece is one <= 32-bit token of whole bytes: 1, 3 or 4 bytes for a
first piece, 2 or 3 for a continuation.

Two token forms: :func:`rle_tokens` is the JAX contract, one
``(value, lens)`` token per position, which the chunked packers take;
:func:`rle_segment_tokens` gives the token bytes per position of a
2048-byte segment, where no run reaches the cap, for K1's plain version.

Word math runs in int64: ``>>`` on a signed torch tensor is arithmetic,
while the stream words are unsigned 32-bit values. Words are stored as
int32 tensors holding the u32 bit pattern (``bitpack.as_i32``).
"""

from __future__ import annotations

import torch

from tudocomp_tpu_torch.ops.bitpack import as_i32, pack_tokens

#: max RLE ``offset``: a larger one lets a run of 2 emit a 2-byte vbyte
#: (the bound the JAX packers assert, ``segpack_pallas.py:781``)
MAX_OFFSET = 125

#: max piece length of a run; keeps vbyte(n - 2 + offset) <= 2 bytes
RUN_CAP = 8192


def be_words_from_bytes(rows: torch.Tensor) -> torch.Tensor:
    """Big-endian u32 stream words (as int32) from byte rows
    ``u8[..., 4k]``: byte 0 lands in the top byte of word 0."""
    b = rows.reshape(*rows.shape[:-1], rows.shape[-1] // 4, 4).long()
    return as_i32((b[..., 0] << 24) | (b[..., 1] << 16)
                  | (b[..., 2] << 8) | b[..., 3])


def bytes_from_words(words: torch.Tensor, count: int) -> torch.Tensor:
    """First ``count`` bytes of big-endian stream words (int32) as u8."""
    w = words.long() & 0xFFFFFFFF
    b = torch.stack([(w >> sh) & 0xFF for sh in (24, 16, 8, 0)], dim=-1)
    b = b.reshape(*words.shape[:-1], 4 * words.shape[-1])
    return b[..., :count].to(torch.uint8)


def rle_segment_tokens(rows: torch.Tensor, lens: torch.Tensor,
                       offset: int = 0):
    """RLE tokens of ``rows[c, :lens[c]]``, one slot per position, for
    rows shorter than ``RUN_CAP`` (no continuation pieces).

    Returns ``(tok i64[NC, N, 4], nbytes i64[NC, N])``: the token bytes
    in stream order and their count, non-zero only at run ends (so the
    stream is the slots' bytes in position order). Positions at or past
    ``lens`` emit nothing and never merge with a real run.
    """
    a = rows.long()
    nc, n = a.shape
    idx = torch.arange(n, device=a.device)
    live = idx[None, :] < lens.long()[:, None]
    first = torch.ones(nc, 1, dtype=torch.bool, device=a.device)
    boundary = torch.cat([first, a[:, 1:] != a[:, :-1]], dim=1) | ~live
    # start of own run: forward cummax of boundary positions
    sor = torch.cummax(torch.where(boundary, idx, 0), dim=1).values
    # a run ends where the next position starts a run or is padding
    is_end = torch.cat([boundary[:, 1:], first], dim=1) & live
    run = idx - sor + 1
    v = (run - 2 + offset).clamp(min=0)
    two = v >= 128  # vbyte(v) needs a second byte (v < 2**14 here)
    vb0 = torch.where(two, (v & 0x7F) | 0x80, v)
    vb1 = v >> 7
    is_run = run >= 2
    tok = torch.stack([a, a, vb0, vb1], dim=-1)
    nbytes = torch.where(is_run, 3 + two.long(), 1)
    return tok, torch.where(is_end, nbytes, 0)


def vbyte2_token(v: torch.Tensor):
    """vbyte of ``v < 2**14`` as one MSB-first token ``(value, bits)``."""
    two = v >= 128
    b0 = (v & 0x7F) | torch.where(two, 0x80, 0)
    b1 = (v >> 7) & 0x7F
    return torch.where(two, (b0 << 8) | b1, b0), torch.where(two, 16, 8)


def rle_tokens(block: torch.Tensor, length, offset: int = 0):
    """RLE tokens of ``block[..., :length]`` — ONE token per position.

    ``block`` is u8 ``[..., N]``; ``length`` an int or an integer tensor
    of the leading shape. Returns ``(values, lens)``, int32 ``[..., N]``
    (values hold the u32 bit pattern), in stream order: tokens are
    emitted at piece ends, zero-length tokens elsewhere. Positions at or
    past ``length`` emit nothing and never merge with a real run.
    """
    if not 0 <= offset < RUN_CAP // 2:
        raise ValueError(f"RLE offset must lie in 0..{RUN_CAP // 2 - 1}")
    a = block.to(torch.int32)
    n = a.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=a.device)
    length = torch.as_tensor(length, device=a.device).to(torch.int32)
    length = length[..., None]
    pad = idx >= length
    ones = torch.ones(*a.shape[:-1], 1, dtype=torch.bool, device=a.device)
    boundary = torch.cat([ones, a[..., 1:] != a[..., :-1]], dim=-1) | pad
    # start of own run: forward cummax of boundary positions
    sor = torch.cummax(torch.where(boundary, idx, 0), dim=-1).values
    # piece end: next position starts a new run / is padding / cap hit
    next_boundary = (torch.cat([boundary[..., 1:], ones], dim=-1)
                     | (idx + 1 >= length))
    since = idx - sor
    piece_len = since % RUN_CAP + 1
    is_end = (next_boundary | (piece_len == RUN_CAP)) & ~pad
    is_cont = since >= RUN_CAP  # continuation piece (not first of run)
    is_run = is_cont | (piece_len >= 2)
    vb_val, vb_bits = vbyte2_token(
        (torch.where(is_cont, piece_len - 1, piece_len - 2) + offset)
        .clamp(min=0)
    )
    a = a.long()
    cc = torch.where(is_cont, a, (a << 8) | a)
    run_val = (cc << vb_bits) | vb_val
    run_bits = torch.where(is_cont, 8, 16) + vb_bits
    values = as_i32(torch.where(is_run, run_val, a))
    lens = torch.where(is_end, torch.where(is_run, run_bits, 8), 0)
    return values, lens.to(torch.int32)


def rle_encode(block: torch.Tensor, length, offset: int = 0):
    """Single-stream RLE ``block u8[N]`` -> ``(words i32[N+1], n_bytes)``:
    the byte stream as big-endian u32 words. Counterpart of
    ``rle_encode_device``."""
    words, bits = pack_tokens(*rle_tokens(block, length, offset))
    return words, bits >> 3
