"""Chunked bit packers: K5 (token pack), K6 (Huffman lookup + pack) and
K7 (RLE + pack).

Counterparts of ``tudocomp_tpu/ops/bitpack_pallas.py``:
``pack_tokens_chunks`` (:319), ``pack_bytes_huffman_chunks`` (:245) and
``rle_pack_chunks`` (:505), with their signatures, shapes and ``cap``
formulas. Each chunk of ``N`` positions is one stream whose bit offset
carries across the whole chunk. Each wrapper launches its hand-written
CUDA kernel (``csrc/bitpack.cu``, ``csrc/huff_chunk_pack.cu``,
``csrc/rle_chunk_pack.cu``) on CUDA
tensors and runs its plain torch version on CPU tensors; there is no
other route. K6 and K7 write every word of their rows (the zero tail
too), so their outputs are allocated with ``torch.empty``; K5 ORs into a
zeroed row.

Output contract: the first ``ceil(bits / 32)`` words of each row plus
the count; the words past the stream are zero. The TPU's K7 returned
its count in a slot at word ``cap - 128``; here it is the second output
and no slot is written. Bit totals are int32, so a chunk must hold fewer
than ``2**31`` bits: ``32 * N < 2**31``.

u32 arrays are held as int32 tensors of the same bit pattern
(``ops/bitpack.py:as_i32``).
"""

from __future__ import annotations

import torch

from tudocomp_tpu_torch import _build
from tudocomp_tpu_torch.ops.bitpack import pack_tokens
from tudocomp_tpu_torch.ops.huffman import huffman_pack
from tudocomp_tpu_torch.ops.rle import RUN_CAP, rle_encode

LANES = 128
KERNEL_TILE = 2048  # positions per tile of the CUDA kernels (csrc: TILE)


def _wt_for(tile: int, max_bits: int) -> int:
    """The TPU kernel's accumulator width (``bitpack_pallas._wt_for``),
    which fixes the output width ``cap``."""
    by_bits = tile * max_bits // 32 + 2 * LANES
    by_window = ((4095 + max_bits * tile) // 4096) * 128 + 3 * LANES
    return max(by_bits, by_window)


def _check_chunks(n: int, tile: int) -> None:
    if tile <= 0 or tile % LANES or n % tile:
        raise ValueError(f"need N % tile == 0 and tile % {LANES} == 0: "
                         f"N={n}, tile={tile}")
    if 32 * n >= 1 << 31:
        raise ValueError(f"N={n}: a chunk's bit total must fit int32")


def _scratch(c: int, n: int, planes: int, device) -> torch.Tensor:
    tiles = -(-n // KERNEL_TILE)
    return torch.empty(planes, c, tiles, dtype=torch.int32, device=device)


def pack_tokens_chunks(values: torch.Tensor, lens: torch.Tensor, *,
                       tile: int = 2048):
    """K5: pack per-chunk token streams ``values, lens i32[C, N]``
    (``lens[c, i]`` MSB-first bits of ``values[c, i]``; lengths outside
    0..32, as u32, are clamped to 32). Returns ``(words i32[C, cap],
    bits i32[C])`` with ``cap = N + tile + 384``."""
    c, n = values.shape
    _build.check(values, torch.int32, (c, n), "values")
    _build.check(lens, torch.int32, (c, n), "lens")
    _check_chunks(n, tile)
    cap = n + tile + 3 * LANES
    if not _build.on_cuda(values, lens):
        return pack_tokens_chunks_plain(values, lens, tile=tile)
    _build.check_aligned(values, "values", 16)
    _build.check_aligned(lens, "lens", 16)
    words = torch.zeros(c, cap, dtype=torch.int32, device=values.device)
    bits = torch.zeros(c, dtype=torch.int32, device=values.device)
    if c and n:
        scratch = _scratch(c, n, 1, values.device)
        _build.launch(
            "tdc_pack_tokens_chunks", values.data_ptr(), lens.data_ptr(),
            words.data_ptr(), bits.data_ptr(), scratch.data_ptr(), c, n, cap,
            device=values.device,
        )
        pack_tokens_chunks.launches += 1
    return words, bits


pack_tokens_chunks.launches = 0


def pack_tokens_chunks_plain(values, lens, *, tile: int = 2048):
    """Plain torch K5: :func:`ops.bitpack.pack_tokens` per chunk."""
    c, n = values.shape
    lens = (lens.long() & 0xFFFFFFFF).clamp(max=32)
    words = torch.zeros(c, n + tile + 3 * LANES, dtype=torch.int32,
                        device=values.device)
    bits = torch.zeros(c, dtype=torch.int32, device=values.device)
    for i in range(c):
        w, bits[i] = pack_tokens(values[i], lens[i])
        words[i, : n + 1] = w
    return words, bits


def _huffman_cap(n: int, tile: int) -> int:
    return n // 2 + _wt_for(tile, 16) + LANES


MAX_CODE_LEN = 16  # K6's cap holds N codes of at most this many bits


def _check_code_lengths(sym_len: torch.Tensor) -> None:
    if bool(((sym_len < 0) | (sym_len > MAX_CODE_LEN)).any()):
        raise ValueError(f"sym_len must lie in 0..{MAX_CODE_LEN}")


def pack_bytes_huffman_chunks(data: torch.Tensor, lengths: torch.Tensor,
                              sym_code: torch.Tensor, sym_len: torch.Tensor,
                              *, tile: int = 2048):
    """K6: canonical-Huffman encode + pack of ``data u8[C, N]`` masked to
    ``lengths i32[C]``, with the table ``sym_code``/``sym_len`` (i32[256]).
    Codes are at most 16 bits: the code's low 16 bits are packed in
    ``sym_len`` bits, and a length outside 0..16 raises ``ValueError``.
    Returns ``(words i32[C, cap], bits i32[C])`` with
    ``cap = N/2 + wt + 128``."""
    c, n = data.shape
    _build.check(data, torch.uint8, (c, n), "data")
    _build.check(lengths, torch.int32, (c,), "lengths")
    _build.check(sym_code, torch.int32, (256,), "sym_code")
    _build.check(sym_len, torch.int32, (256,), "sym_len")
    _check_chunks(n, tile)
    _check_code_lengths(sym_len)
    cap = _huffman_cap(n, tile)
    if not _build.on_cuda(data, lengths, sym_code, sym_len):
        return pack_bytes_huffman_chunks_plain(data, lengths, sym_code,
                                               sym_len, tile=tile)
    _build.check_aligned(data, "data", 8)
    if not (c and n):  # no launch: nothing writes the rows
        return (torch.zeros(c, cap, dtype=torch.int32, device=data.device),
                torch.zeros(c, dtype=torch.int32, device=data.device))
    words = torch.empty(c, cap, dtype=torch.int32, device=data.device)
    bits = torch.empty(c, dtype=torch.int32, device=data.device)
    scratch = _scratch(c, n, 2, data.device)
    _build.launch(
        "tdc_pack_huffman_chunks", data.data_ptr(), lengths.data_ptr(),
        sym_code.data_ptr(), sym_len.data_ptr(), words.data_ptr(),
        bits.data_ptr(), scratch.data_ptr(), c, n, cap, device=data.device,
    )
    pack_bytes_huffman_chunks.launches += 1
    return words, bits


pack_bytes_huffman_chunks.launches = 0


def pack_bytes_huffman_chunks_plain(data, lengths, sym_code, sym_len, *,
                                    tile: int = 2048):
    """Plain torch K6: :func:`ops.huffman.huffman_pack` per chunk."""
    c, n = data.shape
    cap = _huffman_cap(n, tile)
    code = sym_code.long() & 0xFFFF
    words = torch.zeros(c, cap, dtype=torch.int32, device=data.device)
    bits = torch.zeros(c, dtype=torch.int32, device=data.device)
    keep = min(n + 1, cap)  # <= 16 bits a byte: the rest is zero
    for i in range(c):
        length = int(lengths[i].clamp(0, n))
        w, bits[i] = huffman_pack(data[i], length, code, sym_len)
        words[i, :keep] = w[:keep]
    return words, bits


def _rle_cap(n: int, tile: int) -> int:
    cap = n + _wt_for(tile, 32) + 2 * LANES
    return cap + (-cap) % LANES


def _check_offset(offset: int) -> None:
    if not 0 <= offset < RUN_CAP // 2:
        raise ValueError(f"RLE offset must lie in 0..{RUN_CAP // 2 - 1}")


def rle_pack_chunks(data: torch.Tensor, lengths: torch.Tensor, *,
                    tile: int = 2048, offset: int = 0):
    """K7: RLE (runs cut into ``RUN_CAP`` pieces, ``ops/rle.py``) of
    ``data u8[C, N]`` masked to ``lengths i32[C]``, packed. Returns
    ``(words i32[C, cap], rle_bytes i32[C])``: the byte stream as
    big-endian words and its length."""
    c, n = data.shape
    _build.check(data, torch.uint8, (c, n), "data")
    _build.check(lengths, torch.int32, (c,), "lengths")
    _check_chunks(n, tile)
    _check_offset(offset)
    cap = _rle_cap(n, tile)
    if not _build.on_cuda(data, lengths):
        return rle_pack_chunks_plain(data, lengths, tile=tile, offset=offset)
    _build.check_aligned(data, "data", 8)
    if not (c and n):  # no launch: nothing writes the rows
        return (torch.zeros(c, cap, dtype=torch.int32, device=data.device),
                torch.zeros(c, dtype=torch.int32, device=data.device))
    words = torch.empty(c, cap, dtype=torch.int32, device=data.device)
    nbytes = torch.empty(c, dtype=torch.int32, device=data.device)
    scratch = _scratch(c, n, 4, data.device)
    _build.launch(
        "tdc_rle_pack_chunks", data.data_ptr(), lengths.data_ptr(),
        words.data_ptr(), nbytes.data_ptr(), scratch.data_ptr(), c, n, cap,
        offset, device=data.device,
    )
    rle_pack_chunks.launches += 1
    return words, nbytes


rle_pack_chunks.launches = 0


def rle_pack_chunks_plain(data, lengths, *, tile: int = 2048,
                          offset: int = 0):
    """Plain torch K7: :func:`ops.rle.rle_encode` per chunk."""
    c, n = data.shape
    words = torch.zeros(c, _rle_cap(n, tile), dtype=torch.int32,
                        device=data.device)
    nbytes = torch.zeros(c, dtype=torch.int32, device=data.device)
    for i in range(c):
        w, nbytes[i] = rle_encode(data[i], lengths[i], offset)
        words[i, : n + 1] = w
    return words, nbytes


# The arithmetic K6's and K7's kernels rely on, in plain Python at the
# kernels' granularity: per-tile summaries that do not depend on what
# enters a tile, an ordered scan of them, and words written only by the
# tile that holds their last unit, into a buffer that starts as garbage.
# ``tests/test_torch_chunk_carry.py`` holds these models against the
# plain versions above.

GARBAGE = 0x5A5A5A5A  # the models' unwritten words


def append_tail(a, b, unit: int, keep: int):
    """``tdc::Append``: stream ``a`` followed by stream ``b``, each ``(n,
    t)``: its length in ``unit``-bit units and its last ``min(n, keep)``
    units in the low bits of ``t``."""
    (n1, t1), (n2, t2) = a, b
    mask = (1 << unit * keep) - 1
    return n1 + n2, t2 if n2 >= keep else ((t1 << unit * n2) | t2) & mask


def _scan_tails(tails, unit: int, keep: int):
    """Exclusive scan of tile Tails in order, and the total."""
    acc, out = (0, 0), []
    for t in tails:
        out.append(acc)
        acc = append_tail(acc, t, unit, keep)
    return out, acc


def _own_words(row: torch.Tensor, value: int, nunits: int, start: int,
               carry: int, total: int, unit: int) -> None:
    """Write the words that a tile owns into ``row`` (u32 as int32): its
    ``nunits`` units ``value`` from unit ``start`` on, after the carried
    units in its first word. A word belongs to the tile that holds its
    last unit, the stream's last word to the tile that holds the
    stream's last unit."""
    per = 32 // unit
    if nunits == 0:
        return
    k = start % per
    full = ((carry & ((1 << unit * k) - 1)) << unit * nunits) | value
    end = start + nunits
    fw = start // per
    lw = (end - 1) // per if end % per == 0 or end == total \
        else end // per - 1
    length = k + nunits
    for w in range(fw, lw + 1):
        lo = (w - fw) * per  # units of `full` before this word
        have = min(per, length - lo)
        word = (full >> unit * (length - lo - have)) & ((1 << unit * have) - 1)
        word <<= unit * (per - have)
        row[w] = word - (1 << 32) if word >= 1 << 31 else word


def pack_bytes_huffman_chunks_model(data, lengths, sym_code, sym_len, *,
                                    tile_positions: int, tile: int = 2048):
    """K6 as its kernels compute it: tile Tails of bits (``unit`` 1,
    ``keep`` 31), their scan, owned words, the zero tail."""
    c, n = data.shape
    cap = _huffman_cap(n, tile)
    words = torch.full((c, cap), GARBAGE, dtype=torch.int32)
    bits = torch.zeros(c, dtype=torch.int32)
    code = [int(x) & 0xFFFF for x in sym_code]
    ln = [int(x) for x in sym_len]
    for r in range(c):
        length = min(max(int(lengths[r]), 0), n)
        row = [int(x) for x in data[r]]
        tiles = []  # (value, bits) of each tile's codes
        for t0 in range(0, n, tile_positions):
            v = nb = 0
            for i in range(t0, min(t0 + tile_positions, length)):
                l = ln[row[i]]
                v = (v << l) | (code[row[i]] & ((1 << l) - 1))
                nb += l
            tiles.append((v, nb))
        before, (total, _) = _scan_tails(
            [(nb, v & 0x7FFFFFFF) for v, nb in tiles], 1, 31)
        for (v, nb), (s, carry) in zip(tiles, before):
            _own_words(words[r], v, nb, s, carry, total, 1)
        words[r, -(-total // 32):] = 0
        bits[r] = total
    return words, bits


def rle_head_bytes(entering: int, t0: int, first: int, ends: bool, ch: int,
                   offset: int) -> list:
    """The tokens of a tile's head in closed form: positions ``[t0,
    first)`` of the run of ``ch`` that started at ``entering < t0``: the
    pieces of ``RUN_CAP`` that end there, then the run's last piece if
    the run ends at ``first - 1`` (``ends``)."""
    out = []
    if first <= t0:
        return out
    k = (t0 - entering + RUN_CAP) // RUN_CAP
    while entering + k * RUN_CAP <= first:
        out += _piece_token(ch, k > 1, RUN_CAP, offset)
        k += 1
    if ends and (first - entering) % RUN_CAP:
        since = first - 1 - entering
        out += _piece_token(ch, since >= RUN_CAP, since % RUN_CAP + 1,
                            offset)
    return out


def _piece_token(ch: int, cont: bool, piece: int, offset: int) -> list:
    """The bytes of a piece of ``piece`` positions of a run of ``ch``."""
    if not cont and piece < 2:
        return [ch]
    v = (piece - 1 if cont else piece - 2) + offset
    vb = [(v & 0x7F) | 0x80, v >> 7] if v >= 128 else [v]
    return [ch] * (1 if cont else 2) + vb


def rle_pack_chunks_model(data, lengths, *, tile_positions: int,
                          tile: int = 2048, offset: int = 0):
    """K7 as its kernels compute it: tile summaries (last and first run
    start, whether the entering run ends in the tile, the bytes of the
    runs that start in it), the scan (entering run start, head bytes in
    closed form, Tails of bytes: ``unit`` 8, ``keep`` 3), owned words,
    the zero tail."""
    c, n = data.shape
    cap = _rle_cap(n, tile)
    words = torch.full((c, cap), GARBAGE, dtype=torch.int32)
    nbytes = torch.zeros(c, dtype=torch.int32)
    for r in range(c):
        length = min(max(int(lengths[r]), 0), n)
        b = [int(x) for x in data[r]]

        def starts(i):
            return i == 0 or i >= length or b[i] != b[i - 1]

        summaries = []
        for t0 in range(0, n, tile_positions):
            t1 = min(t0 + tile_positions, n)
            st = [i for i in range(t0, t1) if starts(i)]
            first = st[0] if st else t1
            own, sor = [], -1
            for i in range(first, min(t1, length)):
                sor = i if starts(i) else sor
                since = i - sor
                piece = since % RUN_CAP + 1
                if i + 1 >= length or b[i + 1] != b[i] or piece == RUN_CAP:
                    own += _piece_token(b[i], since >= RUN_CAP, piece,
                                        offset)
            ends = bool(st) or t1 >= length or b[t1] != b[t1 - 1]
            summaries.append((st[-1] if st else -1, first, ends, own))
        entering, tiles = -1, []
        for t0, (last, first, ends, own) in zip(range(0, n, tile_positions),
                                                summaries):
            ch = b[t0] if first > t0 else 0
            tiles.append(rle_head_bytes(entering, t0, first, ends, ch,
                                        offset) + own)
            entering = max(entering, last)
        tails = [(len(t), int.from_bytes(bytes(t[-3:]), "big"))
                 for t in tiles]
        before, (total, _) = _scan_tails(tails, 8, 3)
        for t, (o, carry) in zip(tiles, before):
            _own_words(words[r], int.from_bytes(bytes(t), "big"), len(t), o,
                       carry, total, 8)
        words[r, -(-total // 4):] = 0
        nbytes[r] = total
    return words, nbytes
