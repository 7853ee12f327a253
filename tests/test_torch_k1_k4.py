"""CPU checks of what K1's select entry and K4's one-lookup decode table
rest on. Neither needs JAX or a GPU: the table is held against the
threshold compare that the plain decoder (and K4's long-code path) runs,
and the select entry's plain version against the composition that
``rle_stage`` ran before the select moved into K1. Every comparison is
exact.
"""

import numpy as np
import pytest
import torch

from tudocomp_tpu_torch.coders.huffman import HuffmanTable
from tudocomp_tpu_torch.ops.hufdec import (
    FAST_BITS, decoder_tables, fast_decode_table,
)
from tudocomp_tpu_torch.ops.rle import be_words_from_bytes
from tudocomp_tpu_torch.ops.segpack import (
    rle_pack_segments_plain, rle_select_segments, rle_select_segments_plain,
)

SEG = 2048


def _fibonacci_table() -> HuffmanTable:
    fib = [1, 1]
    while len(fib) < 40:
        fib.append(fib[-1] + fib[-2])
    hist = np.ones(256, np.int64)
    hist[:40] = fib[::-1]
    return HuffmanTable.from_counts(hist, max_len=16, min_len=3)


def _zipf_table(min_len: int) -> HuffmanTable:
    counts = np.random.default_rng(min_len).zipf(1.3, 256).clip(max=1 << 20)
    return HuffmanTable.from_counts(counts + 1, max_len=16, min_len=min_len)


TABLES = {
    "none": lambda: None,
    "min_code_len_3": lambda: _zipf_table(3),
    "min_code_len_4": lambda: _zipf_table(4),
    "fibonacci_16_bit": _fibonacci_table,
}


def _threshold_decode(t: dict):
    """(symbol, length) of every 16-bit window under the thresholds."""
    win = np.arange(1 << 16, dtype=np.int64)
    thresh = t["thresh"].astype(np.int64)
    ln = np.minimum(1 + (win[:, None] < thresh[None, :]).sum(axis=1), 16)
    idx = np.clip((win >> (16 - ln)) + t["offs"].astype(np.int64)[ln - 1],
                  0, 255)
    return t["symbols"].astype(np.int64)[idx], ln


@pytest.mark.parametrize("name", list(TABLES))
def test_fast_table_matches_threshold_compare(name):
    table = TABLES[name]()
    t = decoder_tables(table)
    fast = t["fast"].astype(np.int64)
    assert fast.shape == (1 << FAST_BITS,) and t["fast"].dtype == np.int16
    sym, ln = _threshold_decode(t)
    tail = 16 - FAST_BITS
    sym, ln = sym.reshape(-1, 1 << tail), ln.reshape(-1, 1 << tail)
    short = (ln == ln[:, :1]).all(axis=1) & (ln[:, 0] <= FAST_BITS)
    assert (fast[short] == sym[short, 0] | (ln[short, 0] << 8)).all()
    assert (fast[~short] == 0).all()  # the kernel takes the thresholds
    if table is None:
        return
    # every prefix of a code of at most FAST_BITS bits resolves in one
    # lookup; the prefixes of longer codes are marked
    for s in range(256):
        n, code = int(table.sym_len[s]), int(table.sym_code[s])
        if n <= FAST_BITS:
            lo = code << (FAST_BITS - n)
            entries = fast[lo : lo + (1 << (FAST_BITS - n))]
            assert (entries == s | (n << 8)).all(), s
        else:
            assert fast[code >> (n - FAST_BITS)] == 0, s
    assert table.sym_len.max() > FAST_BITS or name == "min_code_len_4"


def test_fibonacci_table_reaches_16_bits():
    assert int(_fibonacci_table().sym_len.max()) == 16


def test_fast_table_on_torch_tensors():
    t = decoder_tables(_fibonacci_table())
    got = fast_decode_table(*(torch.from_numpy(t[k])
                              for k in ("thresh", "offs", "symbols")))
    assert got.dtype == torch.int16
    assert np.array_equal(got.numpy(), t["fast"])


def _rows(seed: int):
    """Segments whose streams fall just under and just over their
    length (both escape branches), text, runs with 2-byte vbytes, a
    constant row, lengths 0, 1, 2047 and 2048, garbage past each."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 256, (10, SEG), dtype=np.uint8)
    rows[1] = np.frombuffer(b"the <b>quick</b> brown fox; " * 80,
                            np.uint8)[:SEG]
    rows[2] = np.repeat(rng.integers(0, 256, SEG // 2, dtype=np.uint8), 2)
    rows[3] = np.repeat(rng.integers(0, 3, SEG, dtype=np.uint8),
                        rng.integers(100, 300, SEG))[:SEG]
    rows[4] = 7
    # row 5: 20 runs of 2 (3 stream bytes each), then literals: the
    # stream is len + 20 bytes; row 6: 19 runs of 3 and one of 4 (3
    # bytes each) before the same literals: len - 1 bytes
    rows[5, 40:] = np.arange(SEG - 40) % 200 + 50
    rows[6] = rows[5]
    rows[5, :40] = np.repeat(np.arange(20, dtype=np.uint8) * 2 + 1, 2)
    rows[6, :57] = np.repeat(np.arange(19, dtype=np.uint8) * 2 + 1, 3)
    rows[6, 57:61] = 250
    lens = np.array([SEG, SEG, SEG, SEG, SEG, 1000, 1000, 0, 1, 2047],
                    np.int32)
    return rows, lens


@pytest.mark.parametrize("offset", [0, 125])
def test_select_plain_matches_rle_stage_composition(offset):
    rows, lens = _rows(offset)
    clean = rows.copy()
    for c, n in enumerate(lens):
        clean[c, n:] = 0  # as split_segments pads
    r, ln = torch.from_numpy(rows), torch.from_numpy(lens)
    # the composition rle_stage ran before K1 took the select in
    words, rle_lens = rle_pack_segments_plain(r, ln, offset=offset)
    rle_raw = rle_lens > ln
    sel = torch.where(rle_raw[:, None],
                      be_words_from_bytes(torch.from_numpy(clean)), words)
    want = (sel, torch.where(rle_raw, ln, rle_lens), rle_raw)
    for rows_in in (clean, rows):  # padded as the codec pads, and garbage
        got = rle_select_segments_plain(torch.from_numpy(rows_in), ln,
                                        offset=offset)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    # both branches ran, the escape just over its length included
    assert rle_raw[[2, 5]].all() and not rle_raw[[1, 3, 4, 6]].any()
    assert int(rle_lens[5]) == 1020 and int(rle_lens[6]) == 999


def test_select_wrapper_takes_plain_on_cpu():
    rows, lens = _rows(3)
    r, ln = torch.from_numpy(rows), torch.from_numpy(lens)
    before = rle_select_segments.launches
    got = rle_select_segments(r, ln, offset=5)
    for g, w in zip(got, rle_select_segments_plain(r, ln, offset=5)):
        assert torch.equal(g, w)
    assert rle_select_segments.launches == before
    with pytest.raises(ValueError):
        rle_select_segments(r, ln, offset=126)
    with pytest.raises(ValueError):
        rle_select_segments(r[:, :1024], ln)


def _complete_table() -> HuffmanTable:
    """A table whose codes fill the code space (Kraft sum 1), so that
    every bit string decodes, zeros past a cut payload included."""
    counts = np.random.default_rng(8).zipf(1.3, 256).clip(max=1 << 20) + 1
    table = HuffmanTable.from_counts(counts, max_len=16)
    assert sum(1 << (16 - int(n)) for n in table.sym_len) == 1 << 16
    return table


def _prefix_decode(payload: np.ndarray, count: int, table) -> np.ndarray:
    """``count`` symbols of an MSB-first payload, bit by bit through the
    code words, with zero bits past its end."""
    words = {(int(n), int(c)): s for s, (c, n) in
             enumerate(zip(table.sym_code, table.sym_len)) if n}
    bits = np.unpackbits(payload)
    out, pos = [], 0
    for _ in range(count):
        code = 0
        for n in range(1, 17):
            code = code << 1 | (int(bits[pos]) if pos < bits.size else 0)
            pos += 1
            if (n, code) in words:
                out.append(words[n, code])
                break
    return np.array(out, np.uint8)


def test_plain_decode_places_short_and_cut_segments():
    """Segments that decode short and payloads cut below what their
    counts read, with whole segments after them: the plain decode puts
    every segment at ``c * SEG`` with zeros past a short decode (as K4
    does), and the reads past a cut payload, which reach beyond the
    widest payload, give zero bits."""
    from tudocomp_tpu_torch.io.bitio import pack_tokens
    from tudocomp_tpu_torch.ops.hufdec import decode_segments_plain

    table = _complete_table()
    rng = np.random.default_rng(12)
    common = np.argsort(-table.sym_len.astype(np.int64))[:16]

    def coded(syms):
        return pack_tokens(table.sym_code[syms].astype(np.uint32),
                           table.sym_len[syms])[0].view(np.uint8)

    raw0 = rng.integers(0, 256, 600, dtype=np.uint8)
    coded1 = rng.choice(common, SEG).astype(np.uint8)
    lits = (np.arange(300) % 200 + 20).astype(np.uint8)
    # a run of 100 fives (vbyte 98), literals, a run of 50 sevens
    rle2 = np.concatenate([[5, 5, 98], lits, [7, 7, 48]]).astype(np.uint8)
    raw3 = rng.integers(0, 256, SEG, dtype=np.uint8)
    coded4 = rng.integers(0, 256, 1000, dtype=np.uint8)
    payload1 = coded(coded1)
    # (payload, payload bytes kept, count, flags, expected segment)
    frames = [
        (raw0, 600, 600, 3, raw0),                          # short
        (payload1, 100, SEG, 2,                             # cut payload
         _prefix_decode(payload1[:100], SEG, table)),
        (rle2, rle2.size, 203, 1,                           # short RLE
         np.concatenate([np.full(100, 5, np.uint8), lits[:200]])),
        (raw3, SEG, SEG, 3, raw3),
        (coded(coded4), None, 1000, 2, coded4),             # last, 1000 B
    ]
    flat, poff, pbytes = bytearray(b"\x09\x09"), [], []
    for payload, kept, *_ in frames:
        poff.append(len(flat))
        pbytes.append(payload.size if kept is None else kept)
        flat += payload.tobytes() + b"\xff" * 3
    # segment 1 reads past the widest payload
    read = int(table.sym_len[frames[1][4]].astype(np.int64).sum())
    assert read > 8 * (max(pbytes) + 3)
    t = decoder_tables(table)
    orig_len = 4 * SEG + 1000
    out = decode_segments_plain(
        torch.from_numpy(np.frombuffer(bytes(flat), np.uint8).copy()),
        torch.tensor(poff), torch.tensor(pbytes),
        torch.tensor([f[2] for f in frames], dtype=torch.int32),
        torch.tensor([f[3] for f in frames], dtype=torch.uint8),
        *(torch.from_numpy(t[k]) for k in ("thresh", "offs", "symbols")),
        offset=0, orig_len=orig_len,
    ).numpy()
    assert out.shape == (orig_len,)
    for c, (*_, want) in enumerate(frames):
        seg = out[c * SEG : min((c + 1) * SEG, orig_len)]
        expect = np.zeros(seg.size, np.uint8)
        expect[: want.size] = want
        assert np.array_equal(seg, expect), c
