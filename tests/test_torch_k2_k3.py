"""CPU checks of K2's select entry and K3's strided form. Neither needs
JAX or a GPU: the select entry's plain version is held against the
composition that ``huff_stage`` ran before the select moved into K2, and
the strided histogram against the histogram of the gathered rows and
``np.bincount``. Every comparison is exact. ``tests/test_torch_cuda.py``
holds the kernels to these plain versions on the same cases.
"""

import numpy as np
import pytest
import torch

from tudocomp_tpu_torch import BlockCodec, device_tables
from tudocomp_tpu_torch.coders.huffman import HuffmanTable
from tudocomp_tpu_torch.models import blockcodec
from tudocomp_tpu_torch.models.blockcodec import huff_stage, rle_stage
from tudocomp_tpu_torch.ops.hist import (
    histogram_rows, histogram_rows_plain, histogram_words_plain,
)
from tudocomp_tpu_torch.ops.segpack import (
    huffman_pack_segments_plain, huffman_select_segments,
    huffman_select_segments_plain,
)

SEG = 2048

#: counts of every batch: empty, one byte, one short of full, full, and
#: full rows whose bits the tables set apart
COUNTS = [0, 1, 2047, SEG, 1000, SEG, SEG, SEG]


def _fibonacci_table() -> HuffmanTable:
    fib = [1, 1]
    while len(fib) < 40:
        fib.append(fib[-1] + fib[-2])
    hist = np.ones(256, np.int64)
    hist[:40] = fib[::-1]
    return HuffmanTable.from_counts(hist, max_len=16, min_len=3)


def _tables(rng) -> dict:
    """name -> (sym_code, sym_len) i32[256]."""
    fib = _fibonacci_table()
    edge_len = np.full(256, 8, np.int32)
    edge_len[:2] = (7, 9)
    return {
        # 8 bits a byte: bits == 8 * count, every segment escapes
        "identity": (np.arange(256, dtype=np.int32), np.full(256, 8,
                                                            np.int32)),
        # codes of 3 to 16 bits, the long ones straddling words
        "fibonacci_16_bit": (fib.sym_code.astype(np.int32),
                             fib.sym_len.astype(np.int32)),
        # every code 3 bits: up to 11 codes share a word
        "three_bit": (np.arange(256, dtype=np.int32) & 7,
                      np.full(256, 3, np.int32)),
        # byte 0 takes 7 bits, byte 1 takes 9, the rest 8 (codes with
        # garbage above their length, which the pack masks off)
        "seven_eight_nine": (rng.integers(0, 1 << 31, 256).astype(np.int32),
                             edge_len),
    }


def select_case(name: str, seed: int = 0):
    """K2's inputs for table ``name``: big-endian stream words i32[8,
    512] with garbage past ``COUNTS``, the counts, and the table. Rows
    5-7 of ``seven_eight_nine`` hold 8 * count - 1 bits (one 0 byte), 8
    * count + 1 (one 1 byte) and 8 * count exactly; the ``fibonacci``
    rows draw bytes so that some segments overflow the 512 kept words."""
    rng = np.random.default_rng(seed)
    code, length = _tables(rng)[name]
    rows = rng.integers(0, 256, (len(COUNTS), SEG), dtype=np.uint8)
    if name == "seven_eight_nine":
        rows[5:] = rng.integers(2, 256, (3, SEG), dtype=np.uint8)
        rows[5, 77] = 0
        rows[6, 1500] = 1
    elif name == "fibonacci_16_bit":
        rows[4:6] = rng.integers(0, 12, (2, SEG), dtype=np.uint8)
    words = rows.view(">u4").astype(np.uint32).view(np.int32)
    return words, np.array(COUNTS, np.int32), code, length


def _former_huff_stage(words, counts, sym_code, sym_len):
    """What ``huff_stage`` ran before K2 took the select in."""
    packed, bits = huffman_pack_segments_plain(words, counts, sym_code,
                                               sym_len)
    huff_raw = bits >= counts * 8
    out = torch.where(huff_raw[:, None], words, packed)
    return out, torch.where(huff_raw, counts * 8, bits), huff_raw


NAMES = ["identity", "fibonacci_16_bit", "three_bit", "seven_eight_nine"]


@pytest.mark.parametrize("name", NAMES)
def test_select_plain_matches_former_huff_stage(name):
    args = [torch.from_numpy(a) for a in select_case(name)]
    want = _former_huff_stage(*args)
    for got in (huffman_select_segments_plain(*args), huff_stage(*args)):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    raw = want[2].tolist()
    assert raw[0]  # count 0: 0 bits >= 0
    if name == "identity":
        assert all(raw)
    elif name == "three_bit":
        assert not any(raw[1:])
    elif name == "seven_eight_nine":
        bits = huffman_pack_segments_plain(*args)[1][5:].tolist()
        assert bits == [8 * SEG - 1, 8 * SEG + 1, 8 * SEG]
        assert raw[5:] == [False, True, True]
    else:
        assert not all(raw[1:]) and any(raw[1:])
        assert int(huffman_pack_segments_plain(*args)[1].max()) > 32 * 512


def test_select_wrapper_takes_plain_on_cpu():
    args = [torch.from_numpy(a) for a in select_case("fibonacci_16_bit", 3)]
    before = huffman_select_segments.launches
    got = huffman_select_segments(*args)
    for g, w in zip(got, huffman_select_segments_plain(*args)):
        assert torch.equal(g, w)
    assert huffman_select_segments.launches == before
    words, counts, code, length = args
    bad = [
        (words[:, :256].contiguous(), counts, code, length),
        (words.long(), counts, code, length),
        (words, counts[:-1], code, length),
        (words, counts, code[:255], length),
        (words, counts, code, length.to(torch.int16)),
        (words.t().contiguous().t(), counts, code, length),
    ]
    for case in bad:
        with pytest.raises(ValueError):
            huffman_select_segments(*case)


def _stream_words(seed: int, nc: int):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 256, (nc, SEG), dtype=np.uint8)
    rows[1::3] = rng.integers(0, 5, (len(range(1, nc, 3)), SEG))
    lens = rng.integers(0, SEG + 1, nc).astype(np.int32)
    lens[::4] = SEG
    words = rows.view(">u4").astype(np.uint32).view(np.int32)
    return rows, words, lens


#: the sampled slices of batches (lo, hi): from the start, and two that
#: start off the 1-in-8 grid and straddle HIST_SEGS (one sampled row,
#: and eleven)
BATCHES = [(0, 70), (8181, 8230), (8100, 8200)]


@pytest.mark.parametrize("lo,hi", BATCHES)
def test_strided_histogram_matches_gathered_rows(lo, hi):
    rows_np, words_np, lens_np = _stream_words(lo, hi - lo)
    rows = BlockCodec.hist_rows(lo, hi, True)
    assert rows.step == 8 and (lo + rows.start) % 8 == 0
    assert lo + rows.stop <= blockcodec.HIST_SEGS
    words, lens = torch.from_numpy(words_np), torch.from_numpy(lens_np)
    got = histogram_rows_plain(words, lens, rows)
    gathered = histogram_words_plain(words[rows].contiguous(),
                                     lens[rows].contiguous())
    assert got.dtype == torch.int64 and torch.equal(got, gathered.long())
    want = sum(np.bincount(r[:n], minlength=256)
               for r, n in zip(rows_np[rows], lens_np[rows]))
    assert got.tolist() == np.asarray(want).tolist()


def test_strided_histogram_wrapper_adds_into_out():
    _, words_np, lens_np = _stream_words(9, 40)
    words, lens = torch.from_numpy(words_np), torch.from_numpy(lens_np)
    out = torch.zeros(256, dtype=torch.int64)
    before = histogram_rows.launches
    assert histogram_rows(words, lens, slice(3, 40, 8), out) is out
    histogram_rows(words, lens, slice(0, 40, 5), out)
    histogram_rows(words, lens, slice(40, 40, 8), out)  # no rows
    assert histogram_rows.launches == before
    want = (histogram_rows_plain(words, lens, slice(3, 40, 8))
            + histogram_rows_plain(words, lens, slice(0, 40, 5)))
    assert torch.equal(out, want)
    for bad_out in (out.int(), out[:255]):
        with pytest.raises(ValueError):
            histogram_rows(words, lens, slice(0, 40, 8), bad_out)
    with pytest.raises(ValueError):
        histogram_rows(words, lens, slice(39, 0, -8), out)


def test_rle_stage_adds_the_sample_into_hist():
    rows_np, _, lens_np = _stream_words(4, 24)
    for c, n in enumerate(lens_np):
        rows_np[c, n:] = 0
    rows, lens = torch.from_numpy(rows_np), torch.from_numpy(lens_np)
    hist = torch.full((256,), 5, dtype=torch.int64)
    sel, counts, _, got = rle_stage(rows, lens, offset=0,
                                    hist_rows=slice(2, 24, 8), hist=hist)
    assert got is hist
    assert torch.equal(hist - 5, histogram_rows_plain(sel, counts,
                                                      slice(2, 24, 8)))
    new = rle_stage(rows, lens, offset=0, hist_rows=slice(0, 24))[3]
    assert torch.equal(new, histogram_rows_plain(sel, counts, slice(0, 24)))
    assert rle_stage(rows, lens, offset=0, hist_rows=None)[3] is None


def test_huff_stage_on_codec_tables():
    """The select entry on the tables ``device_tables`` builds: none (the
    identity code) and a sampled one."""
    _, words_np, lens_np = _stream_words(6, 12)
    words, lens = torch.from_numpy(words_np), torch.from_numpy(lens_np)
    hist = histogram_rows_plain(words, lens, slice(0, 12)).numpy() + 1
    for table in (None, HuffmanTable.from_counts(hist, max_len=16,
                                                 min_len=3)):
        t = device_tables(table, "cpu")
        args = (words, lens, t["sym_code"], t["sym_len"])
        for g, w in zip(huff_stage(*args), _former_huff_stage(*args)):
            assert torch.equal(g, w)
