"""The tile arithmetic of K6 and K7 (``csrc/huff_chunk_pack.cu``,
``csrc/rle_chunk_pack.cu``) in plain form, against the plain versions.

The kernels cut each chunk into tiles, summarise every tile without
knowing what enters it, scan the summaries in order, and let the tile
that holds a word's last unit write that word into a buffer nobody
zeroed. ``ops/bitpack_chunks.py`` has that arithmetic as plain Python
models; here they must equal ``pack_bytes_huffman_chunks_plain`` and
``rle_pack_chunks_plain`` exactly, from a buffer of garbage, at tile
sizes small enough that runs, pieces and carries cross many tiles. No
JAX is imported.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tudocomp_tpu_torch.coders.huffman import HuffmanTable
from tudocomp_tpu_torch.ops import bitpack_chunks as bc
from tudocomp_tpu_torch.ops.rle import RUN_CAP, rle_tokens

STREAMS = st.lists(st.integers(0, 255), max_size=12)


def _tail(units, unit, keep):
    """(n, t) of a stream of units, as the kernels carry it."""
    t = 0
    for u in units[-keep:]:
        t = (t << unit) | u
    return len(units), t


@settings(max_examples=200, deadline=None)
@given(STREAMS, STREAMS, STREAMS, st.sampled_from([(1, 31), (8, 3)]))
def test_append_tail_is_the_tail_of_the_concatenation(a, b, c, form):
    """Append is associative and gives the tail of the joined stream,
    for bits (K6: keep 31) and bytes (K7: keep 3)."""
    unit, keep = form
    a, b, c = ([u & ((1 << unit) - 1) for u in s] for s in (a, b, c))
    ta, tb, tc = (_tail(s, unit, keep) for s in (a, b, c))
    ab = bc.append_tail(ta, tb, unit, keep)
    assert ab == _tail(a + b, unit, keep)
    assert bc.append_tail(ab, tc, unit, keep) == bc.append_tail(
        ta, bc.append_tail(tb, tc, unit, keep), unit, keep)


@settings(max_examples=150, deadline=None)
@given(st.integers(1, 3 * RUN_CAP), st.integers(0, 2048), st.booleans(),
       st.sampled_from([0, 3, 125, 4095]))
def test_rle_head_bytes_closed_form(into, head, ends, offset):
    """A tile starts ``into`` positions into a run that began at 0; its
    head is the run's positions ``[into, into + head)``, after which the
    run ends (``ends``) or goes on past the tile. The closed form emits
    exactly the tokens that ``rle_tokens`` gives those positions."""
    first = into + head
    run = first if ends else first + 5
    n = -(-(run + 2) // 128) * 128
    row = np.full(n, 9, np.uint8)
    row[:run] = 7
    values, lens = rle_tokens(torch.from_numpy(row), n, offset)
    want = []
    for i in range(into, first):
        nb = int(lens[i]) // 8
        if nb:
            want += list((int(values[i]) & 0xFFFFFFFF).to_bytes(4, "big"))[
                4 - nb:]
    assert bc.rle_head_bytes(0, into, first, ends, 7, offset) == want


def _rle_rows(seed: int):
    """Rows with runs across RUN_CAP pieces and many tiles, a piece end
    on a tile edge, short runs, noise and a constant row; lengths full,
    mid-run, 1 and 0."""
    n = 2 * RUN_CAP + 4096
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 4, (5, n), dtype=np.uint8)
    data[0, 100 : 100 + 2 * RUN_CAP + 5] = 9
    data[1, 2048 : 2048 + RUN_CAP] = 8
    data[2] = np.repeat(rng.integers(0, 3, n, dtype=np.uint8),
                        rng.integers(1, 50, n))[:n]
    data[3] = 7
    lengths = np.array([n, 2048 + 5000, 1, n, 0], np.int32)
    return torch.from_numpy(data), torch.from_numpy(lengths)


@pytest.mark.parametrize("offset", [0, 1, 125, 4095])
@pytest.mark.parametrize("tile_positions", [128, 2048])
def test_rle_model_equals_plain(tile_positions, offset):
    data, lengths = _rle_rows(offset)
    got = bc.rle_pack_chunks_model(data, lengths,
                                   tile_positions=tile_positions,
                                   offset=offset)
    want = bc.rle_pack_chunks_plain(data, lengths, offset=offset)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


def _k6_table(kind: str, data: torch.Tensor):
    rng = np.random.default_rng(len(kind))
    if kind == "corpus":
        t = HuffmanTable.from_counts(
            np.bincount(data.numpy().reshape(-1), minlength=256) + 1,
            max_len=16, min_len=3)
        code, length = t.sym_code, t.sym_len
    else:
        code = rng.integers(0, 1 << 20, 256)
        length = (np.full(256, 16) if kind == "16bit"
                  else rng.integers(1, 17, 256) * (np.arange(256) % 3 > 0))
    return (torch.from_numpy(code.astype(np.int32)),
            torch.from_numpy(length.astype(np.int32)))


@pytest.mark.parametrize("tile_positions", [64, 512])
@pytest.mark.parametrize("kind", ["corpus", "16bit", "absent"])
def test_huffman_model_equals_plain(kind, tile_positions):
    """Codes of 16 bits (two fill a word), absent symbols (length 0),
    tiles of fewer than 32 bits (sparse codes in the last row)."""
    n = 4096
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, (5, n), dtype=np.uint8)
    data[1] = np.repeat(rng.integers(0, 3, n, dtype=np.uint8),
                        rng.integers(1, 50, n))[:n]
    data[4] = 0
    data[4, ::97] = 1
    data = torch.from_numpy(data)
    code, length = _k6_table(kind, data)
    length[0] = 0
    lengths = torch.tensor([n, 1000, 1, 0, n], dtype=torch.int32)
    got = bc.pack_bytes_huffman_chunks_model(
        data, lengths, code, length, tile_positions=tile_positions)
    want = bc.pack_bytes_huffman_chunks_plain(data, lengths, code, length)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])
