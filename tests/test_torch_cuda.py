"""The port's CUDA kernels against their plain torch versions, on the card.

Every case here needs an NVIDIA GPU and skips without one. The file
imports nothing of JAX or the JAX package, but the repo's
``tests/conftest.py`` imports JAX, so run it on the card with
``python -m pytest --noconftest -q tests/test_torch_cuda.py``. All
comparisons are exact (integer data).
"""

import numpy as np
import pytest
import torch

from tudocomp_tpu_torch import BlockCodec, device_tables
from tudocomp_tpu_torch.coders.huffman import HuffmanTable
from tudocomp_tpu_torch.ops import CODEC_KERNELS, launch_counts, reset_launches
from tudocomp_tpu_torch.models.blockcodec import BATCH_LANES
from tudocomp_tpu_torch.ops.bitpack_chunks import (
    pack_bytes_huffman_chunks, pack_bytes_huffman_chunks_plain,
    pack_tokens_chunks, pack_tokens_chunks_plain, rle_pack_chunks,
    rle_pack_chunks_plain,
)
from tudocomp_tpu_torch.ops.frames import (
    frame_layout, pack_batches, pack_frames, pack_frames_plain,
)
from tudocomp_tpu_torch.ops.hist import (
    histogram_rows, histogram_rows_plain, histogram_words,
    histogram_words_plain,
)
from tudocomp_tpu_torch.io.bitio import pack_tokens
from tudocomp_tpu_torch.ops.hufdec import (
    decode_segments, decode_segments_plain,
)
from tudocomp_tpu_torch.ops.rle import bytes_from_words
from tudocomp_tpu_torch.ops.segpack import (
    huffman_pack_segments, huffman_pack_segments_plain,
    huffman_select_segments, huffman_select_segments_plain,
    rle_pack_segments, rle_pack_segments_plain, rle_select_segments,
    rle_select_segments_plain,
)
from tudocomp_tpu_torch.probes import ablate, floor, place
from test_torch_container_hardening import flipped, hardening_container
from test_torch_k2_k3 import BATCHES, NAMES, select_case
from tbc2_cases import FRAME_CASES, host_columns, stage_results

pytestmark = pytest.mark.cuda

SEG = 2048


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rows(seed: int, nc: int = 48):
    """Segments of every kind the RLE sees: random bytes, runs of
    1..39, runs of 2, one maximal run, with garbage past short lengths
    and a 1-byte segment."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 256, (nc, SEG), dtype=np.uint8)
    for c in range(nc):
        kind = c % 4
        if kind == 1:
            run = rng.integers(1, 40, SEG)
            rows[c] = np.repeat(rng.integers(0, 4, SEG, dtype=np.uint8),
                                run)[:SEG]
        elif kind == 2:
            rows[c] = np.repeat(rng.integers(0, 256, SEG // 2,
                                             dtype=np.uint8), 2)
        elif kind == 3:
            rows[c] = c % 7
    lens = np.full(nc, SEG, np.int32)
    lens[::5] = rng.integers(0, SEG, lens[::5].size)
    lens[1] = 1
    return rows, lens


def _to(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


@pytest.mark.parametrize("offset", [0, 1, 125])
def test_rle_pack_matches_plain(cuda, offset):
    rows, lens = _to(cuda, *_rows(offset))
    got = rle_pack_segments(rows, lens, offset=offset)
    want = rle_pack_segments_plain(rows, lens, offset=offset)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("identity", [False, True])
def test_huffman_pack_matches_plain(cuda, identity):
    rows, lens = _rows(7)
    words, rle_lens = rle_pack_segments_plain(*_to("cpu", rows, lens))
    counts = torch.minimum(rle_lens, torch.tensor(SEG, dtype=torch.int32))
    hist = np.bincount(rows.reshape(-1), minlength=256) + 1
    table = None if identity else HuffmanTable.from_counts(
        hist, max_len=16, min_len=3)
    t = device_tables(table, cuda)
    words, counts = words.to(cuda), counts.to(cuda)
    got = huffman_pack_segments(words, counts, t["sym_code"], t["sym_len"])
    want = huffman_pack_segments_plain(words, counts, t["sym_code"],
                                       t["sym_len"])
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_histogram_matches_plain(cuda):
    rows, lens = _rows(3)
    words, lens_t = _to(cuda, rows.view(">u4").astype(np.uint32).view(
        np.int32), lens)
    assert torch.equal(histogram_words(words, lens_t),
                       histogram_words_plain(words, lens_t))
    assert torch.equal(histogram_words(words[:0], lens_t[:0]),
                       torch.zeros(256, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("offset", [0, 125])
def test_decode_matches_plain(cuda, offset):
    rows, lens = _rows(11 + offset, nc=40)
    data = b"".join(r[:n].tobytes() for r, n in zip(rows, lens))
    codec = BlockCodec(device="cpu", offset=offset)
    container = codec.compress(data)
    table, off, orig_len, counts, flags, poff, pbytes = codec.parse(container)
    t = device_tables(table, cuda)
    args = _to(cuda, np.frombuffer(container, np.uint8).copy(),
               poff.astype(np.int64), pbytes.astype(np.int64),
               counts.astype(np.int32), flags.astype(np.uint8))
    args += [t["thresh"], t["offs"], t["symbols"]]
    got = decode_segments(*args, offset=off, orig_len=orig_len)
    want = decode_segments_plain(*args, offset=off, orig_len=orig_len)
    assert torch.equal(got, want)
    assert got.cpu().numpy().tobytes() == data


def test_codec_cuda_matches_cpu(cuda):
    rng = np.random.default_rng(5)
    data = (b"<page>text " * 9000 + bytes(rng.integers(0, 256, 30000,
                                                        dtype=np.uint8))
            + b"z" * 5000)[:-7]
    reset_launches()
    gpu = BlockCodec(device=cuda, batch_lanes=16)
    container = gpu.compress(data)
    assert container == BlockCodec(device="cpu").compress(data)
    assert gpu.decompress_device(container) == data
    assert gpu.decompress(container) == data
    assert all(launch_counts()[k] > 0 for k in CODEC_KERNELS), launch_counts()


def test_codec_cuda_empty_and_tiny(cuda):
    gpu = BlockCodec(device=cuda)
    for data in (b"", b"q", b"ab" * 3):
        container = gpu.compress(data)
        assert container == BlockCodec(device="cpu").compress(data)
        assert gpu.decompress_device(container) == data


@pytest.mark.parametrize("batch_lanes", [BATCH_LANES, 5, 8])
@pytest.mark.parametrize("name", list(FRAME_CASES))
def test_frames_on_card_match_the_host_twin(cuda, name, batch_lanes):
    """K8 builds the frames of ``BlockCodec.compress`` on the card: the
    container equals the CPU codec's, its frames the plain version's of
    the same stage results, with one launch a batch; and K8 alone, at
    offsets that start at every residue mod 16 in a dirty buffer, writes
    the plain version's bytes and no others."""
    data, opts = FRAME_CASES[name]
    _dirty(cuda)
    gpu = BlockCodec(device=cuda, batch_lanes=batch_lanes, **opts)
    reset_launches()
    container = gpu.compress(data)
    nseg = -(-len(data) // SEG)
    assert launch_counts()["frame_pack"] == -(-nseg // batch_lanes)
    assert container == BlockCodec(device="cpu", **opts).compress(data)
    _, table, batches = stage_results(gpu, data)
    host = host_columns(batches)
    counts, rle_raw, huff_raw, bits = _to("cpu", *host[:3], host[4])
    plain = frame_layout(counts, rle_raw, huff_raw, bits)
    body = pack_batches([b[3].cpu() for b in batches], *plain[:3],
                        int(plain[3][0]))
    assert container == gpu.prefix(len(data), table) + body.numpy().tobytes()

    counts, rle_raw, huff_raw, bits = _to(cuda, *host[:3], host[4])
    meta1, pbytes, offs, head = frame_layout(counts, rle_raw, huff_raw,
                                             bits)
    (words,) = _to(cuda, host[3].view(np.int32))
    total = int(head[0])
    for shift in range(16):
        out = torch.full((total + 48,), 0xAB, dtype=torch.uint8,
                         device=cuda)
        pack_frames(words, meta1, pbytes, offs + shift, out)
        want = pack_frames_plain(words.cpu(), meta1.cpu(), pbytes.cpu(),
                                 offs.cpu() + shift,
                                 torch.full((total + 48,), 0xAB,
                                            dtype=torch.uint8))
        assert torch.equal(out.cpu(), want), shift


def _chunks(seed: int, c: int = 4, n: int = 16384):
    """Chunk rows: runs past RUN_CAP that cross kernel tiles, short runs,
    random bytes and a constant row; lengths full, short (garbage past
    them), 0 and 1."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (c, n), dtype=np.uint8)
    data[0, 1000:1000 + 9000] = 7             # a run past 8192
    data[0, 12000:] = 8
    data[1] = np.repeat(rng.integers(0, 3, n, dtype=np.uint8),
                        rng.integers(1, 50, n))[:n]
    data[3] = 5
    lengths = np.array([n, n - 3001, 0, 1], np.int32)[:c]
    return data, lengths


def _equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("offset", [0, 1, 125, 4095])
def test_rle_pack_chunks_matches_plain(cuda, offset):
    data, lengths = _to(cuda, *_chunks(offset))
    _equal(rle_pack_chunks(data, lengths, offset=offset),
           rle_pack_chunks_plain(data, lengths, offset=offset))


@pytest.mark.parametrize("tile", [128, 2048])
def test_pack_tokens_chunks_matches_plain(cuda, tile):
    rng = np.random.default_rng(tile)
    c, n = 3, 3 * tile
    values = rng.integers(0, 2**32, (c, n), dtype=np.uint64).astype(np.uint32)
    lens = rng.integers(0, 33, (c, n)).astype(np.int32)
    lens[0, : n // 2] = 0
    lens[1] = 32
    lens[2, :5] = (40, -1, 33, 0, 31)  # clamped to 32 by both
    v, ln = _to(cuda, values.view(np.int32), lens)
    _equal(pack_tokens_chunks(v, ln, tile=tile),
           pack_tokens_chunks_plain(v, ln, tile=tile))


@pytest.mark.parametrize("identity", [False, True])
def test_pack_bytes_huffman_chunks_matches_plain(cuda, identity):
    data, lengths = _chunks(9)
    hist = np.bincount(data.reshape(-1), minlength=256) + 1
    table = None if identity else HuffmanTable.from_counts(
        hist, max_len=16, min_len=3)
    t = device_tables(table, cuda)
    d, ln = _to(cuda, data, lengths)
    _equal(pack_bytes_huffman_chunks(d, ln, t["sym_code"], t["sym_len"]),
           pack_bytes_huffman_chunks_plain(d, ln, t["sym_code"],
                                           t["sym_len"]))


def test_pack_bytes_huffman_chunks_rejects_17_bit_codes(cuda):
    data, lengths = _to(cuda, *_chunks(9))
    t = device_tables(None, cuda)
    sym_len = t["sym_len"].clone()
    sym_len[3] = 17
    before = pack_bytes_huffman_chunks.launches
    with pytest.raises(ValueError, match="sym_len"):
        pack_bytes_huffman_chunks(data, lengths, t["sym_code"], sym_len)
    assert pack_bytes_huffman_chunks.launches == before


def test_pack_tokens_chunks_equals_rle_pack_chunks(cuda):
    from tudocomp_tpu_torch.ops.rle import rle_tokens

    data, lengths = _to(cuda, *_chunks(4))
    words, nbytes = rle_pack_chunks(data, lengths, offset=3)
    tw, bits = pack_tokens_chunks(*rle_tokens(data, lengths, 3))
    assert torch.equal(bits, 8 * nbytes)
    width = min(words.shape[1], tw.shape[1])
    assert torch.equal(words[:, :width], tw[:, :width])


def _dirty(dev, nbytes: int = 64 << 20) -> None:
    """Leave garbage in the caching allocator's free blocks, so that a
    kernel's ``torch.empty`` output starts out non-zero."""
    junk = torch.full((nbytes // 4,), 0x5A5A5A5A, dtype=torch.int32,
                      device=dev)
    del junk


def _zero_past_stream(words, bits):
    """Every word past ``ceil(bits / 32)`` of each row is zero."""
    past = torch.arange(words.shape[1], device=words.device)[None, :] \
        >= ((bits.long() + 31) // 32)[:, None]
    assert not bool((words[past] != 0).any())


#: K7's run boundaries (start, length of a run of 9s in random 0..3 data;
#: tiles are 2048 positions, pieces 8192): a piece end on a tile edge, a
#: run of RUN_CAP + 1, of 2 * RUN_CAP across eight tiles, of RUN_CAP +
#: 2048, one ending on a tile edge, and one of 3 * RUN_CAP from 1
RLE_RUNS = [(8192, 2048), (2047, 8193), (4096, 16384), (100, 8192 + 2048),
            (2048 * 3, 2048), (1, 3 * 8192)]


@pytest.mark.parametrize("offset", [0, 125, 4095])
@pytest.mark.parametrize("run", range(len(RLE_RUNS)))
def test_rle_pack_chunks_run_boundaries(cuda, run, offset):
    """Runs across tiles and pieces, lengths that cut a run mid-tile and
    at a tile edge, an output buffer that was not zeroed."""
    n = 4 * 8192 + 2048
    rng = np.random.default_rng(100 + run)
    data = rng.integers(0, 4, (5, n), dtype=np.uint8)
    start, length = RLE_RUNS[run]
    data[:, start : start + length] = 9
    data[4, :] = 9  # one run over the whole row: four full pieces
    lengths = np.array([n, start + length // 2, start + 4097, 6144, n],
                       np.int32)
    d, ln = _to(cuda, data, lengths)
    _dirty(cuda)
    got = rle_pack_chunks(d, ln, offset=offset)
    _equal(got, rle_pack_chunks_plain(d, ln, offset=offset))
    _zero_past_stream(got[0], 8 * got[1])


def _k6_table(kind: str, data):
    """K6 tables: the data's canonical code, every code 16 bits (a pair
    fills a word), or random codes with a third of the symbols absent
    (length 0) and the others 1..16 bits."""
    rng = np.random.default_rng(len(kind))
    if kind == "corpus":
        t = HuffmanTable.from_counts(
            np.bincount(data.reshape(-1), minlength=256) + 1, max_len=16,
            min_len=3)
        return t.sym_code.astype(np.int32), t.sym_len.astype(np.int32)
    code = rng.integers(0, 1 << 20, 256).astype(np.int32)
    if kind == "16bit":
        return code, np.full(256, 16, np.int32)
    length = rng.integers(1, 17, 256).astype(np.int32)
    length[::3] = 0
    return code, length


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("kind", ["corpus", "16bit", "absent"])
def test_pack_bytes_huffman_chunks_tables_and_lengths(cuda, kind, aligned):
    """K6's tiles are 2048 positions, a warp each, eight a block:
    lengths 0, 1, inside a tile, on a tile and a block edge, one past
    it, and the whole row, with sparse codes (tiles of fewer than 32
    bits) in the last rows, on an output buffer that was not zeroed."""
    n = 3 * 16384 + 2048
    rng = np.random.default_rng(21)
    data = rng.integers(0, 256, (8, n), dtype=np.uint8)
    data[1] = np.repeat(rng.integers(0, 3, n, dtype=np.uint8),
                        rng.integers(1, 50, n))[:n]
    code, length = _k6_table(kind, data)
    data[6:] = 0
    data[6:, ::997] = 1 + np.arange(2)[:, None]  # a code every 997
    length[0] = 0
    lengths = np.array([n, 0, 1, 2048 + 513, 2048 * 3, 16384, 16384 + 1,
                        n - 640 - 8], np.int32)
    d, ln, c, l = _to(cuda, data, lengths, code, length)
    if not aligned:
        d = _unaligned(d, 8)
    _dirty(cuda)
    got = pack_bytes_huffman_chunks(d, ln, c, l)
    _equal(got, pack_bytes_huffman_chunks_plain(d, ln, c, l))
    _zero_past_stream(*got)


@pytest.mark.parametrize("shape", [(0, 16384), (3, 0)])
def test_chunk_packers_without_a_launch_return_zeros(cuda, shape):
    """c == 0 or n == 0 launches nothing, so the outputs must be zeros
    that no kernel wrote."""
    data = torch.zeros(shape, dtype=torch.uint8, device=cuda)
    lengths = torch.full(shape[:1], shape[1], dtype=torch.int32,
                         device=cuda)
    t = device_tables(None, cuda)
    before = (rle_pack_chunks.launches, pack_bytes_huffman_chunks.launches)
    _dirty(cuda)
    for got, want in (
        (rle_pack_chunks(data, lengths),
         rle_pack_chunks_plain(data.cpu(), lengths.cpu())),
        (pack_bytes_huffman_chunks(data, lengths, t["sym_code"],
                                   t["sym_len"]),
         pack_bytes_huffman_chunks_plain(data.cpu(), lengths.cpu(),
                                         t["sym_code"].cpu(),
                                         t["sym_len"].cpu())),
    ):
        _equal([g.cpu() for g in got], want)
        assert not bool(got[0].any()) and not bool(got[1].any())
    assert (rle_pack_chunks.launches,
            pack_bytes_huffman_chunks.launches) == before


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _stage_case(dev, nc: int):
    """K2's inputs in both forms: the rows of ``_rows`` (garbage past
    short counts, a 1-byte segment) and their big-endian words, with a
    table of the rows' histogram."""
    rows, lens = _rows(13, nc)
    hist = np.bincount(rows.reshape(-1), minlength=256) + 1
    t = device_tables(HuffmanTable.from_counts(hist, max_len=16, min_len=3),
                      dev)
    words = rows.view(">u4").astype(np.uint32).view(np.int32)
    return (*_to(dev, rows, words, lens), t["sym_code"], t["sym_len"])


@pytest.mark.parametrize("nc", [48, 7])
@pytest.mark.parametrize("bytes_input", [False, True])
@pytest.mark.parametrize("stage", range(len(ablate.STAGES)))
def test_huff_stage_matches_plain(cuda, stage, bytes_input, nc):
    rows, words, lens, code, length = _stage_case(cuda, nc)
    data = rows if bytes_input else words
    kw = dict(stage=stage, bytes_input=bytes_input)
    _equal(_as_tuple(ablate.huffman_pack_stage(data, lens, code, length,
                                               **kw)),
           _as_tuple(ablate.huffman_pack_stage_plain(data, lens, code,
                                                     length, **kw)))


def test_huff_pack_equals_stage_4(cuda):
    rows, words, lens, code, length = _stage_case(cuda, 48)
    want = huffman_pack_segments(words, lens, code, length)
    _equal(ablate.huffman_pack_stage(words, lens, code, length, stage=4),
           want)
    _equal(ablate.huffman_pack_stage(rows, lens, code, length, stage=4,
                                     bytes_input=True), want)


@pytest.mark.parametrize("nc", [48, 7])
@pytest.mark.parametrize("variant", [
    (f, m, g) for f in floor.FUNCTIONS for m in floor.FORMS
    for g in floor.GROUPS])
def test_floor_matches_plain(cuda, variant, nc):
    function, form, group = variant
    (rows,) = _to(cuda, _rows(17, nc)[0])
    _equal(_as_tuple(floor.floor_probe(rows, function=function, form=form,
                                       group=group)),
           _as_tuple(floor.floor_probe_plain(rows, function=function)))


@pytest.mark.parametrize("nc", [48, 7])
@pytest.mark.parametrize("stride", place.STRIDES)
@pytest.mark.parametrize("strategy", place.STRATEGIES)
def test_place_matches_plain(cuda, strategy, stride, nc):
    (rows,) = _to(cuda, _rows(19, nc)[0])
    _equal(place.place_tokens(rows, strategy=strategy, stride=stride),
           place.place_tokens_plain(rows, stride=stride))


def _edge_rows(seed: int):
    """``_rows`` with K1's edge cases added: lengths 0, 1, 2047 and 2048
    (garbage past each), a stream just over its length (the escape) and
    one just under it, and runs whose vbyte takes two bytes."""
    rows, lens = _rows(seed, nc=45)
    lens[2:6] = (0, 1, 2047, 2048)
    rows[6, 40:] = np.arange(SEG - 40) % 200 + 50
    rows[7] = rows[6]
    rows[6, :40] = np.repeat(np.arange(20, dtype=np.uint8) * 2 + 1, 2)
    rows[7, :57] = np.repeat(np.arange(19, dtype=np.uint8) * 2 + 1, 3)
    rows[7, 57:61] = 250
    lens[6:8] = 1000  # streams of 1020 and 999 bytes
    rows[8] = np.repeat(np.arange(8, dtype=np.uint8), 256)
    lens[8] = SEG
    return rows, lens


def _unaligned(t: torch.Tensor, skip: int) -> torch.Tensor:
    """A copy of ``t`` whose data starts ``skip`` bytes past a 16-byte
    boundary (the kernels' narrower load paths)."""
    n = t.numel() * t.element_size()
    buf = torch.empty(n + 16, dtype=torch.uint8, device=t.device)
    start = (skip - buf.data_ptr()) % 16
    out = buf[start : start + n].view(t.dtype).view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == skip
    return out


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("offset", [0, 125])
def test_rle_pack_and_select_edges_match_plain(cuda, offset, aligned):
    rows, lens = _to(cuda, *_edge_rows(offset))
    if not aligned:
        rows = _unaligned(rows, 8)
    _equal(rle_pack_segments(rows, lens, offset=offset),
           rle_pack_segments_plain(rows, lens, offset=offset))
    got = rle_select_segments(rows, lens, offset=offset)
    _equal(got, rle_select_segments_plain(rows, lens, offset=offset))
    raw = got[2].cpu()
    assert raw[6] and not raw[7] and raw.any() and not raw.all()
    assert got[1][6:8].tolist() == [1000, 999]


def test_rle_select_is_rle_stage_on_the_card(cuda):
    from tudocomp_tpu_torch.models.blockcodec import rle_stage

    rows, lens = _edge_rows(3)
    for c, n in enumerate(lens):
        rows[c, n:] = 0  # as split_segments pads
    r, ln = _to(cuda, rows, lens)
    before = rle_select_segments.launches
    sel, counts, raw, _ = rle_stage(r, ln, offset=0, hist_rows=None)
    assert rle_select_segments.launches == before + 1
    words, rle_lens = rle_pack_segments_plain(*_to("cpu", rows, lens))
    want_raw = rle_lens > torch.from_numpy(lens)
    assert torch.equal(raw.cpu(), want_raw)
    own = torch.from_numpy(rows.view(">u4").astype(np.uint32).view(np.int32))
    assert torch.equal(sel.cpu(), torch.where(want_raw[:, None], own, words))


def _decode_args(dev, container: bytes, codec, shift: int = 0):
    """K4's inputs for ``container`` placed ``shift`` bytes into the
    flat array (every payload moves by ``shift`` mod 16)."""
    table, off, orig_len, counts, flags, poff, pbytes = codec.parse(
        container)
    flat = np.concatenate([np.full(shift, 0xEE, np.uint8),
                           np.frombuffer(container, np.uint8)])
    t = device_tables(table, dev)
    args = _to(dev, flat, poff.astype(np.int64) + shift,
               pbytes.astype(np.int64), counts.astype(np.int32),
               flags.astype(np.uint8))
    return args + [t["thresh"], t["offs"], t["symbols"]], t["fast"], off, \
        orig_len


def _decode_equal(args, fast, offset, orig_len):
    got = decode_segments(*args, offset=offset, orig_len=orig_len, fast=fast)
    want = decode_segments_plain(*args, offset=offset, orig_len=orig_len)
    assert want.numel() == orig_len  # zeros past a short segment
    assert torch.equal(got, want)
    return got


@pytest.mark.parametrize("offset", [0, 125])
def test_decode_every_payload_offset_mod_16(cuda, offset):
    rows, lens = _edge_rows(21 + offset)
    data = b"".join(r[:n].tobytes() for r, n in zip(rows, lens))[:-333]
    codec = BlockCodec(device="cpu", offset=offset)
    container = codec.compress(data)
    flags = codec.parse(container)[4]
    assert {0, 1, 2, 3} <= set(flags.tolist())  # both escapes, alone and
    for shift in range(16):                     # together
        args, fast, off, n = _decode_args(cuda, container, codec, shift)
        got = _decode_equal(args, fast, off, n)
        assert got.cpu().numpy().tobytes() == data


def _fibonacci_table() -> HuffmanTable:
    fib = [1, 1]
    while len(fib) < 40:
        fib.append(fib[-1] + fib[-2])
    hist = np.ones(256, np.int64)
    hist[:40] = fib[::-1]
    return HuffmanTable.from_counts(hist, max_len=16, min_len=3)


def _hand_frames(table, offset: int, cut=False):
    """Frames built from symbol streams: RLE streams of the port's plain
    K1 (2-byte vbytes included), a hand-made 3-byte vbyte, rle_raw and
    huff_raw segments, a short last segment. ``cut``: ``True`` drops the
    last 9 payload bytes of the rle_raw frames at least 200 bytes
    narrower than the widest (zeros past the cut decode to bytes of the
    segment's full length); ``"widest"`` drops them from the widest
    payload too, so that its reads run past every payload; ``"count"``
    cuts the count of an rle_raw frame and of an RLE frame below their
    streams' lengths, so that both decode short."""
    rng = np.random.default_rng(offset)
    rows = rng.integers(0, 256, (9, SEG), dtype=np.uint8)
    rows[1] = np.repeat(rng.integers(0, 40, SEG, dtype=np.uint8),
                        rng.integers(1, 300, SEG))[:SEG]
    rows[2] = rng.integers(0, 3, SEG)
    rows[3] = np.repeat(np.arange(4, dtype=np.uint8), 512)
    lens = np.full(9, SEG, np.int32)
    words, rle_lens = rle_pack_segments_plain(*_to("cpu", rows, lens),
                                              offset=offset)
    streams = bytes_from_words(words, SEG).numpy()
    segs = []
    for c in range(8):
        rle_raw = c in (0, 5) or int(rle_lens[c]) > SEG
        syms = rows[c] if rle_raw else streams[c, : int(rle_lens[c])]
        segs.append((syms, rle_raw, c == 5 or c == 6))
    # a run of 12 written with a 3-byte vbyte of v = offset + 10, then
    # literals with no equal neighbours
    v = offset + 10
    three = np.array([9, 9, 0x80 | (v & 0x7F), 0x80 | (v >> 7), 0], np.uint8)
    literals = (np.arange(SEG - 12) % 200 + 20).astype(np.uint8)
    segs.append((np.concatenate([three, literals]), False, False))
    flat, poff, pbytes, counts, flags = bytearray(b"\x01"), [], [], [], []
    for syms, rle_raw, huff_raw in segs:
        if huff_raw:
            payload = syms.tobytes()
        else:
            payload = pack_tokens(table.sym_code[syms].astype(np.uint32),
                                  table.sym_len[syms])[0].tobytes()
        poff.append(len(flat))
        pbytes.append(len(payload))
        counts.append(syms.size)
        flags.append(2 * rle_raw + huff_raw)
        flat += payload + bytes(len(poff) % 5)
    pbytes, flags = np.array(pbytes), np.array(flags, np.uint8)
    counts = np.array(counts, np.int32)
    if cut in (True, "widest"):
        narrow = (flags & 2).astype(bool) & (pbytes < pbytes.max() - 200)
        assert narrow.sum() >= 2
        if cut == "widest":
            narrow |= pbytes == pbytes.max()
        pbytes[narrow] -= 9
    elif cut == "count":
        assert flags[0] & 2 and not flags[1] & 2
        counts[0] -= 300
        counts[1] //= 2
    return (np.frombuffer(bytes(flat), np.uint8).copy(), np.array(poff),
            pbytes, counts, flags)


@pytest.mark.parametrize("cut", [False, True, "widest", "count"])
@pytest.mark.parametrize("offset", [0, 125])
def test_decode_long_codes_and_hand_frames(cuda, offset, cut):
    table = _fibonacci_table()
    assert table.sym_len.max() == 16
    flat, poff, pbytes, counts, flags = _hand_frames(table, offset, cut)
    t = device_tables(table, cuda)
    args = _to(cuda, flat, poff.astype(np.int64), pbytes.astype(np.int64),
               counts, flags) + [t["thresh"], t["offs"], t["symbols"]]
    orig_len = SEG * (len(counts) - 1) + 1000  # a short last segment
    _decode_equal(args, t["fast"], offset, orig_len)
    # nseg 1, 7 and 9 (not a multiple of the 64-thread block)
    for nseg in (1, 7):
        sub = [a[:nseg] if 1 <= i <= 4 else a for i, a in enumerate(args)]
        _decode_equal(sub, t["fast"], offset, SEG * nseg)


def test_decode_segment_counts_across_blocks(cuda):
    rows, lens = _rows(29, nc=131)  # 2 full 64-thread blocks and 3 more
    lens[:] = SEG
    data = rows.tobytes()[:-5]
    codec = BlockCodec(device="cpu")
    args, fast, off, n = _decode_args(cuda, codec.compress(data), codec, 3)
    assert _decode_equal(args, fast, off, n).cpu().numpy().tobytes() == data
    assert torch.equal(decode_segments(*args, offset=off, orig_len=n),
                       decode_segments(*args, offset=off, orig_len=n,
                                       fast=fast))


@pytest.mark.parametrize("alphabet", [64, 256])
def test_decode_warps_of_rle_raw_segments(cuda, alphabet):
    """Noise that RLE would expand: every segment takes rle_raw (and,
    for 256 symbols, huff_raw too), so whole warps take K4's loop
    without the RLE machine."""
    rng = np.random.default_rng(alphabet)
    data = rng.integers(0, alphabet, 70 * SEG - 100, dtype=np.uint8).tobytes()
    codec = BlockCodec(device="cpu")
    container = codec.compress(data)
    flags = codec.parse(container)[4]
    assert (flags == (3 if alphabet == 256 else 2)).all()
    for shift in (0, 5):
        args, fast, off, n = _decode_args(cuda, container, codec, shift)
        got = _decode_equal(args, fast, off, n)
        assert got.cpu().numpy().tobytes() == data


def test_decode_flipped_containers_complete_or_raise(cuda):
    """K4 (``decompress_device`` on the card) on the hardening suite's 32
    payload flips: each completes or raises, and the card reports no
    fault after it. The port's two decoders may disagree on a flipped
    frame (the host decoder raises on some that the device path decodes
    to other bytes), as the reference's do, so K4 is held to neither."""
    data, comp = hardening_container(cuda)
    codec = BlockCodec(device=cuda)
    assert codec.decompress_device(comp) == data
    done = 0
    for bad in flipped(comp):
        try:
            out = codec.decompress_device(bad)
        except Exception:
            torch.cuda.synchronize()  # a fault on the card raises here
            continue
        torch.cuda.synchronize()
        assert isinstance(out, bytes)
        done += 1
    assert done > 0
    assert codec.decompress_device(comp) == data


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("name", NAMES)
def test_huff_select_and_pack_match_plain(cuda, name, aligned):
    """K2's two entries on the select cases of ``test_torch_k2_k3.py``:
    counts 0, 1, 2047 and 2048, the identity table (every segment
    escapes), 16-bit codes that straddle words and overflow the kept
    words, 3-bit codes that share words, and bits at 8 * count and one
    under it."""
    words, counts, code, length = _to(cuda, *select_case(name, 5))
    if not aligned:
        words = _unaligned(words, 4)
    got = huffman_select_segments(words, counts, code, length)
    _equal(got, huffman_select_segments_plain(words, counts, code, length))
    _equal(huffman_pack_segments(words, counts, code, length),
           huffman_pack_segments_plain(words, counts, code, length))
    raw = got[2].cpu()
    assert raw[0] and (raw.all() if name == "identity" else not raw.all())


def test_codec_stages_launch_the_fused_entries(cuda):
    from tudocomp_tpu_torch.models.blockcodec import huff_stage, rle_stage

    rows, lens = _edge_rows(5)
    r, ln = _to(cuda, rows, lens)
    hist = torch.zeros(256, dtype=torch.int64, device=cuda)
    reset_launches()
    sel, counts, _, h = rle_stage(r, ln, offset=0, hist_rows=slice(1, 45, 8),
                                  hist=hist)
    t = device_tables(HuffmanTable.from_counts(h.cpu().numpy() + 1,
                                               max_len=16, min_len=3), cuda)
    out = huff_stage(sel, counts, t["sym_code"], t["sym_len"])
    torch.cuda.synchronize()
    launched = {k: v for k, v in launch_counts().items() if v}
    assert launched == {"rle_select": 1, "histogram_rows": 1,
                        "huff_select": 1}, launched
    assert h is hist and torch.equal(
        hist, histogram_rows_plain(sel, counts, slice(1, 45, 8)))
    _equal(out, huffman_select_segments_plain(sel, counts, t["sym_code"],
                                              t["sym_len"]))


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("lo,hi", BATCHES)
def test_histogram_rows_matches_plain(cuda, lo, hi, aligned):
    rows, lens = _rows(lo % 97, hi - lo)
    words, lens_t = _to(cuda, rows.view(">u4").astype(np.uint32).view(
        np.int32), lens)
    if not aligned:
        words = _unaligned(words, 8)
    picked = BlockCodec.hist_rows(lo, hi, True)
    out = torch.full((256,), 3, dtype=torch.int64, device=cuda)
    assert histogram_rows(words, lens_t, picked, out) is out
    assert torch.equal(out - 3, histogram_rows_plain(words, lens_t, picked))
    for step in (1, 3):
        out.zero_()
        histogram_rows(words, lens_t, slice(2, None, step), out)
        assert torch.equal(out, histogram_rows_plain(words, lens_t,
                                                     slice(2, None, step)))


# -- the front end on the card: entry(), the CLI, the suffix ops ----------

def _front_text(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = [b"tudocomp ", b"suffix ", b"array ", b"aaaaaaaa ", b"bwt "]
    return b"".join(words[i] for i in
                    rng.integers(0, len(words), n // 4))[:n]


def test_entry_on_card_matches_cpu(cuda):
    from tudocomp_tpu_torch.entry import entry

    fn, args = entry()
    assert all(a.device.type == "cuda" for a in args)
    reset_launches()
    got = fn(*args)
    torch.cuda.synchronize()
    launched = {k: v for k, v in launch_counts().items() if v}
    assert launched == {"rle_select": 1, "histogram_rows": 1,
                        "huff_select": 1}, launched
    cfn, cargs = entry(device="cpu")
    _equal([g.cpu() for g in got], cfn(*cargs))


@pytest.mark.parametrize("algo", ["tbc2", "tbc2(dec=host)",
                                  "bwt(device=true)",
                                  "bwt(device=true):tbc2"])
def test_cli_on_card_matches_cpu(cuda, algo):
    from tudocomp_tpu_torch import cli

    data = _front_text(40 << 10, seed=1)
    out = cli.compress(algo, data)
    assert out == cli.compress(algo, data, device="cpu")
    assert cli.decompress(out) == data


@pytest.mark.parametrize("threads", [2, 4])
def test_cli_blocks_threads_on_card(cuda, tmp_path, threads):
    from tudocomp_tpu_torch import cli

    src = tmp_path / "in.bin"
    data = _front_text(300 << 10, seed=2)
    src.write_bytes(data)
    args = [str(src), "-a", "tbc2", "--blocks", "32Ki", "-f"]
    assert cli.main([*args, "-o", str(tmp_path / "one")]) == 0
    assert cli.main([*args, "--threads", str(threads), "-o",
                     str(tmp_path / "many")]) == 0
    assert (tmp_path / "many").read_bytes() == (tmp_path / "one").read_bytes()
    assert cli.main([str(tmp_path / "many"), "-d", "-f", "--threads",
                     str(threads), "-o", str(tmp_path / "dec")]) == 0
    assert (tmp_path / "dec").read_bytes() == data


def test_stat_phase_dev_mem_peak_reads_the_card(cuda):
    """devMemPeak is the live device bytes at a phase's exit less those
    at its entry, and bubbles up to the parent."""
    from tudocomp_tpu_torch.stats import StatPhase

    torch.empty(1, device=cuda)  # CUDA initialised before either phase
    with StatPhase("root") as root:
        with StatPhase("keep") as keep:
            kept = torch.empty(1 << 20, dtype=torch.uint8, device=cuda)
        with StatPhase("free") as free:
            torch.empty(1 << 20, dtype=torch.uint8, device=cuda)
    assert keep.dev_mem_peak >= kept.numel()
    assert free.dev_mem_peak == 0
    assert root.dev_mem_peak >= keep.dev_mem_peak
    assert root.to_json()["sub"][0]["devMemPeak"] == keep.dev_mem_peak


@pytest.mark.parametrize("n", [1, 7, 1000, 70000])
def test_suffix_ops_on_card_match_cpu(cuda, n):
    from tudocomp_tpu_torch.ops import suffix

    text = np.frombuffer(_front_text(n, seed=n)[: n - 1] + b"\0", np.uint8)
    t_cpu = torch.from_numpy(text.copy())
    t_gpu = t_cpu.to(cuda)
    sa = suffix.suffix_array_device(t_gpu)
    assert torch.equal(sa.cpu(), suffix.suffix_array_device(t_cpu))
    isa = suffix.isa_device(sa)
    bwt = suffix.bwt_device(t_gpu, isa)
    assert torch.equal(bwt.cpu(), suffix.bwt_device(t_cpu, isa.cpu()))
    assert suffix.unbwt_device(bwt).cpu().numpy().tobytes() \
        == text[:-1].tobytes()
    for L in (8, 32):
        for full in (True, False):
            got = suffix.suffix_array_isa_ranks(t_gpu, L=L, full=full)
            want = suffix.suffix_array_isa_ranks(t_cpu, L=L, full=full)
            assert torch.equal(got[0].cpu(), want[0])
            assert torch.equal(got[1].cpu(), want[1])
            assert sorted(got[2]) == sorted(want[2])
            for q in want[2]:
                assert torch.equal(got[2][q].cpu(), want[2][q])


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("n", [5, 513, 6000, 70000])
def test_lz77_matchers_on_card_match_cpu(cuda, n, exact):
    from tudocomp_tpu_torch.ops import lzss

    text = np.frombuffer(_front_text(n, seed=n)[: n - 1] + b"\0", np.uint8)
    t_cpu = torch.from_numpy(text.copy())
    fn = lzss._match_exact_device if exact else lzss._match_device
    max_len = lzss.match_max_len(n, exact)
    got = fn(t_cpu.to(cuda), max_len=max_len)
    want = fn(t_cpu, max_len=max_len)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("algo", [
    "lzss_lcp(coder=huff,comp=device,dec=device)",
    "lzss_lcp(coder=bit,comp=device_fast,dec=device)",
    "lzss_lcp(coder=gamma,comp=device,dec=device)",
])
def test_lzss_lcp_cli_on_card_matches_cpu(cuda, algo):
    from tudocomp_tpu_torch import cli

    data = _front_text(100_000, seed=5)
    out = cli.compress(algo, data)
    assert out == cli.compress(algo, data, device="cpu")
    assert cli.decompress(out) == data


@pytest.mark.parametrize("max_len", [64, 4096])
@pytest.mark.parametrize("n", [5, 513, 6000, 70000])
def test_lcpcomp_lcp_by_position_on_card_matches_cpu(cuda, n, max_len):
    from tudocomp_tpu_torch.ops import lcpcomp

    text = np.frombuffer(_front_text(n, seed=n)[: n - 1] + b"\0", np.uint8)
    t_cpu = torch.from_numpy(text.copy())
    ml = min(max_len, max(4, n - 1))
    got = lcpcomp._lcp_by_position(t_cpu.to(cuda), max_len=ml)
    want = lcpcomp._lcp_by_position(t_cpu, max_len=ml)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("threshold", [2, 5, 100])
@pytest.mark.parametrize("n", [5, 513, 70000])
def test_lcpcomp_factorize_device_on_card_matches_cpu(cuda, n, threshold):
    from tudocomp_tpu_torch.ops import lcpcomp
    from tudocomp_tpu_torch.stats import StatPhase

    text = np.frombuffer(_front_text(n, seed=n)[: n - 1] + b"\0", np.uint8)
    with StatPhase("card") as card:
        got = lcpcomp.factorize_device(text, threshold)
    with StatPhase("cpu") as cpu:
        want = lcpcomp.factorize_device(text, threshold, device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert card.stats == cpu.stats


@pytest.mark.parametrize("dec", ["scan", "compact", "MultimapListBuffer",
                                 "QueueListBuffer"])
@pytest.mark.parametrize("coder", ["ascii", "huff", "sle"])
def test_lcpcomp_cli_on_card_matches_cpu(cuda, coder, dec):
    from tudocomp_tpu_torch import cli

    data = _front_text(100_000, seed=6)
    algo = f"lcpcomp(coder={coder},comp=device,dec={dec})"
    out = cli.compress(algo, data)
    assert out == cli.compress(algo, data, device="cpu")
    assert cli.decompress(out) == data


# --- the sharded pipeline (parallel/) on the card ---------------------------


@pytest.fixture
def nccl_world_1(cuda, tmp_path):
    """One NCCL rank on the card, over a FileStore, in this process."""
    import torch.distributed as dist

    from tudocomp_tpu_torch.parallel import make_mesh
    from tudocomp_tpu_torch.parallel.distributed import TIMEOUT

    dist.init_process_group(
        "nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=TIMEOUT)
    try:
        yield make_mesh(1, device=cuda)
    finally:
        dist.destroy_process_group()


def test_sharded_nccl_world_1_matches_cpu(nccl_world_1):
    import torch_parallel_ranks as ranks

    from tudocomp_tpu_torch.ops.lzss import factorize_device
    from tudocomp_tpu_torch.parallel import compress_sharded
    from tudocomp_tpu_torch.parallel.pipeline import (
        decompress_sharded, factorize_blocks_sharded,
    )

    mesh = nccl_world_1
    codec = BlockCodec(device=mesh.device)
    cases = {**ranks.inputs(), "resume": ranks.resume_data()}
    for name, data in cases.items():
        reset_launches()
        got = compress_sharded(codec, mesh, data)
        assert got == BlockCodec(device="cpu").compress(data), name
        assert decompress_sharded(codec, mesh, got) == data, name
        counts = launch_counts()
        assert counts["rle_select"] and counts["huff_select"], name
        assert counts["decode"] == 1, name
    blocks = ranks.blocks()
    got = factorize_blocks_sharded(mesh, blocks, threshold=4)
    for i in range(len(blocks)):
        want = factorize_device(blocks[i], 4, max_len=383, device="cpu")
        assert all(np.array_equal(a, b) for a, b in zip(got[i], want)), i


def test_sharded_two_gloo_ranks_on_one_card(cuda, tmp_path, monkeypatch):
    """Two spawned ranks on cuda:0 over gloo (NCCL refuses two ranks on
    one card): every case of the CPU world runs equal to the card's
    one-device codec."""
    import torch_parallel_ranks as ranks

    from tudocomp_tpu_torch.models import blockcodec as bc
    from tudocomp_tpu_torch.ops.lzss import factorize_device
    from tudocomp_tpu_torch.parallel.launch import run_ranks

    results = run_ranks(ranks.world_run, 2, device="cuda", backend="gloo",
                        args=(str(tmp_path), (1, 2)), timeout=300)
    root = results[0]
    codec = BlockCodec(device=cuda)
    for name, data in ranks.inputs().items():
        want = codec.compress(data)
        assert root[name, 1] == root[name, 2] == want, name
        assert root["dec", name] == data, name
    assert root["journaled"] == codec.compress(ranks.resume_data())
    blocks = ranks.blocks()
    for i in range(len(blocks)):
        want = factorize_device(blocks[i], 4, max_len=383, device="cpu")
        assert all(np.array_equal(a, b)
                   for a, b in zip(root["factors"][i], want)), i
    monkeypatch.setattr(bc, "HIST_SEGS", ranks.HIST_CAP)
    want = codec.compress(ranks.cap_data())
    assert all(root["cap", lanes] == want for lanes in ranks.CAP_LANES)


def test_sharded_crash_and_resume_on_the_card(cuda, tmp_path):
    import torch_parallel_ranks as ranks

    from tudocomp_tpu_torch.parallel.launch import RanksFailed, run_ranks

    src, dst = str(tmp_path / "in.bin"), str(tmp_path / "out.tbc2")
    (tmp_path / "in.bin").write_bytes(ranks.resume_data())
    with pytest.raises(RanksFailed) as e:
        run_ranks(ranks.journaled, 2, device="cuda", backend="gloo",
                  args=(src, dst, False), timeout=300,
                  env={"TDC_CRASH_AFTER_BATCH": "1"})
    assert e.value.exitcodes[0] == 17
    got = run_ranks(ranks.journaled, 2, device="cuda", backend="gloo",
                    args=(src, dst, True), timeout=300)[0]
    assert got == BlockCodec(device=cuda).compress(ranks.resume_data())


# --- the device ESP rounds (ops/esp.py) on the card --------------------------


@pytest.mark.parametrize("tail_cutoff", [1, 4096])
@pytest.mark.parametrize("n", [9, 513, 4097, 70000, 300_000])
def test_esp_rounds_on_card_match_cpu_and_host(cuda, n, tail_cutoff):
    """Rules, root and ``empty`` on the card equal the CPU run and the
    host library's loop; the device rounds are the CPU's."""
    from tudocomp_tpu_torch.compressors.esp import esp_rounds
    from tudocomp_tpu_torch.ops.esp import esp_rounds_device

    data = _front_text(n, seed=n)
    on_card, on_cpu = {}, {}
    got = esp_rounds_device(data, tail_cutoff=tail_cutoff, stats=on_card)
    want = esp_rounds_device(data, tail_cutoff=tail_cutoff, device="cpu",
                             stats=on_cpu)
    host = esp_rounds(data)
    for g in (got, want):
        assert np.array_equal(g[0], host[0])
        assert g[1:] == host[1:]
    assert on_card["device_rounds"] == on_cpu["device_rounds"]


@pytest.mark.parametrize("algo", ["esp(rounds=device)",
                                  "esp(rounds=device,slp_coder=plain)"])
def test_esp_rounds_device_container_on_card_matches_cpu(cuda, algo):
    from tudocomp_tpu_torch import cli

    data = _front_text(200_000, seed=8)
    out = cli.compress(algo, data)
    assert out == cli.compress(algo, data, device="cpu")
    assert cli.compress(algo.replace("rounds=device", "rounds=host"),
                        data, raw=True) == out.split(b"%", 1)[1]
    assert cli.decompress(out) == data
