"""The port's bit packers against the JAX package, on the CPU.

The chunked packers' plain versions (K5 ``pack_tokens_chunks``, K6
``pack_bytes_huffman_chunks``, K7 ``rle_pack_chunks``; the CUDA kernels
are held to them in ``test_torch_cuda.py``) against
``ops/bitpack_pallas.py`` run in interpret mode, and the XLA and host
specs (``pack_tokens_device``, ``unpack_fixed``, ``rle_encode_device``,
``huffman_pack_device``, ``io/bitio.py:pack_tokens``) against their
counterparts in the port. Each Pallas call compiles once per shape and
static argument, so the chunk shapes are few: (2, 4096) and, for runs
past ``RUN_CAP``, (1, 16384). Everything is integers: every comparison
is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tudocomp_tpu.coders.huffman import HuffmanTable as JaxHuffmanTable
from tudocomp_tpu.compressors.rle import rle_decode
from tudocomp_tpu.io.bitio import pack_tokens as host_pack_tokens
from tudocomp_tpu.ops import bitpack as jax_bitpack
from tudocomp_tpu.ops import bitpack_pallas, huffman_jax, rle_jax
from tudocomp_tpu_torch.ops import bitpack, huffman, rle
from tudocomp_tpu_torch.ops import bitpack_chunks as chunks

C, N = 2, 4096


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _assert_same_stream(port_words, port_bits, jax_words, jax_bits):
    """Equal counts, equal words up to the stream's end, and zero words
    past it in the port's output."""
    port_words, jax_words = _u32(port_words), np.asarray(jax_words)
    assert port_words.shape == jax_words.shape
    for c, bits in enumerate(np.asarray(jax_bits).tolist()):
        assert int(port_bits[c]) == bits, c
        nw = -(-bits // 32)
        assert (port_words[c, :nw] == jax_words[c, :nw]).all(), c
        assert not port_words[c, nw:].any(), c


# -- K5 ----------------------------------------------------------------------


def _tokens(seed: int):
    """Random u32 values and lengths 0..32, with a run of empty tokens
    and a row ending in 32-bit tokens."""
    rng = np.random.default_rng(seed)
    values = rng.integers(0, 2**32, (C, N), dtype=np.uint64).astype(np.uint32)
    lens = rng.integers(0, 33, (C, N)).astype(np.uint32)
    lens[0, 100:700] = 0
    lens[1, -1500:] = 32
    return values, lens


@pytest.fixture(scope="module")
def k5_case():
    values, lens = _tokens(5)
    jw, jb = bitpack_pallas.pack_tokens_chunks(jnp.asarray(values),
                                               jnp.asarray(lens))
    pw, pb = chunks.pack_tokens_chunks(
        torch.from_numpy(values.view(np.int32)),
        torch.from_numpy(lens.view(np.int32)))
    return values, lens, (pw, pb), (np.asarray(jw), np.asarray(jb))


def test_pack_tokens_chunks_matches_pallas(k5_case):
    _, _, port, jax_out = k5_case
    _assert_same_stream(*port, *jax_out)


def test_pack_tokens_matches_device_and_host_specs(k5_case):
    values, lens, (pw, pb), _ = k5_case
    for c in range(C):
        dw, db = jax_bitpack.pack_tokens_device(jnp.asarray(values[c]),
                                                jnp.asarray(lens[c]))
        w, b = bitpack.pack_tokens(torch.from_numpy(values[c].view(np.int32)),
                                   torch.from_numpy(lens[c].view(np.int32)))
        assert (_u32(w) == np.asarray(dw)).all() and int(b) == int(db)
        assert (_u32(pw[c, : N + 1]) == _u32(w)).all() and int(pb[c]) == int(b)
        payload, total = host_pack_tokens(values[c], lens[c])
        assert total == int(b)
        got = _u32(w).astype(">u4").view(np.uint8)[: payload.size]
        assert got.tobytes() == payload.tobytes()


@pytest.mark.parametrize("width", [1, 7, 13, 32])
def test_unpack_fixed_matches_jax(width):
    rng = np.random.default_rng(width)
    count = 300
    vals = rng.integers(0, 2**width, count, dtype=np.uint64)
    words, total = bitpack.pack_tokens(
        bitpack.as_i32(torch.from_numpy(vals.astype(np.int64))),
        torch.full((count,), width, dtype=torch.int32))
    assert int(total) == width * count
    for start in (0, 5 * width):
        got = bitpack.unpack_fixed(words, start, width, count - 5)
        want = jax_bitpack.unpack_fixed(jnp.asarray(_u32(words)), start,
                                        width, count - 5)
        assert got.tolist() == np.asarray(want).tolist()
        assert got.tolist() == vals[start // width :][: count - 5].tolist()


def test_bits_for_and_stream_helpers_match_jax():
    v = np.array([0, 1, 2, 3, 127, 128, 2**31, 2**32 - 1, 65535, 65536],
                 np.uint32)
    got = bitpack.bits_for_u32(torch.from_numpy(v.view(np.int32)))
    assert got.tolist() == np.asarray(
        jax_bitpack.bits_for_u32(jnp.asarray(v))).tolist()
    words = np.array([0xDEADBEEF, 0x01234567, 0x89ABCDEF], np.uint32)
    for total in (0, 3, 8, 13, 70, 96):
        assert (bitpack.words_to_stream(torch.from_numpy(words.view(np.int32)),
                                        total)
                == jax_bitpack.words_to_stream(words, total))
    payload = np.arange(11, dtype=np.uint8)
    assert (bitpack.stream_to_words(payload)
            == jax_bitpack.stream_to_words(payload)).all()


# -- K7 ----------------------------------------------------------------------


def _rle_rows(kind: str):
    """(data u8[C, N], lengths i32[C]) of one K7 case."""
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, (C, N), dtype=np.uint8)
    if kind == "mixed":
        # short runs with garbage past length 3001; a run across the
        # kernel tiles' edge at 2048 and one to the chunk's end
        data[0] = np.repeat(rng.integers(0, 3, N, dtype=np.uint8),
                            rng.integers(1, 200, N))[:N]
        data[1, 1500:2600] = 9
        data[1, 3900:] = 4
        return data, np.array([3001, N], np.int32)
    return data, np.array([0, 1], np.int32)  # "empty_and_one"


def _rle_cap_rows():
    """One chunk of 16384 bytes: a 9000-byte run from 1500 (past the
    8192 cap, across the tile edges at 2048..8192) and a 4384-byte run to
    the end, across 14336."""
    rng = np.random.default_rng(8)
    data = rng.integers(0, 4, (1, 16384), dtype=np.uint8)
    data[0, 1500:10500] = 200
    data[0, 12000:] = 17
    return data, np.array([16384], np.int32)


RLE_CASES = [("mixed", 0), ("mixed", 1), ("mixed", 125),
             ("empty_and_one", 0), ("run_cap", 0)]


@pytest.mark.parametrize("kind,offset", RLE_CASES)
def test_rle_pack_chunks_matches_pallas_and_xla(kind, offset):
    data, lengths = _rle_cap_rows() if kind == "run_cap" else _rle_rows(kind)
    jw, jn = bitpack_pallas.rle_pack_chunks(
        jnp.asarray(data), jnp.asarray(lengths), offset=offset)
    pw, pn = chunks.rle_pack_chunks(torch.from_numpy(data),
                                    torch.from_numpy(lengths), offset=offset)
    jn = np.asarray(jn)
    cap = pw.shape[1]
    # the TPU kernel keeps its count in a slot at word cap - 128
    _assert_same_stream(pw[:, : cap - 128], pn * 8,
                        np.asarray(jw)[:, : cap - 128], jn * 8)
    for c in range(data.shape[0]):
        dw, dn = rle_jax.rle_encode_device(jnp.asarray(data[c]),
                                           int(lengths[c]), offset)
        w, n = rle.rle_encode(torch.from_numpy(data[c]), int(lengths[c]),
                              offset)
        assert int(n) == int(dn) == int(pn[c])
        assert (_u32(w) == np.asarray(dw)).all()
        jv, jl = rle_jax.rle_tokens(jnp.asarray(data[c]), int(lengths[c]),
                                    offset)
        v, ln = rle.rle_tokens(torch.from_numpy(data[c]), int(lengths[c]),
                               offset)
        assert (ln.numpy() == np.asarray(jl).astype(np.int32)).all()
        live = ln.numpy() > 0
        assert (_u32(v)[live] == np.asarray(jv)[live]).all()
        # the reference decoder restores the chunk (continuation pieces
        # included)
        stream = _u32(pw[c]).astype(">u4").view(np.uint8)[: int(pn[c])]
        assert rle_decode(stream, offset) == data[c, : lengths[c]].tobytes()


def test_rle_tokens_batched_equals_rows():
    data, lengths = _rle_rows("mixed")
    v, ln = rle.rle_tokens(torch.from_numpy(data), torch.from_numpy(lengths))
    for c in range(C):
        vc, lc = rle.rle_tokens(torch.from_numpy(data[c]), int(lengths[c]))
        assert torch.equal(v[c], vc) and torch.equal(ln[c], lc)


def test_vbyte2_token_matches_jax():
    v = np.arange(1 << 14, dtype=np.int32)
    got_v, got_b = rle.vbyte2_token(torch.from_numpy(v))
    want_v, want_b = rle_jax.vbyte2_token(jnp.asarray(v))
    assert got_v.tolist() == np.asarray(want_v).tolist()
    assert got_b.tolist() == np.asarray(want_b).tolist()


# -- K6 ----------------------------------------------------------------------


def _huffman_case():
    rng = np.random.default_rng(6)
    text = np.frombuffer(b"<page><title>Anarchism</title> the quick fox "
                         * 100, np.uint8)
    data = np.stack([text[:N], rng.integers(0, 256, N, dtype=np.uint8)])
    lengths = np.array([N, 2500], np.int32)  # garbage past 2500
    hist = np.bincount(data.reshape(-1), minlength=256) + 1
    table = JaxHuffmanTable.from_counts(hist, max_len=16, min_len=3)
    return data, lengths, table


def test_pack_bytes_huffman_chunks_matches_pallas_and_xla():
    data, lengths, table = _huffman_case()
    code = table.sym_code.astype(np.uint32)
    ln = table.sym_len.astype(np.uint32)
    jw, jb = bitpack_pallas.pack_bytes_huffman_chunks(
        jnp.asarray(data), jnp.asarray(lengths), jnp.asarray(code),
        jnp.asarray(ln))
    tcode = torch.from_numpy(code.view(np.int32))
    tlen = torch.from_numpy(ln.astype(np.int32))
    pw, pb = chunks.pack_bytes_huffman_chunks(
        torch.from_numpy(data), torch.from_numpy(lengths), tcode, tlen)
    _assert_same_stream(pw, pb, jw, jb)
    for c in range(C):
        dw, db = huffman_jax.huffman_pack_device(
            jnp.asarray(data[c]), int(lengths[c]), jnp.asarray(code),
            jnp.asarray(ln))
        w, b = huffman.huffman_pack(torch.from_numpy(data[c]),
                                    int(lengths[c]), tcode, tlen)
        assert (_u32(w) == np.asarray(dw)).all() and int(b) == int(db)
        jv, jl = huffman_jax.huffman_encode_tokens(
            jnp.asarray(data[c]), int(lengths[c]), jnp.asarray(code),
            jnp.asarray(ln))
        v, l = huffman.huffman_encode_tokens(torch.from_numpy(data[c]),
                                             int(lengths[c]), tcode, tlen)
        assert (_u32(v) == np.asarray(jv)).all()
        assert (l.numpy() == np.asarray(jl).astype(np.int32)).all()
    for length in (0, 5000, C * N):
        got = huffman.masked_histogram(torch.from_numpy(data), length)
        want = huffman_jax.masked_histogram(jnp.asarray(data), length)
        assert got.tolist() == np.asarray(want).tolist()


def _host_table(hist, max_len=16, min_len=3):
    t = JaxHuffmanTable.from_counts(hist, max_len=max_len, min_len=min_len)
    return t.sym_code.astype(np.int64), t.sym_len.astype(np.int64)


def _fibonacci_hist():
    h = np.ones(256, np.int64)
    f, g = 1, 1
    for i in range(40):
        h[i] = f
        f, g = f + g, f
    return h


#: the histogram families of tests/test_huffman_device_table.py
TABLE_HISTS = {
    "uniform": np.ones(256, np.int64),
    "random": np.random.default_rng(0).integers(1, 1 << 20, 256),
    "ties": np.random.default_rng(1).integers(1, 4, 256),
    "fibonacci": _fibonacci_hist(),
    "fibonacci_reversed": _fibonacci_hist()[::-1].copy(),
    "text": np.bincount(np.random.default_rng(2).zipf(1.3, 1 << 16) % 256,
                        minlength=256) + 1,
}


@pytest.mark.parametrize("name", list(TABLE_HISTS))
@pytest.mark.parametrize("min_len", [3, 8])
def test_device_table_build_matches_host_table(name, min_len):
    hist = np.asarray(TABLE_HISTS[name], np.int64)
    code, ln = huffman.device_table_build(torch.from_numpy(hist),
                                          min_len=min_len)
    want_code, want_len = _host_table(hist, min_len=min_len)
    assert ln.tolist() == want_len.tolist()
    assert code.tolist() == want_code.tolist()


def test_chunk_shapes_are_checked():
    data = torch.zeros(2, 1000, dtype=torch.uint8)
    with pytest.raises(ValueError):
        chunks.rle_pack_chunks(data, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        chunks.rle_pack_chunks(torch.zeros(1, 2048, dtype=torch.uint8),
                               torch.zeros(1, dtype=torch.int32),
                               offset=rle.RUN_CAP // 2)
    with pytest.raises(ValueError):  # 32 * N bits must fit int32
        chunks._check_chunks(1 << 26, 2048)



@pytest.mark.parametrize("bad_len", [17, 32, -1])
def test_huffman_chunks_reject_code_lengths_past_16(bad_len):
    data = torch.zeros(1, 2048, dtype=torch.uint8)
    lengths = torch.full((1,), 2048, dtype=torch.int32)
    code = torch.zeros(256, dtype=torch.int32)
    ln = torch.full((256,), 8, dtype=torch.int32)
    ln[7] = bad_len
    with pytest.raises(ValueError, match="sym_len"):
        chunks.pack_bytes_huffman_chunks(data, lengths, code, ln)
