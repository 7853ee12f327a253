"""Plain torch versions of the port's four kernels against the host specs.

K1 (RLE pack) against ``compressors/rle.py:rle_encode``, K2 (Huffman
pack) against ``io/bitio.py:pack_tokens`` of ``HuffmanTable`` codes, K3
(histogram) against ``np.bincount`` and K4 (decode) against
``rle_decode`` of ``HuffmanTable.fast_decode``. CPU tensors take the
plain versions, so this file needs neither JAX nor a GPU. The pipeline
is integers: every comparison is exact.
"""

import numpy as np
import pytest
import torch

from tudocomp_tpu.coders.huffman import HuffmanTable
from tudocomp_tpu.compressors.rle import rle_decode, rle_encode
from tudocomp_tpu.io.bitio import pack_tokens
from tudocomp_tpu_torch import BlockCodec, device_tables
from tudocomp_tpu_torch.models.blockcodec import huff_stage
from tudocomp_tpu_torch.ops import launch_counts, reset_launches
from tudocomp_tpu_torch.ops.hist import histogram_words
from tudocomp_tpu_torch.ops.hufdec import decode_segments
from tudocomp_tpu_torch.ops.rle import be_words_from_bytes, bytes_from_words
from tudocomp_tpu_torch.ops.segpack import (
    huffman_pack_segments, rle_pack_segments,
)

SEG = 2048


def _segments(seed: int):
    """Rows of every kind K1 sees, garbage past each length included:
    random bytes, text, runs of 2 (RLE expands them), long and maximal
    runs, a 1-byte segment and an empty one."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 256, (8, SEG), dtype=np.uint8)
    text = np.frombuffer(b"the <b>quick</b> brown fox; " * 80, np.uint8)
    rows[1] = text[:SEG]
    rows[2] = np.repeat(rng.integers(0, 256, SEG // 2, dtype=np.uint8), 2)
    rows[3] = np.repeat(rng.integers(0, 3, SEG, dtype=np.uint8),
                        rng.integers(1, 300, SEG))[:SEG]
    rows[4] = 7
    rows[5, :3] = (9, 9, 9)
    lens = np.array([SEG, SEG, SEG, 1500, SEG, 1, 0, 777], np.int32)
    return rows, lens


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _stream_bytes(words: torch.Tensor) -> np.ndarray:
    return bytes_from_words(words, SEG).numpy()


@pytest.mark.parametrize("offset", [0, 1, 125])
def test_rle_pack_matches_rle_encode(offset):
    rows, lens = _segments(offset)
    words, rle_lens = rle_pack_segments(*_t(rows, lens), offset=offset)
    got = _stream_bytes(words)
    for c in range(rows.shape[0]):
        spec = rle_encode(rows[c, : lens[c]], offset)
        assert int(rle_lens[c]) == spec.size, c
        keep = min(spec.size, SEG)
        assert got[c, :keep].tobytes() == spec[:keep].tobytes(), c
        assert not got[c, keep:].any(), c  # zero past the stream
    assert int(rle_lens[2]) > lens[2]  # runs of 2: the rle_raw trigger


def test_rle_pack_ignores_padding():
    rows, lens = _segments(3)
    clean = rows.copy()
    for c, n in enumerate(lens):
        clean[c, n:] = 0
    got = rle_pack_segments(*_t(rows, lens))
    want = rle_pack_segments(*_t(clean, lens))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_rle_pack_rejects_bad_input():
    rows, lens = _t(*_segments(0))
    with pytest.raises(ValueError):
        rle_pack_segments(rows, lens, offset=126)
    with pytest.raises(ValueError):
        rle_pack_segments(rows, lens.long())
    with pytest.raises(ValueError):
        rle_pack_segments(rows[:, :1024], lens)


def _table(seed: int) -> HuffmanTable:
    rng = np.random.default_rng(seed)
    counts = rng.zipf(1.3, 256).clip(max=1 << 20) + 1
    return HuffmanTable.from_counts(counts, max_len=16, min_len=3)


def test_huffman_pack_matches_pack_tokens():
    rng = np.random.default_rng(1)
    table = _table(1)
    streams = rng.integers(0, 256, (6, SEG), dtype=np.uint8)
    counts = np.array([SEG, 1, 0, 1000, 2047, 333], np.int32)
    t = device_tables(table, "cpu")
    words, bits = huffman_pack_segments(
        *_t(streams.view(">u4").astype(np.uint32).view(np.int32), counts),
        t["sym_code"], t["sym_len"],
    )
    got = words.numpy().view(np.uint32).astype(">u4").view(np.uint8)
    got = got.reshape(6, -1)
    for c, n in enumerate(counts):
        sym = streams[c, :n]
        payload, total = pack_tokens(table.sym_code[sym].astype(np.uint32),
                                     table.sym_len[sym])
        assert int(bits[c]) == total, c
        keep = min(payload.size, SEG)
        assert got[c, :keep].tobytes() == payload[:keep].tobytes(), c


def test_huffman_pack_raw_edges():
    """The huff_raw test is ``bits >= 8 * count``: the identity code hits
    it with equality, and a stream of 16-bit codes overflows the 512
    kept words yet reports its full bit count."""
    stream = np.zeros((2, SEG), np.uint8)
    counts = np.array([SEG, 1500], np.int32)
    hist = np.ones(256, np.int64)
    hist[1:5] = 1 << 30  # four frequent bytes: the rest get long codes
    long_codes = HuffmanTable.from_counts(hist, max_len=16, min_len=3)
    assert long_codes.sym_len[0] > 8
    words, cnt = _t(stream.view(np.int32), counts)
    ident = device_tables(None, "cpu")
    _, bits, raw = huff_stage(words, cnt, ident["sym_code"],
                              ident["sym_len"])
    assert bits.tolist() == [8 * SEG, 8 * 1500] and raw.all()
    t = device_tables(long_codes, "cpu")
    _, full = huffman_pack_segments(words, cnt, t["sym_code"], t["sym_len"])
    assert full.tolist() == [int(long_codes.sym_len[0]) * n for n in counts]
    _, bits, raw = huff_stage(words, cnt, t["sym_code"], t["sym_len"])
    assert raw.all() and bits.tolist() == [8 * SEG, 8 * 1500]


def test_histogram_matches_bincount():
    rows, lens = _segments(5)
    words, lens_t = _t(rows.view(">u4").astype(np.uint32).view(np.int32),
                       lens)
    want = sum(np.bincount(r[:n], minlength=256) for r, n in zip(rows, lens))
    assert histogram_words(words, lens_t).tolist() == want.tolist()
    assert not histogram_words(words[:0], lens_t[:0]).any()


def _frames(segments, table, offset):
    """Hand-built TBC2 payloads: (flat, poff, pbytes, counts, flags)."""
    flat, poff, pbytes, counts, flags = bytearray(b"junk"), [], [], [], []
    for seg, rle_raw, huff_raw in segments:
        syms = seg if rle_raw else rle_encode(seg, offset)
        assert syms.size <= SEG  # what the rle_raw escape guarantees
        if huff_raw:
            payload = syms.tobytes()
        else:
            payload = pack_tokens(table.sym_code[syms].astype(np.uint32),
                                  table.sym_len[syms])[0].tobytes()
        poff.append(len(flat))
        pbytes.append(len(payload))
        counts.append(syms.size)
        flags.append(2 * rle_raw + huff_raw)
        flat += payload + b"\xff\xfe"  # bytes after a payload are not read
    return _t(np.frombuffer(flat, np.uint8).copy(), np.array(poff),
              np.array(pbytes), np.array(counts, np.int32),
              np.array(flags, np.uint8))


@pytest.mark.parametrize("offset", [0, 3])
def test_decode_matches_host_spec(offset):
    rows, _ = _segments(offset)
    table = _table(4)
    # (segment, rle_raw, huff_raw); the last segment is short
    segments = [(rows[0], True, True), (rows[1], False, True),
                (rows[2], True, False), (rows[3], False, False),
                (rows[4], False, False), (rows[5, :1000], False, False)]
    frames = _frames(segments, table, offset)
    t = device_tables(table, "cpu")
    orig_len = SEG * 5 + 1000
    out = decode_segments(*frames, t["thresh"], t["offs"], t["symbols"],
                          offset=offset, orig_len=orig_len)
    want = b""
    for (seg, rle_raw, huff_raw), n, pb, po in zip(
        segments, frames[3].tolist(), frames[2].tolist(), frames[1].tolist()
    ):
        payload = frames[0].numpy()[po : po + pb]
        syms = payload[:n] if huff_raw else table.fast_decode(payload, n)
        want += syms.tobytes() if rle_raw else rle_decode(syms, offset)
        assert want[-seg.size:] == seg.tobytes()
    assert out.numpy().tobytes() == want


def test_codec_rejects_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError):
        BlockCodec(device="cuda")
    with pytest.raises(RuntimeError):
        BlockCodec()  # the default device is CUDA; the CPU is never picked


def test_codec_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert BlockCodec().device == torch.device("cuda")
    assert BlockCodec(device="cpu").device == torch.device("cpu")


def test_cpu_path_launches_no_kernel():
    reset_launches()
    codec = BlockCodec(device=torch.device("cpu"))
    data = b"abcabcaaaaaaaaaaaaab" * 300
    assert codec.decompress_device(codec.compress(data)) == data
    assert set(launch_counts().values()) == {0}


def test_device_tables_identity():
    t = device_tables(None, "cpu")
    assert t["sym_code"].tolist() == list(range(256))
    assert t["sym_len"].tolist() == [8] * 256
    assert not t["thresh"].any() and not t["offs"].any()


def test_word_helpers_round_trip():
    rows = np.arange(2 * SEG, dtype=np.uint8).reshape(2, SEG)
    words = be_words_from_bytes(torch.from_numpy(rows))
    assert words.dtype == torch.int32
    assert (words.numpy().view(np.uint32)
            == rows.view(">u4").astype(np.uint32)).all()
    assert (bytes_from_words(words, SEG).numpy() == rows).all()


def test_failed_build_raises_without_fallback(monkeypatch, tmp_path):
    """A kernel route whose build fails raises; it never falls back to
    the plain version."""
    from tudocomp_tpu_torch import _build

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_SO", str(tmp_path / "lib.so"))
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")  # exits 1
    monkeypatch.setattr(_build, "on_cuda", lambda *t: True)
    reset_launches()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        rle_pack_segments(*_t(*_segments(0)))
    assert launch_counts()["rle_pack"] == 0
