"""The port's ``sle`` coder (``coders/sle.py``, ``csrc/host/sle.cpp``) and
the SLE branches of its factor stream (``compressors/lzss.py``) against
``tudocomp_tpu/coders/sle.py`` and the JAX package on the CPU. Every
comparison is exact (bytes). No JAX program runs here: the SLE coder is
host code in both packages.

Sizes straddle the split of the rank tables (numpy up to 4096 literals,
the host library above) and of the flush (the scalar loop up to 64
pending literals, the host matcher above).
"""

import numpy as np
import pytest

from tudocomp_tpu.coders.base import Literals as JaxLiterals
from tudocomp_tpu.coders.sle import SLECoder as JaxSLECoder
from tudocomp_tpu.coders.sle import _rank_tables as jax_rank_tables
from tudocomp_tpu.io.bitio import BitReader as JaxBitReader
from tudocomp_tpu.io.bitio import BitWriter as JaxBitWriter
from tudocomp_tpu.ranges import Range as JaxRange
from tudocomp_tpu.ranges import literal_r as jax_literal_r
from tudocomp_tpu.registry import create_algo as jax_create_algo
from tudocomp_tpu_torch import cli, native
from tudocomp_tpu_torch.coders import sle
from tudocomp_tpu_torch.coders.base import Literals
from tudocomp_tpu_torch.coders.sle import SLECoder
from tudocomp_tpu_torch.compressors import lzss as port_lzss
from tudocomp_tpu_torch.io.bitio import BitReader, BitWriter
from tudocomp_tpu_torch.ranges import Range, literal_r
from tudocomp_tpu_torch.registry import create_algo

ALPHABET = np.frombuffer(b"aabbbcdefgh\x00\xff ", np.uint8)
SIZES = (0, 1, 2, 3, 40, 65, 700, 4096, 4097, 9000)


def _chars(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.choice(ALPHABET, n).astype(np.uint8)


@pytest.mark.parametrize("n", SIZES)
def test_rank_tables_match_jax(n):
    """Below and above 4096 literals the tables equal JAX's; the numpy
    path and the host library's agree on the same literals."""
    chars = _chars(n, n)
    kmers, lits = sle._rank_tables(chars)
    assert (kmers, lits) == jax_rank_tables(chars)
    keys, lit_arr = native.sle_rank(chars, sle.K, sle.MAX_KMERS,
                                    sle.MAX_LITS)
    assert [int(k).to_bytes(sle.K, "big") for k in keys.tolist()] == kmers
    assert lit_arr.tolist() == lits


@pytest.mark.parametrize("n", [4096, 9000, 60000])
def test_rank_tables_numpy_path_equals_the_host_library(n):
    """The numpy tables equal the host library's at any size, full
    tables (255 k-mers, 255 literals) included."""
    rng = np.random.default_rng(n)
    # every byte value once, then 16 values: more than 255 repeated
    # 3-grams and 256 literals
    chars = np.concatenate([rng.permutation(256),
                            rng.integers(0, 16, n - 256)]).astype(np.uint8)
    keys, lits = native.sle_rank(chars, sle.K, sle.MAX_KMERS, sle.MAX_LITS)
    want = ([int(k).to_bytes(sle.K, "big") for k in keys.tolist()],
            lits.tolist())
    assert sle._numpy_rank_tables(chars) == want
    assert len(want[0]) == sle.MAX_KMERS
    assert len(want[1]) == sle.MAX_LITS


def _encode(pkg, chars: np.ndarray, calls) -> bytes:
    """Encode ``chars`` through ``calls``: a list of ("array", lo, hi),
    ("scalar", lo, hi) and ("int", value) steps."""
    if pkg == "jax":
        algo = jax_create_algo(JaxSLECoder)
        w = JaxBitWriter()
        enc = JaxSLECoder.Encoder(algo.env, w, JaxLiterals(chars))
        lit_r, rng = jax_literal_r, JaxRange(1000)
    else:
        algo = create_algo(SLECoder, torch_device="cpu")
        w = BitWriter()
        enc = SLECoder.Encoder(algo.env, w, Literals(chars))
        lit_r, rng = literal_r, Range(1000)
    for step in calls:
        if step[0] == "array":
            enc.encode_array(chars[step[1]:step[2]], lit_r)
        elif step[0] == "scalar":
            for v in chars[step[1]:step[2]].tolist():
                enc.encode(v, lit_r)
        else:
            enc.encode(step[1], rng)
    enc.finish()
    return w.getvalue()


def _scalar_flush(enc):
    """The scalar loop of ``_flush_pending`` for any number of pending
    literals (the host matcher takes over above 64)."""
    def flush(final):
        buf = enc._pending
        limit = len(buf) if final else len(buf) - (sle.K - 1)
        i = 0
        while i < limit:
            km = bytes(buf[i:i + sle.K])
            rank = enc.kmer_rank.get(km) if len(km) == sle.K else None
            if rank is not None:
                enc.out.write_bit(1)
                enc.out.write_elias_gamma(rank)
                i += sle.K
            else:
                enc.out.write_bit(0)
                lr = enc.lit_rank.get(buf[i])
                if lr is not None:
                    enc.out.write_bit(1)
                    enc.out.write_elias_gamma(lr)
                else:
                    enc.out.write_bit(0)
                    enc.out.write_int(buf[i], 8)
                i += 1
        del buf[:i]
    return flush


@pytest.mark.parametrize("n", SIZES)
def test_encoder_matches_jax_and_the_scalar_loop(n):
    """One bulk array, literals one at a time, and literal runs broken by
    other values: each stream equals JAX's, and the host matcher's
    stream equals the scalar loop's."""
    chars = _chars(n, 100 + n)
    plans = [
        [("array", 0, n)],
        [("scalar", 0, n)],
        [("array", 0, n // 3), ("int", 7), ("scalar", n // 3, n // 2),
         ("array", n // 2, n), ("int", 999)],
    ]
    for plan in plans:
        got = _encode("port", chars, plan)
        assert got == _encode("jax", chars, plan), plan
    algo = create_algo(SLECoder, torch_device="cpu")
    w = BitWriter()
    enc = SLECoder.Encoder(algo.env, w, Literals(chars))
    enc._flush_pending = _scalar_flush(enc)
    enc._pending.extend(chars.tolist())
    enc.finish()
    assert w.getvalue() == _encode("port", chars, [("scalar", 0, n)])


@pytest.mark.parametrize("n", SIZES)
def test_decoder_reads_jax_streams(n):
    """The port decodes JAX's literal stream symbol by symbol and whole
    (the host library's walk), and JAX decodes the port's."""
    chars = _chars(n, 200 + n)
    plan = [("array", 0, n)]
    blob = _encode("jax", chars, plan)
    assert _encode("port", chars, plan) == blob
    algo = create_algo(SLECoder, torch_device="cpu")
    dec = SLECoder.Decoder(algo.env, BitReader(blob))
    got = [dec.decode(literal_r) for _ in range(n)]
    assert bytes(got) == chars.tobytes()
    dec = SLECoder.Decoder(algo.env, BitReader(blob))
    assert dec.decode_remaining_literals()[:n] == chars.tobytes()
    if n >= 4:
        # a buffered k-mer tail: the walk goes on symbol by symbol
        dec = SLECoder.Decoder(algo.env, BitReader(blob))
        head = [dec.decode(literal_r) for _ in range(1)]
        tail = dec.decode_remaining_literals()
        assert (bytes(head) + tail)[:n] == chars.tobytes()
    jalgo = jax_create_algo(JaxSLECoder)
    jdec = JaxSLECoder.Decoder(jalgo.env, JaxBitReader(blob))
    assert bytes(jdec.decode(jax_literal_r) for _ in range(n)) \
        == chars.tobytes()


def _text(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = [b"sle ", b"kmer ", b"rank ", b"zzzz ", b"factor "]
    body = b"".join(words[i] for i in rng.integers(0, 5, n // 4))[:n]
    noise = bytes(rng.integers(1, 256, n // 4, dtype=np.uint8))
    return body + noise


def _sle_factor_stream(pkg, data: bytes, factors):
    """``encode_factor_text`` of ``data`` under a fresh SLE encoder."""
    text = np.frombuffer(data, np.uint8)
    if pkg == "jax":
        from tudocomp_tpu.compressors import lzss as jax_lzss

        fb = jax_lzss.FactorBuffer()
        fb.extend_arrays(*factors.arrays())
        w = JaxBitWriter()
        enc = JaxSLECoder.Encoder(jax_create_algo(JaxSLECoder).env, w,
                                  jax_lzss.uncovered_literals(text, fb))
        jax_lzss.encode_factor_text(enc, text, fb)
    else:
        w = BitWriter()
        enc = SLECoder.Encoder(create_algo(SLECoder).env, w,
                               port_lzss.uncovered_literals(text, factors))
        port_lzss.encode_factor_text(enc, text, factors)
    return w.getvalue()


@pytest.mark.parametrize("n", [300, 9000])
def test_factor_stream_branches_equal_the_scalar_loops(n, monkeypatch):
    """``encode_factor_text``'s host SLE branch and
    ``decode_stream_native``'s SLE walk, in mode 0 (back-references)
    and mode 1 (lcpcomp), give what the scalar loops give, and the
    streams equal JAX's."""
    from tudocomp_tpu import cli as jax_cli
    from tudocomp_tpu_torch.compressors import lcpcomp as port_lcpcomp

    data = _text(n, n) + b"\0"
    factors = port_lzss.factorize_lcp(np.frombuffer(data, np.uint8), 3)
    stream = _sle_factor_stream("port", data, factors)
    assert stream == _sle_factor_stream("jax", data, factors)
    dec = SLECoder.Decoder(create_algo(SLECoder).env, BitReader(stream))
    assert port_lzss.decode_factor_text(dec) == data
    algo = "lcpcomp(coder=sle,comp=arrays)"
    fast = cli.compress(algo, data[:-1], raw=True, device="cpu")
    assert fast == jax_cli.compress(algo, data[:-1], raw=True)
    assert cli.decompress(fast, algo, device="cpu") == data[:-1]
    # the scalar loops: an encoder the SLE branch does not recognise,
    # and a decoder walk that declines
    with monkeypatch.context() as m:
        m.setattr(port_lzss, "SLECoder", _NotSLE)
        assert _sle_factor_stream("port", data, factors) == stream
        assert cli.compress(algo, data[:-1], raw=True, device="cpu") == fast
    with monkeypatch.context() as m:
        m.setattr(port_lcpcomp, "decode_stream_native",
                  lambda *a, **k: None)
        assert cli.decompress(fast, algo, device="cpu") == data[:-1]


class _NotSLE:
    class Encoder:
        pass

    class Decoder:
        pass


def test_decode_stream_native_declines_a_buffered_tail():
    algo = create_algo(SLECoder, torch_device="cpu")
    blob = _encode("port", _chars(30, 1), [("array", 0, 30)])
    dec = SLECoder.Decoder(algo.env, BitReader(blob))
    dec.buffer = [1]
    assert port_lzss.decode_stream_native(
        dec, 10, Range(1, 2), Range(10), Range(10), mode=1) is None


def test_malformed_streams_raise():
    with pytest.raises(ValueError, match="malformed sle stream"):
        # flag 1, gamma(0) = "1" "1": a k-mer rank with no k-mer table
        native.sle_decode(np.array([0b11000000], np.uint8), 2, 0, b"",
                          0, sle.K, b"")
    with pytest.raises(ValueError, match="malformed sle factor stream"):
        native.lzss_decode_stream_sle(
            np.array([0b11111111, 0xFF], np.uint8), 16, 0, 8, 1, 3, 1, 3,
            b"", sle.K, b"", mode=1)
