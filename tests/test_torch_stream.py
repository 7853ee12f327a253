"""The port's literal-stream families (``noop``, ``encode`` with every
coder, ``rle``, ``mtf``, the ``arithmetic`` coder,
``csrc/host/literal.cpp``) and its CLI's one-pass streaming path against
the JAX package on the CPU. Every comparison is exact (bytes).

The stream functions run at adversarially small chunk sizes (both
packages' ``STREAM_CHUNK`` patched), so runs, vbytes and the MTF table
straddle chunk edges; the output must equal the buffered path's for
every chunking.
"""

from __future__ import annotations

import io

import numpy as np
import pytest

import tudocomp_tpu.compressors.mtf as jax_mtf
import tudocomp_tpu.compressors.rle as jax_rle
from tudocomp_tpu import cli as jax_cli
from tudocomp_tpu import native as jax_native
from tudocomp_tpu.registry import REGISTRY as JAX_REGISTRY
from tudocomp_tpu_torch import cli, native
from tudocomp_tpu_torch.coders.arithmetic import ArithmeticCoder
from tudocomp_tpu_torch.compressors import mtf as port_mtf
from tudocomp_tpu_torch.compressors import rle as port_rle
from tudocomp_tpu_torch.io.bitio import BitReader
from tudocomp_tpu_torch.meta import InputRestrictions
from tudocomp_tpu_torch.ranges import literal_r
from tudocomp_tpu_torch.registry import REGISTRY

CPU = "cpu"


def _corpus(seed: int, n: int) -> bytes:
    """Tiny-alphabet noise, long runs (past RUN_CAP) and byte noise."""
    rng = np.random.default_rng(seed)
    parts = [
        rng.integers(0, 4, n // 3, dtype=np.uint8),
        np.repeat(rng.integers(0, 256, 12, np.uint8),
                  rng.integers(1, 9000, 12)),
        rng.integers(0, 256, n // 3, dtype=np.uint8),
    ]
    return np.concatenate(parts)[:n].tobytes()


DATA = [b"", b"a", b"aa", b"abracadabra", b"\x00" * 20000,
        _corpus(0, 40000), _corpus(1, 9999)]
CODERS = ("ascii", "bit", "gamma", "delta", "ternary", "huff",
          "arithmetic", "sle")
ALGOS = (["noop", "encode", "rle", "rle(offset=3)", "mtf",
          "bwt:rle:mtf:encode(coder=arithmetic)",
          "bwt:rle:mtf:encode(coder=huff)"]
         + [f"encode(coder={c})" for c in CODERS])
STREAMING = ("noop", "rle", "rle(offset=3)", "mtf")


@pytest.mark.parametrize("algo", ALGOS)
def test_containers_match_jax(algo):
    for data in DATA:
        want = jax_cli.compress(algo, data)
        got = cli.compress(algo, data, device=CPU)
        assert got == want, (algo, len(data))
        assert cli.decompress(want, device=CPU) == data
        assert jax_cli.decompress(got) == data


@pytest.mark.parametrize("algo", ["lzss_lcp(coder=arithmetic)",
                                  "lcpcomp(coder=arithmetic)",
                                  "encode(coder=nope)"])
def test_rejections_match_jax(algo):
    """The compressors that restrict their coders reject ``arithmetic``
    with the JAX package's exception type."""
    with pytest.raises(Exception) as want:
        jax_cli.compress(algo, b"abc")
    with pytest.raises(Exception) as got:
        cli.compress(algo, b"abc", device=CPU)
    assert type(got.value) is type(want.value)


def _stream(mods, comp, data: bytes, method: str, chunk: int) -> bytes:
    old = [m.STREAM_CHUNK for m in mods]
    for m in mods:
        m.STREAM_CHUNK = chunk
    try:
        fout = io.BytesIO()
        getattr(comp, method)(io.BytesIO(data), fout)
        return fout.getvalue()
    finally:
        for m, v in zip(mods, old):
            m.STREAM_CHUNK = v


@pytest.mark.parametrize("chunk", [7, 256, 8192])
@pytest.mark.parametrize("algo", STREAMING)
def test_stream_functions_match_buffered_and_jax(algo, chunk):
    port = REGISTRY.instantiate(algo, torch_device=CPU)
    jax = JAX_REGISTRY.instantiate(algo)
    port_mods, jax_mods = (port_rle, port_mtf), (jax_rle, jax_mtf)
    for data in DATA:
        want = port.compress(data)
        assert want == jax.compress(data)
        got = _stream(port_mods, port, data, "compress_stream", chunk)
        assert got == want
        assert got == _stream(jax_mods, jax, data, "compress_stream",
                              chunk + 5)
        assert _stream(port_mods, port, want, "decompress_stream",
                       chunk) == data


def _write(tmp_path, data: bytes):
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    return src


@pytest.mark.parametrize("algo", STREAMING)
def test_cli_streams_files_and_stdout(algo, tmp_path, capsysbinary,
                                      monkeypatch):
    """The port's CLI streams (``compress`` is never called) to a file
    and to stdout; both equal the buffered container and the JAX CLI's
    streamed file; ``-d`` streams back."""
    data = _corpus(2, 30000)
    src = _write(tmp_path, data)
    want = cli.compress(algo, data, device=CPU)
    assert jax_cli.main([str(src), "-a", algo, "-o",
                         str(tmp_path / "j.tdc")]) == 0
    cls = type(REGISTRY.instantiate(algo, torch_device=CPU))

    def refuse(self, data):
        raise AssertionError("the buffered path ran")

    monkeypatch.setattr(cls, "compress", refuse)
    monkeypatch.setattr(cls, "decompress", refuse)
    monkeypatch.setattr(port_rle, "STREAM_CHUNK", 1000)
    monkeypatch.setattr(port_mtf, "STREAM_CHUNK", 1000)
    out = tmp_path / "p.tdc"
    assert cli.main([str(src), "--device", CPU, "-a", algo, "-o",
                     str(out)]) == 0
    assert out.read_bytes() == want == (tmp_path / "j.tdc").read_bytes()
    capsysbinary.readouterr()
    assert cli.main([str(src), "--device", CPU, "-a", algo,
                     "--usestdout"]) == 0
    assert capsysbinary.readouterr().out == want
    assert cli.main([str(out), "--device", CPU, "-d", "-o",
                     str(tmp_path / "p.out")]) == 0
    assert (tmp_path / "p.out").read_bytes() == data
    assert cli.main([str(out), "--device", CPU, "-d", "--usestdout"]) == 0
    assert capsysbinary.readouterr().out == data


def test_resume_and_restrictions_take_the_buffered_path(tmp_path,
                                                        monkeypatch):
    data = _corpus(3, 20000)
    src = _write(tmp_path, data)
    want = cli.compress("rle", data, device=CPU)

    def refuse(self, fin, fout):
        raise AssertionError("the streaming path ran")

    monkeypatch.setattr(port_rle.RunLengthEncoder, "compress_stream",
                        refuse)
    out = tmp_path / "r.tdc"
    assert cli.main([str(src), "--device", CPU, "-a", "rle", "--resume",
                     "-f", "-o", str(out)]) == 0
    assert out.read_bytes() == want
    # an algorithm with input restrictions (escaping, a sentinel) is
    # compressed buffered, with its escapes applied
    restr = InputRestrictions((0,), True)
    monkeypatch.setattr(REGISTRY, "restrictions_of", lambda env: restr)
    assert cli.main([str(src), "--device", CPU, "-a", "rle", "-f", "-o",
                     str(out)]) == 0
    assert out.read_bytes() == cli.compress("rle", data, device=CPU)


def _listing_rows(listing: str, keep) -> list:
    rows, section = [], None
    for line in listing.splitlines():
        if line.startswith("["):
            section = line.strip("[]")
        elif keep(section, line):
            rows.append((section, line))
    return rows


NEW_TYPES = ("slp_coder", "d_coding", "subseq", "ipd", "hash_function",
             "hash_manager", "hash_prober", "hash_roll")
NEW_ROWS = ("  noop", "  encode(", "  rle(", "  mtf ", "  esp(",
            "  arithmetic ")


def _keep(section, line):
    return section in NEW_TYPES or (
        section in ("compressor", "coder")
        and line.startswith(NEW_ROWS))


def test_list_rows_match_jax(capsys):
    """The ``-l`` rows of every type this slice registers (the hash
    framework included, whatever has run) equal the JAX package's."""
    assert jax_cli.main(["--list"]) == 0
    want = _listing_rows(capsys.readouterr().out, _keep)
    assert cli.main(["--list"]) == 0
    got = _listing_rows(capsys.readouterr().out, _keep)
    assert got == want
    assert {s for s, _ in want} == {"compressor", "coder", *NEW_TYPES}
    assert len([r for r in want if r[0] == "compressor"]) == 5
    # the earlier families' rows stay
    assert cli.main(["--list"]) == 0
    rows = _listing_rows(capsys.readouterr().out,
                         lambda section, line: section == "lcpcomp_comp")
    assert len(rows) == 8


def test_literal_natives_match_jax():
    rng = np.random.default_rng(5)
    data = _corpus(4, 20000)
    arr = np.frombuffer(data, np.uint8)
    assert native.mtf_encode(data) == jax_native.mtf_encode(data)
    assert native.mtf_decode(data) == jax_native.mtf_decode(data)
    t1, t2 = np.arange(256, dtype=np.uint8), np.arange(256, dtype=np.uint8)
    for part in (data[:777], data[777:]):
        assert native.mtf_stream(part, t1) == jax_native.mtf_stream(part, t2)
    assert np.array_equal(t1, t2)
    enc = port_rle.rle_encode(arr, 2)
    assert native.rle_decode(enc, 2) == jax_native.rle_decode(enc, 2) == data
    for cut in (1, 100, enc.size - 1):
        got = native.rle_decode_stream(enc[:cut], 2, -1, False)
        assert got == jax_native.rle_decode_stream(enc[:cut], 2, -1, False)
    with pytest.raises(ValueError, match="malformed RLE"):
        native.rle_decode(np.array([5, 5, 0x80], np.uint8))
    counts = np.bincount(arr, minlength=256)
    mn = int(counts[counts > 0].min())
    cum = (np.cumsum(counts) // mn).astype(np.uint64)
    total = int(cum[255])
    codes = native.arith_encode(arr, cum, total)
    assert np.array_equal(codes, jax_native.arith_encode(arr, cum, total))
    syms = np.flatnonzero(counts).astype(np.uint8)
    payload = np.frombuffer(codes.astype(">u8").tobytes(), np.uint8)
    got = native.arith_decode(payload, payload.size * 8, 0, syms,
                              cum[syms], total, arr.size)
    assert got.tobytes() == data
    bits = rng.integers(0, 2, 999).astype(np.uint8)
    lut_len = np.array([1, 1, 2, 2, 3, 3, 3, 3], np.uint8)
    assert native.huffman_count(np.packbits(bits), 999, lut_len, 3) \
        == jax_native.huffman_count(np.packbits(bits), 999, lut_len, 3)


def test_arithmetic_partly_read_stream_takes_the_scalar_walk():
    """A stream read one literal first decodes the rest by the interval
    scan, to the same bytes."""
    data = b"abracadabra alakazam " * 40
    blob = cli.compress("encode(coder=arithmetic)", data, raw=True,
                        device=CPU)
    env = REGISTRY.evaluate("arithmetic", "coder", torch_device=CPU)
    dec = ArithmeticCoder.Decoder(env, BitReader(blob))
    first = dec.decode(literal_r)
    assert bytes([first]) + dec.decode_remaining_literals() == data


def test_python_specs_match_the_host_library():
    """``rle_decode``, ``mtf_encode`` and ``mtf_decode`` in Python (the
    specifications) equal the host library's, offsets included."""
    data = _corpus(6, 12000)
    for offset in (0, 3):
        enc = port_rle.rle_encode(np.frombuffer(data, np.uint8), offset)
        assert port_rle.rle_decode(enc, offset) \
            == native.rle_decode(enc, offset) == data
    assert port_mtf.mtf_encode(data) == native.mtf_encode(data)
    assert port_mtf.mtf_decode(data) == native.mtf_decode(data)
