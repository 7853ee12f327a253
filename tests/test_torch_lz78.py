"""The port's sliding-window ``lzss``, ``lz78`` and ``lzw`` with every
trie (``compressors/lzss.py``, ``lz78.py``, ``lzw.py``, ``lz78_trie.py``,
``csrc/host/lz78.cpp``, ``csrc/host/lzss_window.cpp``) against the JAX package on the CPU. Every
comparison is exact (bytes).

The grid is the JAX matrix's default selection (``tests/test_matrix.py``:
at most 16 configurations a family, over the corpus entries under
4 KiB). The stream functions run at adversarially small chunk sizes
(both packages' ``STREAM_CHUNK`` patched); their output must equal the
buffered path's for every chunking.
"""

from __future__ import annotations

import io

import numpy as np
import pytest

import tests.test_reference_golden as reference_golden
import tudocomp_tpu.compressors.lz78 as jax_lz78
import tudocomp_tpu.compressors.lzss as jax_lzss
from tudocomp_tpu import cli as jax_cli
from tudocomp_tpu import native as jax_native
from tudocomp_tpu.registry import REGISTRY as JAX_REGISTRY
from tudocomp_tpu_torch import cli, native
from tudocomp_tpu_torch.compressors import lz78 as port_lz78
from tudocomp_tpu_torch.compressors import lzss as port_lzss
from tudocomp_tpu_torch.compressors.lz78_trie import ALL_TRIES
from tudocomp_tpu_torch.registry import REGISTRY

from tests.helpers import roundtrip_corpus
from tests.test_golden import GOLDEN

CPU = "cpu"
CORPUS = [c for c in roundtrip_corpus() if len(c) < 4096][:18]


def matrix_grid(families) -> list:
    """``tests/test_matrix.py``'s default per-family selection of the
    JAX registry's configurations, for ``families``."""
    grid = []
    for fam in families:
        items = sorted(JAX_REGISTRY._enum_cls("compressor", fam,
                                              {"compressor": 1}, 2))
        step = max(1, len(items) // 16)
        grid.extend(items[::step][:16])
    return grid


def same_containers(algo: str, inputs) -> None:
    """The port's container equals the JAX package's, and each package
    decodes the other's."""
    for data in inputs:
        want = jax_cli.compress(algo, data)
        got = cli.compress(algo, data, device=CPU)
        assert got == want, (algo, data[:40])
        assert cli.decompress(want, device=CPU) == data, (algo, data[:40])
        assert jax_cli.decompress(got) == data, (algo, data[:40])


@pytest.mark.parametrize("algo", matrix_grid(("lzss", "lz78", "lzw")))
def test_containers_match_jax(algo):
    same_containers(algo, CORPUS)


def _trie_corpus():
    rng = np.random.default_rng(9)
    return [
        b"abababababab",
        b"to be or not to be that is the question " * 8,
        bytes(rng.integers(0, 256, 1500, dtype=np.uint8)),
        rng.choice(np.frombuffer(b"acgt", np.uint8), 2000)
        .astype(np.uint8).tobytes(),
        b"x" * 500,
        b"",
    ]


@pytest.mark.parametrize("trie", [t.meta().name for t in ALL_TRIES])
@pytest.mark.parametrize("comp,dict_size", [
    ("lz78", 0), ("lz78", 2), ("lz78", 17),
    ("lzw", 0), ("lzw", 257), ("lzw", 300)])
def test_every_trie_matches_jax(comp, dict_size, trie):
    """The port parses every trie in the host library's one dictionary;
    the JAX package walks each trie's own structure in Python where the
    dictionary is bounded (a reset after every factor at the smallest
    sizes). The containers are equal."""
    for coder in ("bit", "gamma"):
        algo = (f"{comp}(coder={coder},lz78trie={trie},"
                f"dict_size={dict_size})")
        same_containers(algo, _trie_corpus())


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


#: the ascii coder's codes end in a terminator byte, which the JAX
#: package's stream decoders may find cut off at a chunk edge: there they
#: reject lzss(coder=ascii) streams and decode lzw(coder=ascii) streams
#: into wrong bytes; the port's decode them (only the port's decoders run
#: here)
STREAMING = ("lzss(coder=bit)", "lzss(coder=gamma, window=64)",
             "lzss(coder=ascii, threshold=2)", "lz78(coder=bit)",
             "lz78(coder=ascii)", "lz78(coder=bit, dict_size=300)",
             "lzw(coder=ternary)", "lzw(coder=delta, dict_size=400)",
             "lzw(coder=ascii)", "lzw(coder=ascii, dict_size=300)")
STREAM_DATA = [b"", b"a", b"abracadabra", CORPUS[-1],
               b"foobar" * 300 + bytes(range(256)) * 3]


@pytest.mark.parametrize("chunk", [7, 1000])
@pytest.mark.parametrize("algo", STREAMING)
def test_stream_functions_match_buffered_and_jax(algo, chunk):
    port = REGISTRY.instantiate(algo, torch_device=CPU)
    jax = JAX_REGISTRY.instantiate(algo)
    port_mods, jax_mods = (port_lz78, port_lzss), (jax_lz78, jax_lzss)
    for data in STREAM_DATA:
        want = port.compress(data)
        assert want == jax.compress(data)
        got = _stream(port_mods, port, data, "compress_stream", chunk)
        assert got == want, (algo, len(data))
        assert got == _stream(jax_mods, jax, data, "compress_stream",
                              chunk + 5)
        assert _stream(port_mods, port, want, "decompress_stream",
                       chunk) == data


def port_cli_streams(algo, data, tmp_path, monkeypatch, chunk):
    """Run the port's CLI one-pass branch on ``data`` at ``chunk``-byte
    chunks, the buffered path refused; assert that ``-d`` streams back
    and return the written file's bytes."""
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    cls = type(REGISTRY.instantiate(algo, torch_device=CPU))

    def refuse(self, data):
        raise AssertionError("the buffered path ran")

    monkeypatch.setattr(cls, "compress", refuse)
    monkeypatch.setattr(cls, "decompress", refuse)
    monkeypatch.setattr(port_lz78, "STREAM_CHUNK", chunk)
    monkeypatch.setattr(port_lzss, "STREAM_CHUNK", chunk)
    out = tmp_path / "p.tdc"
    assert cli.main([str(src), "--device", CPU, "-a", algo, "-o",
                     str(out)]) == 0
    assert cli.main([str(out), "--device", CPU, "-d", "-o",
                     str(tmp_path / "p.out")]) == 0
    assert (tmp_path / "p.out").read_bytes() == data
    monkeypatch.undo()
    return out.read_bytes()


@pytest.mark.parametrize("algo", ["lzss", "lz78(coder=bit)",
                                  "lzw(coder=bit)"])
def test_cli_streams_files_like_jax(algo, tmp_path, monkeypatch):
    """The port's CLI streams these files (the buffered path is refused)
    into the JAX CLI's file and the buffered container, and ``-d``
    streams back; the JAX CLI decodes the port's file."""
    data = b"".join(CORPUS) * 4
    want = cli.compress(algo, data, device=CPU)
    got = port_cli_streams(algo, data, tmp_path, monkeypatch, 999)
    assert jax_cli.main([str(tmp_path / "in.bin"), "-a", algo, "-o",
                         str(tmp_path / "j.tdc")]) == 0
    assert got == want == (tmp_path / "j.tdc").read_bytes()
    assert jax_cli.main([str(tmp_path / "p.tdc"), "-d", "-o",
                         str(tmp_path / "j.out")]) == 0
    assert (tmp_path / "j.out").read_bytes() == data


#: streams whose codes outgrow the host encoder's first buffer (an ascii
#: factor is 40 bits for one byte at threshold 1)
WIDE = ["lzss(coder=ascii, threshold=1)",
        "lzss(coder=ascii, threshold=1, window=64)",
        "lzss(coder=ternary, threshold=1)", "lz78(coder=ascii)",
        "lzw(coder=ascii, dict_size=300)"]


@pytest.mark.parametrize("algo", WIDE)
def test_cli_streams_wide_codes_like_buffered(algo, tmp_path, monkeypatch):
    """Random bytes over four letters, whose factors are short (the JAX
    CLI's one-pass branch fails on them for ``lzss(coder=ascii,
    threshold=1)``, its host buffer being too small): the port's CLI
    streams them into the buffered container, which equals the JAX
    package's buffered container, and ``-d`` streams back."""
    rng = np.random.default_rng(11)
    data = rng.choice(np.frombuffer(b"acgt", np.uint8), 6000) \
        .astype(np.uint8).tobytes()
    want = cli.compress(algo, data, device=CPU)
    assert want == jax_cli.compress(algo, data)
    assert port_cli_streams(algo, data, tmp_path, monkeypatch, 1500) == want


@pytest.mark.parametrize("algo", ["lzss(window=0)", "lzss(window=-3)",
                                  "lzss(threshold=0)",
                                  "lzss(threshold=-1, coder=gamma)"])
def test_lzss_degenerate_options_match_jax(algo):
    """A window below 1 (no candidates) and a threshold below 1 (the
    matches of threshold 1) encode into the JAX package's bytes; each
    package's decode of the result agrees with the other's."""
    for data in CORPUS:
        got = cli.compress(algo, data, device=CPU)
        assert got == jax_cli.compress(algo, data), (algo, data[:40])
        results = []
        for decode in (lambda c: cli.decompress(c, device=CPU),
                       jax_cli.decompress):
            try:
                results.append(decode(got) == data)
            except ValueError as e:
                results.append(str(e))
        assert results[0] == results[1], (algo, data[:40])


NEW_GOLDEN = [g for g in GOLDEN
              if g[0].split("(")[0] in ("lzss", "lz78", "lzw", "repair")]


@pytest.mark.parametrize("algo,data,expected", NEW_GOLDEN,
                         ids=[g[0] for g in NEW_GOLDEN])
def test_golden_bits(algo, data, expected):
    """``tests/test_golden.py``'s pinned streams of the new families."""
    got = cli.compress(algo, data, raw=True, device=CPU)
    assert got.hex() == expected
    assert cli.decompress(got, raw_algo=algo, device=CPU) == data


@pytest.mark.parametrize("case", ["test_lzss_window_reference_bytes",
                                  "test_lz78_reference_bytes",
                                  "test_lzw_reference_bytes"])
def test_reference_golden_bytes(case, monkeypatch):
    """``tests/test_reference_golden.py``'s hand-derived reference bytes,
    with its compressors instantiated from the port."""
    monkeypatch.setattr(reference_golden, "_comp",
                        lambda s: REGISTRY.instantiate(s, torch_device=CPU))
    getattr(reference_golden, case)()


@pytest.mark.parametrize("what", ["lz78", "lzss"])
def test_stream_decoders_reject_garbage_like_jax(what):
    """Garbage into the stream decoder handles raises the JAX handle's
    exception, or decodes to the JAX handle's bytes."""
    rng = np.random.default_rng(3)
    for trial in range(20):
        blob = rng.integers(0, 256, int(rng.integers(1, 300)),
                            np.uint8).tobytes()
        results = []
        for mod in (native, jax_native):
            h = (mod.Lz78DecStream(trial % 2 == 1, 0, trial % 5)
                 if what == "lz78" else mod.LzssDecStream(16, trial % 5))
            try:
                results.append(h.feed(blob, True))
            except ValueError as e:
                results.append(str(e))
            finally:
                h.close()
        assert results[0] == results[1]
