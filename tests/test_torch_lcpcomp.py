"""The port's lcpcomp (``ops/lcpcomp.py``, ``compressors/lcpcomp.py``,
``csrc/host/lcpcomp.cpp``) against ``tudocomp_tpu/ops/lcpcomp_jax.py``
and the JAX package's ``lcpcomp`` on the CPU. Every comparison is exact
(integers and bytes).

The texts are ``tests/test_lcpcomp_device.py``'s five corpora (1291,
2251, 4097, 3001 and 5001 bytes): the JAX ``_lcp_by_position`` compiles
once per length and ``max_len``, and ``factorize_device`` once per
length. The container cases reuse two of those lengths (corpora 0 and
4 less their sentinel, which the CLI appends again).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tudocomp_tpu import cli as jax_cli
from tudocomp_tpu.compressors import lcpcomp as jax_lcpcomp
from tudocomp_tpu.ds.suffix import TextDS as JaxTextDS
from tudocomp_tpu.ops import lcpcomp_jax
from tudocomp_tpu.registry import REGISTRY as JAX_REGISTRY
from tudocomp_tpu.registry import create_algo as jax_create_algo
from tudocomp_tpu.stats import StatPhase as JaxStatPhase
from tudocomp_tpu_torch import cli
from tudocomp_tpu_torch.compressors import lcpcomp as port_lcpcomp
from tudocomp_tpu_torch.ops import lcpcomp as port
from tudocomp_tpu_torch.registry import create_algo
from tudocomp_tpu_torch.stats import StatPhase

CPU = "cpu"


def _corpora():
    rng = np.random.default_rng(17)
    return [
        b"in the beginning was the word and the word " * 30 + b"\x00",
        (b"abcabcabcabcxyz" * 150) + b"\x00",
        bytes(rng.integers(0, 6, 4096, dtype=np.uint8)) + b"\x00",
        b"a" * 3000 + b"\x00",
        rng.choice(np.frombuffer(b"acgt", np.uint8), 5000)
        .astype(np.uint8).tobytes() + b"\x00",
    ]


CORPORA = _corpora()
#: CLI inputs: corpora 0 and 4 without their sentinel (no 0 bytes, so
#: escaping only appends it back: the same text lengths)
CLI_DATA = {"words": CORPORA[0][:-1], "dna": CORPORA[4][:-1]}
COMPS = ("arrays", "heap", "naive", "max_lcp", "plcp", "plcppeaks",
         "bulldozer", "device")
CODERS = ("ascii", "huff", "sle")
DECS = ("scan", "scan(rounds=1)", "scan(rounds=2)", "compact",
        "MultimapListBuffer", "MultimapListBuffer(lazy=2)",
        "QueueListBuffer")


@pytest.mark.parametrize("i", range(len(CORPORA)))
def test_lcp_by_position_matches_jax_and_host(i):
    """Per position: the port's LCP with the SA predecessor and that
    predecessor equal JAX's, and equal the host LCP array capped at
    max_len and both suffixes' lengths."""
    data = CORPORA[i]
    text = np.frombuffer(data, np.uint8)
    n = text.size
    ds = JaxTextDS(data)
    sa = np.asarray(ds.require_sa(), np.int64)
    isa = np.asarray(ds.require_isa(), np.int64)
    lcp = np.asarray(ds.require_lcp(), np.int64)
    src = np.where(isa > 0, sa[np.maximum(isa - 1, 0)], -1)
    for max_len in (64, 4096):
        ml = min(max_len, max(4, n - 1))
        want_l, want_s = lcpcomp_jax._lcp_by_position(jnp.asarray(text),
                                                      max_len=ml)
        got_l, got_s = port._lcp_by_position(torch.from_numpy(text.copy()),
                                             max_len=ml)
        assert got_l.dtype == got_s.dtype == torch.int32
        assert np.array_equal(got_l.numpy(), np.asarray(want_l)), max_len
        assert np.array_equal(got_s.numpy(), np.asarray(want_s)), max_len
        host = np.where(
            src >= 0,
            np.minimum.reduce([lcp[isa], np.full(n, ml),
                               n - 1 - np.arange(n), n - src]), 0)
        assert np.array_equal(got_s.numpy(), src)
        assert np.array_equal(got_l.numpy(), host), max_len


def _factorize_both(text: np.ndarray, threshold: int):
    with JaxStatPhase("jax") as jp:
        want = lcpcomp_jax.factorize_device(text, threshold)
    with StatPhase("port") as pp:
        got = port.factorize_device(text, threshold, device=CPU)
    return want, got, jp.stats, pp.stats


@pytest.mark.parametrize("i", range(len(CORPORA)))
def test_factorize_device_matches_jax(i):
    """The (pos, src, len) triples and ``device_rounds`` equal JAX's;
    targets are disjoint and each equals its source's bytes."""
    text = np.frombuffer(CORPORA[i], np.uint8)
    want, got, jstats, pstats = _factorize_both(text, 5)
    for g, w in zip(got, want):
        assert g.dtype == np.int64
        assert np.array_equal(g, w)
    assert pstats["device_rounds"] == jstats["device_rounds"] >= 1
    pos, src, ln = got
    assert (ln >= 5).all() and (src >= 0).all() and (src != pos).all()
    assert (pos[1:] >= pos[:-1] + ln[:-1]).all(), "overlapping targets"
    for a, b, k in zip(pos.tolist(), src.tolist(), ln.tolist()):
        assert np.array_equal(text[a:a + k], text[b:b + k])


@pytest.mark.parametrize("data", [b"", b"\x00", b"ab\x00", b"aaaa\x00"])
def test_factorize_device_edge_shapes(data):
    text = np.frombuffer(data, np.uint8)
    want, got, jstats, pstats = _factorize_both(text, 5)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert pstats == jstats


def test_factorize_device_threshold_100():
    text = np.frombuffer(CORPORA[3], np.uint8)
    want, got, jstats, pstats = _factorize_both(text, 100)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert pstats["device_rounds"] == jstats["device_rounds"]
    assert got[0].size and (got[2] >= 100).all()


@pytest.mark.parametrize("coder", CODERS)
@pytest.mark.parametrize("comp", COMPS)
def test_container_matches_jax(comp, coder):
    """Every comp x coder: the port's container equals JAX's on both
    texts, and each package decodes the other's."""
    algo = f"lcpcomp(coder={coder},comp={comp})"
    for name, data in CLI_DATA.items():
        want = jax_cli.compress(algo, data, raw=True)
        got = cli.compress(algo, data, raw=True, device=CPU)
        assert got == want, name
        assert cli.decompress(want, algo, device=CPU) == data
        assert jax_cli.decompress(got, algo) == data


@pytest.mark.parametrize("data", [b"", b"\x01", b"abcabcabcabc"])
@pytest.mark.parametrize("coder", CODERS)
def test_short_inputs_match_jax(coder, data):
    algo = f"lcpcomp(coder={coder},comp=device)"
    got = cli.compress(algo, data, raw=True, device=CPU)
    assert got == jax_cli.compress(algo, data, raw=True)
    assert cli.decompress(got, algo, device=CPU) == data


@pytest.mark.parametrize("coder", CODERS)
def test_threshold_100_matches_jax(coder):
    data = CLI_DATA["words"] + b"q" * 300
    for comp in ("arrays", "device"):
        algo = f"lcpcomp(coder={coder},comp={comp},threshold=100)"
        got = cli.compress(algo, data, raw=True, device=CPU)
        assert got == jax_cli.compress(algo, data, raw=True)
        assert cli.decompress(got, algo, device=CPU) == data


@pytest.mark.parametrize("dec", DECS)
@pytest.mark.parametrize("coder", CODERS)
def test_every_dec_decodes_the_other_package(dec, coder):
    """Each dec strategy of the port decodes JAX's ``comp=device``
    container, and JAX's decodes the port's (the same bytes)."""
    algo = f"lcpcomp(coder={coder},comp=device,dec={dec})"
    data = CLI_DATA["dna"]
    want = jax_cli.compress(algo, data, raw=True)
    assert cli.decompress(want, algo, device=CPU) == data
    got = cli.compress(algo, data, raw=True, device=CPU)
    assert got == want
    assert jax_cli.decompress(got, algo) == data


#: forward chains: 4..8 copies from 8 (forward), 8..12 from 0; and a
#: depth-3 chain
CHAINS = {
    "forward": (12, b"abcd", [(4, 8, 4), (8, 0, 4)]),
    "depth3": (10, b"ab", [(2, 6, 2), (4, 8, 2), (6, 0, 2), (8, 0, 2)]),
}


@pytest.mark.parametrize("options", [
    ("ScanDec", ""), ("ScanDec", "rounds=1"), ("CompactDec", ""),
    ("MultimapListBuffer", "lazy=0"), ("MultimapListBuffer", "lazy=1"),
    ("MultimapListBuffer", "lazy=5"), ("QueueListBuffer", ""),
])
@pytest.mark.parametrize("chain", list(CHAINS))
def test_dec_strategies_resolve_forward_chains(chain, options):
    name, opts = options
    n, lits, factors = CHAINS[chain]
    lit = np.frombuffer(lits, np.uint8)
    lit_pos = np.arange(lit.size)
    got = create_algo(getattr(port_lcpcomp, name), opts).resolve(
        n, lit, lit_pos, factors)
    want = jax_create_algo(getattr(jax_lcpcomp, name), opts).resolve(
        n, lit, lit_pos, factors)
    assert got == want == (lits * n)[:n]


@pytest.mark.parametrize("name", ["CompactDec", "QueueListBuffer",
                                  "MultimapListBuffer"])
def test_dec_strategies_reject_a_cycle(name):
    lit = np.frombuffer(b"a", np.uint8)
    factors = [(1, 2, 1), (2, 1, 1)]
    with pytest.raises(ValueError):
        create_algo(getattr(port_lcpcomp, name)).resolve(
            3, lit, np.array([0]), factors)


def test_resolve_factors_defaults_to_scan():
    n, lits, factors = CHAINS["depth3"]
    lit = np.frombuffer(lits, np.uint8)
    assert port_lcpcomp.resolve_factors(
        n, lit, np.arange(lit.size), factors) == b"ab" * 5


def test_scalar_decode_loop_equals_the_host_walk(monkeypatch):
    """The symbol-by-symbol decode (taken when ``decode_stream_native``
    declines) restores what the host walk restores, for every coder."""
    data = CLI_DATA["words"]
    blobs = {c: cli.compress(f"lcpcomp(coder={c},comp=device)", data,
                             raw=True, device=CPU) for c in CODERS}
    monkeypatch.setattr(port_lcpcomp, "decode_stream_native",
                        lambda *a, **k: None)
    for coder, blob in blobs.items():
        for dec in ("scan", "compact"):
            algo = f"lcpcomp(coder={coder},comp=device,dec={dec})"
            assert cli.decompress(blob, algo, device=CPU) == data


def _rows(listing: str, types) -> list:
    """The ``--list`` rows of the sections ``types``, plus the sle row."""
    rows, section = [], None
    for line in listing.splitlines():
        if line.startswith("["):
            section = line.strip("[]")
        elif section in types or (section == "coder"
                                  and line.startswith("  sle")):
            rows.append((section, line))
    return rows


def test_list_rows_match_jax(capsys):
    assert jax_cli.main(["--list"]) == 0
    want = _rows(capsys.readouterr().out,
                 ("lcpcomp_comp", "lcpcomp_dec"))
    assert cli.main(["--list"]) == 0
    out = capsys.readouterr().out
    assert _rows(out, ("lcpcomp_comp", "lcpcomp_dec")) == want
    assert len([r for r in want if r[0] == "lcpcomp_comp"]) == 8
    assert len([r for r in want if r[0] == "lcpcomp_dec"]) == 4
    jax_row = [line for line in JAX_REGISTRY.doc_listing().splitlines()
               if line.startswith("  lcpcomp(")]
    assert jax_row and jax_row[0] in out.splitlines()


def test_each_cli_decodes_the_others_sle_device_file(tmp_path):
    data = CLI_DATA["dna"]
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    algo = "lcpcomp(coder=sle,comp=device)"
    port_out, jax_out = tmp_path / "port.tdc", tmp_path / "jax.tdc"
    assert cli.main([str(src), "--device", CPU, "-a", algo, "-o",
                     str(port_out)]) == 0
    assert jax_cli.main([str(src), "-a", algo, "-o", str(jax_out)]) == 0
    assert port_out.read_bytes() == jax_out.read_bytes()
    assert jax_cli.main([str(port_out), "-d", "-o",
                         str(tmp_path / "a.out")]) == 0
    assert cli.main([str(jax_out), "--device", CPU, "-d", "-o",
                     str(tmp_path / "b.out")]) == 0
    assert (tmp_path / "a.out").read_bytes() == data
    assert (tmp_path / "b.out").read_bytes() == data


def test_device_comp_needs_cuda_by_default():
    """``comp=device`` runs on CUDA unless the caller names the CPU, and
    raises where CUDA is absent; the host strategies need no device."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where CUDA is absent")
    data = CLI_DATA["words"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.compress("lcpcomp(coder=sle,comp=device)", data)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.factorize_device(np.frombuffer(CORPORA[0], np.uint8), 5)
    algo = "lcpcomp(coder=sle,comp=arrays)"
    assert cli.decompress(cli.compress(algo, data)) == data
