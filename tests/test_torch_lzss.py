"""The port's LZ77 (``ops/lzss.py``, ``compressors/lzss.py``, its coders
and host library) against ``tudocomp_tpu/ops/lzss_jax.py`` and the JAX
package's ``lzss_lcp`` on the CPU. Every comparison is exact (integers
and bytes).

The JAX matchers compile once per text length (about 4 s for the exact
one here), so the texts take two lengths: ``SMALL`` (491 bytes, L = 512,
the floor-dominance branch) and ``LARGE`` (5501 bytes, L = 4096: two
full refines with rank probes at q = 1024, 512 and 256, and a run of
1500 bytes); the CLI data is ``SMALL`` less its sentinel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from tudocomp_tpu import cli as jax_cli
from tudocomp_tpu.coders import (
    NON_CONSUMING_CODER_NAMES as JAX_CODER_NAMES,
)
from tudocomp_tpu.io.bitio import BitReader as JaxBitReader
from tudocomp_tpu.io.bitio import BitWriter as JaxBitWriter
from tudocomp_tpu.ops import lzss_jax
from tudocomp_tpu.registry import REGISTRY as JAX_REGISTRY
from tudocomp_tpu_torch import cli
from tudocomp_tpu_torch.coders import NON_CONSUMING_CODER_NAMES
from tudocomp_tpu_torch.io.bitio import BitReader, BitWriter
from tudocomp_tpu_torch.ops import lzss as port
from tudocomp_tpu_torch.registry import REGISTRY

CPU = "cpu"


def _words(n: int, seed: int) -> bytes:
    """Text with repeats and runs, and no 0 or 255 bytes (escaping adds
    only the sentinel)."""
    rng = np.random.default_rng(seed)
    words = [b"tudocomp ", b"suffix ", b"array ", b"aaaaaaaa ", b"bwt "]
    return b"".join(words[i] for i in rng.integers(0, 5, n // 3))[:n]


#: the CLI input: 490 bytes, 491 once sentineled
DATA = _words(490, 7)
SMALL = np.frombuffer(DATA + b"\0", np.uint8)
_W = _words(4000, 8)
LARGE = np.frombuffer(_W[:2500] + b"q" * 1500 + _W[2500:] + b"\0",
                      np.uint8)
TEXTS = {"small": SMALL, "large": LARGE}


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(x) -> np.ndarray:
    return np.asarray(x)


#: one compile per length instead of an eager dispatch per op
_jax_psv = jax.jit(lzss_jax._psv_smaller)


@pytest.mark.parametrize("m", [1, 2, 7, 500, 1280])
def test_psv_and_nsv_match_jax(m):
    a = np.random.default_rng(m).permutation(m).astype(np.int32)
    slot, val = _jax_psv(jnp.asarray(a))
    got = port._psv_smaller(_t(a))
    assert np.array_equal(got[0].numpy(), _np(slot))
    assert np.array_equal(got[1].numpy(), _np(val))
    # the NSV side as the JAX matcher takes it: the PSV of the reversal
    rev, rval = (_np(x)[::-1] for x in _jax_psv(jnp.asarray(a[::-1].copy())))
    got = port._nsv_smaller(_t(a))
    assert np.array_equal(got[0].numpy(), np.where(rev >= 0, m - 1 - rev, -1))
    assert np.array_equal(got[1].numpy(), np.where(rev >= 0, rval, -1))


@pytest.mark.parametrize("name", list(TEXTS))
def test_rank_tables_match_jax(name):
    text = TEXTS[name]
    want = lzss_jax.rank_tables(jnp.asarray(text), 64)
    got = port.rank_tables(_t(text), 64)
    assert sorted(got) == sorted(want)
    for q in want:
        assert np.array_equal(got[q].numpy(), _np(want[q])), q


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("name", list(TEXTS))
def test_matchers_match_jax(name, exact):
    text = TEXTS[name]
    max_len = port.match_max_len(text.size, exact)
    jax_fn = lzss_jax._match_exact_device if exact else lzss_jax._match_device
    port_fn = port._match_exact_device if exact else port._match_device
    want = jax_fn(jnp.asarray(text), max_len=max_len)
    got = port_fn(_t(text), max_len=max_len)
    assert np.array_equal(got[0].numpy(), _np(want[0]))
    assert np.array_equal(got[1].numpy(), _np(want[1]))


def _longest_previous_factor(text: np.ndarray, cap: int) -> np.ndarray:
    """Brute force: max over c < i of lcp(text[i:], text[c:]), capped at
    ``cap`` and at n - 1 - i; one row of the lcp table per position,
    from the end."""
    n = text.size
    out = np.zeros(n, np.int64)
    row = np.zeros(n + 1, np.int32)  # lcp(i + 1, c) for every c
    for i in range(n - 1, -1, -1):
        row = np.concatenate([(text == text[i]) * (1 + row[1:]),
                              [0]]).astype(np.int32)
        if i:
            out[i] = min(int(row[:i].max()), cap, n - 1 - i)
    return out


@pytest.mark.parametrize("name", list(TEXTS))
def test_exact_lengths_are_the_longest_previous_factor(name):
    text = TEXTS[name]
    max_len = port.match_max_len(text.size, True)
    cand, length = port._match_exact_device(_t(text), max_len=max_len)
    cand, length = cand.numpy(), length.numpy()
    assert np.array_equal(length, _longest_previous_factor(text, max_len))
    i = np.flatnonzero(length > 0)
    assert (cand[i] < i).all() and (cand[i] >= 0).all()
    for p in i[:: max(1, i.size // 200)]:
        k, c = length[p], cand[p]
        assert np.array_equal(text[p : p + k], text[c : c + k])


def test_the_run_longer_than_1024_is_matched_at_the_cap():
    # LARGE's 1500-byte run of "q": its second byte matches the first
    # for the rest of the run, which needs all three rank probes
    at = int(np.flatnonzero(LARGE == ord("q"))[0])
    _, length = port._match_exact_device(
        _t(LARGE), max_len=port.match_max_len(LARGE.size, True))
    assert int(length[at + 1]) == 1499


def test_exact_path_has_no_quadratic_tensor():
    from torch.utils._python_dispatch import TorchDispatchMode

    class Largest(TorchDispatchMode):
        most = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor):
                    self.most = max(self.most, t.numel())
            return out

    text = np.frombuffer((_words(20000, 9) + b"\0"), np.uint8)
    n = text.size
    with Largest() as mode:
        port._match_exact_device(_t(text), max_len=4096)
    # the window compares are (n, 32); JAX's chunk routing is n x n/128
    assert mode.most <= 32 * n < n * n // 128


@settings(max_examples=200, deadline=None)
@given(st.data())
def test_commit_walk_matches_jax(data):
    n = data.draw(st.integers(1, 80))
    length = np.array(data.draw(st.lists(st.integers(0, 12), min_size=n,
                                         max_size=n)), np.int64)
    cand = np.array(data.draw(st.lists(st.integers(-1, 80), min_size=n,
                                       max_size=n)), np.int64)
    threshold = data.draw(st.integers(1, 5))
    want = lzss_jax.commit_walk(cand, length, threshold)
    got = port.commit_walk(cand, length, threshold)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("name", list(TEXTS))
def test_factorize_device_matches_jax(name, exact):
    text = TEXTS[name]
    want = lzss_jax.factorize_device(text, 3, exact=exact)
    got = port.factorize_device(text, 3, exact=exact, device=CPU)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_factorize_device_guards():
    z = port.factorize_device(np.zeros(3, np.uint8), 3, device=CPU)
    assert all(a.size == 0 for a in z)
    z = port.factorize_device(SMALL, 0, device=CPU)
    assert all(a.size == 0 for a in z)
    with pytest.raises(ValueError, match="requires len"):
        port.factorize_device(np.zeros((1 << 24) + 1, np.uint8), 3)


@pytest.mark.parametrize("case", [
    (b"ab", [2], [0], [6], 8),  # a copy overlapping its own output
    (b"hello", [], [], [], 5),
    (b"", [], [], [], 0),
    (b"abcd", [4, 7], [1, 5], [3, 2], 9),  # a copy from inside a copy
], ids=["overlap", "literals", "empty", "chained"])
def test_resolve_factors_matches_jax(case):
    lits, fpos, fsrc, flen, n = case
    args = (np.array(bytearray(lits), np.uint8), np.array(fpos, np.int64),
            np.array(fsrc, np.int64), np.array(flen, np.int64), n)
    assert (port.resolve_factors_device(*args, device=CPU)
            == lzss_jax.resolve_factors_device(*args))


@pytest.mark.parametrize("fpos,fsrc,flen", [
    ([2], [2], [3]), ([2], [-1], [3]), ([2], [0], [9]),
], ids=["self", "negative", "past-the-end"])
def test_resolve_factors_rejects_what_is_no_back_reference(fpos, fsrc, flen):
    with pytest.raises(ValueError, match="malformed"):
        port.resolve_factors_device(
            np.frombuffer(b"ab", np.uint8), np.array(fpos), np.array(fsrc),
            np.array(flen), 8, device=CPU)


def test_resolve_factors_of_a_parse_matches_jax():
    pos, src, ln = port.factorize_device(LARGE, 3, device=CPU)
    keep = np.ones(LARGE.size, bool)
    for p, k in zip(pos, ln):
        keep[p : p + k] = False
    args = (LARGE[keep], pos, src, ln, LARGE.size)
    info = {}
    got = port.resolve_factors_device(*args, device=CPU, info=info)
    assert got == lzss_jax.resolve_factors_device(*args) == LARGE.tobytes()
    assert info["rounds"] >= 2


def test_coder_names_match_jax():
    assert NON_CONSUMING_CODER_NAMES == JAX_CODER_NAMES


ALGOS = [f"lzss_lcp(coder={c},comp={m})"
         for c in NON_CONSUMING_CODER_NAMES
         for m in ("psv", "device", "device_fast")]


@pytest.mark.parametrize("algo", ALGOS)
def test_cli_matches_jax_and_each_decodes_the_other(algo):
    want = jax_cli.compress(algo, DATA)
    assert cli.compress(algo, DATA, device=CPU) == want
    for dec in ("host", "device"):
        a = algo[:-1] + f",dec={dec})"
        assert cli.decompress(jax_cli.compress(a, DATA), device=CPU) == DATA
        assert jax_cli.decompress(cli.compress(a, DATA, device=CPU)) == DATA


@pytest.mark.parametrize("algo", [
    "lzss_lcp(ds=compressed)", "lzss_lcp(coder=huff, ds=compressed)",
    "lzss_lcp(coder=gamma, threshold=5)", "lzss_lcp(threshold=1)",
])
def test_options_match_jax(algo):
    out = cli.compress(algo, DATA, device=CPU)
    assert out == jax_cli.compress(algo, DATA)
    assert cli.decompress(out, device=CPU) == DATA


def test_text_ds_matches_jax():
    from tudocomp_tpu.ds.suffix import TextDS as JaxTextDS
    from tudocomp_tpu_torch.ds.suffix import TextDS

    got, want = TextDS(SMALL.tobytes()), JaxTextDS(SMALL.tobytes())
    for name in ("sa", "isa", "plcp", "lcp"):
        g, w = (getattr(d, f"require_{name}")() for d in (got, want))
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    sparse, lcp = got.require_isa_sparse(), got.require_lcp_compressed()
    isa = want.require_isa()
    for i in range(0, SMALL.size, 7):
        assert sparse[i] == isa[i]
        assert lcp[i] == want.require_lcp()[i]


def _stream(*fields) -> bytes:
    """A bit-coder factor stream from (value, width) fields."""
    w = BitWriter()
    for v, bits in fields:
        w.write_int(v, bits)
    return w.getvalue()


@pytest.mark.parametrize("fields,n,error", [
    # a factor at position 0 copying from position 5: no back-reference
    ([(0, 1), (5, 4), (0, 2)], 9, ValueError),
    # 80 literals announced for a text of 1 byte: past the output
    ([(1, 1), (80, 7)] + [(97, 8)] * 80, 1, RuntimeError),
], ids=["forward-copy", "overflow"])
def test_malformed_streams_raise_as_jax(fields, n, error):
    from tudocomp_tpu import native as jax_native
    from tudocomp_tpu_torch import native

    rd = BitReader(_stream(*fields))
    args = (np.packbits(rd._bits), rd.total, 0, n, 3, 4, 2, 7)
    for lib in (native, jax_native):
        with pytest.raises(error):
            lib.lzss_decode_stream(*args)


@pytest.mark.parametrize("data", [b"", b"a", b"abc", b"\x00\xff\x00ab"],
                         ids=["empty", "one", "three", "escaped"])
def test_short_inputs_match_jax(data):
    for algo in ("lzss_lcp", "lzss_lcp(coder=huff,comp=device)"):
        out = cli.compress(algo, data, device=CPU)
        assert out == jax_cli.compress(algo, data)
        assert cli.decompress(out, device=CPU) == data


def test_golden_lzss_lcp_bit():
    # tests/test_golden.py's constant for lzss_lcp(coder=bit)
    got = cli.compress("lzss_lcp(coder=bit)", b"banana banana", raw=True,
                       device=CPU)
    assert got.hex() == "0000000e363ec4c2dc25200e8001"
    assert cli.decompress(got, raw_algo="lzss_lcp(coder=bit)",
                          device=CPU) == b"banana banana"


def test_blocks_of_lzss_lcp_match_jax():
    algo = "blocks(inner=lzss_lcp(coder=bit), b=200)"
    want = jax_cli.compress(algo, DATA)
    assert cli.compress(algo, DATA, device=CPU) == want
    assert cli.decompress(want, device=CPU) == DATA


def test_id_strings_and_listing_match_jax(capsys):
    for algo in ("lzss_lcp", "lzss_lcp(huff, 4, compressed, device, device)",
                 "lzss_lcp(coder=ternary, dec=device)"):
        assert (REGISTRY.evaluate(algo, torch_device=CPU).id_string()
                == JAX_REGISTRY.evaluate(algo).id_string())

    def lines(text):
        """{(type, name): line} of a ``-l`` listing."""
        out, type_ = {}, None
        for ln in text.splitlines():
            if ln.startswith("["):
                type_ = ln.strip("[]")
            elif ln.startswith("  "):
                name = ln.split("(")[0].split(" — ")[0].strip()
                out[type_, name] = ln
        return out

    assert cli.main(["-l"]) == 0
    got = lines(capsys.readouterr().out)
    want = lines(JAX_REGISTRY.doc_listing())
    for key, line in got.items():
        assert line == want[key]
    assert {("compressor", "lzss_lcp"), ("coder", "bit"), ("coder", "huff"),
            ("coder", "gamma")} <= set(got)


@pytest.mark.parametrize("kind", ["gamma", "delta", "ternary", "ascii",
                                  "bit", "huff"])
def test_coders_write_and_read_the_jax_bits(kind):
    from tudocomp_tpu.coders.base import Literals as JaxLiterals
    from tudocomp_tpu.ranges import (
        MinDistributedRange as JaxMDR, Range as JaxRange, bit_r as jbit,
        literal_r as jlit,
    )
    from tudocomp_tpu_torch.coders.base import Literals
    from tudocomp_tpu_torch.ranges import (
        MinDistributedRange, Range, bit_r, literal_r,
    )

    lits = np.frombuffer(b"abracadabra", np.uint8)
    vals = [0, 1, 5, 300, 70000]

    def write(reg, lit_cls, rng, mdr, b_r, l_r, writer):
        env = reg.evaluate(kind, "coder", **(
            {"torch_device": CPU} if reg is REGISTRY else {}))
        enc = env.cls.Encoder(env, writer, lit_cls(lits))
        for v in vals:
            enc.encode(v, rng(1 << 20))
            enc.encode(v + 3, mdr(3, 1 << 20))
            enc.encode(v % 2, b_r)
        enc.encode_array(np.array(vals, np.uint64), rng(1 << 20))
        enc.encode_array(lits, l_r)
        enc.finish()
        return writer.getvalue()

    want = write(JAX_REGISTRY, JaxLiterals, JaxRange, JaxMDR, jbit, jlit,
                 JaxBitWriter())
    got = write(REGISTRY, Literals, Range, MinDistributedRange, bit_r,
                literal_r, BitWriter())
    assert got == want
    env = REGISTRY.evaluate(kind, "coder", torch_device=CPU)
    dec = env.cls.Decoder(env, BitReader(got))
    jenv = JAX_REGISTRY.evaluate(kind, "coder")
    jdec = jenv.cls.Decoder(jenv, JaxBitReader(want))
    for v in vals:
        assert dec.decode(Range(1 << 20)) == jdec.decode(JaxRange(1 << 20))
        assert (dec.decode(MinDistributedRange(3, 1 << 20))
                == jdec.decode(JaxMDR(3, 1 << 20)))
        assert dec.decode(bit_r) == jdec.decode(jbit) == v % 2
    assert np.array_equal(dec.decode_array(Range(1 << 20), len(vals)),
                          jdec.decode_array(JaxRange(1 << 20), len(vals)))
    if hasattr(dec, "decode_remaining_literals"):
        assert (dec.decode_remaining_literals()
                == jdec.decode_remaining_literals() == lits.tobytes())
