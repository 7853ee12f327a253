"""The port's ESP (``ops/esp.py``, ``ops/esp_vec.py``,
``compressors/esp.py``, ``compressors/esp_dcoding.py``,
``csrc/host/esp.cpp``) against the JAX package's on the CPU. Every
comparison is exact (integers and bytes).

``esp_rounds_jax`` runs only at ``tests/test_esp_jax.py``'s inputs (its
twelve ``Random(17)`` draws and eight structured cases at
``tail_cutoff=1``, and its 9000-byte ``Random(23)`` input at the default
cutoff), so JAX compiles no schedule that its own suite does not. The
many more inputs below are held to the JAX package's host
``esp_rounds`` (native) and ``esp_vec.esp_rounds_vec`` (numpy), which
compile nothing.
"""

import mmap
import random

import numpy as np
import pytest
import torch

from tudocomp_tpu import cli as jax_cli
from tudocomp_tpu import native as jax_native
from tudocomp_tpu.compressors import esp as jax_esp
from tudocomp_tpu.io.bitio import BitWriter as JaxBitWriter
from tudocomp_tpu.ops import esp_vec as jax_vec
from tudocomp_tpu.ops.esp_jax import esp_rounds_jax
from tudocomp_tpu.registry import REGISTRY as JAX_REGISTRY
from tudocomp_tpu.registry import create_algo as jax_create_algo
from tudocomp_tpu_torch import cli, native
from tudocomp_tpu_torch.compressors import esp as port_esp
from tudocomp_tpu_torch.compressors.esp_dcoding import recover_D
from tudocomp_tpu_torch.io.bitio import BitReader, BitWriter
from tudocomp_tpu_torch.ops import esp as port_ops
from tudocomp_tpu_torch.ops import esp_vec as port_vec
from tudocomp_tpu_torch.registry import REGISTRY
from tudocomp_tpu_torch.registry import create_algo
from tudocomp_tpu_torch.utils.bits import bits_for
from test_esp_dcoding import VARIANTS, _cases
from test_esp_jax import _gen
from test_golden import GOLDEN

CPU = "cpu"


def _jax_draws():
    """test_esp_jax.py's inputs: the twelve Random(17) draws and the
    eight structured cases (tail_cutoff=1 there)."""
    rng = random.Random(17)
    draws = [_gen(rng, rng.randint(2, 900), rng.choice([3, 8, 250]))
             for _ in range(12)]
    return draws + [
        b"", b"a", b"ab", b"aaaa" * 40, b"abcabcabc" * 200,
        bytes(range(256)) * 8, b"\x00" * 800 + b"\x01" * 800,
        b"to be or not to be that is the question " * 40,
    ]


JAX_INPUTS = _jax_draws()


def _same(got, want):
    rules_g, root_g, empty_g = got
    rules_w, root_w, empty_w = want
    assert empty_g == empty_w
    assert rules_g.dtype == np.int64
    assert np.array_equal(rules_g, np.asarray(rules_w, np.int64))
    if not empty_w:
        assert root_g == root_w


@pytest.mark.parametrize("i", range(len(JAX_INPUTS)))
def test_device_rounds_match_esp_rounds_jax(i):
    """Every round on the device (tail_cutoff=1): rules, root and
    ``empty`` equal JAX's device rounds and the host loop."""
    data = JAX_INPUTS[i]
    got = port_ops.esp_rounds_device(data, tail_cutoff=1, device=CPU)
    _same(got, esp_rounds_jax(data, tail_cutoff=1))
    _same(got, jax_esp.esp_rounds(data))


def test_default_tail_handoff_matches_jax():
    """test_esp_jax.py's default-cutoff input: device rounds, then the
    host tail."""
    data = _gen(random.Random(23), 9000, 8)
    stats = {}
    got = port_ops.esp_rounds_device(data, device=CPU, stats=stats)
    _same(got, esp_rounds_jax(data))
    assert stats["device_rounds"] >= 1 and stats["tail_rounds"] >= 1


def _numpy_input(n: int, sigma: int, seed: int) -> bytes:
    """Runs and noise over ``sigma`` symbols (byte values spread over
    0..255), ``n`` bytes."""
    rng = np.random.default_rng(seed)
    sym = rng.choice(256, sigma, replace=False).astype(np.uint8)
    lens = rng.integers(1, 7, n)
    lens[rng.random(n) < 0.6] = 1
    runs = np.repeat(rng.integers(0, sigma, n), lens)[:n]
    return sym[runs].tobytes()


NUMPY_CASES = [(n, sigma) for n in (4095, 4097, 8191, 8193)
               for sigma in (2, 3, 8, 250)] + [(2, 2), (3, 250), (700, 3)]


@pytest.mark.parametrize("n,sigma", NUMPY_CASES)
def test_device_rounds_match_host_and_spec(n, sigma):
    """Lengths that straddle the 4096 cutoff and twice it, alphabets 2,
    3, 8 and 250: the port at tail_cutoff 1 and at the default equals
    the JAX package's native loop and its numpy spec, and the port's
    own native loop and spec."""
    data = _numpy_input(n, sigma, seed=n * 7 + sigma)
    want = jax_esp.esp_rounds(data)
    _same(jax_vec.esp_rounds_vec(data), want)
    stats = {}
    _same(port_ops.esp_rounds_device(data, tail_cutoff=1, device=CPU,
                                     stats=stats), want)
    assert stats["tail_rounds"] == 0
    for cutoff in (4096, 64):
        _same(port_ops.esp_rounds_device(data, tail_cutoff=cutoff,
                                         device=CPU), want)
    _same(port_esp.esp_rounds(data), want)
    _same(port_vec.esp_rounds_vec(data), want)


def test_device_round_count_is_the_host_loop_less_its_tail():
    """The device rounds plus the tail's are the host loop's rounds."""
    data = _numpy_input(20000, 3, seed=5)
    host = {}
    port_ops.esp_rounds_device(data, tail_cutoff=1, device=CPU, stats=host)
    split = {}
    port_ops.esp_rounds_device(data, tail_cutoff=4096, device=CPU,
                               stats=split)
    assert split["device_rounds"] + split["tail_rounds"] \
        == host["device_rounds"]
    assert split["device_rounds"] >= 1 and split["tail_rounds"] >= 1


def test_round_by_round_matches_jax_spec():
    """Each round of the port's ``esp_vec`` equals JAX's: block starts,
    the 1-block merge, the round's rules and the next layer; and the
    device round's rules and layer equal the spec's."""
    data = _numpy_input(6000, 8, seed=9)
    s = np.frombuffer(data, np.uint8).astype(np.int64)
    base, alphabet, rounds = 256, 256, 0
    while s.size > 1:
        st = port_vec.round_block_starts(s, alphabet)
        assert np.array_equal(st, jax_vec.round_block_starts(s, alphabet))
        lens = np.diff(np.append(np.flatnonzero(st), s.size))
        assert np.array_equal(port_vec.merge_one_blocks_vec(lens),
                              jax_vec.merge_one_blocks_vec(lens))
        top, rules = port_vec.esp_round_vec(s, alphabet)
        top_w, rules_w = jax_vec.esp_round_vec(s, alphabet)
        assert np.array_equal(top, top_w) and np.array_equal(rules, rules_w)
        a = rules[:, 0]
        rules[:, 0] = np.where(a < 0, base + (-a - 1), a)
        dev_top, dev_rules, r = port_ops._esp_round(
            torch.from_numpy(s.copy()), port_esp.iter_log(alphabet), base,
            rounds == 0)
        assert r == rules.shape[0]
        assert np.array_equal(dev_rules.numpy(), rules)
        assert np.array_equal(dev_top.numpy(), base + top)
        s = base + top
        base += rules.shape[0]
        alphabet = base
        rounds += 1
    assert rounds >= 5
    k = np.arange(-2, 12)
    for L in range(1, 9):
        assert np.array_equal(port_vec.eager13_starts(k, L),
                              jax_vec.eager13_starts(k, L))


def test_stable_sort_of_packed_keys_orders_as_lexsort():
    """A stable sort of (a << 31) | b over rows in block order gives
    JAX's three-key order (a, b, sequence), and so does round 1's
    a * 256 + b."""
    rng = np.random.default_rng(4)
    for hi, pack in ((1 << 30, lambda a, b: (a << 31) | b),
                     (256, lambda a, b: a * 256 + b)):
        a = rng.integers(0, 5, 4000) * (hi // 5)
        b = rng.integers(0, 7, 4000) * (hi // 7)
        _, perm = torch.sort(torch.from_numpy(pack(a, b)), stable=True)
        want = np.lexsort((np.arange(a.size), b, a))
        assert np.array_equal(perm.numpy(), want)


def test_length_guard_and_empty_input(tmp_path):
    """``len(data) >= 2**30 - 512`` raises before any byte is read (a
    sparse file, mapped); the empty input is JAX's empty grammar."""
    path = tmp_path / "big.bin"
    with open(path, "wb") as f:
        f.truncate((1 << 30) - 512)
    with open(path, "rb") as f, \
            mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as big:
        with pytest.raises(ValueError, match="2\\*\\*30 - 512"):
            port_ops.esp_rounds_device(big, device=CPU)
    _same(port_ops.esp_rounds_device(b"", device=CPU), esp_rounds_jax(b""))


def test_natives_match_jax():
    """esp_rounds, slp_derive, slp_dep_sort and monotone_decompose equal
    the JAX package's."""
    rng = np.random.default_rng(8)
    for data in (b"abcabcabc", _numpy_input(5000, 3, 1),
                 bytes(rng.integers(0, 256, 3000, dtype=np.uint8))):
        rules, root = native.esp_rounds(data)
        rules_w, root_w = jax_native.esp_rounds(data)
        assert root == root_w and np.array_equal(rules, rules_w)
        assert native.slp_derive(rules, root) == data \
            == jax_native.slp_derive(rules, root)
        srt, sroot = native.slp_dep_sort(rules, root)
        srt_w, sroot_w = jax_native.slp_dep_sort(rules, root)
        assert sroot == sroot_w and np.array_equal(srt, srt_w)
        assert native.slp_derive(srt, sroot) == data
    for n in (0, 1, 2, 17, 400):
        sis = rng.permutation(n).astype(np.int64)
        got, want = native.monotone_decompose(sis), \
            jax_native.monotone_decompose(sis)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert native.esp_rounds(b"") is None
    with pytest.raises(ValueError, match="invalid SLP rule"):
        native.slp_derive(np.array([[97, 300]], np.int64), 257)
    with pytest.raises(ValueError, match="cycle"):
        native.slp_dep_sort(np.array([[257, 97], [256, 98]], np.int64), 257)


IPD_PIECES = [
    b"abcabcabcabcabc",
    np.random.default_rng(21).choice(np.frombuffer(b"acgt", np.uint8), 600)
    .astype(np.uint8).tobytes(),
    bytes(np.random.default_rng(22).integers(0, 256, 400, dtype=np.uint8)),
    b"zzzzzzzzzzzz",
]


@pytest.mark.parametrize("ipd", ["std_unordered_map", "hash_map",
                                 "dynamic_size"])
def test_ipd_python_loop_matches_jax(ipd):
    """The port's Python round loop over each pair dictionary gives the
    JAX package's grammar."""
    for data in IPD_PIECES:
        want = jax_esp.esp_rounds(data)
        got = port_esp.esp_rounds_loop(
            data, ipd=REGISTRY.instantiate(ipd, "ipd", torch_device=CPU))
        _same(got, want)


def test_esp_rounds_takes_the_loop_when_the_library_has_no_grammar(
        monkeypatch):
    data = IPD_PIECES[1]
    want = jax_esp.esp_rounds(data)
    monkeypatch.setattr(native, "esp_rounds", lambda data: None)
    _same(port_esp.esp_rounds(data), want)
    _same(port_esp.esp_rounds(b""), jax_esp.esp_rounds(b""))


@pytest.mark.parametrize("variant", VARIANTS)
def test_dcoding_writes_jax_bits(variant):
    """Every ``d_coding`` writes the JAX package's bits for
    test_esp_dcoding.py's cases and decodes them."""
    for rhs in _cases():
        width = bits_for(int(rhs.max(initial=1)))
        out, out_w = BitWriter(), JaxBitWriter()
        REGISTRY.instantiate(variant, "d_coding",
                             torch_device=CPU).encode(rhs, out, width)
        JAX_REGISTRY.instantiate(variant, type="d_coding").encode(
            rhs, out_w, width)
        blob = out.getvalue()
        assert blob == out_w.getvalue(), variant
        dec = REGISTRY.instantiate(variant, "d_coding",
                                   torch_device=CPU).decode(
            BitReader(blob), width, rhs.size)
        assert np.array_equal(np.asarray(dec, np.int64), rhs)


def test_recover_d_inverts_both_decompositions():
    rng = np.random.default_rng(3)
    for name in ("optimal", "greedy"):
        strat = REGISTRY.instantiate(name, "subseq", torch_device=CPU)
        sis = rng.permutation(300).astype(np.int64)
        dpi, b = strat.decompose(sis)
        dpi_w, b_w = JAX_REGISTRY.instantiate(
            name, type="subseq").decompose(sis)
        assert np.array_equal(dpi, dpi_w) and np.array_equal(b, b_w)
        vals = np.sort(rng.integers(0, 1000, sis.size))
        dsi = np.empty_like(dpi)
        dsi[sis] = dpi
        D = np.empty(sis.size, np.int64)
        D[sis] = np.arange(sis.size)
        assert np.array_equal(recover_D(dpi, dsi, b, vals), vals[D])


D_CODINGS = ["plain", "diff", "wavelet_tree", "succinct",
             "succinct(subseq=greedy)", "succinct(dx_coder=plain)",
             "succinct(dx_coder=huffman)", "huffman", "arithmetic",
             "range_fit"]
ALGOS = (["esp", "esp(slp_coder=plain)", "esp(ipd=hash_map)",
          "esp(ipd=dynamic_size)", "esp(ipd=std_unordered_map)"]
         + [f"esp(slp_coder=sorted(d_coding={d}))" for d in D_CODINGS])
CONTAINER_DATA = [
    b"", b"a", b"abcabcabc", b"to be or not to be " * 64,
    _numpy_input(5000, 4, 2),
    bytes(np.random.default_rng(6).integers(0, 256, 2000, dtype=np.uint8)),
]


@pytest.mark.parametrize("algo", ALGOS)
def test_containers_match_jax(algo):
    """Each container equals the JAX package's, and each package decodes
    the other's. The port's ``rounds=device`` container equals JAX's
    ``rounds=host`` one (which JAX's suite pins to its own device
    container)."""
    for data in CONTAINER_DATA:
        want = jax_cli.compress(algo, data)
        got = cli.compress(algo, data, device=CPU)
        assert got == want, (algo, len(data))
        assert cli.decompress(want, device=CPU) == data
        assert jax_cli.decompress(got) == data
        dev_algo = algo[:-1] + ",rounds=device)" if algo.endswith(")") \
            else algo + "(rounds=device)"
        assert cli.compress(dev_algo, data, raw=True, device=CPU) \
            == jax_cli.compress(algo, data, raw=True)


def test_rounds_device_container_matches_jax_device():
    """test_esp_jax.py's roundtrip input: the port's and JAX's
    ``rounds=device`` containers are equal."""
    data = (b"esp device rounds produce the identical grammar " * 60
            + bytes(range(0, 250, 3)) * 4)
    jax_dev = JAX_REGISTRY.instantiate("esp(rounds=device)")
    port_dev = REGISTRY.instantiate("esp(rounds=device)", torch_device=CPU)
    blob = port_dev.compress(data)
    assert blob == jax_dev.compress(data)
    assert port_dev.decompress(blob) == data


ESP_GOLDEN = [g for g in GOLDEN if g[0].startswith("esp")]


@pytest.mark.parametrize("algo,data,expected", ESP_GOLDEN,
                         ids=[g[0] for g in ESP_GOLDEN])
def test_golden_esp(algo, data, expected):
    blob = cli.compress(algo, data, raw=True, device=CPU)
    assert blob.hex() == expected
    assert cli.decompress(blob, raw_algo=algo, device=CPU) == data


def test_each_cli_decodes_the_others_file(tmp_path):
    data = _numpy_input(9000, 8, 12)
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    for algo in ("esp", "esp(rounds=device,slp_coder=plain)"):
        port_out, jax_out = tmp_path / "p.tdc", tmp_path / "j.tdc"
        assert cli.main([str(src), "--device", CPU, "-a", algo, "-o",
                         str(port_out), "-f"]) == 0
        assert jax_cli.main([str(src), "-a", algo.replace("rounds=device,",
                                                          ""),
                             "-o", str(jax_out), "-f"]) == 0
        want = jax_out.read_bytes()
        if "rounds=device" in algo:
            # the header names the option; the payload is the host's
            got = port_out.read_bytes()
            assert got.split(b"%", 1)[1] == want.split(b"%", 1)[1]
        else:
            assert port_out.read_bytes() == want
        assert jax_cli.main([str(port_out), "-d", "-o",
                             str(tmp_path / "a.out"), "-f"]) == 0
        assert cli.main([str(jax_out), "--device", CPU, "-d", "-o",
                         str(tmp_path / "b.out"), "-f"]) == 0
        assert (tmp_path / "a.out").read_bytes() == data
        assert (tmp_path / "b.out").read_bytes() == data


def test_device_rounds_need_cuda_by_default():
    """``rounds=device`` runs on CUDA unless the caller names the CPU,
    and raises where CUDA is absent; ``rounds=host`` needs no device."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where CUDA is absent")
    data = b"abcabcabc" * 50
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.compress("esp(rounds=device)", data)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_ops.esp_rounds_device(data)
    assert cli.decompress(cli.compress("esp", data)) == data
    assert create_algo(port_esp.EspCompressor).compress(data) \
        == jax_create_algo(jax_esp.EspCompressor).compress(data)


@pytest.mark.parametrize("width", [1, 3, 8, 13, 40, 64])
def test_int_vector_matches_jax(width):
    """``ds/int_vector.py`` (the ``dynamic_size`` table's storage) packs,
    repacks and widens as the JAX package's does."""
    from tudocomp_tpu.ds import int_vector as jax_iv
    from tudocomp_tpu_torch.ds import int_vector as port_iv

    rng = np.random.default_rng(width)
    vals = rng.integers(0, 1 << min(width, 63), 50, dtype=np.uint64)
    got, want = port_iv.IntVector(vals, width), jax_iv.IntVector(vals, width)
    assert got.to_bytes() == want.to_bytes()
    assert np.array_equal(
        port_iv.IntVector.from_bytes(got.to_bytes(), width, 50).as_array(),
        vals)
    assert got.compress().width == want.compress().width
    bits = rng.integers(0, 2, 37, dtype=np.uint64)
    assert port_iv.BitVector(bits).to_bytes() \
        == jax_iv.BitVector(bits).to_bytes()
    dv, dw = port_iv.DynamicIntVector(), jax_iv.DynamicIntVector()
    for v in vals[:8].tolist():
        dv.append(v)
        dw.append(v)
        assert dv.width == dw.width
    assert dv.to_bytes() == dw.to_bytes()
    with pytest.raises(ValueError):
        port_iv.IntVector([8], 3)


def test_hash_framework_matches_jax():
    """Every registered hasher, size manager and prober, the rolling
    hashes and ``HashMap`` over each combination agree with the JAX
    package's."""
    from tudocomp_tpu.utils import hash as jax_hash
    from tudocomp_tpu_torch.utils import hash as port_hash

    keys = [0, 1, 97, (5 << 32) | 7, (1 << 63) + 12345, (1 << 64) - 2]
    arr = np.asarray(keys, np.uint64)
    for kind in ("hash_function", "hash_manager", "hash_prober"):
        assert REGISTRY.names(kind) == JAX_REGISTRY.names(kind)
    for name in REGISTRY.names("hash_function"):
        got = REGISTRY.instantiate(name, "hash_function", torch_device=CPU)
        want = JAX_REGISTRY.instantiate(name, type="hash_function")
        assert [got.hash(k) for k in keys] == [want.hash(k) for k in keys]
        assert np.array_equal(got.hash_arr(arr), want.hash_arr(arr))
    for roll in ("WordpackRollingHash", "KarpRabinHash"):
        g, w = getattr(port_hash, roll)(3), getattr(jax_hash, roll)(3)
        for c in b"rolling":
            g, w = g.extended(c), w.extended(c)
            assert g.key() == w.key()
    for manager in REGISTRY.names("hash_manager"):
        for prober in REGISTRY.names("hash_prober"):
            got = port_hash.HashMap(
                manager=REGISTRY.instantiate(manager, "hash_manager",
                                             torch_device=CPU),
                prober=REGISTRY.instantiate(prober, "hash_prober",
                                            torch_device=CPU))
            want = jax_hash.HashMap(
                manager=JAX_REGISTRY.instantiate(manager,
                                                 type="hash_manager"),
                prober=JAX_REGISTRY.instantiate(prober, type="hash_prober"))
            for i, k in enumerate(keys + list(range(200, 260))):
                got.insert(k, i)
                want.insert(k, i)
            assert got.m == want.m and len(got) == len(want)
            assert np.array_equal(got.keys, want.keys)
            assert [got.get(k) for k in keys] == [want.get(k) for k in keys]


def test_check_kraft_holds_the_huffman_d_coding_lengths():
    """The port's ``check_kraft`` (armed by the suite's TDC_PARANOID)
    accepts an optimal code and rejects an overfull or a short one, as
    the JAX package's does."""
    from tudocomp_tpu.debug import check_kraft as jax_check
    from tudocomp_tpu_torch.debug import InvariantError, check_kraft

    check_kraft(np.array([1, 2, 3, 3]))
    for bad in ([1, 1, 2], [2, 2, 2], [0, 1]):
        with pytest.raises(InvariantError):
            check_kraft(np.array(bad))
        with pytest.raises(AssertionError):
            jax_check(np.array(bad))
