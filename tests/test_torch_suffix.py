"""The port's suffix array, ISA and BWT (``ops/suffix.py``) against
``tudocomp_tpu/ops/suffix_jax.py`` on the CPU, and the port's host SA-IS
and BWT decode against the JAX package's ``ds`` and ``native``. Every
comparison is exact.

The texts are ``tests/test_suffix_device.py``'s ``CASES`` and a few
seeded random texts of at most 4096 bytes; each distinct length costs
the JAX functions one compile.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tudocomp_tpu import native as jax_native
from tudocomp_tpu.ds.bwt import bwt_decode as jax_bwt_decode
from tudocomp_tpu.ds.suffix import suffix_array as jax_suffix_array
from tudocomp_tpu.ops import suffix_jax
from tudocomp_tpu_torch import native as port_native
from tudocomp_tpu_torch.ds.bwt import bwt_forward, compute_lf
from tudocomp_tpu_torch.ds.suffix import suffix_array
from tudocomp_tpu_torch.ops import suffix as port

from tests.test_suffix_device import CASES


def _random_texts():
    rng = np.random.default_rng(41)
    return [
        bytes(rng.integers(1, 5, 777, dtype=np.uint8)) + b"\0",
        (b"abcab" * 300)[:1499] + b"\0",
        bytes(rng.integers(1, 256, 4095, dtype=np.uint8)) + b"\0",
        # long runs: many doubling rounds
        b"a" * 900 + b"b" * 600 + b"\0",
    ]


TEXTS = CASES + _random_texts()
IDS = [f"n{len(t)}_{i}" for i, t in enumerate(TEXTS)]


def _port(text: bytes) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(text, np.uint8).copy())


@pytest.mark.parametrize("text", TEXTS, ids=IDS)
def test_sa_isa_bwt_unbwt_match_jax(text):
    arr = np.frombuffer(text, np.uint8)
    t = _port(text)
    sa_j = np.asarray(suffix_jax.suffix_array_device(jnp.asarray(arr)))
    info = {}
    sa = port.suffix_array_device(t, info)
    assert sa.dtype == torch.int32
    np.testing.assert_array_equal(sa.numpy(), sa_j)
    np.testing.assert_array_equal(sa.numpy(), jax_suffix_array(arr))
    assert info["rounds"] >= 0

    isa_j = np.asarray(suffix_jax.isa_device(jnp.asarray(sa_j)))
    isa = port.isa_device(sa)
    np.testing.assert_array_equal(isa.numpy(), isa_j)

    bwt_j = np.asarray(suffix_jax.bwt_device(jnp.asarray(arr),
                                             jnp.asarray(isa_j)))
    bwt = port.bwt_device(t, isa)
    assert bwt.dtype == torch.uint8
    np.testing.assert_array_equal(bwt.numpy(), bwt_j)
    np.testing.assert_array_equal(bwt.numpy(), arr[(sa_j - 1) % arr.size])

    un_j = np.asarray(suffix_jax.unbwt_device(jnp.asarray(bwt_j)))
    un = port.unbwt_device(bwt)
    np.testing.assert_array_equal(un.numpy(), un_j)
    assert un.numpy().tobytes() == text[:-1]


def test_round_count_is_that_of_the_doubling():
    """Distinct bytes need no doubling round; a run of n equal bytes
    needs ceil(log2 n) of them."""
    info = {}
    port.suffix_array_device(_port(bytes(range(1, 200)) + b"\0"), info)
    assert info["rounds"] == 0
    port.suffix_array_device(_port(b"a" * 1000), info)
    assert info["rounds"] == 10


ISA_RANKS_TEXTS = [
    np.random.default_rng(17).integers(97, 101, n, dtype=np.uint8).tobytes()
    for n in (1, 7, 200, 515)
] + [(b"abcab" * 300)[:1499] + b"\0"]


@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("L", [8, 32])
@pytest.mark.parametrize("text", ISA_RANKS_TEXTS,
                         ids=[f"n{len(t)}" for t in ISA_RANKS_TEXTS])
def test_isa_ranks_match_jax(text, L, full):
    arr = np.frombuffer(text, np.uint8)
    sa_j, isa_j, ranks_j = suffix_jax.suffix_array_isa_ranks(
        jnp.asarray(arr), L=L, full=full)
    sa, isa, ranks = port.suffix_array_isa_ranks(_port(text), L=L,
                                                 full=full)
    np.testing.assert_array_equal(sa.numpy(), np.asarray(sa_j))
    np.testing.assert_array_equal(isa.numpy(), np.asarray(isa_j))
    assert sorted(ranks) == sorted(ranks_j)
    for q in ranks_j:
        assert ranks[q].dtype == torch.int32
        np.testing.assert_array_equal(ranks[q].numpy(),
                                      np.asarray(ranks_j[q]))
    if full:
        np.testing.assert_array_equal(
            sa.numpy(), np.asarray(suffix_jax.suffix_array_device(
                jnp.asarray(arr))))


def test_suffix_ops_follow_the_input_device():
    t = _port(b"banana\0")
    assert port.suffix_array_device(t).device == t.device
    with pytest.raises(ValueError, match="u8"):
        port.suffix_array_device(t.to(torch.int32))
    with pytest.raises(ValueError, match="length"):
        port.suffix_array_device(t[:0])


def _host_cases():
    rng = np.random.default_rng(17)
    return [
        b"", b"a", b"banana\x00", b"aaaaaaaaaa", b"ab" * 700,
        bytes(rng.integers(0, 256, 4000, dtype=np.uint8)),
        bytes(rng.integers(0, 2, 6000, dtype=np.uint8)),
        rng.choice(np.frombuffer(b"acgt", np.uint8), 5000)
        .astype(np.uint8).tobytes() + b"\x00",
    ]


@pytest.mark.parametrize("data", _host_cases(),
                         ids=[f"n{len(d)}" for d in _host_cases()])
def test_host_sais_matches_jax_package(data):
    t = np.frombuffer(data, np.uint8)
    sa = suffix_array(t)
    np.testing.assert_array_equal(sa, jax_suffix_array(t))
    if t.size:
        assert sa.dtype == np.int32
        np.testing.assert_array_equal(port_native.suffix_array(t),
                                      jax_native.suffix_array(t))
        np.testing.assert_array_equal(np.sort(sa), np.arange(t.size))


@pytest.mark.parametrize("data", [
    b"banana\x00", b"x\x00", b"\x00",
    b"mississippi river mississippi delta\x00",
    bytes(np.random.default_rng(29).integers(1, 255, 3000,
                                             dtype=np.uint8)) + b"\x00",
    b"a" * 700 + b"b" * 700 + b"\x00",
])
def test_host_bwt_decode_matches_jax_package(data):
    t = np.frombuffer(data, np.uint8)
    bwt = bwt_forward(t, suffix_array(t))
    lf = compute_lf(bwt)
    np.testing.assert_array_equal(np.sort(lf), np.arange(t.size))
    got = port_native.bwt_decode(bwt.tobytes())
    assert got == jax_native.bwt_decode(bwt.tobytes())
    assert got == jax_bwt_decode(bwt.tobytes()) == data[:-1]
