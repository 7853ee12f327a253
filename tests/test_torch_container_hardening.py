"""Malformed TBC2 containers against the torch port's decoders.

The port's counterpart of the TBC2 cases of
``tests/test_container_hardening.py``, on the same corpus (seed 11):
truncations raise or decode to other bytes, a bad magic raises, and
payload flips complete or raise. Both decoders are held to it: the host
decoder (``decompress``, the port's ``csrc/host/tbc2.cpp``) and the
device path (``decompress_device``, here K4's plain version on the CPU;
``tests/test_torch_cuda.py`` runs K4 itself on the same flips). There is
no checksum in the container, so a flip may decode to other bytes
silently, and the two decoders need not agree on a flipped frame: the
host decoder raises on some malformed frames where the device path
returns bytes, as the reference's do. No JAX is imported.
"""

import numpy as np
import pytest
import torch

from tudocomp_tpu_torch import BlockCodec

CPU = torch.device("cpu")
FLIPS = 32


def hardening_container(device) -> tuple[bytes, bytes]:
    """The reference suite's corpus and its container."""
    rng = np.random.default_rng(11)
    data = (
        b"hardening corpus " * 400
        + bytes(rng.integers(0, 256, 3000, dtype=np.uint8))
        + b"r" * 5000
    )
    return data, BlockCodec(device=device).compress(data)


def flipped(comp: bytes):
    """The reference suite's 32 payload flips of ``comp``."""
    rng = np.random.default_rng(0)
    for _ in range(FLIPS):
        bad = bytearray(comp)
        i = int(rng.integers(8, len(comp)))
        bad[i] ^= int(rng.integers(1, 256))
        yield bytes(bad)


@pytest.fixture(scope="module")
def container():
    return hardening_container(CPU)


DECODERS = ["decompress", "decompress_device"]


@pytest.mark.parametrize("decoder", DECODERS)
def test_truncations_raise_or_differ(container, decoder):
    data, comp = container
    decode = getattr(BlockCodec(device=CPU), decoder)
    for cut in (0, 1, 3, 4, 5, len(comp) // 2, len(comp) - 1):
        try:
            out = decode(comp[:cut])
        except Exception:
            continue  # loud failure is the expected path
        assert out != data  # silent truncation must not round-trip


@pytest.mark.parametrize("decoder", DECODERS)
def test_header_corruption_raises(container, decoder):
    _, comp = container
    bad = b"XXXX" + comp[4:]
    with pytest.raises(Exception):
        getattr(BlockCodec(device=CPU), decoder)(bad)


@pytest.mark.parametrize("decoder", DECODERS)
def test_payload_flip_no_crash(container, decoder):
    """Each flip decodes to some bytes or raises; out-of-bounds writes in
    the host library would crash the process here."""
    _, comp = container
    decode = getattr(BlockCodec(device=CPU), decoder)
    done = 0
    for bad in flipped(comp):
        try:
            out = decode(bad)
        except Exception:
            continue
        assert isinstance(out, bytes)
        done += 1
    assert 0 < done <= FLIPS


def test_corpus_round_trips(container):
    data, comp = container
    codec = BlockCodec(device=CPU)
    assert codec.decompress(comp) == data
    assert codec.decompress_device(comp) == data
