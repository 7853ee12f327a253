"""The torch port's TBC2 codec against the JAX package, byte for byte.

The JAX containers come from one module-scoped fixture that uses two
JAX batch shapes only (inputs of at most 8 segments, and exactly 64
segments): each new shape costs the interpret-mode Pallas kernels a
long first compile on the CPU. The port runs on the CPU here, i.e.
through the plain versions of its kernels. Every comparison is exact.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tudocomp_tpu.models.blockcodec as jax_blockcodec
import tudocomp_tpu_torch.models.blockcodec as port_blockcodec
from tudocomp_tpu import native as jax_native
from tudocomp_tpu.coders.huffman import HuffmanTable
from tudocomp_tpu.compressors.rle import rle_encode
from tudocomp_tpu.io.bitio import BitReader, BitWriter
from tudocomp_tpu_torch import BlockCodec
from tudocomp_tpu_torch import native as port_native
from tudocomp_tpu_torch.coders.huffman import HuffmanTable as PortTable
from tudocomp_tpu_torch.io.bitio import BitReader as PortReader
from tudocomp_tpu_torch.io.bitio import BitWriter as PortWriter
from tbc2_cases import CASES, mixed as _mixed

SEG = 2048
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def jax_containers():
    return {name: jax_blockcodec.BlockCodec(**opts).compress(data)
            for name, (data, opts) in CASES.items()}


@pytest.fixture(scope="module")
def port_containers():
    return {name: BlockCodec(device=CPU, **opts).compress(data)
            for name, (data, opts) in CASES.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_container_matches_jax(name, jax_containers, port_containers):
    assert port_containers[name] == jax_containers[name]


@pytest.mark.parametrize("name", list(CASES))
def test_round_trips_across_packages(name, jax_containers, port_containers):
    data, opts = CASES[name]
    port = BlockCodec(device=CPU, **opts)
    assert port.decompress_device(port_containers[name]) == data
    assert port.decompress(port_containers[name]) == data
    # the wire format is the shared state: each package decodes the other
    jax_codec = jax_blockcodec.BlockCodec()
    assert jax_codec.decompress(port_containers[name]) == data
    assert port.decompress_device(jax_containers[name]) == data


def test_jax_device_decoder_reads_port_container(port_containers):
    data, _ = CASES["mixed_5seg"]
    codec = jax_blockcodec.BlockCodec(dec_kernel="scan")
    assert codec.decompress_device(port_containers["mixed_5seg"]) == data


def test_mixed_case_takes_both_escapes():
    data, _ = CASES["mixed_5seg"]
    enc = BlockCodec(device=CPU).encode(data)
    assert enc.rle_raw.any() and enc.huff_raw.any()
    assert (~enc.rle_raw & ~enc.huff_raw).any()


def _hist_spec(data: bytes, segs) -> np.ndarray:
    """Histogram of the escape-selected streams of segments ``segs``."""
    hist = np.zeros(256, np.int64)
    for s in segs:
        seg = np.frombuffer(data[s * SEG : (s + 1) * SEG], np.uint8)
        stream = rle_encode(seg)
        hist += np.bincount(stream if stream.size <= seg.size else seg,
                            minlength=256)
    return hist


def test_hist_cap_straddles_batches(monkeypatch):
    """With the cap inside the second batch, batching changes nothing:
    the histogram is still segments [0:HIST_SEGS:8] (+1 smoothing)."""
    monkeypatch.setattr(port_blockcodec, "HIST_SEGS", 12)
    data = _mixed(64, seed=3)
    batched = BlockCodec(device=CPU, batch_lanes=8)
    enc = batched.encode(data)
    spec = _hist_spec(data, range(0, 12, 8))
    assert enc.hist.tolist() == spec.tolist()
    table = HuffmanTable.from_counts(spec + 1, max_len=16, min_len=3)
    assert enc.table.sym_len.tolist() == table.sym_len.tolist()
    single = BlockCodec(device=CPU).compress(data)
    assert batched.compress(data) == single
    odd = BlockCodec(device=CPU, batch_lanes=5).compress(data)
    assert odd == single


@pytest.mark.slow
def test_hist_cap_straddle_matches_jax(monkeypatch):
    monkeypatch.setattr(port_blockcodec, "HIST_SEGS", 12)
    monkeypatch.setattr(jax_blockcodec, "HIST_SEGS", 12)
    data = _mixed(64, seed=3)
    want = jax_blockcodec.BlockCodec(batch_lanes=8).compress(data)
    assert BlockCodec(device=CPU, batch_lanes=8).compress(data) == want


def test_port_runs_without_jax():
    """Importing the port and round-tripping on the CPU loads neither JAX
    nor the JAX package."""
    code = (
        "import sys\n"
        "import torch\n"
        "from tudocomp_tpu_torch import BlockCodec\n"
        "import tudocomp_tpu_torch.ops\n"
        "c = BlockCodec(device=torch.device('cpu'))\n"
        "data = b'no jax here ' * 500 + bytes(range(256)) * 9\n"
        "assert c.decompress_device(c.compress(data)) == data\n"
        "assert c.decompress(c.compress(data)) == data\n"
        "loaded = [m for m in sys.modules\n"
        "          if m.split('.')[0] in ('jax', 'jaxlib', 'tudocomp_tpu')]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"


def _histograms():
    rng = np.random.default_rng(11)
    sparse = np.zeros(256, np.int64)
    sparse[[3, 97, 98, 200]] = (5, 1000, 1, 77)
    return {"zipf": rng.zipf(1.3, 256).clip(max=1 << 20) + 1,
            "sparse": sparse, "uniform": np.ones(256, np.int64)}


@pytest.mark.parametrize("name", ["zipf", "sparse", "uniform"])
def test_host_copies_match_jax_package(name):
    """The port's own HuffmanTable, BitWriter and BitReader equal the JAX
    package's: the same table bytes, codes, decode LUT and read-back."""
    hist = _histograms()[name]
    port, ref = PortTable.from_counts(hist, 16, 3), HuffmanTable.from_counts(
        hist, 16, 3)
    assert port.sym_code.tolist() == ref.sym_code.tolist()
    assert port.sym_len.tolist() == ref.sym_len.tolist()
    out = {}
    for key, writer, table in (("port", PortWriter(), port),
                               ("jax", BitWriter(), ref)):
        writer.write_compressed_int(123456)
        writer.write_bit(1)
        table.write(writer)
        out[key] = writer.getvalue()
    assert out["port"] == out["jax"]
    for reader, cls in ((PortReader(out["jax"]), PortTable),
                        (BitReader(out["jax"]), HuffmanTable)):
        assert reader.read_compressed_int() == 123456 and reader.read_bit()
        back = cls.read(reader)
        assert back.sym_code.tolist() == ref.sym_code.tolist()
    for a, b in zip(port.build_lut(), ref.build_lut()):
        assert a.tolist() == b.tolist()
    rng = np.random.default_rng(3)
    sym = port.symbols[rng.integers(0, port.symbols.size, 5000)]
    writer = PortWriter()
    writer.write_tokens(port.sym_code[sym], port.sym_len[sym].astype(np.int32))
    payload = np.frombuffer(writer.getvalue(), np.uint8)
    assert (port.fast_decode(payload, sym.size) == sym).all()
    assert (ref.fast_decode(payload, sym.size) == sym).all()


@pytest.mark.parametrize("name", ["mixed_5seg", "sampled_64seg"])
def test_host_decoder_matches_jax_native(name, jax_containers):
    """The port's host TBC2 parser and decoder give the JAX package's
    native runtime's frames and bytes on the JAX package's containers."""
    container = jax_containers[name]
    codec = BlockCodec(device=CPU)
    table, offset, orig_len, *frames = codec._parse(container)
    for got, want in zip(frames, jax_native.tbc2_parse(
            container, _frames_start(container), len(frames[0]))):
        assert got.tolist() == want.tolist()
    got = port_native.tbc2_decode(container, *frames, orig_len, SEG, table,
                                  offset)
    want = jax_native.tbc2_decode(container, *frames, orig_len, SEG,
                                  HuffmanTable.read(_header(container)),
                                  offset)
    assert got == want == CASES[name][0]
    with pytest.raises(ValueError):
        port_native.tbc2_parse(container[:-5], _frames_start(container),
                               len(frames[0]) + 1)


def _header(container: bytes):
    """A BitReader at the JAX package's table in a TBC2 header."""
    from tudocomp_tpu.utils.vbyte import read_vbyte

    n, pos = read_vbyte(container, 4)
    head = BitReader(container[pos : pos + n])
    for _ in range(3):
        head.read_compressed_int()
    assert head.read_bit()
    return head


def _frames_start(container: bytes) -> int:
    from tudocomp_tpu.utils.vbyte import read_vbyte

    n, pos = read_vbyte(container, 4)
    return pos + n
