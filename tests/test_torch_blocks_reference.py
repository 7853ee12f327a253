"""The port's block container (``blocks(inner=chain(first=bwt(device=true),
second=tbc2), b=N)``, bzip2 -9's layout at N = 900,000) against the
benchmark's plain reference (``benchmark/reference/blocks.py``), and its
per-block phases, on the CPU at small block sizes.

Blocks of 32 KiB and more take the BWT's device path (``ops/suffix.py``
on the CPU), smaller ones the host's SA-IS. Imports nothing of JAX.
"""

import json
import re
import threading
import time
from collections import Counter

import pytest
import torch

from benchmark import spec
from benchmark.cell import reference
from benchmark.corpora import dna
from benchmark.reference import blocks as ref_blocks
from tests.tbc2_cases import mixed
from tudocomp_tpu_torch import cli
from tudocomp_tpu_torch.compressors import blocks as blocks_mod
from tudocomp_tpu_torch.compressors.bwt import BWTCompressor
from tudocomp_tpu_torch.stats import StatPhase

#: the DNA of the benchmark's bwt-tbc2-dna configuration
CORPUS = spec.cell("bwt-tbc2-dna.bulk").config["corpus"]
INNER = [{"stage": "bwt"}, {"stage": "tbc2", "offset": 0, "min_code_len": 3}]
CPU = [torch.profiler.ProfilerActivity.CPU]


def _dna(n: int, seed: int) -> bytes:
    gen = torch.Generator()
    gen.manual_seed(seed)
    return dna.generate(gen, n, CORPUS).numpy().tobytes()


def _algo(b: int) -> str:
    return f"blocks(inner=chain(first=bwt(device=true), second=tbc2), b={b})"


def _header(b: int) -> bytes:
    return (f"blocks(inner=chain(first=bwt(device=true), second=tbc2("
            f"offset=0, min_code_len=3, dec=auto)), b={b})").encode()


#: bzip2 -9's deployment: the benchmark's configuration
CONFIG = spec.cell("bwt-tbc2-dna.blocks900k").config


#: name -> (input, block size): DNA and the codec tests' texts; a last
#: block shorter than the rest, blocks under one 2 KiB segment, an input
#: shorter than one block, blocks on both sides of the device path's
#: 32 KiB
CASES = {
    "dna_b4096": (_dna(30_000, 1), 4096),
    "dna_b4097": (_dna(30_000, 2), 4097),
    "dna_b2000": (_dna(9_000, 3), 2000),
    "dna_shorter_than_a_block": (_dna(3_000, 4), 4096),
    "dna_device_blocks": (_dna(100_000, 5), 40_000),
    "mixed_b4096": (mixed(9, seed=4)[:-777], 4096),
    "all_equal_b4097": (b"e" * 20_000, 4097),
    "noise_b2000": (bytes(range(256)) * 30, 2000),
    "one_byte": (b"x", 4096),
    "empty": (b"", 4096),
}
BWT_DEVICE_MIN = BWTCompressor.DEVICE_MIN


def test_cases_cover_both_bwt_paths():
    b = CASES["dna_device_blocks"][1]
    assert b >= BWT_DEVICE_MIN > CASES["dna_b4097"][1]


@pytest.mark.parametrize("name", CASES)
def test_port_equals_the_reference(name):
    data, b = CASES[name]
    got = cli.compress(_algo(b), data, device="cpu")
    want = _header(b) + b"%" + ref_blocks.compress(data, "cpu", b=b,
                                                    inner=INNER)
    assert got == want
    assert got.count(b"TBC2") >= -(-len(data) // b)


@pytest.mark.parametrize("name", CASES)
def test_blocks_flag_equals_the_explicit_string(name):
    data, b = CASES[name]
    assert cli.compress("bwt(device=true):tbc2", data, blocks=b,
                        device="cpu") == cli.compress(_algo(b), data,
                                                      device="cpu")


@pytest.mark.parametrize("name", CASES)
def test_decompress_restores(name):
    data, b = CASES[name]
    container = cli.compress(_algo(b), data, device="cpu")
    assert cli.decompress(container, device="cpu") == data


def test_configuration_is_the_port_at_900000():
    """bzip2 -9's block size through the harness's reference, on an
    input shorter than its one block."""
    assert CONFIG["algorithm"] == _algo(900_000)
    assert CONFIG["header"].encode() == _header(900_000)
    assert CONFIG["corpus"] == CORPUS
    data = _dna(60_000, 6)
    got = cli.compress(CONFIG["algorithm"], data, device="cpu")
    assert got == reference(CONFIG, data, "cpu")
    assert cli.decompress(got, device="cpu") == data


def _round_trip_log(algo: str, data: bytes):
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=CPU):
        container = cli.compress(algo, data, device="cpu")
        assert cli.decompress(container, device="cpu") == data
    return container, [r for r in StatPhase.recorded() if r["start"] >= t0]


def _frames_bytes(container: bytes, b: int) -> int:
    """The container's bytes after its header and the TBK1 head."""
    payload = container[container.index(b"%") + 1:]
    return len(payload) - len(ref_blocks.MAGIC) - (b.bit_length() + 6) // 7


@pytest.mark.parametrize("name", ["dna_b4097", "dna_device_blocks"])
def test_one_phase_a_block_with_its_counters(name):
    data, b = CASES[name]
    container, log = _round_trip_log(_algo(b), data)
    n = -(-len(data) // b)
    for phase, raw, frame, call in (
            ("blocks.compress_block", "bytes_in", "bytes_out", "compress"),
            ("blocks.decompress_block", "bytes_out", "bytes_in",
             "decompress")):
        recs = sorted((r for r in log if r["name"] == phase),
                      key=lambda r: r["start"])
        assert [r["stats"]["index"] for r in recs] == list(range(n))
        assert [r["stats"][raw] for r in recs] == [
            len(data[i:i + b]) for i in range(0, len(data), b)]
        assert sum(r["stats"][frame] for r in recs) == _frames_bytes(
            container, b)
        # the serial loop's phases sit in the CLI call's phase
        parents = {r["parent"] for r in recs}
        assert [r["name"] for r in log if r["id"] in parents] == [call]
    assert not [r for r in log if re.fullmatch(r"block \d+", r["name"])]


def test_no_numbered_block_phase_in_the_stats_tree(tmp_path, capsys):
    data, b = CASES["dna_b4096"]
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    out = tmp_path / "in.tdc"
    assert cli.main([str(src), "-a", "bwt(device=true):tbc2", "--blocks",
                     str(b), "--stats", "--device", "cpu", "-f", "-o",
                     str(out)]) == 0
    err = capsys.readouterr().err
    tree = json.loads(err[err.index("{"): err.rindex("}") + 1])

    def walk(node):
        yield node["title"]
        for sub in node["sub"]:
            yield from walk(sub)

    titles = Counter(walk(tree))
    assert titles["blocks.compress_block"] == -(-len(data) // b)
    assert not [t for t in titles if re.fullmatch(r"block \d+", t)]
    assert out.read_bytes() == cli.compress(_algo(b), data, device="cpu")


@pytest.mark.parametrize("workers", [2, 3])
def test_threaded_blocks_open_their_phases_on_the_workers(workers,
                                                          monkeypatch):
    """With ``workers`` > 1 each block's phase is a root on the worker
    thread that runs it, with the same counters as the serial loop."""
    seen, lock = [], threading.Lock()

    class Spy(StatPhase):
        def __exit__(self, *exc):
            super().__exit__(*exc)
            with lock:
                seen.append((self.title, threading.get_ident(),
                             self.parent, dict(self.stats)))

    data, b = CASES["dna_b4097"]
    container = cli.compress(_algo(b), data, device="cpu")
    payload = container[container.index(b"%") + 1:]
    monkeypatch.setattr(blocks_mod, "StatPhase", Spy)
    comp = cli._instantiate(_algo(b), threads=workers, device="cpu")
    assert comp.compress(data) == payload
    assert comp.decompress(payload) == data
    n = -(-len(data) // b)
    main = threading.get_ident()
    for phase, raw, frame in (("blocks.compress_block", "bytes_in",
                               "bytes_out"),
                              ("blocks.decompress_block", "bytes_out",
                               "bytes_in")):
        recs = [s for s in seen if s[0] == phase]
        assert sorted(s[3]["index"] for s in recs) == list(range(n))
        assert all(t != main and parent is None for _, t, parent, _ in recs)
        by_index = {s[3]["index"]: s[3] for s in recs}
        assert [by_index[i][raw] for i in range(n)] == [
            len(data[i * b:(i + 1) * b]) for i in range(n)]
        assert sum(s[frame] for s in by_index.values()) == _frames_bytes(
            container, b)
    assert {s[0] for s in seen} == {"blocks.compress_block",
                                    "blocks.decompress_block",
                                    f"blocks x{workers}"}
