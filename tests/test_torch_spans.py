"""The port's span log (``StatPhase.recorded()``) and the spans it
opens on the CLI's paths, on the CPU.

A phase is recorded while a ``torch.profiler`` session records; each
record pairs with one ``record_function`` range of the exported trace.
These tests import nothing of JAX.
"""

import json
import math
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch

from tudocomp_tpu_torch import cli
from tudocomp_tpu_torch.cli import REGISTRY
from tudocomp_tpu_torch.compressors.bwt import BWTCompressor
from tudocomp_tpu_torch.io.restrictions import escape
from tudocomp_tpu_torch.models.blockcodec import BlockCodec
from tudocomp_tpu_torch.ops.hufdec import SEG
from tudocomp_tpu_torch.ops.suffix import suffix_array_device
from tudocomp_tpu_torch.stats import StatPhase

CPU = [torch.profiler.ProfilerActivity.CPU]
CONFIGS = ["tbc2", "bwt(device=true):tbc2"]


def _input(n: int, seed: int) -> bytes:
    """Words over a small alphabet, then random bytes: segments of both
    escapes (``rle_raw`` on the text, ``huff_raw`` on the noise)."""
    rng = np.random.default_rng(seed)
    words = [rng.integers(97, 105, rng.integers(2, 9)).astype(np.uint8)
             .tobytes() for _ in range(200)]
    text = b" ".join(words[i] for i in rng.integers(0, 200, n))[: n // 2]
    return text + rng.integers(1, 256, n - len(text), np.uint8).tobytes()


def _since(t0: float):
    """The log's records of phases opened since ``t0``: the log is
    emptied at a session's first phase only where a phase has seen the
    profiler off since the last session, which tests that run one
    session after another do not ensure."""
    return [r for r in StatPhase.recorded() if r["start"] >= t0]


def _round_trip(algo: str, data: bytes, path):
    """``cli.compress`` and ``cli.decompress`` of ``data`` under the
    profiler; returns the container, the session's records and the
    trace's ranges ``{name: [(start s, dur s), ...]}`` in start order."""
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=CPU) as prof:
        container = cli.compress(algo, data, device="cpu")
        assert cli.decompress(container, device="cpu") == data
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            ranges.setdefault(e["name"], []).append(
                (e["ts"] * 1e-6, e["dur"] * 1e-6))
    return container, _since(t0), {
        k: sorted(v) for k, v in ranges.items()}


def _named(log, name):
    return [r for r in log if r["name"] == name]


def test_nested_phases_are_recorded_with_parents_and_counters():
    with StatPhase("before"):  # sees the profiler off
        pass
    with torch.profiler.profile(activities=CPU):
        with StatPhase("outer") as outer:
            with StatPhase("inner") as inner:
                inner.log_stat("bytes", 7)
                StatPhase.log("ranks", 3)
            with StatPhase("second"):
                pass
            outer.log_stat("segments", 2)
    log = StatPhase.recorded()
    assert [r["name"] for r in log] == ["inner", "second", "outer"]
    by = {r["name"]: r for r in log}
    assert by["outer"]["parent"] is None
    assert by["inner"]["parent"] == by["outer"]["id"] == outer.id
    assert by["second"]["parent"] == outer.id
    assert by["inner"]["stats"] == {"bytes": 7, "ranks": 3}
    assert by["outer"]["stats"] == {"segments": 2}
    assert {r["thread"] for r in log} == {threading.get_ident()}
    for r in log:
        assert r["start"] <= r["end"]
    assert by["outer"]["start"] <= by["inner"]["start"]
    assert by["inner"]["end"] <= by["outer"]["end"]
    # the tree is what it was
    assert [c.title for c in outer.children] == ["inner", "second"]

    # no profiler: the phases keep no record, and the log keeps the last
    # session
    with StatPhase("unrecorded"):
        pass
    assert StatPhase.recorded() == log
    # a new session starts the log afresh
    with torch.profiler.profile(activities=CPU):
        with StatPhase("again"):
            pass
    assert [r["name"] for r in StatPhase.recorded()] == ["again"]


def test_a_phase_on_another_thread_stays_out_of_the_tree():
    """A worker's phase is a root on its thread. The profiler records a
    thread where its session was started there (its flag is per
    thread), and the log keeps the phases whose ranges it records."""
    seen = {}

    def work():
        t0 = time.perf_counter()
        with torch.profiler.profile(activities=CPU):
            with StatPhase("worker") as w:
                StatPhase.log("rows", 5)
                seen["parent"] = w.parent
        seen["thread"] = threading.get_ident()
        seen["log"] = _since(t0)

    with StatPhase("main") as main:
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        with StatPhase("child") as child:
            StatPhase.log("rows", 1)
    assert seen["parent"] is None
    assert [c.title for c in main.children] == ["child"]
    assert child.stats == {"rows": 1}
    (worker,) = seen["log"]
    assert worker["name"] == "worker" and worker["parent"] is None
    assert worker["stats"] == {"rows": 5}
    assert worker["thread"] == seen["thread"] != threading.get_ident()

    # a session started on this thread records none of another's phases,
    # and the log keeps none of them either
    def elsewhere():
        with StatPhase("elsewhere"):
            pass

    t0 = time.perf_counter()
    with torch.profiler.profile(activities=CPU):
        t = threading.Thread(target=elsewhere)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    assert not _named(_since(t0), "elsewhere")


@pytest.mark.parametrize("algo", CONFIGS)
def test_every_logged_span_is_one_trace_range(algo, tmp_path):
    n = 40 << 10
    assert n > BWTCompressor.DEVICE_MIN
    _, log, ranges = _round_trip(algo, _input(n, seed=3),
                                 tmp_path / "trace.json")
    assert Counter(r["name"] for r in log) == Counter(
        {k: len(v) for k, v in ranges.items()})
    for name, spans in ranges.items():
        recs = sorted(_named(log, name), key=lambda r: r["start"])
        for r, (_, dur) in zip(recs, spans):
            host = r["end"] - r["start"]
            assert abs(host - dur) <= max(1e-3, 0.05 * dur), name
    for name in ("compress", "decompress", "front.instantiate",
                 "front.escape", "front.frame", "front.unframe",
                 "front.unescape", "tbc2.encode", "tbc2.split",
                 "tbc2.upload", "tbc2.rle", "tbc2.table", "tbc2.huff",
                 "tbc2.download", "tbc2.assemble", "tbc2.parse"):
        assert name in ranges, name
    if algo.startswith("bwt"):
        for name in ("bwt.forward", "bwt.upload", "bwt.sa", "bwt.isa_bwt",
                     "bwt.download", "suffix.round", "bwt.inverse",
                     "bwt.unbwt"):
            assert name in ranges, name


@pytest.mark.parametrize("algo", CONFIGS)
def test_counters_agree_with_the_container(algo, tmp_path):
    data = _input(40 << 10, seed=4)
    container, log, _ = _round_trip(algo, data, tmp_path / "trace.json")
    (comp,) = _named(log, "compress")
    (dec,) = _named(log, "decompress")
    assert comp["stats"] == {"bytes_in": len(data),
                             "bytes_out": len(container)}
    assert dec["stats"] == {"bytes_in": len(container),
                            "bytes_out": len(data)}
    (frame,) = _named(log, "front.frame")
    assert frame["stats"] == {"bytes": len(container)}
    payload = container[container.index(b"%") + 1:]
    (unframe,) = _named(log, "front.unframe")
    assert unframe["stats"] == {"bytes": len(payload)}

    (enc,) = _named(log, "tbc2.encode")
    (asm,) = _named(log, "tbc2.assemble")
    (parse,) = _named(log, "tbc2.parse")
    n = enc["stats"]["bytes_in"]
    assert enc["stats"]["segments"] == math.ceil(n / SEG)
    assert asm["stats"]["segments"] == math.ceil(n / SEG)
    assert asm["stats"]["bytes_in"] == n
    assert parse["stats"] == {"bytes_in": asm["stats"]["bytes_out"],
                              "segments": math.ceil(n / SEG)}
    # the payload is the TBC2 container (in the chain, of the BWT of the
    # escaped and sentineled input)
    text = data
    if algo.startswith("bwt"):
        bwt = REGISTRY.instantiate("bwt(device=true)", torch_device="cpu")
        text = escape(data, REGISTRY.restrictions_of(bwt.env))
    assert n == len(text)
    assert len(payload) == asm["stats"]["bytes_out"]
    flags = BlockCodec(device="cpu").parse(payload)[4]
    assert asm["stats"]["rle_raw"] == int(((flags >> 1) & 1).sum())
    assert asm["stats"]["huff_raw"] == int((flags & 1).sum())
    assert asm["stats"]["on_device"] == 0  # K8's plain version on the CPU
    if algo == "tbc2":
        assert asm["stats"]["rle_raw"] > 0 and asm["stats"]["huff_raw"] > 0
    for up in _named(log, "tbc2.upload") + _named(log, "tbc2.download"):
        assert up["stats"]["bytes"] > 0 and up["stats"]["pinned"] == 0

    if algo.startswith("bwt"):
        (fwd,) = _named(log, "bwt.forward")
        info = {}
        suffix_array_device(torch.from_numpy(
            np.frombuffer(text, np.uint8).copy()), info)
        assert fwd["stats"] == {"bytes_in": len(text),
                                "rounds": info["rounds"]}
        rounds = _named(log, "suffix.round")
        assert len(rounds) == info["rounds"]
        assert [r["stats"]["k"] for r in rounds] == [
            1 << i for i in range(len(rounds))]
        assert rounds[-1]["stats"]["ranks"] == len(text)
        (inv,) = _named(log, "bwt.inverse")
        assert inv["stats"]["bytes_out"] == len(text)
        assert inv["stats"]["rounds"] == math.ceil(math.log2(len(text) - 1))


def test_no_program_span_is_named_as_a_harness_span(tmp_path):
    import pathlib

    configs = pathlib.Path(__file__).parents[1] / "benchmark" / "configs"
    harness = {"window", "cli.compress", "cli.decompress"}
    for path in configs.glob("*.json"):
        for layer in json.loads(path.read_text()).get("layers", []):
            harness |= {layer["span"] + ".compress",
                        layer["span"] + ".decompress"}
    assert {"bwt.compress", "codec.compress"} <= harness
    program = set()
    for i, algo in enumerate(CONFIGS):
        _, log, _ = _round_trip(algo, _input(40 << 10, seed=5),
                                tmp_path / f"trace{i}.json")
        program |= {r["name"] for r in log}
    assert not program & harness


def test_stats_tree_with_block_workers_round_trips(tmp_path, capsys):
    src = tmp_path / "in.bin"
    data = _input(200 << 10, seed=6)
    src.write_bytes(data)
    out = tmp_path / "in.tdc"
    dec = tmp_path / "in.out"
    assert cli.main([str(src), "-a", "tbc2", "--blocks", "64K",
                     "--threads", "2", "--stats", "--device", "cpu", "-f",
                     "-o", str(out)]) == 0
    err = capsys.readouterr().err
    tree = json.loads(err[err.index("{"): err.rindex("}") + 1])
    keys = {"title", "timeDelta", "memPeak", "devMemPeak", "stats", "sub"}

    def walk(node):
        assert set(node) == keys
        yield node["title"]
        for sub in node["sub"]:
            yield from walk(sub)

    # the workers' codec phases are roots on their threads: the tree
    # holds the main thread's phases alone
    assert list(walk(tree)) == ["STATS", "blocks x2"]
    assert cli.main([str(out), "-d", "--threads", "2", "--stats",
                     "--device", "cpu", "-f", "-o", str(dec)]) == 0
    err = capsys.readouterr().err
    tree = json.loads(err[err.index("{"): err.rindex("}") + 1])
    assert list(walk(tree)) == ["STATS", "blocks x2"]
    assert dec.read_bytes() == data
