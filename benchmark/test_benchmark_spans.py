"""The program's span log paired with the trace (``spans.py``) and the
seven readers built on it, on a synthetic trace and log."""

import pytest

from benchmark import spans, spec
from benchmark.trace import Trace

H100 = "NVIDIA H100 80GB HBM3"
NEW = ("front.compress_GBps", "front.decompress_GBps", "tbc2.parse_GBps",
       "copy.compress_GBps", "copy.decompress_GBps", "bwt.forward_GBps",
       "bwt.inverse_GBps")


def ev(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts * 1e6,
            "dur": dur * 1e6}


#: (name, start, duration, counters): one compress and one decompress
#: call inside the window, and a layer call after it
SPANS = [
    ("compress", 1.0, 4.0, {"bytes_in": 100, "bytes_out": 60}),
    ("front.instantiate", 1.0, 0.5, {}),
    ("front.escape", 1.5, 0.5, {"bytes_in": 100, "bytes_out": 100}),
    ("bwt.forward", 2.0, 1.0, {"bytes_in": 101, "rounds": 3}),
    ("bwt.upload", 2.0, 0.25, {"bytes": 101, "pinned": 0}),
    ("bwt.download", 2.75, 0.25, {"bytes": 101, "pinned": 0}),
    ("tbc2.encode", 3.0, 1.0, {"bytes_in": 101, "segments": 1}),
    ("tbc2.upload", 3.0, 0.5, {"bytes": 2100, "pinned": 0}),
    ("front.frame", 4.5, 0.5, {"bytes": 60}),
    ("decompress", 6.0, 2.0, {"bytes_in": 60, "bytes_out": 100}),
    ("front.unframe", 6.0, 0.25, {"bytes": 55}),
    ("tbc2.parse", 6.25, 0.25, {"bytes_in": 55, "segments": 1}),
    ("tbc2.download", 6.5, 0.5, {"bytes": 2048, "pinned": 0}),
    ("bwt.inverse", 7.0, 0.5, {"bytes_out": 101, "rounds": 7}),
    ("front.unescape", 7.5, 0.5, {"bytes_in": 101, "bytes_out": 100}),
    # after the window: the harness's layer-by-layer calls
    ("tbc2.parse", 30.0, 1.0, {"bytes_in": 55, "segments": 1}),
    ("bwt.forward", 32.0, 1.0, {"bytes_in": 101, "rounds": 3}),
]


def synthetic(extra=()):
    events = [ev("window", 0.0, 20.0), ev("cli.compress", 0.9, 4.2),
              ev("cli.decompress", 5.9, 2.2)]
    events += [ev(name, ts, dur) for name, ts, dur, _ in SPANS]
    events += list(extra)
    # the log's host clock is another clock than the trace's: only the
    # order within each name pairs them
    log = [{"name": name, "id": i, "parent": None, "thread": 1,
            "start": 1000.0 + ts, "end": 1000.0 + ts + dur,
            "stats": stats}
           for i, (name, ts, dur, stats) in enumerate(SPANS)]
    return Trace(events, {}, H100, {}), log


def test_pairs_by_name_and_order_with_the_trace_times():
    t, log = synthetic()
    got = spans.paired(t, ["tbc2.parse", "compress"], log)
    assert got["compress"] == [(SPANS[0][3], 1.0, 5.0)]
    assert [s[1:] for s in got["tbc2.parse"]] == [(6.25, 6.5),
                                                   (30.0, 31.0)]
    assert spans.paired(t, ["no.such.span"], log) == {"no.such.span": []}


def test_the_window_keeps_the_calls_inside_it():
    t, log = synthetic()
    got = spans.paired(t, ["bwt.forward"], log)
    assert len(got["bwt.forward"]) == 2
    assert [s[1:] for s in spans.in_window(t, got["bwt.forward"])] == [
        (2.0, 3.0)]
    assert spans.rate(t, "tbc2.parse", "bytes_in", log) == pytest.approx(
        55 / 0.25 / 1e9)
    no_window = Trace([ev("tbc2.parse", 6.25, 0.25)], {}, H100, {})
    assert spans.in_window(no_window, [({}, 6.25, 6.5)]) == []


def test_none_where_log_and_trace_do_not_pair():
    t, log = synthetic()
    # a range the log lacks
    t2, _ = synthetic([ev("tbc2.parse", 40.0, 1.0)])
    assert spans.paired(t2, ["tbc2.parse"], log) is None
    assert spans.rate(t2, "tbc2.parse", "bytes_in", log) is None
    # a record the trace lacks
    extra = dict(log[0], name="front.escape", start=2000.0, end=2001.0)
    assert spans.front_rate(t, "compress", "bytes_in",
                            log + [extra]) is None
    # records of one name on two threads
    other = [dict(r, thread=2) if r["start"] > 1020 else r for r in log]
    assert spans.paired(t, ["tbc2.parse"], other) is None
    assert spans.paired(t, ["compress"], other) is not None
    # no log at all: a program that keeps none
    assert spans.paired(t, ["compress"], []) is None


def test_front_and_copy_rates():
    t, log = synthetic()
    # front.* inside compress: 0.5 + 0.5 + 0.5 s for 100 input bytes
    assert spans.front_rate(t, "compress", "bytes_in", log) == \
        pytest.approx(100 / 1.5 / 1e9)
    # front.* inside decompress: 0.25 + 0.5 s for 100 output bytes
    assert spans.front_rate(t, "decompress", "bytes_out", log) == \
        pytest.approx(100 / 0.75 / 1e9)
    # copies inside compress: 101 + 101 + 2100 bytes in 1.0 s
    assert spans.copy_rate(t, "compress", log) == pytest.approx(
        2302 / 1.0 / 1e9)
    assert spans.copy_rate(t, "decompress", log) == pytest.approx(
        2048 / 0.5 / 1e9)


def test_overlapping_inner_spans_count_once():
    t, log = synthetic()
    nested = dict(log[1], name="front.escape", start=1001.25,
                  end=1001.5, stats={})
    t2, _ = synthetic([ev("front.escape", 1.25, 0.25)])
    assert spans.front_rate(t2, "compress", "bytes_in", log + [nested]) \
        == pytest.approx(100 / 1.5 / 1e9)


def test_readers_read_the_program_log(monkeypatch):
    t, log = synthetic()
    monkeypatch.setattr(spans, "program_log", lambda: log)
    want = {"front.compress_GBps": 100 / 1.5, "front.decompress_GBps":
            100 / 0.75, "tbc2.parse_GBps": 55 / 0.25,
            "copy.compress_GBps": 2302 / 1.0,
            "copy.decompress_GBps": 2048 / 0.5,
            "bwt.forward_GBps": 101 / 1.0, "bwt.inverse_GBps": 101 / 0.5}
    for name in NEW:
        assert spec.reader(name)(t) == pytest.approx(want[name] / 1e9), name


def test_readers_give_none_for_a_program_without_a_log(monkeypatch):
    from tudocomp_tpu_torch.stats import StatPhase

    t, _ = synthetic()
    monkeypatch.delattr(StatPhase, "recorded")
    assert spans.program_log() is None
    for name in NEW:
        assert spec.reader(name)(t) is None, name


def test_each_new_metric_is_listed():
    listed = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    for name in NEW:
        m = listed[name]
        assert m["source"] == "program_span" and m["unit"] == "GB/s"
        cells = {"bwt-tbc2-dna.bulk"} if name.startswith("bwt.") else {
            "tbc2-enwik.bulk", "bwt-tbc2-dna.bulk"}
        assert set(m["workloads"]) == cells
