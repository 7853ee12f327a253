"""The reduction from a trace to metrics, on a synthetic trace."""

import json

import pytest

from benchmark import spec
from benchmark.reference import tbc2 as ref_tbc2
from benchmark.trace import Cover, Trace

H100 = "NVIDIA H100 80GB HBM3"


def ev(name, cat, ts, dur):
    """A chrome-trace event; ``ts`` and ``dur`` in seconds."""
    return {"ph": "X", "name": name, "cat": cat, "ts": ts * 1e6,
            "dur": dur * 1e6}


def synthetic(records=None):
    events = [
        ev("window", "user_annotation", 0.0, 20.0),
        ev("cli.compress", "user_annotation", 0.0, 10.0),
        ev("compress", "user_annotation", 0.5, 9.0),
        ev("aten::copy_", "cpu_op", 1.0, 2.0),
        ev("cli.decompress", "user_annotation", 12.0, 4.0),
        ev("codec.compress", "user_annotation", 30.0, 2.0),
        ev("K1", "kernel", 1.0, 1.0),
        ev("Memcpy HtoD", "gpu_memcpy", 1.5, 1.5),   # overlaps K1
        ev("K4", "kernel", 13.0, 1.0),
        ev("K2", "kernel", 30.5, 0.002),
        ev("fill", "gpu_memset", 31.0, 0.5),
    ]
    peaks = {H100: {"hbm_bytes_per_s": 3.35e12}}
    return Trace(events, records or {}, H100, peaks)


def test_cover():
    c = Cover([(0, 2), (1, 3), (5, 6)])
    assert c.within(0, 10) == 4
    assert c.within(2.5, 5.5) == 1.0
    assert c.within(7, 9) == 0
    assert Cover([]).within(0, 1) == 0


def test_busy_and_idle():
    t = synthetic()
    assert t.busy_seconds("cli.compress") == pytest.approx(2.0)
    assert t.idle_share("cli.compress") == pytest.approx(0.8)
    assert t.idle_share("cli.decompress") == pytest.approx(0.75)
    assert t.kernel_seconds("codec.compress") == pytest.approx(0.002)
    assert t.idle_share("no.such.span") is None
    assert spec.reader("idle_share.compress")(t) == pytest.approx(0.8)
    assert spec.reader("idle_share.decompress")(t) == pytest.approx(0.75)


def test_breakdown():
    b = synthetic().breakdown("window")
    ops = dict(b["device_ops"])
    assert ops["K1"] == pytest.approx(1.0)
    assert ops["Memcpy HtoD"] == pytest.approx(1.5)
    assert "K2" not in ops  # outside the window
    idle = dict(b["idle_gaps"])
    # the window's 20 s less 3 s busy: the innermost host span names it
    assert sum(idle.values()) == pytest.approx(17.0)
    assert "aten::copy_" not in idle  # the device was busy all through
    assert idle["compress"] == pytest.approx(9.0 - 2.0)
    assert idle["cli.compress"] == pytest.approx(1.0)
    assert idle["cli.decompress"] == pytest.approx(3.0)
    assert idle["window"] == pytest.approx(6.0)


def test_rates_and_rooflines():
    data = bytes(range(256)) * 4000
    container = ref_tbc2.compress(data, "cpu")
    n, payload = ref_tbc2.payload_bytes(container)
    assert n == len(data) and 0 < payload < len(container)
    records = {
        "codec.compress": [dict(bytes_in=len(data), container=container,
                                timings={"encode": 0.5, "assemble": 2.0},
                                seconds=2.5)],
        "codec.decompress": [dict(bytes_out=len(data), container=container,
                                  timings={"parse": 0.1, "decode": 0.25})],
        "bwt.compress": [dict(bytes_in=2_000_000, seconds=0.5)],
        "bwt.decompress": [dict(bytes_out=1_000_000, seconds=0.25)],
    }
    t = synthetic(records)
    assert spec.reader("assemble_GBps")(t) == pytest.approx(len(data) / 2e9)
    assert spec.reader("device_encode_GBps")(t) == pytest.approx(
        len(data) / 0.5e9)
    assert spec.reader("device_decode_GBps")(t) == pytest.approx(
        len(data) / 0.25e9)
    assert spec.reader("suffix_GBps")(t) == pytest.approx(0.004)
    assert spec.reader("unbwt_GBps")(t) == pytest.approx(0.004)
    want = 100 * (n + payload) / 3.35e12 / 0.002
    assert spec.reader("encode_roofline")(t) == pytest.approx(want)
    # no codec.decompress span in the trace: nothing to read
    assert spec.reader("decode_roofline")(t) is None


def test_nothing_to_read():
    t = synthetic()
    for m in spec.benchmark()["per_layer"]:
        if not m["name"].startswith("idle_share"):
            assert spec.reader(m["name"])(t) is None, m["name"]
    cpu = Trace([ev("cli.compress", "user_annotation", 0, 1)], {}, "cpu", {})
    assert cpu.idle_share("cli.compress") is None


def test_from_chrome(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        ev("cli.compress", "user_annotation", 0.0, 1.0),
        ev("K1", "kernel", 0.25, 0.25), {"ph": "M", "name": "meta"}]}))
    t = Trace.from_chrome(str(path), {}, H100, {})
    assert t.idle_share("cli.compress") == pytest.approx(0.75)
