"""BENCHMARK.json and the files it names: each configuration, mix and
per-layer metric is found by its name, and the file keeps to the keys,
names, units and lengths its readers accept."""

import json
import os
import re

import pytest

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


@pytest.mark.parametrize("group", KEYS)
def test_entry_keys_and_text(group):
    for e in BENCH[group]:
        assert KEYS[group] <= set(e) <= KEYS[group] | {"workloads"}
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200
                assert "\n" not in e[key] and "\t" not in e[key]


def test_names_and_units():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
        for n in names:
            assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_end_to_end_bounds():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert names == {"compress_GBps", "decompress_GBps", "setup_s"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    cell = spec.cell(name)
    assert cell.config["name"] == cell.workload["config"]
    assert cell.traffic["name"] == cell.workload["traffic"]
    assert cell.workload["chips"] == 1
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in reported
        assert callable(spec.reader(m["name"]))


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    path = os.path.join(spec.ROOT, conf["file"])
    assert conf["file"].startswith("benchmark/configs/")
    with open(path) as f:
        config = json.load(f)
    assert config["name"] == conf["name"]
    assert config["source"] == conf["source"]
    assert config["reduced"] == conf["reduced"] == []
    assert config["assumed"] and config["corpus"]["kind"]
    assert os.path.exists(os.path.join(
        spec.HERE, "corpora", config["corpus"]["kind"] + ".py"))
    for stage in config["reference"]:
        assert os.path.exists(os.path.join(
            spec.HERE, "reference", stage["stage"] + ".py"))


def test_unknown_workload():
    with pytest.raises(KeyError):
        spec.cell("no-such-cell")
