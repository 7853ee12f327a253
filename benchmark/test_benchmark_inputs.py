"""The generators: deterministic in the seed, of the stated sizes, and
different across seeds and across a run's distinct files."""

import numpy as np
import pytest
import torch

from benchmark import inputs, spec

SMALL = 150_000
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def _make(cell, seed, size=SMALL):
    traffic = dict(cell.traffic, file_bytes=size)
    return inputs.make(cell.config, traffic, seed, torch.device("cpu"))


@pytest.mark.parametrize("name", CELLS)
def test_deterministic_and_sized(name):
    cell = spec.cell(name)
    seed = 2**31 + 12345  # larger than 32 signed bits hold
    a = _make(cell, seed)
    assert a == _make(cell, seed)
    assert len(a) == cell.traffic["distinct_inputs"] >= 2
    assert all(len(x) == SMALL for x in a)
    assert a[0] != a[1]
    assert a[0] != _make(cell, seed + 1)[0]


@pytest.mark.parametrize("name", CELLS)
def test_stated_file_size(name):
    cell = spec.cell(name)
    assert inputs.file_bytes(cell.config, cell.traffic) == \
        cell.config["file_bytes"]


def test_wiki_shape():
    cell = spec.cell("tbc2-enwik.bulk")
    x = np.frombuffer(_make(cell, 7, 400_000)[0], np.uint8)
    text = x.tobytes()
    assert text.startswith(b"  <page>\n    <title>")
    assert text.count(b"<page>") >= 3 and b"[[Category:" in text
    counts = np.bincount(x, minlength=256)
    p = counts[counts > 0] / x.size
    h0 = float(-(p * np.log2(p)).sum())
    assert 4.2 < h0 < 4.8 and 60 < (counts > 0).sum() < 90


def test_dna_shape():
    cell = spec.cell("bwt-tbc2-dna.bulk")
    x = np.frombuffer(_make(cell, 7, 1 << 20)[0], np.uint8)
    counts = np.bincount(x, minlength=256)
    acgt = counts[list(b"ACGT")].sum() / x.size
    assert acgt > 0.98
    assert set(np.flatnonzero(counts)) <= set(b"ACGTNRYKMSWBDHV")
    assert 0 not in x and 255 not in x


def test_file_seed():
    assert inputs.file_seed(5, 0) != inputs.file_seed(5, 1)
    assert inputs.file_seed(-1, 0) == inputs.file_seed(2**64 - 1, 0)
    assert 0 <= inputs.file_seed(2**40, 3) < 2**63
