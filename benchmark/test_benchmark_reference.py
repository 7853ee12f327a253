"""The plain reference against the program's containers at small sizes
on the CPU (the program's plain kernel versions), and its independence
from the program."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import spec
from benchmark.cell import reference
from benchmark.reference import bwt as ref_bwt
from benchmark.reference import format as fmt
from benchmark.reference import tbc2 as ref_tbc2

rng = np.random.default_rng(20261018)
CASES = {
    "one": b"a",
    "two": b"aa",
    "zeros": bytes(5000),
    "period3": b"abc" * 1000,
    "noise": rng.integers(0, 256, 140_000, dtype=np.uint8).tobytes(),
    "letters": rng.integers(97, 101, 200_000, dtype=np.uint8).tobytes(),
    "runs": np.repeat(rng.integers(0, 256, 2000, dtype=np.uint8),
                      rng.integers(1, 300, 2000)).tobytes(),
    "skew": rng.choice(256, 150_001, p=np.r_[[0.5], np.full(255, 0.5 / 255)]
                       ).astype(np.uint8).tobytes(),
}


def _codec(**kw):
    from tudocomp_tpu_torch.models.blockcodec import BlockCodec

    return BlockCodec(device="cpu", **kw)


@pytest.mark.parametrize("name", CASES)
def test_tbc2_equals_program(name):
    data = CASES[name]
    assert ref_tbc2.compress(data, "cpu") == _codec().compress(data)


@pytest.mark.parametrize("offset,min_len", [(5, 3), (0, 5), (125, 8)])
def test_tbc2_options(offset, min_len):
    data = CASES["runs"]
    want = _codec(offset=offset, min_code_len=min_len).compress(data)
    assert ref_tbc2.compress(data, "cpu", offset=offset,
                             min_code_len=min_len) == want


def test_tbc2_blocks_and_sample_cap(monkeypatch):
    """Several device batches and the histogram's segment cap, made
    small on both sides."""
    import tudocomp_tpu_torch.models.blockcodec as bc

    monkeypatch.setattr(bc, "HIST_SEGS", 40)
    monkeypatch.setattr(ref_tbc2, "HIST_SEGS", 40)
    monkeypatch.setattr(ref_tbc2, "BLOCK", 33)
    data = CASES["letters"] + CASES["noise"]
    assert ref_tbc2.compress(data, "cpu") == _codec(
        batch_lanes=50).compress(data)


def test_payload_bytes():
    data = CASES["letters"]
    container = ref_tbc2.compress(data, "cpu")
    n, payload = ref_tbc2.payload_bytes(container)
    assert n == len(data)
    nseg = -(-n // 2048)
    hlen, pos = fmt.read_vbyte(container, 4)
    framing = len(container) - pos - hlen - payload  # two vbytes a frame
    assert nseg * 2 <= framing <= nseg * 4


def test_escape_equals_program():
    from tudocomp_tpu_torch.io.restrictions import escape
    from tudocomp_tpu_torch.meta import InputRestrictions

    data = bytes([0, 255, 254, 7, 0, 0, 255, 1]) + CASES["noise"][:999]
    r = InputRestrictions(escape_bytes=(), null_terminate=True)
    assert fmt.escape(data, sentinel=True) == escape(data, r)
    r = InputRestrictions(escape_bytes=(3, 255), null_terminate=False)
    assert fmt.escape(data, forbidden=(3, 255)) == escape(data, r)


def test_suffix_array():
    text = torch.from_numpy(np.frombuffer(b"mississippi\x00", np.uint8)
                            .copy())
    sa = ref_bwt.suffix_array(text).tolist()
    s = b"mississippi\x00"
    assert sa == sorted(range(len(s)), key=lambda i: s[i:])


@pytest.mark.parametrize("name", [w["name"] for w in
                                  spec.benchmark()["workloads"]])
@pytest.mark.parametrize("case", ["noise", "runs", "zeros"])
def test_cli_container_equals_program(name, case):
    from tudocomp_tpu_torch import cli

    cell = spec.cell(name)
    data = CASES[case]
    got = cli.compress(cell.config["algorithm"], data, device="cpu")
    assert reference(cell.config, data, "cpu") == got


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, benchmark.reference.tbc2, benchmark.reference.bwt,"
            " benchmark.reference.huffman, benchmark.reference.format;"
            "bad = [m for m in sys.modules if m.split('.')[0] in"
            " ('tudocomp_tpu_torch', 'tudocomp_tpu', 'jax', 'bench')];"
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=spec.ROOT))
    assert r.returncode == 0, r.stdout + r.stderr
