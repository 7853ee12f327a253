"""The block container's plain reference (``reference/blocks.py``) at
bzip2 -9's block size, and its broken-guarantee variant, on the DNA of
the ``bwt-tbc2-dna`` configuration; the cell ``bwt-tbc2-dna.blocks900k``
and the readers of its ``blocks.*`` metrics (``blockspans.py``)."""

import os
import subprocess
import sys

import pytest
import torch

from benchmark import inputs, spec
from benchmark.cell import bytes_off
from benchmark.reference import blocks as ref_blocks
from benchmark.trace import Trace

#: the cell whose files the DNA comes from
CELL = "bwt-tbc2-dna.bulk"
#: the blocked cell and its metrics
BLOCKED = "bwt-tbc2-dna.blocks900k"
METRICS = ("blocks.compress_ms", "blocks.decompress_ms",
           "blocks.compress_syncs", "blocks.decompress_syncs")


def _stage():
    """bzip2 -9's blocks around the cell's own stages."""
    return {"b": 900_000, "inner": spec.cell(CELL).config["reference"]}


def _inputs(seed, size, device="cpu"):
    cell = spec.cell(CELL)
    traffic = dict(cell.traffic, file_bytes=size)
    return inputs.make(cell.config, traffic, seed, torch.device(device))


def test_exact_histogram_reaches_the_inner_stage():
    """The table from every segment's histogram, forwarded to each
    block's TBC2, breaks the sampled-table guarantee: the container
    differs (blocks of 73 segments, so the sample leaves segments out)."""
    opts = dict(_stage(), b=150_000)
    for data in _inputs(2**31 + 5, 300_000):
        want = ref_blocks.compress(data, "cpu", **opts)
        got = ref_blocks.compress(data, "cpu", exact_hist=True, **opts)
        assert bytes_off(got, want) > 0


def test_an_option_no_stage_takes_raises():
    with pytest.raises(TypeError, match="exact_hst"):
        ref_blocks.compress(b"abc", "cpu", exact_hst=True, **_stage())


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, benchmark.reference.blocks;"
            "bad = [m for m in sys.modules if m.split('.')[0] in"
            " ('tudocomp_tpu_torch', 'tudocomp_tpu', 'jax', 'bench')];"
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=spec.ROOT))
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.cuda
def test_exact_histogram_differs_at_cell_size(cuda_device):
    """The broken-guarantee container at the cell's own sizes, on the
    card: some bytes differ from the reference's for every seed."""
    for seed in (11, 12, 13):
        off = 0
        for data in _inputs(seed, spec.cell(CELL).config["file_bytes"],
                            cuda_device):
            want = ref_blocks.compress(data, cuda_device, **_stage())
            got = ref_blocks.compress(data, cuda_device, exact_hist=True,
                                      **_stage())
            off += bytes_off(got, want)
        print(f"exact_hist {CELL} seed {seed}: container_bytes_off {off}")
        assert off > 0


def test_blocked_cell_is_bzip2_9_around_the_bulk_stages():
    cell = spec.cell(BLOCKED)
    bulk = spec.cell(CELL)
    assert cell.config["corpus"] == bulk.config["corpus"]
    assert cell.config["file_bytes"] == bulk.config["file_bytes"]
    assert cell.config["reference"] == [dict(_stage(), stage="blocks")]
    assert cell.traffic == bulk.traffic
    assert [m["name"] for m in cell.per_layer] == list(METRICS)


def ev(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts * 1e6,
            "dur": dur * 1e6}


def _trace(block):
    """Two blocks of ``block`` inside the window, one outside it."""
    events = [ev("window", 0.0, 10.0), ev("cli.compress", 0.5, 5.0)]
    for t in (1.0, 3.0, 20.0):
        events += [
            ev(block, t, 1.0),
            ev("front.escape", t + 0.1, 0.2),
            ev("bwt.forward", t + 0.3, 0.4),
            ev("bwt.sa", t + 0.4, 0.2),          # nested: counted once
            ev("cudaStreamSynchronize", t + 0.5, 0.01, "cuda_runtime"),
            ev("cudaEventSynchronize", t + 0.8, 0.01, "cuda_runtime"),
            ev("cudaLaunchKernel", t + 0.85, 0.01, "cuda_runtime"),
        ]
    # a wait outside every block
    events.append(ev("cudaDeviceSynchronize", 2.5, 0.01, "cuda_runtime"))
    return Trace(events, {}, "NVIDIA H100 80GB HBM3", {})


@pytest.mark.parametrize("side", ["compress", "decompress"])
def test_block_readers(side):
    t = _trace(f"blocks.{side}_block")
    # 1.0 s a block less 0.2 + 0.4 covered: 0.4 s of its own
    assert spec.reader(f"blocks.{side}_ms")(t) == pytest.approx(400.0)
    assert spec.reader(f"blocks.{side}_syncs")(t) == 2.0


@pytest.mark.parametrize("name", METRICS)
def test_block_readers_give_none_without_block_phases(name):
    """The numbered phases of a program before the fixed names, and a
    trace with no phase at all, read nothing."""
    for t in (_trace("block 0"), Trace([ev("window", 0.0, 1.0)], {},
                                       "cpu", {})):
        assert spec.reader(name)(t) is None
