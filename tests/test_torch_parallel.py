"""The port's sharded pipeline (``tudocomp_tpu_torch/parallel/``) on CPU
ranks, against the JAX package's ``parallel/`` and the port's one-device
codec.

Each world size is one spawn of ``gloo`` ranks (``parallel/launch.py``:
a ``FileStore`` rendezvous, no network, a wall-clock limit), run once per
module; the ranks run ``tests/torch_parallel_ranks.py``, which imports
nothing of JAX, and the JAX references run here, where the conftest gives
JAX 8 virtual CPU devices. All comparisons are exact.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tudocomp_tpu.models.blockcodec import BlockCodec as JaxCodec
from tudocomp_tpu.parallel.mesh import make_mesh as jax_mesh
from tudocomp_tpu.parallel.pipeline import (
    compress_sharded as jax_compress_sharded,
    factorize_blocks_sharded as jax_factorize_blocks,
)
from tudocomp_tpu_torch.entry import dryrun_multichip
from tudocomp_tpu_torch.models import blockcodec as bc
from tudocomp_tpu_torch.models.blockcodec import BlockCodec
from tudocomp_tpu_torch.ops.lzss import factorize_device
from tudocomp_tpu_torch.parallel import compress_sharded, make_mesh
from tudocomp_tpu_torch.parallel.launch import run_ranks
from tudocomp_tpu_torch.parallel.pipeline import decompress_sharded
from tudocomp_tpu_torch.utils.vbyte import write_vbyte
import torch_parallel_ranks as ranks

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: wall-clock limit of one spawn of ranks
LIMIT = 180.0
WORLDS = (1, 2, 3, 8)
NAMES = tuple(ranks.inputs())


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """``world_run`` at each world size, spawned on first use: one list
    of per-rank results per world (world 8 on ``sp`` 1, 2 and 4)."""
    done = {}

    def get(world: int) -> list:
        if world not in done:
            sps = (1, 2, 4) if world == 8 else (1,)
            workdir = str(tmp_path_factory.mktemp(f"world{world}"))
            done[world] = run_ranks(ranks.world_run, world, device="cpu",
                                    args=(workdir, sps), timeout=LIMIT)
        return done[world]

    return get


@pytest.fixture(scope="module")
def one_device():
    """The port's one-device containers (CPU, the plain kernels)."""
    return {name: BlockCodec(device="cpu").compress(d)
            for name, d in ranks.inputs().items()}


@pytest.fixture(scope="module")
def jax_sharded():
    """JAX's ``compress_sharded`` on its 8-device CPU mesh: ``_data()``
    at ``sp`` 1, and the sampled input at ``sp`` 2, as
    ``test_parallel.py`` runs them (JAX's container does not depend on
    ``sp``: ``test_parallel.py`` holds its ``sp`` 1, 2 and 4 equal)."""
    return {
        "data": jax_compress_sharded(JaxCodec(), jax_mesh(8, sp=1),
                                     ranks.data()),
        "sampled": jax_compress_sharded(JaxCodec(), jax_mesh(8, sp=2),
                                        ranks.inputs()["sampled"]),
    }


@pytest.mark.parametrize("sp", [1, 2, 4])
@pytest.mark.parametrize("name", ["data", "sampled"])
def test_compress_sharded_matches_jax_at_world_8(worlds, jax_sharded, name,
                                                 sp):
    assert worlds(8)[0][name, sp] == jax_sharded[name]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("world", WORLDS)
def test_compress_sharded_equals_one_device(worlds, one_device, world,
                                            name):
    results = worlds(world)
    assert results[0][name, 1] == one_device[name]
    assert all(r[name, 1] is None for r in results[1:])


@pytest.fixture(scope="module")
def capped():
    """The one-device container of ``cap_data()`` with ``HIST_SEGS``
    patched to the cap, the same with a batch straddling the cap, and
    without the patch."""
    data = ranks.cap_data()
    uncapped = BlockCodec(device="cpu").compress(data)
    saved = bc.HIST_SEGS
    bc.HIST_SEGS = ranks.HIST_CAP
    try:
        return (BlockCodec(device="cpu").compress(data),
                BlockCodec(device="cpu", batch_lanes=32).compress(data),
                uncapped)
    finally:
        bc.HIST_SEGS = saved


def test_hist_cap_one_device_batch_split(capped):
    want, split, uncapped = capped
    assert split == want
    assert want != uncapped  # the cap changes the table


@pytest.mark.parametrize("lanes", ranks.CAP_LANES)
@pytest.mark.parametrize("world", WORLDS)
def test_hist_cap_equal_across_worlds_and_batch_splits(worlds, capped,
                                                       world, lanes):
    """``HIST_SEGS`` patched low in every rank: the table comes from the
    sampled segments below the cap alone, whatever the world size and
    the batch split (with 32 lanes a batch straddles the cap; at world 3
    a rank's range starts off the 1-in-8 grid)."""
    assert worlds(world)[0]["cap", lanes] == capped[0]


@pytest.mark.parametrize("name", NAMES)
def test_decompress_sharded_at_world_8(worlds, name):
    results = worlds(8)
    assert results[0]["dec", name] == ranks.inputs()[name]
    assert all(r["dec", name] is None for r in results[1:])


def test_decompress_sharded_ranks_without_segments(worlds):
    """``_data()``'s 6 segments over 8 ranks: ranks 6 and 7 own none."""
    got = [r["range"] for r in worlds(8)]
    assert got == [(i, i + 1) for i in range(6)] + [(6, 6)] * 2


def test_factorize_blocks_sharded_matches_jax(worlds):
    blocks = ranks.blocks()
    want = jax_factorize_blocks(jax_mesh(8, sp=2), blocks, threshold=4)
    got = worlds(8)[0]["factors"]
    assert len(got) == len(want) == 16
    for i, (g, w) in enumerate(zip(got, want)):
        assert all(np.array_equal(a, b) for a, b in zip(g, w)), i
        mine = factorize_device(blocks[i], 4, max_len=383, exact=True,
                                device="cpu")
        assert all(np.array_equal(a, b) for a, b in zip(g, mine)), i


@pytest.mark.parametrize("world", WORLDS)
def test_journaled_run_equals_one_shot(worlds, world):
    want = BlockCodec(device="cpu").compress(ranks.resume_data())
    assert worlds(world)[0]["journaled"] == want


@pytest.mark.parametrize("what", ["bad_n", "bad_sp"])
@pytest.mark.parametrize("world", [1, 8])
def test_make_mesh_rejects_a_wrong_size(worlds, world, what):
    assert all(r[what] for r in worlds(world))


def test_mesh_coordinates_in_rank_order(worlds):
    """World 8 on ``sp`` 4: rank ``r`` sits at ``(r // 4, r % 4)``, as
    JAX's ``devs.reshape(dp, sp)`` places device ``r``."""
    assert [r["coords"] for r in worlds(8)] == [divmod(r, 4)
                                                for r in range(8)]


@pytest.mark.parametrize("kwargs", [{"n_devices": 2}, {"sp": 2},
                                    {"n_devices": 1, "sp": 0}])
def test_make_mesh_rejects_a_wrong_size_without_a_group(kwargs):
    with pytest.raises(ValueError):
        make_mesh(device="cpu", **kwargs)


@pytest.mark.parametrize("call", ["make_mesh", "run_ranks", "dryrun"])
def test_cuda_is_the_default_device(call):
    """The entry points default to CUDA and raise where it is absent,
    before any rank is spawned."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present")
    fn = {"make_mesh": make_mesh,
          "run_ranks": lambda: run_ranks(ranks.loaded_modules, 1),
          "dryrun": lambda: dryrun_multichip(2)}[call]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fn()


def test_sharded_stages_accept_an_empty_range():
    """A rank with no segments runs no kernel, adds nothing to the
    histogram, frames nothing and decodes nothing."""
    mesh = make_mesh(1, device="cpu")
    codec = BlockCodec(device="cpu")
    rows, lens = codec.split_segments(b"")
    stage1, hist = codec.rle(rows, lens, first=8, sampled=True)
    assert stage1 == [] and hist.shape == (256,)
    mesh.all_reduce(hist)
    assert int(hist.abs().sum()) == 0
    table, tables = codec.table(hist, True)
    assert codec.huff(stage1, tables) == []
    assert codec.frames([]) == b""
    assert codec.frames([], b"TBC2") == b"TBC2"
    none = np.zeros(0, np.int64)
    assert codec.decode(b"", none, none, none, none, table, offset=0,
                        orig_len=0) == b""


def _private_codec_uses(path: str) -> list:
    """Lines of ``path`` that name a ``_``-prefixed member of
    ``BlockCodec``: an attribute that the class defines, any such
    attribute of a name ``codec`` or ``BlockCodec``, or an import of a
    ``_``-prefixed name from the codec's module."""
    import ast

    private = {n for n in vars(BlockCodec)
               if n.startswith("_") and not n.startswith("__")}
    with open(path) as f:
        tree = ast.parse(f.read())
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr.startswith("_") \
                and not node.attr.startswith("__"):
            owner = getattr(node.value, "id", None)
            if node.attr in private or owner in ("codec", "BlockCodec"):
                bad.append((node.lineno, node.attr))
        elif isinstance(node, ast.ImportFrom) and (
                node.module or "").endswith("blockcodec"):
            bad += [(node.lineno, a.name) for a in node.names
                    if a.name.startswith("_")]
    return bad


@pytest.mark.parametrize("path", [
    "tudocomp_tpu_torch/parallel/pipeline.py",
    "tudocomp_tpu_torch/parallel/distributed.py",
    "tudocomp_tpu_torch/parallel/mesh.py",
    "tudocomp_tpu_torch/parallel/launch.py",
    "tudocomp_tpu_torch/entry.py",
    "chip_smoke.py",
])
def test_callers_use_only_the_codecs_public_stages(path):
    """``parallel/``, its entry and the card's smoke run call the codec
    through its public stages alone, so the codec's rules live in
    ``models/blockcodec.py`` only."""
    assert _private_codec_uses(os.path.join(ROOT, path)) == []


def test_world_1_without_a_group_equals_one_device(one_device):
    mesh = make_mesh(device="cpu")
    codec = BlockCodec(device="cpu")
    for name, d in ranks.inputs().items():
        assert compress_sharded(codec, mesh, d) == one_device[name]
        assert decompress_sharded(codec, mesh, one_device[name]) == d
    empty = compress_sharded(codec, mesh, b"")
    assert empty == codec.compress(b"")
    assert decompress_sharded(codec, mesh, empty) == b""


def test_dryrun_multichip_on_8_cpu_ranks():
    dryrun_multichip(8, device="cpu")


def test_compress_distributed_on_two_processes(tmp_path):
    """Two processes joined by ``initialize`` over TCP on this host, as
    ``tests/test_distributed.py`` runs the JAX pair: the header and both
    processes' pieces glued in global order equal the one-device
    container."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    worker = os.path.join(HERE, "torch_dist_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(i), "2", str(port), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=LIMIT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    data = (tmp_path / "input.bin").read_bytes()
    pieces = sorted(tmp_path.glob("piece_*.bin"))
    assert len(pieces) == 2
    glued = (tmp_path / "prefix.bin").read_bytes() + b"".join(
        p.read_bytes() for p in pieces)
    assert glued == BlockCodec(device="cpu").compress(data)
    firsts = sorted((tmp_path / f"first{i}.txt").read_text()
                    for i in range(2))
    assert firsts == ["0", str(int(pieces[1].name[6:14]))]


SOLO = r"""
import os, sys, tempfile
sys.path.insert(0, {root!r})
sys.path.insert(0, {here!r})
import torch.distributed as dist
import torch_parallel_ranks as ranks
from tudocomp_tpu_torch.models.blockcodec import BlockCodec
from tudocomp_tpu_torch.parallel import make_mesh
with tempfile.TemporaryDirectory() as td:
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(td, "store"), 1), rank=0, world_size=1)
    mesh = make_mesh(1, device="cpu")
    out = ranks.world_run(mesh, td)
    dist.destroy_process_group()
want = BlockCodec(device="cpu").compress(ranks.data())
print("EQUAL", out["data", 1] == want and out["dec", "data"] == ranks.data())
print("LOADED", ranks.loaded_modules(mesh))
"""


def test_world_1_subprocess_loads_no_jax():
    r = subprocess.run(
        [sys.executable, "-c", SOLO.format(root=ROOT, here=HERE)],
        capture_output=True, text=True, timeout=LIMIT, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "EQUAL True" in r.stdout
    assert "LOADED []" in r.stdout


def test_decompress_sharded_rejects_malformed_frames():
    """A frame whose count passes a segment is refused before any rank
    decodes (every rank parses the whole container and refuses alike)."""
    codec = BlockCodec(device="cpu")
    good = codec.compress(b"\x07")
    prefix = codec.prefix(1, None)
    frame = good[len(prefix):]
    bad = bytearray(prefix)
    write_vbyte(bad, 4096 << 2 | frame[0] & 3)
    bad += frame[1:]
    with pytest.raises(ValueError, match="malformed TBC2 frames"):
        decompress_sharded(codec, make_mesh(device="cpu"), bytes(bad))
