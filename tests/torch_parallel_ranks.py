"""Rank functions and inputs of the port's sharded tests.

Spawned ranks import the module of their function, so everything they
run lives here, beside the inputs, and this module imports nothing of
JAX or the JAX package (``tests/test_torch_parallel.py`` and
``tests/test_torch_cuda.py`` hold the results against the references).
Each function takes the rank's mesh first (``parallel/launch.py``) and
returns what the test compares; rank 0 returns the containers.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from tudocomp_tpu_torch.models import blockcodec as bc
from tudocomp_tpu_torch.models.blockcodec import BlockCodec
from tudocomp_tpu_torch.parallel import make_mesh
from tudocomp_tpu_torch.parallel.pipeline import (
    compress_sharded, compress_sharded_resumable, decompress_sharded,
    factorize_blocks_sharded,
)

#: the HIST_SEGS cap of the cap cases, and their batch splits: with 32
#: lanes the batch at 32 straddles the cap (global 48)
HIST_CAP = 48
CAP_LANES = (bc.BATCH_LANES, 32)
#: segments per batch of the journaled runs (3 batches of
#: :func:`resume_data`; world 3 rounds it up to 48, world 8 to 64)
RESUME_BATCH = 32


def data() -> bytes:
    """``tests/test_parallel.py``'s ``_data()``: 6 segments."""
    rng = np.random.default_rng(7)
    return (
        b"sing, goddess, of the anger of achilles " * 120
        + bytes(rng.integers(0, 16, 4096, dtype=np.uint8))
        + b"\x00" * 1500
    )


def inputs() -> dict:
    """The encode cases: ``_data()``; its 70-segment sampled form (the
    histogram takes 1 segment in 8); one byte (one symbol: no table)."""
    return {"data": data(), "sampled": (data() * 16)[: 70 * 2048],
            "byte": b"\x07"}


def cap_data() -> bytes:
    """100 segments past the patched cap (``test_parallel.py``'s)."""
    return (data() * 32)[: 100 * 2048]


def blocks() -> np.ndarray:
    """``test_parallel.py``'s 16 blocks of 384 bytes, each ending in 0."""
    return np.stack([
        np.frombuffer(((b"shard %d lorem ipsum " % i) * 32)[:383] + b"\x00",
                      np.uint8)
        for i in range(16)
    ])


def resume_data() -> bytes:
    """72 segments (the histogram sampled), a ragged tail: the start of
    ``tests/test_resume_sharded.py``'s input."""
    rng = np.random.default_rng(5)
    return (
        b"call me ishmael. some years ago - never mind how long " * 8000
        + bytes(rng.integers(0, 64, 120000, dtype=np.uint8))
    )[: 71 * 2048 + 777]


def _raises(fn) -> bool:
    try:
        fn()
    except ValueError:
        return True
    return False


def world_run(mesh, workdir: str, sps: tuple = (1,)) -> dict:
    """Everything one world size checks, on one group: the containers
    of :func:`inputs` on a ``(world / sp, sp)`` mesh for each ``sp``,
    their sharded decode, the cap cases with ``HIST_SEGS`` patched to
    :data:`HIST_CAP`, ``factorize_blocks_sharded`` on :func:`blocks`,
    an uninterrupted journaled run on :func:`resume_data` (its source
    in ``workdir``), this rank's segment range of ``data()``, its
    coordinates on the last ``sp``'s mesh and whether ``make_mesh``
    rejects a wrong ``n_devices`` and ``sp``."""
    dev = mesh.device
    world = mesh.size
    out = {"range": mesh.segment_range(-(-len(data()) // 2048))}
    for name, d in inputs().items():
        for sp in sps:
            out[name, sp] = compress_sharded(
                BlockCodec(device=dev), make_mesh(world, sp, device=dev), d)
        container = mesh.broadcast(out[name, sps[0]])
        out["dec", name] = decompress_sharded(BlockCodec(device=dev), mesh,
                                              container)
    saved = bc.HIST_SEGS
    bc.HIST_SEGS = HIST_CAP
    try:
        for lanes in CAP_LANES:
            out["cap", lanes] = compress_sharded(
                BlockCodec(device=dev, batch_lanes=lanes), mesh, cap_data())
    finally:
        bc.HIST_SEGS = saved
    out["factors"] = factorize_blocks_sharded(mesh, blocks(), threshold=4)
    src = os.path.join(workdir, "resume.bin")
    dst = os.path.join(workdir, f"journaled{world}.tbc2")
    if mesh.rank == 0:
        with open(src, "wb") as f:
            f.write(resume_data())
    mesh.broadcast(None)  # the source is written
    out["journaled"] = compress_sharded_resumable(
        BlockCodec(device=dev), mesh, src, dst, batch_segments=RESUME_BATCH)
    if mesh.rank == 0:
        with open(dst, "rb") as f:
            out["journaled"] = f.read()
    out["coords"] = make_mesh(world, sps[-1], device=dev).coords
    out["bad_n"] = _raises(lambda: make_mesh(world + 1, device=dev))
    out["bad_sp"] = _raises(lambda: make_mesh(world, world + 1, device=dev))
    return out


def journaled(mesh, src: str, dst: str, resume: bool) -> bytes | None:
    """``compress_sharded_resumable`` of ``src`` into ``dst`` in batches
    of :data:`RESUME_BATCH`; on rank 0 the container. Set
    ``TDC_CRASH_AFTER_BATCH`` in the ranks to stop it midway."""
    compress_sharded_resumable(BlockCodec(device=mesh.device), mesh, src,
                               dst, batch_segments=RESUME_BATCH,
                               resume=resume)
    if mesh.rank != 0:
        return None
    with open(dst, "rb") as f:
        return f.read()


def loaded_modules(mesh) -> list:
    """The modules of JAX or the JAX package this rank has loaded."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "tudocomp_tpu"))
