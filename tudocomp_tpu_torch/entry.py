"""Driver entry points of the port: the flagship encode step with tiny
example arguments, and the multi-device dry run.

``entry()`` is the counterpart of ``__graft_entry__.entry()``:
``rle_stage`` with the histogram over every row (unsampled), then
``huff_stage`` under the identity table, on 8 segments of 2048 random
bytes below 8 (seed 0). The arguments are tensors on ``device``, CUDA
unless the caller names another; CUDA raises where it is absent. On
CUDA the step runs K1's and K2's select entries and K3; on the CPU their
plain versions.
``dryrun_multichip(n)`` is the counterpart of
``__graft_entry__.dryrun_multichip``, on ``n`` spawned ranks.
"""

from __future__ import annotations

import numpy as np
import torch

from tudocomp_tpu_torch.device import resolve_device
from tudocomp_tpu_torch.models.blockcodec import huff_stage, rle_stage


def entry(device="cuda"):
    """``(fn, args)``: ``fn(*args)`` returns ``(words i32[8, 512],
    bits i32[8], hist i64[256])``."""
    dev = resolve_device(device)

    def fn(seg_rows, seg_lens, sym_code, sym_len):
        rows, counts, rle_raw, hist = rle_stage(
            seg_rows, seg_lens, offset=0, hist_rows=slice(None)
        )
        words, bits, huff_raw = huff_stage(rows, counts, sym_code, sym_len)
        return words, bits, hist

    rng = np.random.default_rng(0)
    seg_rows = torch.from_numpy(
        rng.integers(0, 8, (8, 2048), dtype=np.uint8)
    ).to(dev)
    seg_lens = torch.full((8,), 2048, dtype=torch.int32, device=dev)
    sym_code = torch.arange(256, dtype=torch.int32, device=dev)
    sym_len = torch.full((256,), 8, dtype=torch.int32, device=dev)
    return fn, (seg_rows, seg_lens, sym_code, sym_len)


def dryrun_multichip(n_devices: int, device="cuda",
                     backend: str | None = None) -> None:
    """Counterpart of ``__graft_entry__.dryrun_multichip``: spawn
    ``n_devices`` ranks (``parallel/launch.py``; a ``(n / 2, 2)`` mesh
    when ``n`` is even) on ``device`` and run the JAX dry run's checks on
    the same data there (:func:`_dryrun_rank`). ``backend`` defaults to
    ``nccl`` on CUDA and ``gloo`` on the CPU; several ranks on one card
    need ``gloo``. Any rank's failure raises here (``RanksFailed``)."""
    from tudocomp_tpu_torch.parallel.launch import run_ranks

    run_ranks(_dryrun_rank, n_devices, device=device, backend=backend,
              sp=2 if n_devices % 2 == 0 else 1)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _dryrun_rank(mesh) -> None:
    """One rank of :func:`dryrun_multichip`: the sharded container of
    2 MiB (1024 segments, histogram sampled) equals the one-device
    container, which ``decompress``, ``decompress_device`` and
    ``decompress_sharded`` restore; ``factorize_blocks_sharded`` on
    2 * n blocks of 2 KiB equals ``factorize_device`` per block; the
    journaled ``compress_sharded_resumable`` (256-segment batches)
    writes the one-shot container. Rank 0 checks."""
    import os
    import tempfile

    from tudocomp_tpu_torch.models.blockcodec import BlockCodec
    from tudocomp_tpu_torch.ops.lzss import factorize_device
    from tudocomp_tpu_torch.parallel.pipeline import (
        compress_sharded, compress_sharded_resumable, decompress_sharded,
        factorize_blocks_sharded,
    )

    root = mesh.rank == 0
    codec = BlockCodec(device=mesh.device)
    rng = np.random.default_rng(1)
    data = (
        b"abracadabra " * 60000
        + bytes(rng.integers(0, 4, 1 << 20, dtype=np.uint8))
    )[: 2 << 20]
    _check(codec.sample_rule(-(-len(data) // 2048)), "input not sampled")
    compressed = mesh.broadcast(compress_sharded(codec, mesh, data))
    if root:
        _check(compressed == codec.compress(data),
               "compress_sharded differs from BlockCodec.compress")
        _check(codec.decompress(compressed) == data, "decompress")
        _check(codec.decompress_device(compressed) == data,
               "decompress_device")
    restored = decompress_sharded(codec, mesh, compressed)
    _check(not root or restored == data, "decompress_sharded")

    n_blocks = 2 * mesh.size
    blocks = np.stack([
        np.frombuffer(
            ((b"lz mesh block %d jumps over the lazy dog " % i) * 52)
            [:2047] + b"\x00",
            np.uint8,
        )
        for i in range(n_blocks)
    ])
    got = factorize_blocks_sharded(mesh, blocks, threshold=3, max_len=512)
    if root:
        for i in range(n_blocks):
            want = factorize_device(blocks[i], 3, max_len=512, exact=True,
                                    device=mesh.device)
            _check(all(np.array_equal(a, b) for a, b in zip(got[i], want)),
                   f"factorize_blocks_sharded block {i}")

    # rank 0 writes the input in its temporary directory, then names it
    tmp = tempfile.TemporaryDirectory() if root else None
    try:
        if root:
            with open(os.path.join(tmp.name, "in.bin"), "wb") as f:
                f.write(data)
        td = mesh.broadcast(tmp.name if root else None)
        dst = os.path.join(td, "out.tbc2")
        compress_sharded_resumable(codec, mesh, os.path.join(td, "in.bin"),
                                   dst, batch_segments=256)
        if root:
            with open(dst, "rb") as f:
                _check(f.read() == compressed,
                       "compress_sharded_resumable differs")
    finally:
        if tmp is not None:
            tmp.cleanup()
