"""Worker for ``tests/test_torch_parallel.py``: one CPU process of a
2-process job joined by the port's ``distributed.initialize`` over TCP
on this host (the counterpart of ``tests/dist_worker.py``).

It takes its contiguous slice of the segment batch (equal slices, the
last padded with empty segments), runs ``compress_distributed`` and
writes its pieces, tagged with their global segment index; process 0
also writes the input and the container's prefix. It imports nothing of
JAX or the JAX package.

Usage: torch_dist_worker.py PID NPROC PORT OUTDIR
"""

import os
import sys

import numpy as np
import torch

pid, nproc, port, outdir = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
torch.set_num_threads(1)

from tudocomp_tpu_torch.models.blockcodec import BlockCodec  # noqa: E402
from tudocomp_tpu_torch.parallel import distributed, make_mesh  # noqa: E402

distributed.initialize(f"localhost:{port}", nproc, pid, backend="gloo")
mesh = make_mesh(nproc, device="cpu")

rng = np.random.default_rng(11)
data = (
    b"rosebud was his sled all along; " * 22000
    + bytes(rng.integers(0, 48, 400000, dtype=np.uint8))
)[: (1 << 20) + 3000]  # 513 segments: the last slice ends in padding
codec = BlockCodec(device="cpu")
rows, lens = codec.split_segments(data)
per = -(-rows.shape[0] // nproc)
rows = np.pad(rows, ((0, per * nproc - rows.shape[0]), (0, 0)))
lens = np.pad(lens, (0, per * nproc - lens.shape[0]))
local = slice(pid * per, (pid + 1) * per)

_, _, first = distributed.global_block_batch(mesh, rows[local], lens[local])
prefix, pieces = distributed.compress_distributed(
    codec, mesh, rows[local], lens[local], len(data))
with open(os.path.join(outdir, f"first{pid}.txt"), "w") as f:
    f.write(str(first))
if pid == 0:
    with open(os.path.join(outdir, "prefix.bin"), "wb") as f:
        f.write(prefix)
    with open(os.path.join(outdir, "input.bin"), "wb") as f:
        f.write(data)
for start, frames in pieces:
    with open(os.path.join(outdir, f"piece_{start:08d}.bin"), "wb") as f:
        f.write(frames)
torch.distributed.destroy_process_group()
print("WORKER_OK", pid, flush=True)
