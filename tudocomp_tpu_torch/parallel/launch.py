"""Spawn the ranks of one job on this host and wait for them.

``run_ranks(fn, world)`` starts ``world`` processes (the ``spawn`` start
method: each imports only the module of ``fn`` and its own), joins them
into one process group over a ``FileStore`` in a temporary directory (no
network, no port to race for), runs ``fn(mesh, *args)`` on every rank and
returns each rank's result. Every spawn has a wall-clock limit; when a
rank exits non-zero or the limit passes, the other ranks are killed and
``RanksFailed`` carries every rank's exit code. Nothing waits without a
bound: the process group also has a timeout (``distributed.TIMEOUT``).
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import tempfile
import time

import torch
import torch.distributed as dist

from tudocomp_tpu_torch.device import resolve_device
from tudocomp_tpu_torch.parallel.distributed import TIMEOUT
from tudocomp_tpu_torch.parallel.mesh import make_mesh


class RanksFailed(RuntimeError):
    """A rank exited non-zero, or the ranks ran past their limit.
    ``exitcodes``: each rank's exit code (negative: killed by that
    signal)."""

    def __init__(self, message: str, exitcodes: list):
        super().__init__(f"{message}: exit codes {exitcodes}")
        self.exitcodes = exitcodes


def _rank_main(fn, rank: int, world: int, sp: int, device: str,
               backend: str, workdir: str, args: tuple, env: dict) -> None:
    os.environ.update(env)
    torch.set_num_threads(1)
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(workdir, "store"), world),
        rank=rank, world_size=world, timeout=TIMEOUT,
    )
    try:
        out = fn(make_mesh(world, sp, device=device), *args)
        dist.barrier()  # no rank leaves while another still needs it
    finally:
        dist.destroy_process_group()
    path = os.path.join(workdir, f"rank{rank}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(path + ".tmp", path)


def _wait(procs, deadline: float) -> bool | None:
    """Until every process has exited 0 (True), one has exited non-zero
    (False) or the deadline passes (None)."""
    while True:
        codes = [p.exitcode for p in procs]
        if any(c not in (None, 0) for c in codes):
            return False
        if all(c == 0 for c in codes):
            return True
        if time.monotonic() > deadline:
            return None
        time.sleep(0.02)


def run_ranks(fn, world: int, *, device="cuda", backend: str | None = None,
              sp: int = 1, args: tuple = (), env: dict | None = None,
              timeout: float = 300.0) -> list:
    """``fn(mesh, *args)`` on each of ``world`` spawned ranks, each with
    a ``(world // sp, sp)`` mesh on ``device`` (CUDA unless the caller
    names the CPU; it raises here, before any spawn, where CUDA is
    absent). ``backend`` defaults to ``nccl`` on CUDA and ``gloo`` on the
    CPU; ``env`` is set in every rank before it starts. ``fn`` must be
    importable by name and its result picklable. Returns the results in
    rank order; raises ``RanksFailed`` if a rank exits non-zero or the
    ranks run past ``timeout`` seconds."""
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="tdc_ranks_") as workdir:
        procs = [ctx.Process(target=_rank_main, args=(
            fn, r, world, sp, str(dev), backend, workdir, tuple(args),
            dict(env or {}))) for r in range(world)]
        ok = None
        try:
            for p in procs:
                p.start()
            ok = _wait(procs, time.monotonic() + timeout)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                if p.pid is not None:
                    p.join(30)
        codes = [p.exitcode for p in procs]
        if ok is None:
            raise RanksFailed(f"ranks ran past {timeout} s", codes)
        if not ok:
            raise RanksFailed("a rank failed", codes)
        out = []
        for r in range(world):
            with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
