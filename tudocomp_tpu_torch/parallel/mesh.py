"""The ``(dp, sp)`` mesh of the port: one process per device, over the
default ``torch.distributed`` process group.

Counterpart of ``tudocomp_tpu/parallel/mesh.py``. The JAX functions run
once, in one controller, over a ``Mesh`` of devices; the port's run on
every rank of a process group (SPMD), and each rank drives one device:
on CUDA, rank ``r`` uses ``cuda:(r % torch.cuda.device_count())``; on
the CPU each rank is a CPU process. The segment axis is split over the
whole group in rank order (JAX's ``P(("dp", "sp"))``): rank ``r`` of
``W = dp * sp`` owns ``[r * ceil(n / W), min((r + 1) * ceil(n / W), n))``,
which may be empty (:meth:`Mesh.segment_range`). No collective runs
along one axis alone, so the mesh keeps both coordinates and no per-axis
groups (``init_device_mesh`` would create one per axis).

The backend is the caller's, chosen where the group is made
(``distributed.initialize``, ``launch.run_ranks``): ``nccl`` for CUDA by
default, ``gloo`` for the CPU, and ``gloo`` on CUDA only when the caller
names it (two ranks on one card, which NCCL refuses). Nothing swaps one
backend for another. Without a process group the mesh has one rank and
its collectives are local.

Cross-rank traffic is the :meth:`Mesh.all_reduce` of the histogram and
host objects (frames, decoded bytes, factor triples, journal state)
gathered to rank 0, the single writer, or sent from it.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from tudocomp_tpu_torch.device import resolve_device


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a ``(dp, sp)`` mesh and the device it
    drives. ``grouped``: a process group exists (collectives go through
    it); without one the mesh has a single rank."""

    dp: int
    sp: int
    rank: int
    device: torch.device
    grouped: bool

    axis_names = ("dp", "sp")

    @property
    def size(self) -> int:
        return self.dp * self.sp

    @property
    def coords(self) -> tuple[int, int]:
        """This rank's ``(dp, sp)`` coordinates (row-major, as JAX's
        ``devs.reshape(dp, sp)``)."""
        return divmod(self.rank, self.sp)

    def segment_range(self, n: int) -> tuple[int, int]:
        """This rank's ``[lo, hi)`` of ``n`` items split in rank order."""
        per = -(-n // self.size)
        lo = min(self.rank * per, n)
        return lo, min(lo + per, n)

    # -- collectives (over the default group; local without one) ----------

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over every rank, in place."""
        if self.grouped:
            dist.all_reduce(t)
        return t

    def gather(self, obj) -> list | None:
        """Every rank's ``obj`` in rank order on rank 0; ``None``
        elsewhere."""
        if not self.grouped:
            return [obj]
        out = [None] * self.size if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0)
        return out

    def all_gather(self, obj) -> list:
        """Every rank's ``obj`` in rank order, on every rank."""
        if not self.grouped:
            return [obj]
        out = [None] * self.size
        dist.all_gather_object(out, obj)
        return out

    def broadcast(self, obj):
        """Rank 0's ``obj`` on every rank."""
        if not self.grouped:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]


def make_mesh(n_devices: int | None = None, sp: int = 1, *,
              device="cuda") -> Mesh:
    """A ``(dp, sp)`` mesh over the default process group (one rank when
    there is none). Raises when ``n_devices`` differs from the group's
    size, when ``sp`` does not divide it, and for CUDA where CUDA is
    absent; an ``nccl`` group needs a CUDA device. On CUDA it makes the
    rank's card current (object collectives on ``nccl`` send through
    it)."""
    dev = resolve_device(device)
    grouped = dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    rank = dist.get_rank() if grouped else 0
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"n_devices={n} but the process group has "
                         f"{world} ranks")
    if sp < 1 or n % sp:
        raise ValueError(f"n_devices={n} not divisible by sp={sp}")
    if grouped and dist.get_backend() == "nccl" and dev.type != "cuda":
        raise ValueError("an nccl group needs a CUDA device")
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return Mesh(dp=n // sp, sp=sp, rank=rank, device=dev, grouped=grouped)
