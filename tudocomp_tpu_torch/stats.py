"""StatPhase: nested time/memory phase tracking with JSON export.

Re-design of the reference's observability layer
(``tudocomp_stat/StatPhase.hpp:24-336``, malloc override
``src/tudocomp_stat/malloc.cpp``): RAII-nested phases measuring wall time
and memory, arbitrary key-value stats, and a JSON tree compatible in
spirit with the reference's ``--stats`` output / the D3 charter app.

The port's copy of ``tudocomp_tpu/stats.py``, with its two JAX hooks on
torch:
- host memory is sampled via ``tracemalloc`` when enabled (the Python
  equivalent of the reference's malloc hook);
- device memory is the CUDA allocator's live bytes, read only once CUDA
  is initialised (reading it never initialises CUDA): ``devMemPeak`` is,
  as in the JAX package, the live device bytes at a phase's exit less
  those at its entry, bubbled up through the tree;
- every phase opens a ``torch.profiler.record_function`` range, so
  phase names show up in traces captured with ``torch.profiler``.

The innermost open phase is kept per thread: a phase opened on a thread
with no open phase of its own is a root there, and joins no other
thread's tree.

While a ``torch.profiler`` session records the thread (the profiler's
own flag, per thread, read at each phase's entry), every phase that
closes there is also kept in a span log, :meth:`StatPhase.recorded`:
its name, id, parent id, thread, host start and end
(``time.perf_counter`` seconds) and its stats. So each record has its
range in the trace. The log is emptied at the first phase that finds a
session recording after one that found none: it holds one session
where any phase ran between the two. A reader pairs its records with
the trace's ranges by name and order, and takes the times from the
trace, which puts them on the clock of the device's operations.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
import tracemalloc
from typing import Any, Dict, List, Optional

import torch


def _device_mem() -> int:
    # never initialise CUDA just to read memory: the first CUDA call
    # would land inside whatever phase happened to run first. This is
    # torch.cuda.memory_allocated() without the flattened and sorted
    # copy of every allocator statistic that it builds on each call
    if not torch.cuda.is_initialized():
        return 0
    stats = torch._C._cuda_memoryStats(torch.cuda.current_device())
    return int(stats["allocated_bytes"]["all"]["current"])


def _profiling() -> bool:
    return torch._C._autograd._profiler_enabled()


class StatPhase:
    """Nested phase timer. Use as a context manager::

        with StatPhase("compress") as root:
            with StatPhase("construct sa"):
                ...
            root.log_stat("factors", n)
        print(root.to_json_str())
    """

    _local = threading.local()  # .phase: the innermost open phase
    _ids = itertools.count(1)
    _log: List[Dict[str, Any]] = []
    _recording = False

    def __init__(self, title: str, track_memory: bool = False):
        self.title = title
        self.children: List[StatPhase] = []
        self.stats: Dict[str, Any] = {}
        self.parent: Optional[StatPhase] = None
        self.track_memory = track_memory
        self.duration_ms = 0.0
        self.mem_peak = 0
        self.dev_mem_peak = 0
        self._t0 = 0.0
        self._trace = None
        self._record = False

    # -- lifecycle -----------------------------------------------------------

    def __enter__(self) -> "StatPhase":
        local = StatPhase._local
        self.parent = getattr(local, "phase", None)
        if self.parent is not None:
            self.parent.children.append(self)
            self.track_memory = self.track_memory or self.parent.track_memory
        local.phase = self
        self.id = next(StatPhase._ids)
        self._record = _profiling()
        if self._record and not StatPhase._recording:
            StatPhase._log.clear()  # a new profiler session
        StatPhase._recording = self._record
        if self.track_memory and not tracemalloc.is_tracing():
            tracemalloc.start()
        if self.track_memory:
            self._mem0 = tracemalloc.get_traced_memory()[0]
        self._dev0 = _device_mem()
        self._trace = torch.profiler.record_function(self.title)
        self._trace.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        self.duration_ms = (t1 - self._t0) * 1000.0
        self._trace.__exit__(*exc)
        if self.track_memory:
            cur, peak = tracemalloc.get_traced_memory()
            self.mem_peak = max(self.mem_peak, peak - self._mem0)
        self.dev_mem_peak = max(self.dev_mem_peak, _device_mem() - self._dev0)
        StatPhase._local.phase = self.parent
        # bubble peaks up like the reference (StatPhase.hpp:73-86)
        if self.parent is not None:
            self.parent.mem_peak = max(self.parent.mem_peak, self.mem_peak)
            self.parent.dev_mem_peak = max(
                self.parent.dev_mem_peak, self.dev_mem_peak
            )
        if self._record:
            StatPhase._log.append({
                "name": self.title, "id": self.id,
                "parent": None if self.parent is None else self.parent.id,
                "thread": threading.get_ident(), "start": self._t0,
                "end": t1, "stats": dict(self.stats),
            })

    @property
    def seconds(self) -> float:
        """The closed phase's wall time."""
        return self.duration_ms / 1000.0

    # -- stats ---------------------------------------------------------------

    def log_stat(self, key: str, value: Any) -> None:
        self.stats[key] = value

    def log_copy(self, *host) -> None:
        """Counters of a host<->device copy: ``bytes`` of its host-side
        arrays or tensors ``host``, and ``pinned`` (1 where all of them
        are in page-locked memory, else 0)."""
        self.log_stat("bytes", sum(h.nbytes for h in host))
        self.log_stat("pinned", int(all(torch.as_tensor(h).is_pinned()
                                        for h in host)))

    @classmethod
    def log(cls, key: str, value: Any) -> None:
        """Log into this thread's innermost open phase, if any."""
        phase = getattr(cls._local, "phase", None)
        if phase is not None:
            phase.log_stat(key, value)

    @classmethod
    def recorded(cls) -> List[Dict[str, Any]]:
        """The span log of the profiler session under way or last ended:
        one dict per closed phase, in the order they closed."""
        return list(cls._log)

    # -- export --------------------------------------------------------------

    def to_json(self) -> Dict[str, Any]:
        """Reference-shaped phase tree (``StatPhase.hpp:311-321``)."""
        return {
            "title": self.title,
            "timeDelta": self.duration_ms,
            "memPeak": self.mem_peak,
            "devMemPeak": self.dev_mem_peak,
            "stats": [
                {"key": k, "value": v} for k, v in self.stats.items()
            ],
            "sub": [c.to_json() for c in self.children],
        }

    def to_json_str(self, indent: int = 2) -> str:
        return json.dumps(self.to_json(), indent=indent)
