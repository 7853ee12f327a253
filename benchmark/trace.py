"""The reduction of a traced run: device time inside spans, idle gaps.

A traced run records ``torch.profiler`` activity (the chrome trace it
exports) and the harness's own records. From the trace this module
keeps:

- device operations (``kernel``, ``gpu_memcpy``, ``gpu_memset``) as
  intervals; *busy* time is the length of their union, so that
  operations that overlap count once;
- spans: ``torch.profiler.record_function`` ranges (``user_annotation``)
  by name, the harness's around each call it makes and the program's
  own;
- host activity (operators, annotations, CUDA runtime calls), to name
  what the host was doing while the device sat idle.

The records (``records[span name]``: one dict a call, in call order)
hold what the trace cannot: bytes in and out, the program's stage
timings, the outputs. Per-layer metric readers (``metrics/``) take a
:class:`Trace` and return a number, or ``None`` where it has nothing to
read.
"""

from __future__ import annotations

import heapq
import json
from collections import defaultdict

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class Cover:
    """The union of intervals, and how much of ``[a, b]`` it covers."""

    def __init__(self, intervals):
        iv = sorted(intervals)
        starts, ends = [], []
        for a, b in iv:
            if starts and a <= ends[-1]:
                ends[-1] = max(ends[-1], b)
            else:
                starts.append(a)
                ends.append(b)
        self.starts = np.array(starts, np.float64)
        self.ends = np.array(ends, np.float64)
        self.before = np.concatenate(
            [[0.0], np.cumsum(self.ends - self.starts)])

    def upto(self, x: float) -> float:
        """Covered length of ``(-inf, x]``."""
        i = int(np.searchsorted(self.ends, x, side="right"))
        part = 0.0
        if i < self.starts.size and self.starts[i] < x:
            part = x - self.starts[i]
        return float(self.before[i] + part)

    def within(self, a: float, b: float) -> float:
        return self.upto(b) - self.upto(a) if b > a else 0.0


class Trace:
    """One traced run. Times are seconds on the trace's clock."""

    def __init__(self, events: list, records: dict, device_kind: str,
                 peaks: dict):
        self.records = records
        self.device_kind = device_kind
        self.peaks = peaks
        self.device = []   # (start, end, name, cat)
        self.host = []     # (start, end, name)
        self.spans = defaultdict(list)
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            a = float(e["ts"]) * 1e-6
            b = a + float(e["dur"]) * 1e-6
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                self.device.append((a, b, e.get("name", ""), cat))
            elif cat in HOST_CATS:
                self.host.append((a, b, e.get("name", "")))
                if cat == "user_annotation":
                    self.spans[e["name"]].append((a, b))
        for v in self.spans.values():
            v.sort()
        self.busy = Cover((a, b) for a, b, _, _ in self.device)
        self.kernels = Cover((a, b) for a, b, _, c in self.device
                             if c == "kernel")

    @classmethod
    def from_chrome(cls, path: str, records: dict, device_kind: str,
                    peaks: dict) -> "Trace":
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        return cls(events, records, device_kind, peaks)

    def peak(self, key: str):
        return self.peaks.get(self.device_kind, {}).get(key)

    def span_seconds(self, name: str) -> float:
        return sum(b - a for a, b in self.spans.get(name, ()))

    def busy_seconds(self, name: str) -> float:
        """Device time, overlaps counted once, inside the spans ``name``."""
        return sum(self.busy.within(a, b) for a, b in self.spans.get(name,
                                                                     ()))

    def kernel_seconds(self, name: str) -> float:
        """Time in which a kernel (no copy, no fill) ran inside ``name``."""
        return sum(self.kernels.within(a, b)
                   for a, b in self.spans.get(name, ()))

    def idle_share(self, name: str):
        """The share of the spans ``name`` in which no device operation
        ran; ``None`` without spans or without any device operation."""
        total = self.span_seconds(name)
        if total <= 0 or not self.device:
            return None
        return 1.0 - self.busy_seconds(name) / total

    def breakdown(self, window: str, top: int = 10) -> dict:
        """In the span ``window``: the device operations that took most
        time, and the idle gaps' time by the innermost host activity
        under way (``(no host activity)`` where none was)."""
        w0, w1 = (self.spans.get(window) or [(0.0, 0.0)])[0]
        ops = defaultdict(float)
        for a, b, name, _ in self.device:
            if b > w0 and a < w1:
                ops[name] += min(b, w1) - max(a, w0)
        idle = defaultdict(float)
        edges = []
        for i, (a, b, _) in enumerate(self.host):
            if b > w0 and a < w1:
                edges.append((max(a, w0), 1, i))
                edges.append((min(b, w1), 0, i))
        edges.sort()
        # heap of (-start, end, index): the innermost activity first
        active, done = [], set()
        t = w0
        for x, opening, i in edges + [(w1, 0, -1)]:
            while active and active[0][2] in done:
                heapq.heappop(active)
            gap = (x - t) - self.busy.within(t, x)
            if gap > 0:
                name = (self.host[active[0][2]][2] if active
                        else "(no host activity)")
                idle[name] += gap
            t = max(t, x)
            if i < 0:
                break
            if opening:
                heapq.heappush(active, (-self.host[i][0], self.host[i][1],
                                        i))
            else:
                done.add(i)

        def best(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:top]]

        return {"device_ops": best(ops), "idle_gaps": best(idle)}
