"""One run of one cell: set-up, the measured window, the check.

The window drives the program as its command line does, less the file
I/O: ``tudocomp_tpu_torch.cli.compress(algorithm, data, device=...)``
and ``cli.decompress(container, device=...)`` (algorithm string ->
registry -> ``Env`` -> compressor, with the restriction escape), in a
closed loop with one caller: compress file ``i`` of the run's distinct
inputs, decompress its container, go on to file ``i + 1``, until the
window's seconds are up. Each rate is all the bytes of its calls over
the summed wall time of those calls.

A traced run (``trace=True``) records the window under
``torch.profiler`` with a span around each call, then calls the layers
one at a time, as the chain does (the configuration's ``layers``), each
under a span of its own, and hands the trace and its records to the
per-layer metric readers.

Between calls, outside their times, the run keeps a SHA-256 digest of
each output, and the bytes of each output whose digest it has not seen
(normally one container a file), so that its memory does not grow with
the window. Once the window has closed, the run reads the device's peak
memory, makes sure that no JAX module was loaded, frees the program's
state, and compares every container with the plain reference's
(``reference/``) and every restored file with its input: bytes that
differ, an output of an unseen digest counted byte for byte.
"""

from __future__ import annotations

import gc
import hashlib
import importlib
import json
import os
import sys
import time
import traceback
from collections import defaultdict
from contextlib import nullcontext

import numpy as np
import torch

from benchmark import inputs as inputs_mod
from benchmark import spec as spec_mod
from benchmark.trace import Trace

#: top-level module names that the run may not load
FORBIDDEN = ("jax", "jaxlib", "flax", "tudocomp_tpu", "bench")


class ForbiddenModules(RuntimeError):
    pass


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def digest(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


class _Outputs:
    """Each call's output as a digest, and the bytes of each digest the
    first time it comes."""

    def __init__(self):
        self.digests = []   # (input index, digest or None)
        self.blobs = {}

    def add(self, k: int, out) -> None:
        d = None if out is None else digest(out)
        if d is not None and d not in self.blobs:
            self.blobs[d] = out
        self.digests.append((k, d))

    def off(self, want: dict) -> int:
        """Bytes that differ from ``want[k]``, over every call."""
        wanted = {k: digest(w) for k, w in want.items()}
        return sum(bytes_off(self.blobs.get(d), want[k])
                   for k, d in self.digests if d != wanted[k])


def bytes_off(got, want: bytes) -> int:
    """Bytes that differ, counting a length difference in full."""
    if got is None:
        return len(want)
    m = min(len(got), len(want))
    a = np.frombuffer(got, np.uint8, m)
    b = np.frombuffer(want, np.uint8, m)
    return int(np.count_nonzero(a != b)) + abs(len(got) - len(want))


def reference(config: dict, data: bytes, device, control: bool = False
              ) -> bytes:
    """The container the configuration's algorithm writes for ``data``,
    worked out by the plain reference. ``control`` breaks the format's
    guarantee that the Huffman table comes from the sampled histogram
    (it counts every segment instead)."""
    out = data
    for stage in config["reference"]:
        options = {k: v for k, v in stage.items() if k != "stage"}
        if control and stage["stage"] == "tbc2":
            options["exact_hist"] = True
        module = importlib.import_module("benchmark.reference."
                                         + stage["stage"])
        out = module.compress(out, device, **options)
    return config["header"].encode() + b"%" + out


class _Spans:
    """Spans around the harness's calls: a profiler range when traced,
    and a record of bytes and seconds."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.records = defaultdict(list)

    def call(self, name: str, fn, arg, **extra):
        ctx = (torch.profiler.record_function(name) if self.traced
               else nullcontext())
        with ctx:
            t0 = time.perf_counter()
            out = fn(arg)
            seconds = time.perf_counter() - t0
        self.records[name].append(dict(bytes_in=len(arg),
                                       bytes_out=len(out), seconds=seconds,
                                       **extra))
        return out, seconds


def _layers(cell, data: bytes, device, spans: _Spans):
    """The configuration's layers, called one at a time as the chain
    calls them; returns the last stage's container and the restored
    bytes."""
    from tudocomp_tpu_torch.cli import REGISTRY
    from tudocomp_tpu_torch.io.restrictions import escape, unescape
    from tudocomp_tpu_torch.models.blockcodec import BlockCodec

    stages = []
    x = data
    for layer in cell.config["layers"]:
        name = layer["span"]
        if layer["call"] == "blockcodec":
            codec = BlockCodec(device=device, **layer.get("options", {}))
            x, _ = spans.call(name + ".compress", codec.compress, x)
            spans.records[name + ".compress"][-1].update(
                timings=dict(codec.timings), container=x)
            stages.append((layer, codec, None))
        else:
            comp = REGISTRY.instantiate(layer["algorithm"],
                                        torch_device=device)
            restr = REGISTRY.restrictions_of(comp.env)
            x, _ = spans.call(name + ".compress", comp.compress,
                              escape(x, restr))
            stages.append((layer, comp, restr))
    container = x
    for layer, obj, restr in reversed(stages):
        name = layer["span"]
        if restr is None:
            x, _ = spans.call(name + ".decompress", obj.decompress_device, x,
                              container=x)
            spans.records[name + ".decompress"][-1].update(
                timings=dict(obj.timings))
        else:
            x, _ = spans.call(name + ".decompress", obj.decompress, x)
            x = unescape(x, restr)
    return container, x


def _peaks() -> dict:
    with open(os.path.join(spec_mod.HERE, "peaks.json")) as f:
        return json.load(f)


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device="cuda", t0: float | None = None,
        overrides: dict | None = None) -> dict:
    """Run the cell once; returns the result line's object. ``t0`` is
    when the process started (set-up counts from it); ``overrides``
    replace entries of the traffic mix (tests run small files). Raises
    ``ForbiddenModules`` where a JAX module was loaded."""
    log = sys.stderr
    t0 = time.perf_counter() if t0 is None else t0
    cell = spec_mod.cell(workload)
    traffic = dict(cell.traffic, **(overrides or {}))
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    # -- set-up: inputs, the program, one round trip of each shape ------
    s0 = time.perf_counter()
    data = inputs_mod.make(cell.config, traffic, seed, dev)
    s1 = time.perf_counter()
    from tudocomp_tpu_torch import cli

    algo = cell.config["algorithm"]
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    cli.decompress(cli.compress(algo, data[0], device=dev), device=dev)
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    print(f"set-up: {setup_s:.3f} s: {s0 - t0:.3f} s to the cell, "
          f"{s1 - s0:.3f} s for the inputs, {t0 + setup_s - s1:.3f} s to "
          f"load the program and make one round trip", file=log)

    # -- the window ------------------------------------------------------
    spans = _Spans(trace)
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    containers, restored_files = _Outputs(), _Outputs()
    failed = 0
    c_bytes = c_time = d_bytes = d_time = 0.0
    w_ctx = (torch.profiler.record_function("window") if trace
             else nullcontext())
    with w_ctx:
        start = time.perf_counter()
        deadline = start + seconds
        i = 0
        while time.perf_counter() < deadline:
            k = i % len(data)
            i += 1
            container = restored = None
            try:
                container, dt = spans.call(
                    "cli.compress",
                    lambda x: cli.compress(algo, x, device=dev), data[k])
                c_bytes += len(data[k])
                c_time += dt
                restored, dt = spans.call(
                    "cli.decompress",
                    lambda x: cli.decompress(x, device=dev), container)
                d_bytes += len(restored)
                d_time += dt
            except Exception:  # noqa: BLE001 - a call that raises fails
                failed += 1
                traceback.print_exc(file=log)
            containers.add(k, container)
            restored_files.add(k, restored)
            container = restored = None
        window_s = time.perf_counter() - start
    calls = containers.digests
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    found = loaded_forbidden()
    if found:
        if prof is not None:
            prof.__exit__(None, None, None)
        raise ForbiddenModules("loaded: " + ", ".join(found))

    layer_out = []
    if trace:
        for x in data:
            layer_out.append(_layers(cell, x, dev, spans))
        prof.__exit__(None, None, None)
        out_dir = os.path.join(spec_mod.ROOT, "bench_out")
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"trace.{workload}.json")
        prof.export_chrome_trace(path)
        kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
        tr = Trace.from_chrome(path, spans.records, kind, _peaks())
        del prof
    if cuda:
        torch.cuda.synchronize(dev)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # -- the check -------------------------------------------------------
    r0 = time.perf_counter()
    used = sorted({k for k, _ in calls})
    want = {k: reference(cell.config, data[k], dev)
            for k in range(len(data)) if trace or k in used}
    expect = {k: digest(w) for k, w in want.items()}
    source = {k: digest(x) for k, x in enumerate(data)}
    failed += sum(1 for (k, c), (_, r) in zip(containers.digests,
                                              restored_files.digests)
                  if c is not None and r is not None
                  and (c != expect[k] or r != source[k]))
    checks = {"container_bytes_off": [containers.off(want), 0],
              "restored_bytes_off": [restored_files.off(dict(
                  enumerate(data))), 0]}
    if trace:
        off = 0
        for k, (container, restored) in enumerate(layer_out):
            payload = want[k][want[k].index(b"%") + 1:]
            off += bytes_off(container, payload) + bytes_off(restored,
                                                             data[k])
        checks["layer_bytes_off"] = [off, 0]
    print(f"reference: {time.perf_counter() - r0:.3f} s for {len(want)} "
          f"input(s)", file=log)
    if used:
        ratio = len(want[used[0]]) / len(data[used[0]])
        print(f"ratio: {len(want[used[0]])} / {len(data[used[0]])} bytes "
              f"= {ratio:.6f}", file=log)
    correct = bool(calls) and all(v <= lim for v, lim in checks.values())

    # -- the result ------------------------------------------------------
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": 2 * len(calls),
              "failed": failed, "metrics": {}, "device": device_info}
    if not trace:
        values = {"compress_GBps": c_bytes / c_time / 1e9 if c_time else None,
                  "decompress_GBps": (d_bytes / d_time / 1e9 if d_time
                                      else None),
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                result["metrics"][m["name"]] = {"value": values[m["name"]],
                                                "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            value = spec_mod.reader(m["name"])(tr)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        device_info["busy_s"] = tr.busy_seconds("window")
        device_info["window_s"] = tr.span_seconds("window")
        result["breakdown"] = tr.breakdown("window")
    for name in ("cli.compress", "cli.decompress"):
        times = " ".join(f"{r['seconds']:.4f}" for r in spans.records[name])
        print(f"{name} s: {times}", file=log)
    print(f"window: {len(calls)} round trips in {window_s:.3f} s; "
          f"compress {c_bytes / max(c_time, 1e-9) / 1e9:.6f} GB/s, "
          f"decompress {d_bytes / max(d_time, 1e-9) / 1e9:.6f} GB/s",
          file=log)
    for name, (value, limit) in checks.items():
        print(f"check {name} {value} limit {limit}", file=log)
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, (value, limit) in checks.items()}
    return result
