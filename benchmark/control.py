"""The control of a cell's check: the plain reference put in the
program's place with one guarantee of the configuration broken.

The configurations state that the container bytes are the TBC2
format's, whose Huffman table comes from the sampled histogram (every
8th of the first 8192 segments). The control builds its table from
every segment instead: a lossless container, smaller where the sample
misses bytes, and the step a later change might be tempted to take. The
check has to fail it (``container_bytes_off`` above its limit of 0).

    python3 -m benchmark.control --workload NAME --seeds 11,12,13

makes each seed's inputs as a run does, at the cell's own sizes, and
prints the control's reading of each number the check compares beside
its limit. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from benchmark import inputs as inputs_mod
from benchmark import spec as spec_mod
from benchmark.cell import bytes_off, reference


def readings(workload: str, seed: int, device, overrides=None) -> dict:
    """The control's readings of the check's numbers for one seed."""
    cell = spec_mod.cell(workload)
    traffic = dict(cell.traffic, **(overrides or {}))
    dev = torch.device(device)
    data = inputs_mod.make(cell.config, traffic, seed, dev)
    off = 0
    for x in data:
        want = reference(cell.config, x, dev)
        off += bytes_off(reference(cell.config, x, dev, control=True), want)
    # the control decodes as the reference does: every byte restored
    return {"container_bytes_off": off, "restored_bytes_off": 0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    failed_all = True
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = readings(args.workload, seed, args.device)
        fails = r["container_bytes_off"] > 0 or r["restored_bytes_off"] > 0
        failed_all &= fails
        print(f"control {args.workload} seed {seed}: "
              + ", ".join(f"{k} {v} limit 0" for k, v in r.items())
              + f" -> {'not correct' if fails else 'CORRECT'}"
              f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
