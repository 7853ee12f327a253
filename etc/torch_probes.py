#!/usr/bin/env python3
"""Stage probes of the torch port's segment kernels, on one NVIDIA GPU.

Run from the repo root::

    python3 etc/torch_probes.py [ablate|floor|place|all] [MB]

(default ``all`` at 256 MiB of ``bench.make_corpus``, as 2 KiB
segments). It needs CUDA and exits non-zero without it. Counterparts of
the TPU probes, with what each printed:

- ``ablate`` (``etc/probe_ablate.py``, ``etc/probe_ablate_w4.py``): K2
  cut after each stage, in its word form and its byte form, on K2's own
  inputs (K1's escape-selected streams and the sampled table); each
  stage's time and its ``(+delta)`` over the stage before;
- ``floor`` (``etc/probe_floor.py``): the u8 -> i32 widening and the
  big-endian word view alone (torch ops), then each floor variant;
- ``place`` (``etc/probe_int8.py``): each placement strategy at strides
  1 and 2.

Times are the mean of 20 calls after a warm-up (CUDA events), each
beside its bound (``chip_smoke.py``'s). Imports nothing of JAX or the JAX
package.
"""

from __future__ import annotations

import subprocess
import sys

REPS = 20


def main() -> int:
    import torch

    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    mb = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    if which not in ("ablate", "floor", "place", "all"):
        print(f"torch_probes: unknown probe {which!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_probes: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ".")
    from bench import make_corpus
    from chip_smoke import bound, probe_cases, probe_inputs, time_ms
    from tudocomp_tpu_torch import _build
    from tudocomp_tpu_torch.ops.rle import be_words_from_bytes
    from tudocomp_tpu_torch.probes import ablate

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    _build.build()
    x = probe_inputs(make_corpus(mb << 20), torch.device("cuda"))
    cases = {c["name"]: c for c in probe_cases(x)}
    print(f"{mb} MiB: {x['rows'].shape[0]} segments, "
          f"{int(x['counts'].sum())} stream bytes into K2")

    def line(label: str, case: dict, prev: float | None = None) -> float:
        ms = time_ms(case["kernel"], REPS)
        b = bound(case["nbytes"], case["nops"])
        delta = "" if prev is None else f"  (+{ms - prev:.4f} ms)"
        print(f"{label:28s} {ms:8.4f} ms{delta}  bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
        return ms

    if which in ("ablate", "all"):
        for bytes_input in (False, True):
            prev = None
            for stage, what in enumerate(ablate.STAGES):
                name = ablate.variant(stage, bytes_input)
                prev = line(f"s{stage} {what} "
                            f"({'bytes' if bytes_input else 'w4'})",
                            cases[name], prev)
    if which in ("floor", "all"):
        rows = x["rows"]
        print(f"{'conv (u8 -> i32)':28s} "
              f"{time_ms(lambda: rows.to(torch.int32), REPS):8.4f} ms")
        print(f"{'bitcast (big-endian words)':28s} "
              f"{time_ms(lambda: be_words_from_bytes(rows), REPS):8.4f} ms")
        for name, case in cases.items():
            if name.startswith("floor_"):
                line(name, case)
    if which in ("place", "all"):
        for name, case in cases.items():
            if name.startswith("place_"):
                line(name, case)
    return 0


if __name__ == "__main__":
    sys.exit(main())
