"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout. The last line of standard output is
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``; ``checks`` last, each
number compared beside its limit); the checks are also the last lines
of standard error. Without a CUDA device, or with fewer devices than
the cell asks for, or where a JAX module was loaded, it prints no
result and exits non-zero.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dirs() -> None:
    """Kernel caches inside the checkout, at fixed paths: the program
    builds its own libraries into its package's ``csrc/build/``; these
    take whatever torch or the CUDA driver would compile at run time."""
    cache = os.path.join(ROOT, "bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(cache, sub)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _cache_dirs()
    t_import = time.perf_counter()
    import torch

    from benchmark import spec

    t_cuda = time.perf_counter()
    chips = spec.cell(args.workload).workload["chips"]
    if not torch.cuda.is_available():
        print("no CUDA device: no result", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"{torch.cuda.device_count()} CUDA device(s), the cell asks "
              f"for {chips}: no result", file=sys.stderr)
        return 2
    print(f"start: {t_import - T0:.3f} s to parse, {t_cuda - t_import:.3f} "
          f"s to import torch, {time.perf_counter() - t_cuda:.3f} s to find "
          f"the CUDA devices", file=sys.stderr)
    from benchmark.cell import ForbiddenModules, run

    try:
        result = run(args.workload, args.seed, args.seconds,
                     bool(args.trace), device="cuda", t0=T0)
    except ForbiddenModules as e:
        print(f"forbidden modules were loaded ({e}): no result",
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
