#!/usr/bin/env python3
"""Card times of the TBC2 codec's RLE stage and decode kernel (K1, K4).

Run from the root of a checkout: ``python3 etc/torch_kernels.py``. The
package it times is the one under the current directory, so the same
script times another checkout of the port when run from that
checkout's root (``cd other && python3 /path/to/etc/torch_kernels.py``):
it calls only entry points that the port has had since its first
version. It needs CUDA and exits non-zero without it.

On ``bench.make_corpus(256 << 20)`` it times, with CUDA events (mean
per call after a warm-up):

- K1 (``rle_pack_segments``) on the first 16 MiB batch of 8192 segments;
- ``rle_stage`` on that batch without the histogram: K1, the ``rle_raw``
  escape select and the counts, i.e. the stage's device time per batch;
- K4 (``decode_segments``) on the container of that batch, and on the
  container of the whole 256 MiB in one launch, as ``decompress_device``
  runs it.

Each line carries its bound: the bytes the function must move (inputs
read once, outputs written once) over 3.35 TB/s. The last line is one
JSON object with every number. Imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

MIB = 1 << 20
SEG = 2048
HBM_BYTES_PER_S = 3.35e12


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def decode_case(codec, data: bytes, dev):
    """K4's call on the container of ``data``, its bound in bytes, and
    the check that it restores ``data``."""
    import numpy as np
    import torch

    from tudocomp_tpu_torch.models.blockcodec import device_tables
    from tudocomp_tpu_torch.ops.hufdec import decode_segments

    container = codec.compress(data)
    table, offset, orig_len, cnt, flags, poff, pbytes = codec._parse(
        container)
    t = device_tables(table, dev)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        np.frombuffer(container, np.uint8).copy(), poff.astype(np.int64),
        pbytes.astype(np.int64), cnt.astype(np.int32),
        flags.astype(np.uint8))] + [t["thresh"], t["offs"], t["symbols"]]
    kw = {"fast": t["fast"]} if "fast" in t else {}

    def call():
        return decode_segments(*args, offset=offset, orig_len=orig_len, **kw)

    if call().cpu().numpy().tobytes() != data:
        raise AssertionError("K4 did not restore its input")
    nbytes = int(pbytes.sum()) + 21 * cnt.size + 4 * 32 + 256 + orig_len
    return call, nbytes


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_kernels: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import tudocomp_tpu_torch
    from bench import make_corpus
    from tudocomp_tpu_torch import BlockCodec, _build
    from tudocomp_tpu_torch.models.blockcodec import rle_stage
    from tudocomp_tpu_torch.ops.segpack import rle_pack_segments

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(card)
    print(f"package {os.path.dirname(tudocomp_tpu_torch.__file__)}")
    print(f"kernel build {_build.build():.1f} s")
    dev = torch.device("cuda")
    corpus = make_corpus(256 * MIB)
    codec = BlockCodec(device=dev)
    batch = corpus[: 8192 * SEG].tobytes()
    rows_np, lens_np = codec.split_segments(batch)
    rows = torch.from_numpy(rows_np).to(dev)
    lens = torch.from_numpy(lens_np).to(dev)
    nseg = rows.shape[0]
    # live bytes and lengths in; 512 words and a count per segment out
    k1_bytes = int(lens_np.sum()) + 4 * nseg + 4 * (512 * nseg + nseg)
    res = {
        "card": card,
        "rle_pack_ms": time_ms(lambda: rle_pack_segments(rows, lens), 20),
        "rle_pack_bound_ms": bound_ms(k1_bytes),
        "rle_stage_ms": time_ms(
            lambda: rle_stage(rows, lens, offset=0, hist_rows=None), 20),
        # + the escape flag
        "rle_stage_bound_ms": bound_ms(k1_bytes + nseg),
    }
    for tag, data in (("16MiB", batch), ("256MiB", corpus.tobytes())):
        call, nbytes = decode_case(codec, data, dev)
        res[f"decode_{tag}_ms"] = time_ms(call, 10)
        res[f"decode_{tag}_bound_ms"] = bound_ms(nbytes)
    for key, value in res.items():
        if key != "card":
            print(f"{key}: {value:.4f}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
