#!/usr/bin/env python3
"""Where the time goes in the torch port, on one NVIDIA GPU.

Run from the repo root: ``python3 etc/torch_profile.py
[all|stages|chunks]`` (``stages``: only the per-stage traces of item 1,
``chunks``: only items 2 and 3, each in a process of its own). It needs CUDA and exits non-zero without it. After one warm-up of
each, it traces with ``torch.profiler`` (CPU and CUDA activities):

1. the TBC2 codec: ``BlockCodec(device="cuda").compress`` and
   ``decompress_device`` of ``bench.make_corpus(256 << 20)``, then
   ``rle_stage`` alone on the same bytes as 16 device-resident batches
   of 16 MiB (no histogram), so its device time per batch shows apart,
   and K1's plain entry (``rle_pack_segments``) on the same batches;
   ``huff_stage`` alone on those batches' escape-selected streams with
   the codec's table; and the table histogram 16 times over the first
   batch's 1024 sampled rows, once inside ``rle_stage`` (with whatever
   copies the stage makes for it) and once as K3 alone on the gathered
   rows (``histogram_words``);
2. the chunked bit packers on the same bytes as 64 chunks of 4 MiB, as
   ``chip_smoke.py`` phase 6 runs them (K7, RLE tokens, K5, histogram,
   K6, Huffman tokens, K5);
3. K7, K5 (on the RLE tokens) and K6 alone, so that each one's passes
   show apart, and K5's zero-fill of its output (K6 and K7 write their
   zero tails themselves).

For each it prints the host wall time, the device's busy time (the union
of its kernel, copy and memset intervals), the idle share, and the
device time by kernel name. Imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import subprocess
import sys
import time

MIB = 1 << 20
CHUNKS = 64


def _device_events(prof):
    """(name, start, end) in us of every device-side event of a trace:
    kernels, copies and memsets."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def _busy_us(events) -> float:
    """Length of the union of the events' intervals."""
    busy, end = 0.0, float("-inf")
    for _, s, e in sorted(events, key=lambda x: x[1]):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def traced(name: str, fn, top: int = 14) -> None:
    """Run ``fn`` once untraced, then once under the profiler; print the
    wall time, device busy time, idle share and top device items."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = _device_events(prof)
    busy = _busy_us(events) / 1e3
    print(f"== {name}: wall {wall * 1e3:.3f} ms, device busy {busy:.3f} ms,"
          f" idle share {1 - busy / (wall * 1e3):.4f}")
    by_name: dict[str, list] = {}
    for key, s, e in events:
        row = by_name.setdefault(key, [0, 0.0])
        row[0] += 1
        row[1] += (e - s) / 1e3
    for key, (count, ms) in sorted(by_name.items(),
                                   key=lambda r: -r[1][1])[:top]:
        print(f"  {ms:10.3f} ms  {count:5d}x  {key[:100]}")


def main() -> int:
    import torch

    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which not in ("all", "stages", "chunks"):
        print(f"torch_profile: unknown part {which!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_profile: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ".")
    from bench import make_corpus
    from tudocomp_tpu_torch import BlockCodec, _build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    _build.build()
    _build.build_host()
    corpus = make_corpus(256 * MIB)
    codec = BlockCodec(device="cuda")
    dev = torch.device("cuda")
    if which != "chunks":
        stage_traces(which, codec, corpus, dev)
    if which == "stages":
        return 0
    chunk_traces(corpus, dev)
    return 0


def stage_traces(which, codec, corpus, dev) -> None:
    """Item 1: the codec (``all`` only) and its stages alone."""
    import torch

    from tudocomp_tpu_torch.models.blockcodec import (
        BATCH_LANES, huff_stage, rle_stage,
    )
    from tudocomp_tpu_torch.ops.hist import histogram_words
    from tudocomp_tpu_torch.ops.segpack import rle_pack_segments

    data_bytes = corpus.tobytes()
    if which == "all":
        container = codec.compress(data_bytes)
        traced("codec compress 256 MiB", lambda: codec.compress(data_bytes))
        traced("codec decompress_device 256 MiB",
               lambda: codec.decompress_device(container))

    rows = torch.from_numpy(corpus.reshape(-1, 2048)).to(dev)
    seg_lens = torch.full((rows.shape[0],), 2048, dtype=torch.int32,
                          device=dev)

    def stage1():
        for lo in range(0, rows.shape[0], BATCH_LANES):
            rle_stage(rows[lo:lo + BATCH_LANES], seg_lens[lo:lo + BATCH_LANES],
                      offset=0, hist_rows=None)

    traced(f"rle_stage alone, {rows.shape[0] // BATCH_LANES} batches of "
           f"{BATCH_LANES} segments", stage1)

    def k1():
        for lo in range(0, rows.shape[0], BATCH_LANES):
            rle_pack_segments(rows[lo:lo + BATCH_LANES],
                              seg_lens[lo:lo + BATCH_LANES])

    traced("K1 rle_pack_segments alone, same batches", k1)

    sample = slice(0, BATCH_LANES, 8)
    batches = [rle_stage(rows[lo:lo + BATCH_LANES],
                         seg_lens[lo:lo + BATCH_LANES], offset=0,
                         hist_rows=sample if lo == 0 else None)
               for lo in range(0, rows.shape[0], BATCH_LANES)]
    t = codec.table(batches[0][3], True)[1]

    def stage2():
        for sel, counts, _, _ in batches:
            huff_stage(sel, counts, t["sym_code"], t["sym_len"])

    traced(f"huff_stage alone, same {len(batches)} batches", stage2)
    rows0, lens0 = rows[:BATCH_LANES], seg_lens[:BATCH_LANES]

    def hist_in_stage():
        for _ in range(16):
            rle_stage(rows0, lens0, offset=0, hist_rows=sample)

    traced("rle_stage with the 1024-row histogram, first batch, 16 times",
           hist_in_stage)
    sel0, counts0 = batches[0][0], batches[0][1]
    sub, subc = sel0[sample].contiguous(), counts0[sample].contiguous()
    traced("K3 histogram_words alone, the 1024 gathered rows, 16 times",
           lambda: [histogram_words(sub, subc) for _ in range(16)])


def chunk_traces(corpus, dev) -> None:
    """Items 2 and 3: the chunked bit packers."""
    import numpy as np
    import torch

    from tudocomp_tpu_torch.coders.huffman import HuffmanTable
    from tudocomp_tpu_torch.ops import bitpack_chunks as bc
    from tudocomp_tpu_torch.ops.huffman import (
        huffman_encode_tokens, masked_histogram,
    )
    from tudocomp_tpu_torch.ops.rle import rle_tokens

    data = torch.from_numpy(corpus.reshape(CHUNKS, -1)).to(dev)
    c, n = data.shape
    lengths = torch.full((c,), n, dtype=torch.int32, device=dev)
    hist = masked_histogram(data, data.numel())
    table = HuffmanTable.from_counts(hist.cpu().numpy() + 1, max_len=16,
                                     min_len=3)
    code = torch.from_numpy(table.sym_code.astype(np.int32)).to(dev)
    length = torch.from_numpy(table.sym_len.astype(np.int32)).to(dev)

    def chunk_path():
        bc.rle_pack_chunks(data, lengths)
        bc.pack_tokens_chunks(*rle_tokens(data, lengths))
        masked_histogram(data, data.numel())
        bc.pack_bytes_huffman_chunks(data, lengths, code, length)
        hv, hl = huffman_encode_tokens(data, data.numel(), code, length)
        bc.pack_tokens_chunks(hv.reshape(c, n), hl.reshape(c, n))

    traced(f"chunk path {c} x {n // MIB} MiB", chunk_path, top=30)
    values, lens = rle_tokens(data, lengths)
    traced("K7 rle_pack_chunks alone", lambda: bc.rle_pack_chunks(data,
                                                                  lengths))
    traced("K5 pack_tokens_chunks alone (RLE tokens)",
           lambda: bc.pack_tokens_chunks(values, lens))
    traced("K6 pack_bytes_huffman_chunks alone",
           lambda: bc.pack_bytes_huffman_chunks(data, lengths, code, length))


if __name__ == "__main__":
    sys.exit(main())
