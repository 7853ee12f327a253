#!/usr/bin/env python3
"""Card times of the TBC2 codec's stages and kernels (K1-K4), or of the
chunked bit packers (K5-K7).

Run from the root of a checkout: ``python3 etc/torch_kernels.py
[codec|chunks]`` (default ``codec``). The
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
- K3 (``histogram_words``) on that batch's 1024 sampled rows, gathered,
  and ``rle_stage`` with the histogram of those rows (the gather, if
  the stage makes one, included);
- K2 (``huffman_pack_segments``) on the batch's escape-selected streams
  with the table of its sample, and ``huff_stage`` on them: K2, the
  ``huff_raw`` escape select and the bits;
- K4 (``decode_segments``) on the container of that batch, and on the
  container of the whole 256 MiB in one launch, as ``decompress_device``
  runs it.

``chunks`` times, on the same 256 MiB as 64 chunks of 4 MiB (as
``chip_smoke.py`` phase 6 runs them): K7 (``rle_pack_chunks``), K5
(``pack_tokens_chunks``) on the RLE tokens, K6
(``pack_bytes_huffman_chunks``) with the table of the corpus histogram,
and K5 on the Huffman tokens, after checking that K5's streams equal
K7's and K6's and that every word past each stream is zero. Each line
carries two bounds: with the whole ``[C, cap]`` row written (the output
contract) and with the stream words alone.

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
    table, offset, orig_len, cnt, flags, poff, pbytes = codec.parse(
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


def chunk_cases(corpus, dev) -> dict:
    """K5-K7 on ``corpus`` as 64 chunks: each kernel's time and bounds."""
    import numpy as np
    import torch

    from tudocomp_tpu_torch.coders.huffman import HuffmanTable
    from tudocomp_tpu_torch.ops import bitpack_chunks as bc
    from tudocomp_tpu_torch.ops.huffman import (
        huffman_encode_tokens, masked_histogram,
    )
    from tudocomp_tpu_torch.ops.rle import rle_tokens

    data = torch.from_numpy(corpus.reshape(64, -1)).to(dev)
    c, n = data.shape
    lengths = torch.full((c,), n, dtype=torch.int32, device=dev)
    values, lens = rle_tokens(data, lengths)
    hist = masked_histogram(data, data.numel())
    table = HuffmanTable.from_counts(hist.cpu().numpy() + 1, max_len=16,
                                     min_len=3)
    code = torch.from_numpy(table.sym_code.astype(np.int32)).to(dev)
    length = torch.from_numpy(table.sym_len.astype(np.int32)).to(dev)
    hv, hl = huffman_encode_tokens(data, data.numel(), code, length)
    hv, hl = hv.reshape(c, n), hl.reshape(c, n)
    cases = {
        "rle_pack_chunks": (lambda: bc.rle_pack_chunks(data, lengths),
                            n * c + 4 * c, 8),
        "pack_tokens_chunks": (lambda: bc.pack_tokens_chunks(values, lens),
                               8 * n * c, 1),
        "pack_bytes_huffman_chunks": (
            lambda: bc.pack_bytes_huffman_chunks(data, lengths, code, length),
            n * c + 4 * c + 2 * 4 * 256, 1),
        "pack_tokens_chunks_huffman": (lambda: bc.pack_tokens_chunks(hv, hl),
                                       8 * n * c, 1),
    }
    outs = {}
    for name, (call, _, unit) in cases.items():
        words, count = call()
        bits = count.long() * unit
        past = torch.arange(words.shape[1], device=dev)[None, :] \
            >= ((bits + 31) // 32)[:, None]
        if bool((words[past] != 0).any()):
            raise AssertionError(f"{name}: words past the stream not zero")
        outs[name] = (words, bits)
    for a, b in (("pack_tokens_chunks", "rle_pack_chunks"),
                 ("pack_tokens_chunks_huffman", "pack_bytes_huffman_chunks")):
        (wa, ba), (wb, bb) = outs[a], outs[b]
        width = min(wa.shape[1], wb.shape[1])
        if not (torch.equal(ba, bb)
                and torch.equal(wa[:, :width], wb[:, :width])):
            raise AssertionError(f"{a} differs from {b}")
    res = {}
    for name, (call, in_bytes, _) in cases.items():
        words, bits = outs[name]
        stream = 4 * int(((bits + 31) // 32).sum())
        res[f"{name}_ms"] = time_ms(call, 20)
        res[f"{name}_bound_ms"] = bound_ms(in_bytes + 4 * words.numel()
                                           + 4 * c)
        res[f"{name}_stream_bound_ms"] = bound_ms(in_bytes + stream + 4 * c)
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_kernels: CUDA is not available", file=sys.stderr)
        return 1
    mode = sys.argv[1] if len(sys.argv) > 1 else "codec"
    if mode not in ("codec", "chunks"):
        print(f"torch_kernels: unknown mode {mode!r}", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import tudocomp_tpu_torch
    from bench import make_corpus
    from tudocomp_tpu_torch import BlockCodec, _build
    from tudocomp_tpu_torch.models.blockcodec import huff_stage, rle_stage
    from tudocomp_tpu_torch.ops.hist import histogram_words
    from tudocomp_tpu_torch.ops.segpack import (
        huffman_pack_segments, rle_pack_segments,
    )

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(card)
    print(f"package {os.path.dirname(tudocomp_tpu_torch.__file__)}")
    print(f"kernel build {_build.build():.1f} s")
    dev = torch.device("cuda")
    corpus = make_corpus(256 * MIB)
    if mode == "chunks":
        res = {"card": card, **chunk_cases(corpus, dev)}
        for key, value in res.items():
            if key != "card":
                print(f"{key}: {value:.4f}")
        print(json.dumps(res))
        return 0
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
    sample = slice(0, nseg, 8)
    sel, counts, _, hist = rle_stage(rows, lens, offset=0, hist_rows=sample)
    sub, subc = sel[sample].contiguous(), counts[sample].contiguous()
    live = int(subc.sum())
    res["histogram_ms"] = time_ms(lambda: histogram_words(sub, subc), 20)
    res["histogram_bound_ms"] = bound_ms(live + 4 * subc.numel() + 4 * 256)
    res["rle_stage_hist_ms"] = time_ms(
        lambda: rle_stage(rows, lens, offset=0, hist_rows=sample), 20)
    t = codec.table(hist, True)[1]
    code, length = t["sym_code"], t["sym_len"]
    stream = int(counts.sum())
    # live stream bytes, counts and the table in; 512 words and the bits
    # per segment out (+ the escape flag for huff_stage)
    k2_bytes = stream + 4 * nseg + 2 * 4 * 256 + 4 * (512 * nseg + nseg)
    res["huffman_pack_ms"] = time_ms(
        lambda: huffman_pack_segments(sel, counts, code, length), 20)
    res["huffman_pack_bound_ms"] = bound_ms(k2_bytes)
    res["huff_stage_ms"] = time_ms(
        lambda: huff_stage(sel, counts, code, length), 20)
    res["huff_stage_bound_ms"] = bound_ms(k2_bytes + nseg)
    res["huff_raw_share"] = float(
        huff_stage(sel, counts, code, length)[2].float().mean())
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
