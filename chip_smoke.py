#!/usr/bin/env python3
"""Smoke run of the torch port (``tudocomp_tpu_torch``) on one NVIDIA GPU.

Run from the repo root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and exits non-zero without one. Phases:

1. toolchain: torch, CUDA, nvcc, Triton, the card and its power limit,
   and the build of the CUDA kernels from ``tudocomp_tpu_torch/csrc``;
2. each kernel (K1 RLE pack, K1's select entry with the ``rle_raw``
   escape, K3 histogram, K3 on the 1-in-8 sample read in place, K2
   Huffman pack, K2's select entry with the ``huff_raw`` escape, K8
   frame pack, whose container must also equal ``BlockCodec.compress``'s,
   K4 decode) against its plain torch version on the card, at the shapes
   of the main path's first 16 MiB batch: exact equality, both times
   (CUDA events, after a warm-up);
3. the main path at 256 MiB: ``BlockCodec(device=cuda).compress`` of
   ``bench.make_corpus(256 << 20)`` and ``decompress_device``; the
   output must equal the input, and the port's host decoder must
   restore it from the same container; the shares of segments that
   take each escape; then K4 alone at the shape
   ``decompress_device`` launches it, one launch over the whole
   container, against its plain version and the input bytes;
4. a 20 MiB slice (past the 16 MiB histogram cap): the CUDA container
   equals the CPU one (plain versions) byte for byte;
5. every kernel of phase 3 ran there (launch counts);
6. the chunked bit packers on the same 256 MiB as 64 chunks of 4 MiB:
   K7 (RLE + pack), K5 on the RLE tokens (equal to K7 bit for bit), K6
   (Huffman + pack) with the table of the corpus histogram, K5 on the
   Huffman tokens (equal to K6), chunk 0 of K6 decoded back with the
   port's host decoder; launch counts of that run, then each kernel
   against its plain version (exact equality, the zero words past each
   stream included, both times), with the share of its bound that each
   reaches;
7. the stage probes (P1-P4: K2 cut after each stage in its word and
   byte forms, the data-movement floor, placement under three
   strategies) on the same 256 MiB as 131,072 segments and on the main
   path's 16 MiB batch: launch counts of that run, then each variant
   against its plain version at both sizes. The stage probes take K2's
   own inputs there: K1's escape-selected streams, their counts and the
   table of the sampled histogram;
8. ``entry()`` (``tudocomp_tpu_torch/entry.py``, the counterpart of
   ``__graft_entry__.entry``): its ``fn(*args)`` on the card, words,
   bits and histogram equal to the same call on the CPU (the plain
   versions), with the launches of that call;
9. the front end at full width: the 256 MiB corpus in a temporary file
   through the port's ``cli.main``, in-process: ``-a tbc2`` writes the
   header and phase 3's container, ``-d`` (``dec=auto``, K4 on the card)
   restores the input, and so do ``-a "tbc2(dec=host)"`` with ``-d``,
   ``--blocks 64M`` with ``--threads 1`` and ``--threads 2`` (the same
   bytes), and ``--stats`` (the phase tree); launch counts of the
   ``tbc2`` round trip, and each call's wall time;
10. the device suffix array and BWT (``ops/suffix.py``) on 64 MiB of
   ``bench.make_corpus``, sentineled as ``bwt`` gets it: the SA equal to
   the host SA-IS, ``suffix_array_isa_ranks(L=32)`` giving the same SA
   and an ISA that inverts it, the BWT equal to ``text[(sa - 1) mod n]``,
   the inverse BWT restoring the text; each op's time (CUDA events), the
   doubling rounds, the peak device memory, the host SA-IS time; then
   ``-a "bwt(device=true):tbc2"`` through the CLI round-trips those
   64 MiB and writes the payload of ``-a "bwt:tbc2"`` (the host path);
11. the device LZ77 (``ops/lzss.py``) behind ``lzss_lcp``, on
   ``bench.make_corpus`` sentineled as ``lzss_lcp`` gets it: at 1 MiB
   both matchers' per-position ``(cand, length)`` on the card equal the
   CPU run; at 15 MiB (under 2^24 bytes once escaped) the exact
   matcher's time (CUDA events), peak device memory (under 24 GiB) and
   doubling rounds, the q-gram matcher's time, and the five largest
   device operations of one ``torch.profiler`` trace of the exact
   matcher; then ``-a "lzss_lcp(coder=huff,comp=C)"`` for C = device,
   device_fast and psv through the CLI, each container decoded with
   ``dec=host`` and with ``dec=device`` back to the input, every factor
   of the device parses a true back-reference (``src < pos``, equal
   bytes, length at least the threshold), with each call's wall time,
   the factor counts and the container sizes;
12. the sharded pipeline (``tudocomp_tpu_torch/parallel/``) on the
   256 MiB of phase 3: (a) one NCCL rank on the card in this process
   (a ``FileStore`` rendezvous): ``compress_sharded`` equals phase 3's
   container and ``decompress_sharded`` restores the input, with the
   launches of that run (K1's select entry 16, K3's rows entry 1, K2's
   select entry 16, K4 1), both timed beside ``BlockCodec.compress`` and
   ``decompress_device`` of the same bytes; ``factorize_blocks_sharded``
   on 8 blocks of 256 KiB equals ``factorize_device`` per block on the
   card, and one block on the CPU; (b) two spawned ranks on the same
   card over ``gloo`` (NCCL refuses two ranks on one card): the same
   container and round trip, each rank's frames time, then
   ``compress_sharded_resumable`` of 64 MiB stopped by
   ``TDC_CRASH_AFTER_BATCH=1`` (rank 0 exits 17) and resumed, equal to
   ``BlockCodec.compress`` of those bytes; (c)
   ``dryrun_multichip(2, device="cuda", backend="gloo")``. A rank's
   non-zero exit or a spawn past its limit fails the phase;
13. the device lcpcomp (``ops/lcpcomp.py``) behind ``lcpcomp
   comp=device``, on ``bench.make_corpus`` sentineled as ``lcpcomp``
   gets it: (a) at 1 MiB, ``_lcp_by_position`` and ``factorize_device``
   on the card equal the CPU's position by position and factor by factor
   (with ``device_rounds``), the device operations a round and the five
   largest of one traced ``_all_rounds``, and every ``dec`` strategy
   (``scan``, ``compact``, ``MultimapListBuffer``, ``QueueListBuffer``)
   restores the input from the ``comp=device`` container; (b) at 16 MiB,
   ``_lcp_by_position`` and ``_all_rounds`` timed apart (CUDA events),
   the rounds, the ms a round, the host syncs of each (``torch.cuda``'s
   sync debug mode), the peak device memory and its bytes a position,
   the factors (targets disjoint, each equal to its source: they may
   point forward) and the five largest device operations of one trace
   of ``_lcp_by_position``; (c) at 4 MiB, ``-a
   "lcpcomp(coder=huff,comp=device)"``, ``coder=sle,comp=device`` and
   ``coder=huff,comp=arrays`` through ``cli.main``, each ``-d`` back to
   the input, with wall times, bytes, factors, the wall-time ratio
   device/arrays, and the host flatten of each strategy's factors. (b)
   and (c) run below phases 10 and 11's 64 and 15 MiB:
   ``LCPCOMP_*_MIB`` says why;
14. the device ESP rounds (``ops/esp.py``) behind ``esp rounds=device``,
   on ``bench.make_corpus``: (a) at 1 MiB the rules and root on the card
   (at ``tail_cutoff`` 4096 and 1) equal the CPU run's and the host
   library's, with the same round counts; (b) at 64 MiB
   ``esp_rounds_device`` against the host library (equal rules, both
   timed), its host syncs (``torch.cuda``'s sync debug mode: one a round
   plus the hand-off), the device and host rounds, the host tail's ms,
   the peak device memory and its bytes a position, each device round
   again by CUDA events with its layer's length, and the five largest
   device operations of one trace of round 1; (c) at 16 MiB ``-a
   "esp(rounds=device)"`` and ``-a esp`` through ``cli.main``: the same
   payload, each ``-d`` back to the input, wall times; (d) at 16 MiB ``-a
   "bwt(device=true):rle:mtf:encode(coder=arithmetic)"`` against ``-a
   "bwt:rle:mtf:encode(coder=arithmetic)"`` the same way;
15. the host families (sliding-window ``lzss``, ``lz78``, ``lzw``,
   ``repair``, ``lz78u``, ``lfs_comp``, ``lfs2``, ``lfs2bst``; host code
   with no kernel, ``csrc/host/``) through ``cli.main`` on
   ``bench.make_corpus``, file to file, each ``-d`` back to the input and
   each file equal to ``cli.compress``'s buffered container: (a) the
   one-pass streaming branch at 16 MiB: ``lzss``, ``lz78(coder=bit)``,
   ``lzw(coder=bit)``; (b) at 4 MiB ``repair(coder=bit)`` and
   ``lz78u(coder=bit)``; (c) at 256 KiB ``lfs_comp``, ``lfs2`` and
   ``lfs2bst`` (``HOST_CLI`` says why these sizes); (d) the host library
   built on this machine gives the JAX package's bytes: each family's
   container of ``make_corpus(64 KiB)`` hashes to the SHA-256 pinned in
   ``HOST_DIGESTS`` (computed from the JAX package;
   ``tests/test_torch_registry.py`` holds the pins against it).

Every time of phases 8-15 is printed with the card's name and power
limit, and so is the whole run's wall time.

Each kernel's line carries its bound: the bytes it must move (inputs
read once, outputs written once, counted from this run's data) over the
card's 3.35 TB/s, or its integer operations over 67 TOP/s (the float32
rate outside the tensor cores; the larger of the two), and, where one
PyTorch call computes the same function, that call's time.

It prints a JSON line with the kernels' numbers, the card's name and
power limit, and, last, one JSON line ``{"ok": true, "device": {...}}``.
Any failure raises and exits non-zero. It imports nothing of JAX or of
the JAX package, and fails if either is loaded.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

MIB = 1 << 20

#: H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, and the
#: float32 rate outside the tensor cores, taken for integer operations
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12


def _sh(*cmd: str) -> str:
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


def time_ms(fn, reps: int) -> float:
    """Mean ms per call on the current stream (CUDA events, one warm-up)."""
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


def bound(nbytes: int, nops: int) -> dict:
    """The least time the card could take: bytes over HBM bandwidth or
    operations over the peak rate, whichever is larger."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = nops / OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


class Checker:
    """Runs each kernel against its plain version on the same inputs
    (exact equality), times both and its library call, and records the
    results by kernel name."""

    def __init__(self):
        self.res = {}

    def __call__(self, name, kernel, plain, *, nbytes, nops, library=None,
                 reps=(20, 3)):
        got, want = kernel(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max_abs_err(got, want)
        r = {"max_abs_err": err, "ms": time_ms(kernel, reps[0]),
             "plain_ms": time_ms(plain, reps[1]), **bound(nbytes, nops),
             "library_ms": time_ms(library, reps[0]) if library else None}
        self.res[name] = r
        lib = "" if library is None else f" library {r['library_ms']:.3f} ms"
        print(f"{name}: max_abs_err {err} kernel {r['ms']:.3f} ms plain "
              f"{r['plain_ms']:.3f} ms bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}){lib}")
        if err:
            raise AssertionError(f"{name} differs from its plain version")
        return got


def max_abs_err(got, want) -> int:
    """Largest element difference over pairs of integer tensors."""
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def toolchain() -> str:
    import torch

    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    from tudocomp_tpu_torch import _build

    print(_sh(_build._nvcc(), "--version").splitlines()[-1])
    try:
        import triton
        print(f"triton {triton.__version__}")
    except ImportError:
        print("triton not installed")
    card = _sh("nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader").splitlines()[0]
    print(card)
    print(f"kernel build: {_build.build():.1f} s, host build: "
          f"{_build.build_host():.1f} s")
    return card


#: integer operations per element that each kernel's function needs at
#: least (compare, scan step, shift, mask, place), for its bound; every
#: bound here is set by bytes, which outweigh these by more than 10x
OPS_PER_ELEM = 8


def kernels_vs_plain(corpus, dev, check: Checker) -> None:
    """Phase 2: each TBC2 kernel against its plain version at main-path
    shapes (the first 16 MiB batch)."""
    import torch

    from tudocomp_tpu_torch.models.blockcodec import BlockCodec, huff_stage
    from tudocomp_tpu_torch.ops import frames, hist, segpack

    codec = BlockCodec(device=dev)
    data = corpus[: 8192 * 2048].tobytes()
    rows_np, lens_np = codec.split_segments(data)
    rows = torch.from_numpy(rows_np).to(dev)
    lens = torch.from_numpy(lens_np).to(dev)
    nseg = rows.shape[0]
    in_bytes = int(lens_np.sum())

    check(
        "rle_pack",
        lambda: segpack.rle_pack_segments(rows, lens),
        lambda: segpack.rle_pack_segments_plain(rows, lens),
        nbytes=in_bytes + 4 * nseg + 4 * words_and_counts(nseg, 512),
        nops=OPS_PER_ELEM * in_bytes,
    )
    sel, counts, rle_raw = check(
        "rle_select",
        lambda: segpack.rle_select_segments(rows, lens),
        lambda: segpack.rle_select_segments_plain(rows, lens),
        # + the escape flag (one byte a segment)
        nbytes=in_bytes + 4 * nseg + 4 * words_and_counts(nseg, 512) + nseg,
        nops=OPS_PER_ELEM * in_bytes,
    )
    sample = codec.hist_rows(0, nseg, True)  # the 1024 sampled rows
    sub, subc = sel[sample].contiguous(), counts[sample].contiguous()
    live = segpack.bytes_from_words(sub, segpack.SEG)[
        torch.arange(segpack.SEG, device=dev)[None, :] < subc[:, None]
    ].long()
    sampled = int(subc.sum())
    check(
        "histogram",
        lambda: hist.histogram_words(sub, subc),
        lambda: hist.histogram_words_plain(sub, subc),
        nbytes=sampled + 4 * subc.numel() + 4 * 256,
        nops=sampled,
        library=lambda: torch.bincount(live, minlength=256),
    )
    # the rows entry adds into the caller's histogram: a zeroed one each
    # call (its fill is in the kernel's time)
    (h,) = check(
        "histogram_rows",
        lambda: hist.histogram_rows(
            sel, counts, sample,
            torch.zeros(256, dtype=torch.int64, device=dev)),
        lambda: hist.histogram_rows_plain(sel, counts, sample),
        nbytes=sampled + 4 * subc.numel() + 8 * 256,
        nops=sampled,
        library=lambda: torch.bincount(live, minlength=256),
    )
    table, t = codec.table(h, True)
    code, length = t["sym_code"], t["sym_len"]
    stream = int(counts.sum())
    check(
        "huffman_pack",
        lambda: segpack.huffman_pack_segments(sel, counts, code, length),
        lambda: segpack.huffman_pack_segments_plain(sel, counts, code,
                                                    length),
        nbytes=stream + 4 * nseg + 2 * 4 * 256
        + 4 * words_and_counts(nseg, 512),
        nops=OPS_PER_ELEM * stream,
    )
    out, bits, huff_raw = check(
        "huff_select",
        lambda: segpack.huffman_select_segments(sel, counts, code, length),
        lambda: segpack.huffman_select_segments_plain(sel, counts, code,
                                                      length),
        # + the escape flag (one byte a segment)
        nbytes=stream + 4 * nseg + 2 * 4 * 256
        + 4 * words_and_counts(nseg, 512) + nseg,
        nops=OPS_PER_ELEM * stream,
    )
    print(f"   huff_raw share of the batch's segments: "
          f"{float(huff_raw.float().mean()):.4f}")
    for a, b in zip((out, bits, huff_raw),
                    huff_stage(sel, counts, code, length)):
        if not torch.equal(a, b):
            raise AssertionError("huff_stage differs from K2's select entry")
    meta1, pbytes, offs, head = frames.frame_layout(counts, rle_raw,
                                                    huff_raw, bits)
    total = int(head[0])
    (packed,) = check(
        "frame_pack",
        lambda: frames.pack_frames(out, meta1, pbytes, offs, torch.empty(
            total, dtype=torch.uint8, device=dev)),
        lambda: frames.pack_frames_plain(out, meta1, pbytes, offs,
                                         torch.zeros(total, dtype=torch.uint8,
                                                     device=dev)),
        # the payload bytes read and the frames written, + each frame's
        # two fields and offset
        nbytes=int(pbytes.sum()) + total + 16 * nseg,
        nops=OPS_PER_ELEM * total,
    )
    container = (codec.prefix(len(data), table)
                 + packed.cpu().numpy().tobytes())
    if container != codec.compress(data):
        raise AssertionError("K8's frames differ from BlockCodec.compress")
    check_decode("decode", codec, container, data, dev, check)


def check_decode(name, codec, container: bytes, data: bytes, dev,
                 check: Checker) -> None:
    """K4 on the whole of ``container`` in one launch, as
    ``decompress_device`` runs it, against its plain version and the
    input bytes ``data``."""
    import numpy as np
    import torch

    from tudocomp_tpu_torch.models.blockcodec import device_tables
    from tudocomp_tpu_torch.ops import hufdec

    table, offset, orig_len, cnt, flags, poff, pbytes = codec.parse(
        container)
    t = device_tables(table, dev)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        np.frombuffer(container, np.uint8).copy(), poff.astype(np.int64),
        pbytes.astype(np.int64), cnt.astype(np.int32),
        flags.astype(np.uint8))] + [t["thresh"], t["offs"], t["symbols"]]
    (dec,) = check(
        name,
        lambda: hufdec.decode_segments(*args, offset=offset,
                                       orig_len=orig_len, fast=t["fast"]),
        lambda: hufdec.decode_segments_plain(*args, offset=offset,
                                             orig_len=orig_len),
        # payloads + per-segment poff, pbytes, count, flag + tables in;
        # the output bytes out
        nbytes=int(pbytes.sum()) + 21 * cnt.size + 4 * 32 + 256
        + 2 * 1024 + orig_len,
        nops=OPS_PER_ELEM * orig_len,
        reps=(10, 1),
    )
    if dec.cpu().numpy().tobytes() != data:
        raise AssertionError(f"K4 did not restore the input ({name})")


def words_and_counts(rows: int, width: int) -> int:
    """u32 elements of a ``[rows, width]`` word output and its counts."""
    return rows * width + rows


def main_path(corpus, dev, check: Checker) -> tuple[dict, bytes]:
    """Phase 3: the 256 MiB round trip through the codec's entry points,
    counting kernel launches; then K4 at that shape alone. Returns the
    launch counts of the round trip and the container."""
    from tudocomp_tpu_torch import BlockCodec
    from tudocomp_tpu_torch.ops import launch_counts, reset_launches

    data = corpus.tobytes()
    codec = BlockCodec(device=dev)
    reset_launches()
    container = codec.compress(data)
    enc = dict(codec.timings)
    restored = codec.decompress_device(container)
    dec = dict(codec.timings)
    counts = launch_counts()
    if restored != data:
        raise AssertionError("device round trip differs from the input")
    t0 = time.perf_counter()
    if codec.decompress(container) != data:
        raise AssertionError("host decode of the CUDA container differs")
    t_host = time.perf_counter() - t0
    gb = len(data) / 1e9
    flags = codec.parse(container)[4]
    print(f"main path {len(data) // MIB} MiB: ratio "
          f"{len(container) / len(data):.4f}; segments taking huff_raw "
          f"{float((flags & 1).mean()):.4f}, rle_raw "
          f"{float((flags >> 1 & 1).mean()):.4f}")
    print(f"  encode device stages {enc['encode']:.3f} s "
          f"({gb / enc['encode']:.3f} GB/s), assembly "
          f"{enc['assemble']:.3f} s")
    print(f"  decode parse {dec['parse']:.3f} s, device decode "
          f"{dec['decode']:.3f} s ({gb / dec['decode']:.3f} GB/s)")
    print(f"  host decode {t_host:.3f} s ({gb / t_host:.3f} GB/s)")
    check_decode("decode@256MiB", codec, container, data, dev, check)
    return counts, container


def cross_device(corpus, dev) -> None:
    """Phase 4: CUDA container == CPU (plain) container at 20 MiB."""
    from tudocomp_tpu_torch import BlockCodec

    data = corpus[: 20 * MIB].tobytes()
    gpu = BlockCodec(device=dev).compress(data)
    cpu = BlockCodec(device="cpu").compress(data)
    if gpu != cpu:
        raise AssertionError("CUDA and CPU containers differ at 20 MiB")
    print(f"20 MiB: CUDA container == CPU container ({len(gpu)} bytes)")


CHUNKS = 64  # phase 6: the corpus as 64 chunks of 4 MiB


def stream_words(words, bits):
    """Per chunk, the words that hold its stream (``ceil(bits / 32)``),
    as a boolean mask over ``words``."""
    import torch

    nwords = (bits.long() + 31) // 32
    return torch.arange(words.shape[1], device=words.device)[None, :] \
        < nwords[:, None]


def same_stream(a_words, a_bits, b_words, b_bits) -> bool:
    """Two packers' outputs hold the same bit stream."""
    width = min(a_words.shape[1], b_words.shape[1])
    a_words, b_words = a_words[:, :width], b_words[:, :width]
    live = stream_words(a_words, a_bits)
    return (bool((a_bits == b_bits).all())
            and bool((a_words[live] == b_words[live]).all()))


def chunk_path(corpus, dev, check: Checker) -> dict:
    """Phase 6: the chunked bit packers K5-K7 on the whole corpus as
    ``CHUNKS`` chunks. Returns the launch counts of the path's run; then
    compares each kernel with its plain version."""
    import numpy as np
    import torch

    from tudocomp_tpu_torch.coders.huffman import HuffmanTable
    from tudocomp_tpu_torch.ops import (
        bitpack_chunks as bc, launch_counts, reset_launches,
    )
    from tudocomp_tpu_torch.ops.huffman import (
        huffman_encode_tokens, masked_histogram,
    )
    from tudocomp_tpu_torch.ops.rle import rle_tokens

    data = torch.from_numpy(corpus.reshape(CHUNKS, -1)).to(dev)
    c, n = data.shape
    lengths = torch.full((c,), n, dtype=torch.int32, device=dev)
    reset_launches()
    t0 = time.perf_counter()
    rle_words, rle_bytes = bc.rle_pack_chunks(data, lengths)
    values, lens = rle_tokens(data, lengths)
    tok_words, tok_bits = bc.pack_tokens_chunks(values, lens)
    hist = masked_histogram(data, data.numel())
    table = HuffmanTable.from_counts(hist.cpu().numpy() + 1, max_len=16,
                                     min_len=3)
    code = torch.from_numpy(table.sym_code.astype(np.int32)).to(dev)
    length = torch.from_numpy(table.sym_len.astype(np.int32)).to(dev)
    huf_words, huf_bits = bc.pack_bytes_huffman_chunks(data, lengths, code,
                                                       length)
    hv, hl = huffman_encode_tokens(data, data.numel(), code, length)
    hv, hl = hv.reshape(c, n), hl.reshape(c, n)
    htok_words, htok_bits = bc.pack_tokens_chunks(hv, hl)
    torch.cuda.synchronize()
    t_path = time.perf_counter() - t0
    counts = launch_counts()
    print(f"chunk path {c} x {n // MIB} MiB: {t_path:.3f} s; RLE "
          f"{int(rle_bytes.sum()) / data.numel():.4f}, Huffman "
          f"{int(huf_bits.sum()) / 8 / data.numel():.4f} of the input")
    if not same_stream(tok_words, tok_bits, rle_words, rle_bytes * 8):
        raise AssertionError("K5 on the RLE tokens differs from K7")
    if not same_stream(htok_words, htok_bits, huf_words, huf_bits):
        raise AssertionError("K5 on the Huffman tokens differs from K6")
    nbits = int(huf_bits[0])
    payload = huf_words[0, : (nbits + 31) // 32].cpu().numpy().view(
        np.uint32).astype(">u4").view(np.uint8)[: (nbits + 7) // 8]
    if not np.array_equal(table.fast_decode(payload, n), corpus[:n]):
        raise AssertionError("chunk 0 of K6 does not decode to its input")
    print("K5 == K7 and K5 == K6 on every chunk; chunk 0 of K6 decodes")

    # each output written once: every word of the [C, cap] rows (the
    # zero tail past each stream is part of the output contract) and the
    # counts; the bound of the stream words alone is printed beside it
    positions = data.numel()
    for name, kernel, plain, in_bytes, words, bits in (
        ("rle_pack_chunks", lambda: bc.rle_pack_chunks(data, lengths),
         lambda: bc.rle_pack_chunks_plain(data, lengths),
         positions + 4 * c, rle_words, rle_bytes * 8),
        ("pack_tokens_chunks", lambda: bc.pack_tokens_chunks(values, lens),
         lambda: bc.pack_tokens_chunks_plain(values, lens),
         8 * positions, tok_words, tok_bits),
        ("pack_bytes_huffman_chunks",
         lambda: bc.pack_bytes_huffman_chunks(data, lengths, code, length),
         lambda: bc.pack_bytes_huffman_chunks_plain(data, lengths, code,
                                                    length),
         positions + 4 * c + 2 * 4 * 256, huf_words, huf_bits),
    ):
        check(name, kernel, plain,
              nbytes=in_bytes + 4 * words.numel() + 4 * c,
              nops=OPS_PER_ELEM * positions, reps=(10, 1))
        r = check.res[name]
        stream = 4 * int(((bits.long() + 31) // 32).sum()) + 4 * c
        alone = bound(in_bytes + stream, 0)["bound_ms"]
        print(f"   {name}: {r['ms']:.4f} ms, {r['bound_ms'] / r['ms']:.0%} "
              f"of its bound {r['bound_ms']:.4f} ms ({alone:.4f} ms for "
              f"the stream words alone, without the zero tail)")
    return counts


SOURCES = {
    "rle_pack": ("tudocomp_tpu_torch/csrc/rle_pack.cu",
                 "tudocomp_tpu/ops/segpack_pallas.py:1032"),
    "rle_select": ("tudocomp_tpu_torch/csrc/rle_pack.cu",
                   "tudocomp_tpu/ops/segpack_pallas.py:1032"),
    "histogram": ("tudocomp_tpu_torch/csrc/hist.cu",
                  "tudocomp_tpu/ops/hist_pallas.py:26"),
    "histogram_rows": ("tudocomp_tpu_torch/csrc/hist.cu",
                       "tudocomp_tpu/ops/hist_pallas.py:26"),
    "huffman_pack": ("tudocomp_tpu_torch/csrc/huff_pack.cu",
                     "tudocomp_tpu/ops/segpack_pallas.py:957"),
    "huff_select": ("tudocomp_tpu_torch/csrc/huff_pack.cu",
                    "tudocomp_tpu/ops/segpack_pallas.py:957"),
    "decode": ("tudocomp_tpu_torch/csrc/hufdec.cu",
               "tudocomp_tpu/ops/hufdec_pallas.py:74"),
    "decode@256MiB": ("tudocomp_tpu_torch/csrc/hufdec.cu",
                      "tudocomp_tpu/ops/hufdec_pallas.py:74"),
    "pack_tokens_chunks": ("tudocomp_tpu_torch/csrc/bitpack.cu",
                           "tudocomp_tpu/ops/bitpack_pallas.py:187"),
    "pack_bytes_huffman_chunks": (
        "tudocomp_tpu_torch/csrc/huff_chunk_pack.cu",
        "tudocomp_tpu/ops/bitpack_pallas.py:198"),
    "rle_pack_chunks": ("tudocomp_tpu_torch/csrc/rle_chunk_pack.cu",
                        "tudocomp_tpu/ops/bitpack_pallas.py:371"),
}

SEG = 2048


def probe_inputs(corpus, dev) -> dict:
    """The probes' inputs for ``corpus`` as segments: the rows, and K2's
    inputs on the codec's path (K1's escape-selected stream words, in
    both forms, their counts, the table of the sampled histogram)."""
    import torch

    from tudocomp_tpu_torch.models.blockcodec import BlockCodec, rle_stage
    from tudocomp_tpu_torch.ops.rle import bytes_from_words

    codec = BlockCodec(device=dev)
    rows = torch.from_numpy(corpus.reshape(-1, SEG)).to(dev)
    nseg = rows.shape[0]
    lens = torch.full((nseg,), SEG, dtype=torch.int32, device=dev)
    sampled = codec.sample_rule(nseg)
    words, counts, _, hist = rle_stage(
        rows, lens, offset=0, hist_rows=codec.hist_rows(0, nseg, sampled))
    t = codec.table(hist, sampled)[1]
    return {"rows": rows, "words": words,
            "stream": bytes_from_words(words, SEG).contiguous(),
            "counts": counts, "code": t["sym_code"], "length": t["sym_len"]}


def probe_cases(x: dict) -> list:
    """Every probe variant on ``probe_inputs`` ``x``: its name, source,
    the TPU kernel it stands for, kernel and plain calls, the bytes and
    operations its function needs, and its library call (or None)."""
    import functools

    import torch

    from tudocomp_tpu_torch.probes import ablate, floor, place

    nseg = x["rows"].shape[0]
    stream = int(x["counts"].sum())
    csrc = "tudocomp_tpu_torch/csrc/"
    cases = []
    for bytes_input in (False, True):
        data = x["stream"] if bytes_input else x["words"]
        for stage in range(len(ablate.STAGES)):
            args = (data, x["counts"], x["code"], x["length"])
            kw = {"stage": stage, "bytes_input": bytes_input}
            out = (4 * words_and_counts(nseg, 512)
                   if stage == ablate.FULL else 4 * nseg)
            cases.append({
                "name": ablate.variant(stage, bytes_input),
                "source": csrc + "huff_pack.cu",
                "replaces": ("etc/probe_ablate.py:58" if bytes_input
                             else "etc/probe_ablate_w4.py:55"),
                "kernel": functools.partial(ablate.huffman_pack_stage,
                                            *args, **kw),
                "plain": functools.partial(ablate.huffman_pack_stage_plain,
                                           *args, **kw),
                # live bytes and counts in (+ the table from stage 1)
                "nbytes": stream + 4 * nseg + (2 * 4 * 256 if stage else 0)
                + out,
                "nops": OPS_PER_ELEM * stream, "library": None,
            })
    rows = x["rows"]
    for function in floor.FUNCTIONS:
        for form in floor.FORMS:
            for group in floor.GROUPS:
                kw = {"function": function, "form": form, "group": group}
                copy = function == "copy"
                cases.append({
                    "name": floor.variant(function, form, group),
                    "source": csrc + "probe_floor.cu",
                    "replaces": ("etc/probe_floor.py:101" if form == "vec16"
                                 else "etc/probe_floor.py:62"),
                    "kernel": functools.partial(floor.floor_probe, rows,
                                                **kw),
                    "plain": functools.partial(floor.floor_probe_plain, rows,
                                               function=function),
                    "nbytes": SEG * nseg + 4 * nseg
                    + (4 * 512 * nseg if copy else 0),
                    "nops": SEG * nseg,
                    "library": None if copy else functools.partial(
                        torch.sum, rows, 1, dtype=torch.int32),
                })
    for strategy in place.STRATEGIES:
        for stride in place.STRIDES:
            cases.append({
                "name": place.variant(strategy, stride),
                "source": csrc + "probe_place.cu",
                "replaces": "etc/probe_int8.py:49",
                "kernel": functools.partial(place.place_tokens, rows,
                                            strategy=strategy, stride=stride),
                "plain": functools.partial(place.place_tokens_plain, rows,
                                           stride=stride),
                "nbytes": SEG * nseg + 4 * words_and_counts(
                    nseg, place.OUT_WORDS),
                "nops": OPS_PER_ELEM * SEG * nseg, "library": None,
            })
    return cases


def probe_path(corpus, dev, check: Checker) -> tuple[dict, list]:
    """Phase 7: every probe variant on the whole corpus and on the main
    path's first 16 MiB batch. Returns the launch counts of that run and
    the whole corpus's cases; then compares each variant with its plain
    version at both sizes (the 16 MiB results under ``name@16MiB``)."""
    import torch

    from tudocomp_tpu_torch.ops import launch_counts, reset_launches

    sizes = {"": probe_inputs(corpus, dev),
             "@16MiB": probe_inputs(corpus[: 8192 * SEG], dev)}
    runs = {tag: probe_cases(x) for tag, x in sizes.items()}
    reset_launches()
    for cases in runs.values():
        for case in cases:
            case["kernel"]()
    torch.cuda.synchronize()
    counts = launch_counts()
    for tag, cases in runs.items():
        print(f"-- {sizes[tag]['rows'].shape[0]} segments")
        for case in cases:
            check(case["name"] + tag, case["kernel"], case["plain"],
                  nbytes=case["nbytes"], nops=case["nops"],
                  library=case["library"])
    return counts, runs[""]


def entry_phase(dev, card: str) -> dict:
    """Phase 8: ``entry()``'s step on the card against the same call on
    the CPU. Returns the launch counts of the card's call."""
    import torch

    from tudocomp_tpu_torch.entry import entry
    from tudocomp_tpu_torch.ops import launch_counts, reset_launches

    fn, args = entry(device=dev)
    reset_launches()
    t0 = time.perf_counter()
    got = fn(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    cfn, cargs = entry(device="cpu")
    for name, g, w in zip(("words", "bits", "hist"), got, cfn(*cargs)):
        if not torch.equal(g.cpu(), w):
            raise AssertionError(f"entry(): {name} differ from the CPU's")
    print(f"entry(): words, bits and histogram equal the CPU's; first call "
          f"{wall * 1e3:.3f} ms ({card})")
    return counts


def _cli(argv) -> float:
    """``cli.main(argv)`` in this process; raises unless it returns 0.
    Returns its wall time in seconds."""
    from tudocomp_tpu_torch import cli

    t0 = time.perf_counter()
    rc = cli.main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli.main{argv} returned {rc}")
    return wall


def _same_file(path: str, data: bytes, what: str) -> None:
    with open(path, "rb") as f:
        if f.read() != data:
            raise AssertionError(f"{what} differs")


TBC2_HEADER = b"tbc2(offset=0, min_code_len=3, dec=auto)%"


def front_end(corpus, container: bytes, card: str) -> dict:
    """Phase 9: the port's CLI on the 256 MiB corpus, in-process. Returns
    the launch counts of the ``tbc2`` compress and decompress."""
    import contextlib
    import io
    import os
    import tempfile
    import tracemalloc

    import torch

    from tudocomp_tpu_torch.ops import launch_counts, reset_launches

    data = corpus.tobytes()
    mib = len(data) // MIB
    with tempfile.TemporaryDirectory() as td:
        src = os.path.join(td, "in.bin")
        with open(src, "wb") as f:
            f.write(data)

        def run(tag, *argv) -> str:
            out = os.path.join(td, tag)
            wall = _cli([*argv, "-f", "-o", out])
            shown = " ".join(os.path.basename(a) if a.startswith(td) else a
                             for a in argv)
            print(f"  {shown}: "
                  f"{wall:.3f} s, {len(data) / 1e9 / wall:.3f} GB/s of the "
                  f"{mib} MiB ({card})")
            return out

        reset_launches()
        c1 = run("tbc2.tdc", src, "-a", "tbc2")
        d1 = run("tbc2.dec", c1, "-d")
        torch.cuda.synchronize()
        counts = launch_counts()
        _same_file(c1, TBC2_HEADER + container,
                   "-a tbc2 against the header and phase 3's container")
        _same_file(d1, data, "-d of -a tbc2 against the input")
        for path in (c1, d1):
            os.remove(path)
        c2 = run("host.tdc", src, "-a", "tbc2(dec=host)")
        _same_file(run("host.dec", c2, "-d"), data,
                   "-d of -a tbc2(dec=host) against the input")
        blocks = {}
        for threads in ("1", "2"):
            c = run(f"blocks{threads}.tdc", src, "-a", "tbc2", "--blocks",
                    "64M", "--threads", threads)
            _same_file(run(f"blocks{threads}.dec", c, "-d"), data,
                       f"-d of --blocks 64M --threads {threads}")
            with open(c, "rb") as f:
                blocks[threads] = f.read()
        if blocks["1"] != blocks["2"]:
            raise AssertionError("--threads 2 wrote other bytes than 1")
        print(f"  {mib} MiB: -a tbc2 == header + phase 3's container; -d, "
              f"tbc2(dec=host), --blocks 64M (--threads 1 == --threads 2, "
              f"{len(blocks['1'])} bytes) restore the input")
        err = io.StringIO()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with contextlib.redirect_stderr(err):
            wall = _cli([src, "-a", "tbc2", "-f", "-o",
                         os.path.join(td, "stats.tdc"), "--stats"])
        peak = torch.cuda.max_memory_allocated() - base
        tracemalloc.stop()  # --stats started it; the CLI's process ends
    text = err.getvalue()
    tree = json.loads(text[text.index("{"): text.rindex("}") + 1])
    (phase,) = (p for p in tree["sub"] if p["title"] == "compress")
    keys = {"title", "timeDelta", "memPeak", "devMemPeak", "stats", "sub"}
    if set(tree) != keys or set(phase) != keys:
        raise AssertionError(f"--stats keys {sorted(tree)}")
    print(f"  --stats: {wall:.3f} s ({card}); compress phase "
          f"{phase['timeDelta']:.1f} ms, memPeak {phase['memPeak']} B, "
          f"devMemPeak {phase['devMemPeak']} B (live device bytes at the "
          f"phase's exit less at its entry); the call's peak device "
          f"memory above its start {peak} B")
    from tudocomp_tpu_torch.stats import StatPhase

    with StatPhase("root") as root:
        with StatPhase("keep") as keep:
            kept = torch.empty(MIB, dtype=torch.uint8, device="cuda")
    if not (keep.dev_mem_peak >= kept.numel()
            and root.dev_mem_peak >= keep.dev_mem_peak):
        raise AssertionError(f"devMemPeak of a phase that keeps 1 MiB on "
                             f"the card: {keep.dev_mem_peak}, parent "
                             f"{root.dev_mem_peak}")
    print(f"  StatPhase keeping 1 MiB on the card: devMemPeak "
          f"{keep.dev_mem_peak} B, bubbled to its parent")
    return counts


def timed(fn):
    """``fn()``'s result, its time in ms (CUDA events, one call) and the
    device memory it allocated at its peak above its start."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return (out, start.elapsed_time(end),
            torch.cuda.max_memory_allocated() - base)


def suffix_phase(dev, card: str) -> None:
    """Phase 10: the device SA, ISA and BWT of 64 MiB of the corpus
    against the host's, then ``bwt(device=true):tbc2`` through the CLI."""
    import os
    import tempfile

    import numpy as np
    import torch

    from bench import make_corpus
    from tudocomp_tpu_torch import native
    from tudocomp_tpu_torch.io.restrictions import escape
    from tudocomp_tpu_torch.meta import InputRestrictions
    from tudocomp_tpu_torch.ops import suffix

    raw = make_corpus(64 * MIB).tobytes()
    # as bwt gets it: 0 bytes escaped, one 0 sentinel appended
    text = np.frombuffer(escape(raw, InputRestrictions((), True)), np.uint8)
    n = text.size
    t0 = time.perf_counter()
    sa_host = native.suffix_array(text)
    t_host = time.perf_counter() - t0
    td = torch.from_numpy(text.copy()).to(dev)
    info = {}
    sa, ms_sa, mem_sa = timed(lambda: suffix.suffix_array_device(td, info))
    if not np.array_equal(sa.cpu().numpy(), sa_host):
        raise AssertionError("device SA differs from the host SA-IS")
    rinfo = {}
    (sa2, isa2, ranks), ms_r, mem_r = timed(
        lambda: suffix.suffix_array_isa_ranks(td, L=32, full=True,
                                              info=rinfo))
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    if not torch.equal(sa2, sa) or not torch.equal(isa2[sa.long()], iota):
        raise AssertionError("suffix_array_isa_ranks: SA or ISA wrong")
    if sorted(ranks) != [4, 8, 16, 32]:
        raise AssertionError(f"rank levels {sorted(ranks)}")
    del sa2, isa2, ranks
    isa, ms_isa, mem_isa = timed(lambda: suffix.isa_device(sa))
    bwt, ms_bwt, mem_bwt = timed(lambda: suffix.bwt_device(td, isa))
    if not torch.equal(bwt, td[(sa.long() - 1) % n]):
        raise AssertionError("device BWT differs from text[(sa - 1) mod n]")
    del isa, sa
    un, ms_un, mem_un = timed(lambda: suffix.unbwt_device(bwt))
    if not torch.equal(un, td[:-1]):
        raise AssertionError("unbwt_device did not restore the text")
    del un, bwt
    print(f"  {n} bytes ({card}): host SA-IS {t_host:.3f} s")
    for name, ms, mem, extra in (
        ("suffix_array_device", ms_sa, mem_sa,
         f", {info['rounds']} doubling rounds"),
        ("suffix_array_isa_ranks(L=32, full=True)", ms_r, mem_r,
         f", {rinfo['rounds']} doubling rounds"),
        ("isa_device", ms_isa, mem_isa, ""),
        ("bwt_device", ms_bwt, mem_bwt, ""),
        ("unbwt_device", ms_un, mem_un, ""),
    ):
        print(f"  {name}: {ms:.3f} ms, peak device memory {mem / MIB:.1f} "
              f"MiB above its start{extra} ({card})")
    print("  SA == host SA-IS; isa_ranks SA == SA, ISA inverts it; BWT == "
          "text[(sa - 1) mod n]; unBWT restores the text")
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.bin")
        with open(src, "wb") as f:
            f.write(raw)
        outs = {}
        for algo in ("bwt(device=true):tbc2", "bwt:tbc2"):
            out = os.path.join(tmp, algo.replace(":", "_") + ".tdc")
            wall = _cli([src, "-a", algo, "-f", "-o", out])
            print(f"  -a {algo}: {wall:.3f} s ({card})")
            with open(out, "rb") as f:
                outs[algo] = f.read().split(b"%", 1)
        dec = os.path.join(tmp, "dev.dec")
        wall = _cli([os.path.join(tmp, "bwt(device=true)_tbc2.tdc"), "-d",
                     "-f", "-o", dec])
        print(f"  -d of bwt(device=true):tbc2: {wall:.3f} s ({card})")
        _same_file(dec, raw, "-d of bwt(device=true):tbc2")
    if outs["bwt(device=true):tbc2"][1] != outs["bwt:tbc2"][1]:
        raise AssertionError("bwt(device=true):tbc2 differs from bwt:tbc2")
    print(f"  {len(raw) // MIB} MiB: bwt(device=true):tbc2 round-trips and "
          f"writes the payload of bwt:tbc2")


def _trace_top(fn, top: int) -> list:
    """(device ms, count, name) of the ``top`` device operations of one
    ``torch.profiler`` trace of ``fn()``, largest first."""
    return _trace_rows(fn)[:top]


def _trace_rows(fn) -> list:
    """(device ms, count, name) of every device operation of one
    ``torch.profiler`` trace of ``fn()``, largest first."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            row = rows.setdefault(e.name, [0.0, 0])
            row[0] += (e.time_range.end - e.time_range.start) / 1e3
            row[1] += 1
    return sorted(((ms, k, name) for name, (ms, k) in rows.items()),
                  reverse=True)


def _check_back_references(td, fpos, fsrc, flen, threshold: int) -> None:
    """Every factor copies earlier bytes: ``src < pos``, ``len >=
    threshold`` and ``text[src:src+len] == text[pos:pos+len]``, checked
    on the card over all factors at once."""
    import torch

    dev = td.device
    pos, src, ln = (torch.from_numpy(a.astype("int64")).to(dev)
                    for a in (fpos, fsrc, flen))
    if not bool((src < pos).all()) or not bool((ln >= threshold).all()):
        raise AssertionError("a factor is no back-reference")
    _check_copies(td, pos, src, ln)


def _check_copies(td, pos, src, ln) -> None:
    """``text[src:src+len] == text[pos:pos+len]`` for every factor (int64
    tensors on the card)."""
    import torch

    ramp = torch.arange(int(ln.sum()), device=td.device) - \
        torch.repeat_interleave(torch.cumsum(ln, 0) - ln, ln)
    if not torch.equal(td[torch.repeat_interleave(pos, ln) + ramp],
                       td[torch.repeat_interleave(src, ln) + ramp]):
        raise AssertionError("a factor's bytes differ from its source's")


def lz77_phase(dev, card: str) -> None:
    """Phase 11: the device LZ77 of ``lzss_lcp`` at 1 MiB against the
    CPU and at 15 MiB alone and through the CLI."""
    import os
    import tempfile

    import numpy as np
    import torch

    from bench import make_corpus
    from tudocomp_tpu_torch.compressors.lzss import parse_factor_arrays
    from tudocomp_tpu_torch.io.bitio import BitReader
    from tudocomp_tpu_torch.io.restrictions import escape
    from tudocomp_tpu_torch.meta import InputRestrictions
    from tudocomp_tpu_torch.ops import lzss
    from tudocomp_tpu_torch.registry import REGISTRY

    # as lzss_lcp gets it: 0 bytes escaped, one 0 sentinel appended
    sentinel = InputRestrictions((), True)
    small = np.frombuffer(escape(make_corpus(MIB).tobytes(), sentinel),
                          np.uint8)
    t_cpu = torch.from_numpy(small.copy())
    for name, fn, exact in (("exact", lzss._match_exact_device, True),
                            ("q-gram", lzss._match_device, False)):
        max_len = lzss.match_max_len(small.size, exact)
        got = fn(t_cpu.to(dev), max_len=max_len)
        want = fn(t_cpu, max_len=max_len)
        if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
            raise AssertionError(f"{name} matcher: card differs from CPU")
    print(f"  {small.size} bytes: both matchers' (cand, length) on the "
          f"card equal the CPU's")

    raw = make_corpus(15 * MIB).tobytes()
    text = np.frombuffer(escape(raw, sentinel), np.uint8)
    if text.size > 1 << 24:
        raise AssertionError(f"{text.size} bytes exceed 2^24")
    td = torch.from_numpy(text.copy()).to(dev)
    info = {}
    exact_len = lzss.match_max_len(text.size, True)
    _, ms_exact, mem_exact = timed(
        lambda: lzss._match_exact_device(td, max_len=exact_len, info=info))
    _, ms_fast, mem_fast = timed(lambda: lzss._match_device(
        td, max_len=lzss.match_max_len(text.size, False)))
    print(f"  {text.size} bytes ({card}): exact matcher {ms_exact:.3f} ms, "
          f"peak device memory {mem_exact / MIB:.1f} MiB above its start, "
          f"{info['rounds']} doubling rounds; q-gram matcher "
          f"{ms_fast:.3f} ms, {mem_fast / MIB:.1f} MiB")
    if mem_exact >= 24 << 30:
        raise AssertionError("the exact matcher needs 24 GiB or more")
    top = _trace_top(lambda: lzss._match_exact_device(td, max_len=exact_len),
                     5)
    print("  exact matcher, largest device operations of one trace:")
    for ms, count, name in top:
        print(f"    {ms:10.3f} ms  {count:5d}x  {name[:100]}")
    if not top:
        print("    (the trace holds no device events)")

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.bin")
        with open(src, "wb") as f:
            f.write(raw)
        for comp in ("device", "device_fast", "psv"):
            algo = f"lzss_lcp(coder=huff,comp={comp})"
            out = os.path.join(tmp, f"{comp}.tdc")
            wall = _cli([src, "-a", algo, "-f", "-o", out])
            with open(out, "rb") as f:
                header, payload = f.read().split(b"%", 1)
            on_dev = os.path.join(tmp, f"{comp}.dev.tdc")
            with open(on_dev, "wb") as f:
                f.write(header.replace(b"dec=host", b"dec=device") + b"%"
                        + payload)
            walls = []
            for path in (out, on_dev):
                dec = path + ".dec"
                walls.append(_cli([path, "-d", "-f", "-o", dec]))
                _same_file(dec, raw, f"-d of {os.path.basename(path)}")
                os.remove(dec)
            env = REGISTRY.evaluate(header.decode(), torch_device=dev)
            total, _, fpos, fsrc, flen = parse_factor_arrays(
                env.cls(env).coder_decoder(BitReader(payload)))
            if total != text.size:
                raise AssertionError(f"{comp}: {total} bytes parsed")
            _check_back_references(td, fpos, fsrc, flen, 3)
            print(f"  -a {algo}: {wall:.3f} s, {len(payload) + 1 + len(header)}"
                  f" bytes, {fpos.size} factors; -d dec=host {walls[0]:.3f} s,"
                  f" dec=device {walls[1]:.3f} s ({card})")
    print(f"  {len(raw) // MIB} MiB: every container restores the input "
          f"under dec=host and dec=device; every factor is a "
          f"back-reference")


#: phase 12: the launches of one 256 MiB round trip at world size 1
SHARDED_LAUNCHES = {"rle_select": 16, "histogram_rows": 1,
                    "huff_select": 16, "decode": 1}
#: phase 12: wall-clock limit of one spawn of ranks, in seconds
RANKS_LIMIT = 300.0


def _wall(fn):
    """``fn()``'s result and its wall time in seconds (synchronised)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _sharded_round_trip(mesh, n_bytes: int, expected: str) -> dict:
    """Phase 12 (b), one rank: ``compress_sharded`` of
    ``make_corpus(n_bytes)`` equal to the container in the file
    ``expected``, and ``decompress_sharded`` of it restoring the input
    (rank 0 checks). Returns this rank's wall times and stage times."""
    from bench import make_corpus
    from tudocomp_tpu_torch import BlockCodec
    from tudocomp_tpu_torch.ops import launch_counts, reset_launches
    from tudocomp_tpu_torch.parallel import compress_sharded
    from tudocomp_tpu_torch.parallel.pipeline import decompress_sharded

    data = make_corpus(n_bytes).tobytes()
    codec = BlockCodec(device=mesh.device)
    reset_launches()
    got, t_comp = _wall(lambda: compress_sharded(codec, mesh, data))
    enc = dict(codec.timings)
    with open(expected, "rb") as f:
        container = f.read()
    if mesh.rank == 0 and got != container:
        raise AssertionError("compress_sharded at world 2 differs from "
                             "phase 3's container")
    back, t_dec = _wall(lambda: decompress_sharded(codec, mesh, container))
    if mesh.rank == 0 and back != data:
        raise AssertionError("decompress_sharded at world 2 differs")
    counts = launch_counts()
    return {"compress_s": t_comp, **enc, "decompress_s": t_dec,
            **{f"dec_{k}": v for k, v in codec.timings.items()},
            "launches": {k: counts[k] for k in SHARDED_LAUNCHES}}


def _journaled(mesh, src: str, dst: str, resume: bool) -> float:
    """Phase 12 (b), one rank: ``compress_sharded_resumable`` of ``src``
    into ``dst``; its wall time."""
    from tudocomp_tpu_torch import BlockCodec
    from tudocomp_tpu_torch.parallel.pipeline import (
        compress_sharded_resumable,
    )

    return _wall(lambda: compress_sharded_resumable(
        BlockCodec(device=mesh.device), mesh, src, dst, resume=resume))[1]


def parallel_phase(corpus, dev, card: str, container=None) -> dict:
    """Phase 12: the sharded pipeline at world size 1 over NCCL in this
    process, at world size 2 over gloo in two spawned ranks on the same
    card, and ``dryrun_multichip(2)``. ``container``: phase 3's, which
    ``BlockCodec.compress`` must give again. Returns the launch counts
    of the world-1 round trip."""
    import os
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from tudocomp_tpu_torch import BlockCodec
    from tudocomp_tpu_torch.entry import dryrun_multichip
    from tudocomp_tpu_torch.ops import launch_counts, reset_launches
    from tudocomp_tpu_torch.ops.lzss import factorize_device
    from tudocomp_tpu_torch.parallel import compress_sharded, make_mesh
    from tudocomp_tpu_torch.parallel.distributed import TIMEOUT
    from tudocomp_tpu_torch.parallel.launch import RanksFailed, run_ranks
    from tudocomp_tpu_torch.parallel.pipeline import (
        decompress_sharded, factorize_blocks_sharded,
    )

    data = corpus.tobytes()
    mib = len(data) // MIB
    codec = BlockCodec(device=dev)
    ref, t_ref = _wall(lambda: codec.compress(data))
    if container is not None and ref != container:
        raise AssertionError("BlockCodec.compress differs from phase 3's")
    restored, t_ref_dec = _wall(lambda: codec.decompress_device(ref))
    if restored != data:
        raise AssertionError("decompress_device differs from the input")
    del restored
    print(f"  {mib} MiB ({card}): BlockCodec.compress {t_ref:.3f} s, "
          f"decompress_device {t_ref_dec:.3f} s")

    print("  (a) world size 1, nccl, this process")
    with tempfile.TemporaryDirectory() as td:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(td, "store"), 1),
            rank=0, world_size=1, timeout=TIMEOUT)
        try:
            mesh = make_mesh(1, device=dev)
            # NCCL starts its communicator at the first collective: start
            # it here, outside the timed calls
            mesh.all_reduce(torch.zeros(1, device=dev))
            reset_launches()
            got, t_comp = _wall(lambda: compress_sharded(codec, mesh, data))
            enc = dict(codec.timings)
            back, t_dec = _wall(
                lambda: decompress_sharded(codec, mesh, got))
            counts = launch_counts()
            if got != ref:
                raise AssertionError("compress_sharded at world 1 differs "
                                     "from phase 3's container")
            if back != data:
                raise AssertionError("decompress_sharded at world 1 "
                                     "differs from the input")
            del got, back
            launched = {k: counts[k] for k in SHARDED_LAUNCHES}
            if launched != SHARDED_LAUNCHES:
                raise AssertionError(f"launches at world 1: {launched}")
            print(f"  compress_sharded {t_comp:.3f} s (encode "
                  f"{enc['encode']:.3f}, frames {enc['frames']:.3f}, gather "
                  f"{enc['gather']:.3f}), decompress_sharded {t_dec:.3f} s "
                  f"({card}); == phase 3's container, restores the input; "
                  f"launches {json.dumps(launched)}")
            block = 256 << 10
            blocks = corpus.reshape(8, -1)[:, :block].copy()
            blocks[:, -1] = 0
            factors, t_fact = _wall(lambda: factorize_blocks_sharded(
                mesh, blocks, threshold=3, max_len=512))
        finally:
            dist.destroy_process_group()
    for i in range(len(blocks)):
        want = factorize_device(blocks[i], 3, max_len=512, device=dev)
        if not all(np.array_equal(a, b) for a, b in zip(factors[i], want)):
            raise AssertionError(f"factorize_blocks_sharded block {i}")
    want = factorize_device(blocks[0], 3, max_len=512, device="cpu")
    if not all(np.array_equal(a, b) for a, b in zip(factors[0], want)):
        raise AssertionError("factorize_blocks_sharded block 0 != the CPU")
    print(f"  factorize_blocks_sharded, 8 x 256 KiB: {t_fact:.3f} s "
          f"({card}), {sum(f[0].size for f in factors)} factors; == "
          f"factorize_device per block on the card, block 0 on the CPU")

    print("  (b) world size 2, gloo, two spawned ranks on one card")
    with tempfile.TemporaryDirectory() as td:
        expected = os.path.join(td, "container.bin")
        with open(expected, "wb") as f:
            f.write(ref)
        (r0, r1), t_spawn = _wall(lambda: run_ranks(
            _sharded_round_trip, 2, device=dev.type, backend="gloo",
            args=(len(data), expected), timeout=RANKS_LIMIT))
        for rank, r in enumerate((r0, r1)):
            print(f"  rank {rank}: compress_sharded {r['compress_s']:.3f} s"
                  f" (encode {r['encode']:.3f}, frames {r['frames']:.3f}, "
                  f"gather {r['gather']:.3f}), decompress_sharded "
                  f"{r['decompress_s']:.3f} s (parse {r['dec_parse']:.3f}, "
                  f"decode {r['dec_decode']:.3f}, gather "
                  f"{r['dec_gather']:.3f}) ({card}); launches "
              f"{json.dumps(r['launches'])}")
        both = {k: r0["launches"][k] + r1["launches"][k]
                for k in SHARDED_LAUNCHES}
        if both != {**SHARDED_LAUNCHES, "decode": 2}:
            raise AssertionError(f"launches of the two ranks: {both}")
        print(f"  == phase 3's container, restores the input; the spawn "
              f"{t_spawn:.3f} s in all")
        part = corpus[: 64 * MIB].tobytes()
        src, dst = os.path.join(td, "in64.bin"), os.path.join(td, "out.tbc2")
        with open(src, "wb") as f:
            f.write(part)
        print("  stopping rank 0 after batch 1: rank 1 then loses its peer "
              "(a gloo error and its traceback are expected)", flush=True)
        try:
            run_ranks(_journaled, 2, device=dev.type, backend="gloo",
                      args=(src, dst, False), timeout=RANKS_LIMIT,
                      env={"TDC_CRASH_AFTER_BATCH": "1"})
        except RanksFailed as e:
            if e.exitcodes[0] != 17:
                raise
            crashed = e.exitcodes
        else:
            raise AssertionError("TDC_CRASH_AFTER_BATCH=1 did not stop it")
        times = run_ranks(_journaled, 2, device=dev.type, backend="gloo",
                          args=(src, dst, True), timeout=RANKS_LIMIT)
        with open(dst, "rb") as f:
            if f.read() != codec.compress(part):
                raise AssertionError("the resumed container differs from "
                                     "BlockCodec.compress")
        print(f"  compress_sharded_resumable, 64 MiB: stopped after batch 1"
              f" (exit codes {crashed}), resumed in {max(times):.3f} s "
              f"({card}); == BlockCodec.compress")

    print("  (c) dryrun_multichip(2, device=cuda, backend=gloo)")
    _, t_dry = _wall(lambda: dryrun_multichip(2, device=dev.type,
                                              backend="gloo"))
    print(f"  passed in {t_dry:.3f} s ({card})")
    return counts


#: phase 13: the input sizes of its three parts, in MiB. The corpus's
#: period-124 half takes one round per 4096 bytes (8,201 rounds, 185 s
#: at 64 MiB) and the host flatten of comp=arrays grows as n^2, so (b)
#: and (c) run below phases 10 and 11's 64 and 15 MiB to keep the phase
#: near a minute
LCPCOMP_CHECK_MIB, LCPCOMP_ALONE_MIB, LCPCOMP_CLI_MIB = 1, 16, 4
LCPCOMP_DECS = ("scan", "compact", "MultimapListBuffer", "QueueListBuffer")


def _check_lcpcomp_factors(td, pos, src, ln, threshold: int) -> None:
    """lcpcomp's factors may point forward: the targets, by position,
    are disjoint and inside the text, every length reaches the
    threshold, and each target's bytes equal its source's (int64 tensors
    on the card)."""
    n = td.numel()
    ok = ((ln >= threshold).all() & (src >= 0).all() & (src != pos).all()
          & (src + ln <= n).all() & (pos + ln <= n).all()
          & (pos[1:] >= pos[:-1] + ln[:-1]).all())
    if not bool(ok):
        raise AssertionError("lcpcomp factors overlap or leave the text")
    _check_copies(td, pos, src, ln)


def _syncs(fn):
    """``fn()``'s result and the host syncs it made: the warnings of
    ``torch.cuda``'s sync debug mode."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def lcpcomp_alone(dev, card: str, mib: int) -> None:
    """Phase 13 (b): ``factorize_device`` alone on ``mib`` MiB of the
    corpus, its two parts timed apart, with their host syncs, the peak
    device memory, the factor checks and one trace of the LCP part (the
    rounds' trace is (a)'s: a trace of thousands of rounds takes the
    profiler minutes to read)."""
    import numpy as np
    import torch

    from bench import make_corpus
    from tudocomp_tpu_torch.io.restrictions import escape
    from tudocomp_tpu_torch.meta import InputRestrictions
    from tudocomp_tpu_torch.ops import lcpcomp

    sentinel = InputRestrictions((), True)
    text = np.frombuffer(
        escape(make_corpus(mib * MIB).tobytes(), sentinel), np.uint8)
    n = text.size
    max_len = min(4096, n - 1)
    td = torch.from_numpy(text.copy()).to(dev)
    del text
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    events[0].record()
    (lcp0, src), syncs_lcp = _syncs(
        lambda: lcpcomp._lcp_by_position(td, max_len=max_len))
    events[1].record()
    cov0 = torch.zeros(n, dtype=torch.bool, device=dev)
    ch0 = torch.zeros(n, dtype=torch.int32, device=dev)
    (_, chosen, rounds), syncs_rounds = _syncs(
        lambda: lcpcomp._all_rounds(cov0, ch0, lcp0, 5, max_len=max_len))
    events[2].record()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    ms_lcp = events[0].elapsed_time(events[1])
    ms_rounds = events[1].elapsed_time(events[2])
    starts = torch.nonzero(chosen > 0).squeeze(1)
    _check_lcpcomp_factors(td, starts, src[starts].long(),
                           chosen[starts].long(), 5)
    print(f"  {n} bytes ({card}): _lcp_by_position {ms_lcp:.3f} ms "
          f"({syncs_lcp} host syncs), _all_rounds {ms_rounds:.3f} ms: "
          f"{rounds} rounds, {ms_rounds / rounds:.3f} ms a round "
          f"({syncs_rounds} host syncs); peak device memory "
          f"{peak / MIB:.1f} MiB above the text ({peak / n:.1f} bytes a "
          f"position); {starts.numel()} factors, targets disjoint, each "
          f"equal to its source")
    del starts, chosen, cov0, ch0, lcp0, src
    top = _trace_top(lambda: lcpcomp._lcp_by_position(td, max_len=max_len),
                     5)
    print("  _lcp_by_position, largest device operations of one trace:")
    for ms, count, name in top:
        print(f"    {ms:10.3f} ms  {count:5d}x  {name[:100]}")


def lcpcomp_phase(dev, card: str) -> None:
    """Phase 13: the device lcpcomp (``ops/lcpcomp.py``) at 1 MiB against
    the CPU, alone at 16 MiB, and through the CLI at 4 MiB."""
    import os
    import tempfile

    import numpy as np
    import torch

    from bench import make_corpus
    from tudocomp_tpu_torch import cli, native
    from tudocomp_tpu_torch.compressors.lzss import (
        FactorBuffer, parse_factor_arrays,
    )
    from tudocomp_tpu_torch.ds.suffix import TextDS
    from tudocomp_tpu_torch.io.bitio import BitReader
    from tudocomp_tpu_torch.io.restrictions import escape
    from tudocomp_tpu_torch.meta import InputRestrictions
    from tudocomp_tpu_torch.ops import lcpcomp
    from tudocomp_tpu_torch.registry import REGISTRY
    from tudocomp_tpu_torch.stats import StatPhase

    # as lcpcomp gets it: 0 bytes escaped, one 0 sentinel appended
    sentinel = InputRestrictions((), True)

    # (a) the card against the CPU, and every decoder
    raw = make_corpus(LCPCOMP_CHECK_MIB * MIB).tobytes()
    small = np.frombuffer(escape(raw, sentinel), np.uint8)
    t_cpu = torch.from_numpy(small.copy())
    max_len = min(4096, max(4, small.size - 1))
    lcp_card = lcpcomp._lcp_by_position(t_cpu.to(dev), max_len=max_len)
    lcp_cpu = lcpcomp._lcp_by_position(t_cpu, max_len=max_len)
    if not all(torch.equal(g.cpu(), w) for g, w in zip(lcp_card, lcp_cpu)):
        raise AssertionError("_lcp_by_position: the card differs from the "
                             "CPU")
    with StatPhase("card") as on_card:
        f_card = lcpcomp.factorize_device(small, 5, device=dev)
    with StatPhase("cpu") as on_cpu:
        f_cpu = lcpcomp.factorize_device(small, 5, device="cpu")
    if (not all(np.array_equal(a, b) for a, b in zip(f_card, f_cpu))
            or on_card.stats != on_cpu.stats):
        raise AssertionError("factorize_device: the card differs from the "
                             "CPU")
    rounds_small = on_card.stats["device_rounds"]
    rows = _trace_rows(lambda: lcpcomp._all_rounds(
        torch.zeros(small.size, dtype=torch.bool, device=dev),
        torch.zeros(small.size, dtype=torch.int32, device=dev),
        lcp_card[0], 5, max_len=max_len))
    launches = sum(k for _, k, _ in rows)
    print(f"  {small.size} bytes: _lcp_by_position and factorize_device "
          f"({f_card[0].size} factors, {rounds_small} rounds) on the card "
          f"equal the CPU's; _all_rounds launched {launches} device "
          f"operations in one trace ({launches / rounds_small:.1f} a round),"
          f" the largest:")
    for ms, count, name in rows[:5]:
        print(f"    {ms:10.3f} ms  {count:5d}x  {name[:100]}")
    algo = "lcpcomp(coder=huff,comp=device)"
    blob = cli.compress(algo, raw, raw=True, device=dev)
    for dec in LCPCOMP_DECS:
        t0 = time.perf_counter()
        out = cli.decompress(blob, algo[:-1] + f",dec={dec})", device=dev)
        if out != raw:
            raise AssertionError(f"dec={dec} did not restore the input")
        print(f"  dec={dec} restores the comp=device container: "
              f"{time.perf_counter() - t0:.3f} s ({card})")
    del t_cpu, lcp_card, lcp_cpu

    # (b) factorize_device alone, its two parts apart
    lcpcomp_alone(dev, card, LCPCOMP_ALONE_MIB)
    torch.cuda.empty_cache()

    # (c) through the CLI
    raw = make_corpus(LCPCOMP_CLI_MIB * MIB).tobytes()
    n = len(escape(raw, sentinel))
    walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "in.bin")
        with open(path, "wb") as f:
            f.write(raw)
        for i, algo in enumerate(("lcpcomp(coder=huff,comp=device)",
                                  "lcpcomp(coder=sle,comp=device)",
                                  "lcpcomp(coder=huff,comp=arrays)")):
            out = os.path.join(tmp, f"{i}.tdc")
            walls[algo] = _cli([path, "-a", algo, "-f", "-o", out])
            dec = out + ".dec"
            wall_d = _cli([out, "-d", "-f", "-o", dec])
            _same_file(dec, raw, f"-d of {algo}")
            os.remove(dec)
            with open(out, "rb") as f:
                header, payload = f.read().split(b"%", 1)
            env = REGISTRY.evaluate(header.decode(), torch_device=dev)
            total, _, fpos, _, _ = parse_factor_arrays(
                env.cls(env).coder_decoder(BitReader(payload)))
            if total != n:
                raise AssertionError(f"{algo}: {total} bytes parsed")
            print(f"  -a {algo}: {walls[algo]:.3f} s, "
                  f"{len(header) + 1 + len(payload)} bytes, {fpos.size} "
                  f"factors; -d {wall_d:.3f} s ({card})")
    ratio = (walls["lcpcomp(coder=huff,comp=device)"]
             / walls["lcpcomp(coder=huff,comp=arrays)"])
    print(f"  {LCPCOMP_CLI_MIB} MiB: every container restores the input; "
          f"wall time comp=device / comp=arrays (huff) {ratio:.3f}")
    # the host share: the factor flatten that every comp strategy runs
    text = np.frombuffer(escape(raw, sentinel), np.uint8)
    ds = TextDS(text.tobytes())
    for comp, got in (
            ("device", lcpcomp.factorize_device(text, 5, device=dev)),
            ("arrays", native.lcpcomp_factorize(
                ds.require_sa(), ds.require_isa(), ds.require_lcp(), 5))):
        factors = FactorBuffer()
        factors.extend_arrays(*got)
        t0 = time.perf_counter()
        factors.sort()
        factors.flatten()
        print(f"  FactorBuffer.sort + flatten of the comp={comp} factors: "
              f"{time.perf_counter() - t0:.3f} s (host)")



#: phase 14: the input sizes of its parts, in MiB: (a) the card against
#: the CPU and the host library, (b) the device rounds alone, (c) -a
#: "esp(rounds=device)" against -a esp through the CLI and (d) the
#: literal chain through the CLI
ESP_CHECK_MIB, ESP_ALONE_MIB, ESP_CLI_MIB, CHAIN_MIB = 1, 64, 16, 16


def esp_alone(dev, card: str, mib: int) -> None:
    """Phase 14 (b): ``esp_rounds_device`` on ``mib`` MiB of the corpus
    against the host library, with its host syncs, the host tail, the
    peak device memory, each device round again by CUDA events, and one
    trace of round 1."""
    import numpy as np
    import torch

    from bench import make_corpus
    from tudocomp_tpu_torch import native
    from tudocomp_tpu_torch.compressors.esp import iter_log
    from tudocomp_tpu_torch.ops import esp

    data = make_corpus(mib * MIB).tobytes()
    n = len(data)
    t0 = time.perf_counter()
    rules_h, root_h = native.esp_rounds(data)
    host_s = time.perf_counter() - t0
    stats = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    (rules, root, _), syncs = _syncs(
        lambda: esp.esp_rounds_device(data, device=dev, stats=stats))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - mem0
    if root != root_h or not np.array_equal(rules, rules_h):
        raise AssertionError("esp_rounds_device: the card differs from the "
                             "host library")
    rounds = stats["device_rounds"]
    # the same device rounds again, each timed by CUDA events
    s0 = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(dev)
    s = s0 = s0.long()
    base, lens = 256, []
    events = [torch.cuda.Event(enable_timing=True)]
    events[0].record()
    while s.numel() > 4096:
        lens.append(s.numel())
        s, _, r = esp._esp_round(s, iter_log(256 if base == 256 else 257),
                                 base, base == 256)
        base += r
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    if len(ms) != rounds or base - 256 != stats["device_rules"]:
        raise AssertionError("the timed rounds differ from the call's")
    print(f"  {n} bytes ({card}): host library {host_s:.3f} s; "
          f"esp_rounds_device {wall:.3f} s wall: {rounds} device rounds "
          f"of {sum(ms):.3f} ms ({sum(ms) / rounds:.3f} ms a round, CUDA "
          f"events), then {stats['tail_rounds']} host rounds in "
          f"{stats['tail_s'] * 1e3:.3f} ms; {syncs} host syncs ({rounds} "
          f"rounds + the hand-off); peak device memory {peak / MIB:.1f} "
          f"MiB ({peak / n:.1f} bytes a position); {rules.shape[0]} rules, "
          f"equal to the host library's")
    print("  layer length and ms of each device round: "
          + ", ".join(f"{k} {t:.3f}" for k, t in zip(lens, ms)))
    del s
    top = _trace_top(lambda: esp._esp_round(s0, iter_log(256), 256, True),
                     5)
    print("  device round 1, largest device operations of one trace:")
    for t, count, name in top:
        print(f"    {t:10.3f} ms  {count:5d}x  {name[:100]}")


def esp_phase(dev, card: str) -> None:
    """Phase 14: the device ESP rounds (``ops/esp.py``) at 1 MiB against
    the CPU and the host library, alone at 64 MiB, ``esp(rounds=device)``
    through the CLI at 16 MiB, and the literal chain
    ``bwt:rle:mtf:encode(coder=arithmetic)`` through the CLI."""
    import os
    import tempfile

    import numpy as np
    import torch

    from bench import make_corpus
    from tudocomp_tpu_torch.compressors.esp import esp_rounds
    from tudocomp_tpu_torch.ops.esp import esp_rounds_device

    # (a) the card against the CPU and the host library
    raw = make_corpus(ESP_CHECK_MIB * MIB).tobytes()
    want = esp_rounds(raw)
    on_card, on_cpu = {}, {}
    got = [esp_rounds_device(raw, device=dev, stats=on_card),
           esp_rounds_device(raw, device="cpu", stats=on_cpu),
           esp_rounds_device(raw, tail_cutoff=1, device=dev)]
    for g in got:
        if g[1:] != want[1:] or not np.array_equal(g[0], want[0]):
            raise AssertionError("esp_rounds_device differs from the host "
                                 "library")
    if on_card != {**on_cpu, "tail_s": on_card["tail_s"]}:
        raise AssertionError(f"rounds on the card {on_card}, on the CPU "
                             f"{on_cpu}")
    print(f"  {len(raw)} bytes: rules and root on the card (tail_cutoff "
          f"4096 and 1) == the CPU's == the host library's "
          f"({want[0].shape[0]} rules; {on_card['device_rounds']} device "
          f"rounds, {on_card['tail_rounds']} host rounds)")

    # (b) the device rounds alone
    esp_alone(dev, card, ESP_ALONE_MIB)
    torch.cuda.empty_cache()

    # (c), (d) through the CLI
    with tempfile.TemporaryDirectory() as tmp:
        for mib, pair in (
                (ESP_CLI_MIB, ("esp(rounds=device)", "esp")),
                (CHAIN_MIB, ("bwt(device=true):rle:mtf:"
                             "encode(coder=arithmetic)",
                             "bwt:rle:mtf:encode(coder=arithmetic)"))):
            raw = make_corpus(mib * MIB).tobytes()
            path = os.path.join(tmp, "in.bin")
            with open(path, "wb") as f:
                f.write(raw)
            payloads, line = [], []
            for i, algo in enumerate(pair):
                out = os.path.join(tmp, f"{i}.tdc")
                wall = _cli([path, "-a", algo, "-f", "-o", out])
                dec = out + ".dec"
                wall_d = _cli([out, "-d", "-f", "-o", dec])
                _same_file(dec, raw, f"-d of {algo}")
                os.remove(dec)
                with open(out, "rb") as f:
                    payloads.append(f.read().split(b"%", 1)[1])
                line.append(f"-a {algo}: {wall:.3f} s, -d {wall_d:.3f} s")
            if payloads[0] != payloads[1]:
                raise AssertionError(f"{pair[0]} and {pair[1]} write "
                                     f"different payloads")
            print(f"  {mib} MiB ({card}): " + "; ".join(line)
                  + f"; the same {len(payloads[0])}-byte payload, and "
                  f"each -d restores the input")

#: phase 15 (a)-(c): algorithm and input size (bytes) through cli.main.
#: The sizes follow the JAX package's host speed on these families (a
#: CPU measures lfs_comp and lfs2 at 10-20 s a MiB, the others at
#: 0.1-0.3 s), so that the phase stays under a minute; (a) takes the
#: CLI's one-pass streaming branch, (b) and (c) its buffered path
HOST_CLI = (("lzss", 16 * MIB), ("lz78(coder=bit)", 16 * MIB),
            ("lzw(coder=bit)", 16 * MIB), ("repair(coder=bit)", 4 * MIB),
            ("lz78u(coder=bit)", 4 * MIB), ("lfs_comp", 256 << 10),
            ("lfs2", 256 << 10), ("lfs2bst", 256 << 10))

#: phase 15 (d): SHA-256 of each family's container (header included) of
#: make_corpus(HOST_DIGEST_BYTES), computed from the JAX package
HOST_DIGEST_BYTES = 64 << 10
HOST_DIGESTS = {
    "lzss":
        "e3e1823e14b1caa79e77678c17d5922f0b7b9bc6fd2490fa13b34fdb246cc4a5",
    "lz78(coder=bit)":
        "86486fec9706eabf00570efaa3265ac1f2e9073f37b1531397a7ea046f4aecfd",
    "lzw(coder=bit)":
        "4f1f0c936867005e5b7e0cfe0c7a5ca30fab7b94d04de83503f0ca5675d45dcd",
    "repair(coder=bit)":
        "cdd8dccaef9aca84c3431bda00b491d4d23dc9236e97299ac66e91c7c332d807",
    "lz78u(coder=bit)":
        "cdd394a54f6fb7e64ca4119bfafd9e5bec11bdf7edac3d6c7317e2194e06fee2",
    "lfs_comp":
        "3b8b11649f112d37dc67c7ba031df5825ecd680f3b365d8c56433a8f4a05d581",
    "lfs2":
        "48ca1f1088516399b6469b1fbde9bc5a4f74dacea37c1ea96a3b77c1b731e276",
    "lfs2bst":
        "b402dcb978f2bde9c4b2ad62fc3b0f039eb918bc090b833a43430d222d3a4d80",
}


def host_phase(card: str) -> float:
    """Phase 15: the host families through ``cli.main``, file to file,
    and their containers' digests. Returns the phase's wall time (s)."""
    import hashlib
    import os
    import tempfile

    from bench import make_corpus
    from tudocomp_tpu_torch import cli

    t0 = time.perf_counter()
    data = make_corpus(HOST_DIGEST_BYTES).tobytes()
    for algo, want in HOST_DIGESTS.items():
        got = hashlib.sha256(cli.compress(algo, data)).hexdigest()
        if got != want:
            raise AssertionError(f"{algo}: container digest {got}, the "
                                 f"JAX package's {want}")
    print(f"  (d) {len(HOST_DIGESTS)} containers of {len(data)} bytes "
          f"hash to the JAX package's digests")
    with tempfile.TemporaryDirectory() as tmp:
        for algo, n in HOST_CLI:
            raw = make_corpus(n).tobytes()
            src = os.path.join(tmp, "in.bin")
            with open(src, "wb") as f:
                f.write(raw)
            out = os.path.join(tmp, "out.tdc")
            wall = _cli([src, "-a", algo, "-f", "-o", out])
            dec = out + ".dec"
            wall_d = _cli([out, "-d", "-f", "-o", dec])
            _same_file(dec, raw, f"-d of {algo}")
            with open(out, "rb") as f:
                size = len(f.read())
            _same_file(out, cli.compress(algo, raw), f"the file of {algo}")
            print(f"  {algo} on {n} bytes ({card}): -a {wall:.3f} s "
                  f"({n / wall / MIB:.2f} MiB/s), -d {wall_d:.3f} s, "
                  f"{size} bytes, the buffered container, -d restores "
                  f"the input")
    return time.perf_counter() - t0


def require_launched(counts: dict, names) -> dict:
    """The path's launch counts; raises if one of its kernels never ran."""
    got = {k: counts[k] for k in names}
    missing = [k for k, v in got.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on their path: "
                             f"{missing}")
    return got


#: modules that the phases run, held to importing no JAX
PORT_MODULES = (
    "tudocomp_tpu_torch.models.blockcodec", "tudocomp_tpu_torch.cli",
    "tudocomp_tpu_torch.ops.suffix", "tudocomp_tpu_torch.ops.lzss",
    "tudocomp_tpu_torch.parallel.pipeline", "tudocomp_tpu_torch.ops.lcpcomp",
    "tudocomp_tpu_torch.compressors.lcpcomp",
    "tudocomp_tpu_torch.coders.sle", "tudocomp_tpu_torch.ops.esp",
    "tudocomp_tpu_torch.compressors.esp",
    "tudocomp_tpu_torch.compressors.esp_dcoding",
    "tudocomp_tpu_torch.coders.arithmetic",
    "tudocomp_tpu_torch.compressors.rle", "tudocomp_tpu_torch.compressors.mtf",
    "tudocomp_tpu_torch.compressors.literal",
    "tudocomp_tpu_torch.compressors.lzss",
    "tudocomp_tpu_torch.compressors.lz78",
    "tudocomp_tpu_torch.compressors.lzw",
    "tudocomp_tpu_torch.compressors.lz78_trie",
    "tudocomp_tpu_torch.compressors.repair",
    "tudocomp_tpu_torch.compressors.lz78u",
    "tudocomp_tpu_torch.compressors.lfs", "tudocomp_tpu_torch.ds.suffix_tree",
    "tudocomp_tpu_torch.utils.log",
)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from bench import make_corpus

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    print("== phase 1: toolchain")
    card = toolchain()
    corpus = make_corpus(256 * MIB)
    check = Checker()
    print("== phase 2: kernels vs plain versions")
    kernels_vs_plain(corpus, dev, check)
    print("== phase 3: main path")
    counts, container = main_path(corpus, dev, check)
    print("== phase 4: CUDA vs CPU container")
    cross_device(corpus, dev)
    from tudocomp_tpu_torch.ops import CHUNK_KERNELS, CODEC_KERNELS

    print("== phase 5: launch counts",
          json.dumps(require_launched(counts, CODEC_KERNELS)))
    # K1's and K2's plain entries and K3's gathered form are off the
    # main path (the stages take the select entries and the rows entry):
    # their counts there are 0; K4 at 256 MiB is the main path's launch
    # of K4
    launches = {k: counts[k] for k in ("rle_pack", "huffman_pack",
                                       "histogram", *CODEC_KERNELS)}
    launches["decode@256MiB"] = counts["decode"]
    print("== phase 6: chunked bit packers")
    chunk_counts = chunk_path(corpus, dev, check)
    chunk_launches = require_launched(chunk_counts, CHUNK_KERNELS)
    print("   launch counts", json.dumps(chunk_launches))
    launches.update(chunk_launches)
    print("== phase 7: stage probes")
    from tudocomp_tpu_torch.ops import PROBE_KERNELS

    probe_counts, probes = probe_path(corpus, dev, check)
    probe_launches = require_launched(probe_counts, PROBE_KERNELS)
    print("   launch counts", json.dumps(probe_launches))
    launches.update(probe_launches)
    print("== phase 8: entry()")
    entry_counts = require_launched(entry_phase(dev, card),
                                    ("rle_select", "histogram_rows",
                                     "huff_select"))
    print("   launch counts", json.dumps(entry_counts))
    print("== phase 9: the front end (cli.main) at 256 MiB")
    cli_counts = require_launched(front_end(corpus, container, card),
                                  CODEC_KERNELS)
    print("   launch counts of -a tbc2 and -d", json.dumps(cli_counts))
    print("== phase 10: device suffix array and BWT at 64 MiB")
    suffix_phase(dev, card)
    print("== phase 11: device LZ77 (lzss_lcp) at 1 MiB and 15 MiB")
    lz77_phase(dev, card)
    print("== phase 12: the sharded pipeline (parallel/) at 256 MiB")
    parallel_phase(corpus, dev, card, container)
    del container, corpus
    print("== phase 13: device lcpcomp at 1 MiB, 16 MiB and 4 MiB")
    lcpcomp_phase(dev, card)
    print("== phase 14: device ESP at 1 MiB and 64 MiB, the CLI at 16 MiB")
    esp_phase(dev, card)
    print("== phase 15: the host families through the CLI")
    print(f"  phase 15: {host_phase(card):.1f} s ({card})")
    sources = dict(SOURCES)
    sources.update({c["name"]: (c["source"], c["replaces"]) for c in probes})
    # the modules of every phase ran in this process; none of them (nor
    # anything they import) may have loaded JAX or the JAX package
    unrun = [m for m in PORT_MODULES if m not in sys.modules]
    if unrun:
        raise AssertionError(f"modules of the phases not loaded: {unrun}")
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "tudocomp_tpu"))
    if loaded:
        raise AssertionError(f"the port imported {loaded}")
    print(f"whole run: {time.perf_counter() - t_start:.1f} s ({card})")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **check.res[name]}
        for name, (src, rep) in sources.items()
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
