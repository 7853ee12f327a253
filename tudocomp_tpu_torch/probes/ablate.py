"""P1/P2: stage ablation of K2, the per-segment Huffman pack.

Counterparts of the TPU probes ``etc/probe_ablate.py`` (byte form, P1)
and ``etc/probe_ablate_w4.py`` (word form, P2). Those timed cuts through
the TPU kernels' one-hot dots and VMEM slices; these time cuts through
the Hopper K2 itself: ``csrc/huff_pack.cu`` is one kernel template over
the stage it stops after, so each variant runs K2's own code up to its
cut. The cost of a stage is the difference between adjacent variants.

====== ============================================ ======================
stage  runs                                         output
====== ============================================ ======================
0      load (one warp a segment, 16-byte loads)     wrapping sum of live
                                                    bytes
1      + shared table fill and code-length lookup   ... of ``code + len``
2      + warp sum-scans of the code lengths         ... of live bit offsets
3      + placement: a second lookup, each lane's    ... of the 512 words
       codes appended in registers, whole words
       staged in shared memory, shared words
       completed by a warp OR-scan (no atomics)
4      + store: K2 itself                           ``(words, bits)``
====== ============================================ ======================

The cuts fall where they fell in the first K2 (one block a segment,
shared ``atomicOr`` placement) and the checksums are the same, so the
plain versions did not change with the kernel's redesign: s3 - s2 is
still what placement costs, now with the second table lookup in it
(s1 looks up the lengths only once, for the scan).

Stages 0-3 return one checksum per segment (``i32[NC]``, the u32 sum's
bit pattern), so that nothing they compute is dead code. The word form
reads K2's input, big-endian stream words ``i32[NC, 512]``; the byte
form reads the segment bytes ``u8[NC, 2048]`` straight, and its stage 4
equals K2 on ``be_words_from_bytes(rows)``. CUDA tensors launch the
kernel; CPU tensors take the plain version, whose stages are checksums
of the intermediate values of ``huffman_pack_segments_plain``.
"""

from __future__ import annotations

import types

import torch

from tudocomp_tpu_torch import _build
from tudocomp_tpu_torch.ops.bitpack import as_i32
from tudocomp_tpu_torch.ops.rle import be_words_from_bytes
from tudocomp_tpu_torch.ops.segpack import (
    SEG, STREAM_WORDS, huffman_pack_segments_plain, huffman_terms, pack_rows,
)

STAGES = ("load", "lookup", "scan", "place", "store")
FULL = len(STAGES) - 1


def variant(stage: int, bytes_input: bool) -> str:
    """The name under which a stage of one form counts its launches."""
    return f"huff_stage_{'bytes' if bytes_input else 'w4'}_s{stage}"


#: launch count of each variant, by name
COUNTERS = {variant(s, b): types.SimpleNamespace(launches=0)
            for b in (False, True) for s in range(len(STAGES))}


def _check_stage(stage: int) -> None:
    if stage not in range(len(STAGES)):
        raise ValueError(f"stage must lie in 0..{FULL}: {stage}")


def huffman_pack_stage(data: torch.Tensor, counts: torch.Tensor,
                       sym_code: torch.Tensor, sym_len: torch.Tensor, *,
                       stage: int, bytes_input: bool = False):
    """K2 up to ``stage`` on ``data``: big-endian stream words
    ``i32[NC, 512]``, or with ``bytes_input`` the bytes ``u8[NC, 2048]``.
    Returns the checksums ``i32[NC]`` for stages 0-3 and K2's ``(words
    i32[NC, 512], bits i32[NC])`` for stage 4."""
    _check_stage(stage)
    nc = data.shape[0]
    if bytes_input:
        _build.check(data, torch.uint8, (nc, SEG), "rows")
        _build.check_aligned(data, "rows", 4)
    else:
        _build.check(data, torch.int32, (nc, STREAM_WORDS), "words")
    _build.check(counts, torch.int32, (nc,), "counts")
    _build.check(sym_code, torch.int32, (256,), "sym_code")
    _build.check(sym_len, torch.int32, (256,), "sym_len")
    if not _build.on_cuda(data, counts, sym_code, sym_len):
        return huffman_pack_stage_plain(data, counts, sym_code, sym_len,
                                        stage=stage, bytes_input=bytes_input)
    bits = torch.empty(nc, dtype=torch.int32, device=data.device)
    words = (torch.empty(nc, STREAM_WORDS, dtype=torch.int32,
                         device=data.device) if stage == FULL else None)
    if nc:
        _build.launch(
            "tdc_huff_pack_stage", data.data_ptr(), counts.data_ptr(),
            sym_code.data_ptr(), sym_len.data_ptr(),
            None if words is None else words.data_ptr(), bits.data_ptr(),
            nc, stage, int(bytes_input), device=data.device,
        )
        COUNTERS[variant(stage, bytes_input)].launches += 1
    return bits if words is None else (words, bits)


def huffman_pack_stage_plain(data, counts, sym_code, sym_len, *, stage: int,
                             bytes_input: bool = False):
    """Plain torch stages: stage 4 is ``huffman_pack_segments_plain``;
    stages 0-3 are wrapping u32 sums of its intermediate values."""
    _check_stage(stage)
    words = be_words_from_bytes(data) if bytes_input else data
    if stage == FULL:
        return huffman_pack_segments_plain(words, counts, sym_code, sym_len)
    sym, live, code, ln = huffman_terms(words, counts, sym_code, sym_len)
    if stage == 0:
        x = torch.where(live, sym, 0)
    elif stage == 1:
        x = code + ln
    elif stage == 2:
        x = torch.where(live, torch.cumsum(ln, dim=1) - ln, 0)
    else:
        x = pack_rows(code, ln, STREAM_WORDS).long() & 0xFFFFFFFF
    return as_i32(x.sum(dim=1))
