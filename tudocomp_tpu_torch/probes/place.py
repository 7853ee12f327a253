"""P4: the cost of K2's placement step alone, under three strategies.

Counterpart of the TPU probe ``etc/probe_int8.py``, which timed the
placement loop on fake tokens in three MXU dtype strategies (bf16, int8,
int8raw) at row strides 1 and 2. Hopper has no one-hot placement, so
``csrc/probe_place.cu`` times the ways a Hopper kernel can OR tokens
into words instead:

- ``smem_atomic``: K2's, ``atomicOr`` into shared memory, then one store;
- ``global_atomic``: ``atomicOr`` straight into the output, which each
  block zeroes first;
- ``warp_combine``: the tokens of a warp that hit the same word are
  OR-ed in registers (a segmented OR-scan over the lanes, by shuffles)
  and the word is stored once; atomics only for the words two warps
  share.

The tokens are P4's, taken from each segment's bytes ``b``: value
``(b << 8) | b``, length ``8 + (b & 7)``; at stride 2 the odd positions
get length 0. Unlike the TPU probe's fixed ``10 * pos`` offsets, each
token's offset is the exclusive scan of the lengths, so the output is a
real stream: ``(words i32[NC, 960], bits i32[NC])`` (2048 tokens of at
most 15 bits fill at most 960 words; the words past the stream are
zero). CUDA tensors launch the kernel; CPU tensors take the plain
version.
"""

from __future__ import annotations

import types

import torch

from tudocomp_tpu_torch import _build
from tudocomp_tpu_torch.ops.segpack import SEG, pack_rows

STRATEGIES = ("smem_atomic", "global_atomic", "warp_combine")
STRIDES = (1, 2)
OUT_WORDS = SEG * 15 // 32


def variant(strategy: str, stride: int) -> str:
    """The name under which one variant counts its launches."""
    return f"place_{strategy}_stride{stride}"


#: launch count of each variant, by name
COUNTERS = {variant(s, k): types.SimpleNamespace(launches=0)
            for s in STRATEGIES for k in STRIDES}


def _check_variant(strategy: str, stride: int) -> None:
    if strategy not in STRATEGIES or stride not in STRIDES:
        raise ValueError(f"no placement variant {strategy!r}, stride "
                         f"{stride!r}: want one of {STRATEGIES} x {STRIDES}")


def place_tokens(rows: torch.Tensor, *, strategy: str, stride: int):
    """Pack the fake tokens of each row of ``rows u8[NC, 2048]`` into one
    stream per row. Returns ``(words i32[NC, 960], bits i32[NC])``."""
    _check_variant(strategy, stride)
    nc = rows.shape[0]
    _build.check(rows, torch.uint8, (nc, SEG), "rows")
    if not _build.on_cuda(rows):
        return place_tokens_plain(rows, stride=stride)
    words = torch.empty(nc, OUT_WORDS, dtype=torch.int32, device=rows.device)
    bits = torch.empty(nc, dtype=torch.int32, device=rows.device)
    if nc:
        _build.launch(
            "tdc_probe_place", rows.data_ptr(), words.data_ptr(),
            bits.data_ptr(), nc, STRATEGIES.index(strategy), stride,
            device=rows.device,
        )
        COUNTERS[variant(strategy, stride)].launches += 1
    return words, bits


def fake_tokens(rows: torch.Tensor, stride: int):
    """P4's tokens ``(values, lens)``, int64 ``[NC, 2048]``."""
    b = rows.long()
    ln = 8 + (b & 7)
    if stride == 2:
        ln[:, 1::2] = 0
    return ((b << 8) | b) & ((1 << ln) - 1), ln


def place_tokens_plain(rows, *, stride: int):
    """Plain torch placement: ``pack_rows`` of the fake tokens."""
    values, ln = fake_tokens(rows, stride)
    return pack_rows(values, ln, OUT_WORDS), ln.sum(dim=1).to(torch.int32)
