"""Huffman on the device in plain torch: masked histogram, table-driven
encode, and the canonical table build.

Counterpart of ``tudocomp_tpu/ops/huffman_jax.py``. The TPU looks codes
up as one-hot matmuls (``table_lookup_mxu``) because its gather is slow;
here the lookup is a plain gather. The table is built on the host from
the histogram (``coders/huffman.py``); :func:`device_table_build`, the
counterpart of the JAX package's on-device build, is that host build
with every byte given a code.
"""

from __future__ import annotations

import numpy as np
import torch

from tudocomp_tpu_torch.coders.huffman import HuffmanTable
from tudocomp_tpu_torch.ops.bitpack import as_i32, pack_tokens


def masked_histogram(data: torch.Tensor, length) -> torch.Tensor:
    """256-bin histogram (int64) of ``data.ravel()[:length]`` (u8)."""
    flat = data.reshape(-1)[: int(length)]
    return torch.bincount(flat.long(), minlength=256)


def lookup_codes(flat_u8: torch.Tensor, sym_code: torch.Tensor,
                 sym_len: torch.Tensor):
    """(codeword, length) per byte: ``(i32 u32-pattern, i32)``."""
    idx = flat_u8.long()
    return as_i32(sym_code.long()[idx]), sym_len.to(torch.int32)[idx]


def huffman_encode_tokens(data: torch.Tensor, length,
                          sym_code: torch.Tensor, sym_len: torch.Tensor):
    """Token arrays coding ``data.ravel()[:length]`` with a canonical
    table; positions at or past ``length`` get ``lens == 0``."""
    flat = data.reshape(-1)
    values, lens = lookup_codes(flat, sym_code, sym_len)
    live = torch.arange(flat.shape[0], device=flat.device) < int(length)
    return values, torch.where(live, lens, 0)


def huffman_pack(data: torch.Tensor, length, sym_code: torch.Tensor,
                 sym_len: torch.Tensor):
    """Gather-encode + pack. Returns ``(words i32[N+1], total_bits)``."""
    return pack_tokens(*huffman_encode_tokens(data, length, sym_code,
                                              sym_len))


def device_table_build(hist: torch.Tensor, *, max_len: int = 16,
                       min_len: int = 3):
    """``(sym_code, sym_len)`` (i32[256], on ``hist``'s device) from a
    256-bin histogram: ``HuffmanTable.from_counts(hist, max_len,
    min_len)`` with zero bins counted as 1, so every byte has a code.
    The build is sequential and runs on the host."""
    t = HuffmanTable.from_counts(hist.clamp(min=1).cpu().numpy(),
                                 max_len=max_len, min_len=min_len)
    return (torch.from_numpy(t.sym_code.astype(np.int32)).to(hist.device),
            torch.from_numpy(t.sym_len.astype(np.int32)).to(hist.device))
