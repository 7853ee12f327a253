"""The flagship encode step with tiny example arguments, on torch.

Counterpart of ``__graft_entry__.entry()``: ``rle_stage`` with the
histogram over every row (unsampled), then ``huff_stage`` under the
identity table, on 8 segments of 2048 random bytes below 8 (seed 0).
The arguments are tensors on ``device``, CUDA unless the caller names
another; CUDA raises where it is absent. On CUDA the step runs K1's and
K2's select entries and K3; on the CPU their plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from tudocomp_tpu_torch.device import resolve_device
from tudocomp_tpu_torch.models.blockcodec import huff_stage, rle_stage


def entry(device="cuda"):
    """``(fn, args)``: ``fn(*args)`` returns ``(words i32[8, 512],
    bits i32[8], hist i64[256])``."""
    dev = resolve_device(device)

    def fn(seg_rows, seg_lens, sym_code, sym_len):
        rows, counts, rle_raw, hist = rle_stage(
            seg_rows, seg_lens, offset=0, hist_rows=slice(None)
        )
        words, bits, huff_raw = huff_stage(rows, counts, sym_code, sym_len)
        return words, bits, hist

    rng = np.random.default_rng(0)
    seg_rows = torch.from_numpy(
        rng.integers(0, 8, (8, 2048), dtype=np.uint8)
    ).to(dev)
    seg_lens = torch.full((8,), 2048, dtype=torch.int32, device=dev)
    sym_code = torch.arange(256, dtype=torch.int32, device=dev)
    sym_len = torch.full((256,), 8, dtype=torch.int32, device=dev)
    return fn, (seg_rows, seg_lens, sym_code, sym_len)
