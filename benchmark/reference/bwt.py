"""The BWT stage of tudocomp's ``bwt`` compressor, worked out plainly.

The compressor forbids nothing but asks for a ``\\0`` sentinel, so its
input is escaped (``format.escape``) and ends with one ``\\0``, the
smallest byte and found nowhere else. Its output is the BWT of that
text ``t`` of ``n`` bytes: ``bwt[i] = t[(sa[i] - 1) mod n]``, where
``sa`` lists the suffixes in sorted order. The suffix array comes from
prefix doubling: rank the suffixes by their first ``2k`` bytes as pairs
of ranks by their first ``k``, until every rank differs.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import format as fmt

_I64 = torch.int64


def suffix_array(text: torch.Tensor) -> torch.Tensor:
    """The suffix array (i64[n]) of ``text`` (u8[n]), whose suffixes
    all differ."""
    n = text.numel()
    rank = text.to(_I64)
    k = 1
    while True:
        after = torch.zeros(n, dtype=_I64, device=text.device)
        if k < n:
            after[: n - k] = rank[k:] + 1  # 0: the suffix ends first
        key = rank * (n + 1) + after
        order = torch.argsort(key)
        sk = key[order]
        dense = torch.zeros(n, dtype=_I64, device=text.device)
        dense[1:] = torch.cumsum((sk[1:] != sk[:-1]).to(_I64), 0)
        rank = torch.empty_like(rank)
        rank[order] = dense
        if int(dense[-1]) == n - 1:
            return order
        k *= 2


def transform(text: torch.Tensor) -> torch.Tensor:
    sa = suffix_array(text)
    return text[(sa - 1) % text.numel()]


def compress(data: bytes, device) -> bytes:
    t = fmt.escape(data, sentinel=True)
    text = torch.from_numpy(np.frombuffer(t, np.uint8).copy()).to(device)
    return transform(text).cpu().numpy().tobytes()
