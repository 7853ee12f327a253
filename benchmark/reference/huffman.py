"""The canonical Huffman table of tudocomp's ``HuffmanCoder``, plainly.

Code lengths: Huffman's construction over the symbols that occur, by a
heap of ``(count, node)`` pairs (leaves are nodes ``0..n-1`` in symbol
order, merged nodes count on from ``n``), so ties break by node number.
Where the longest code exceeds ``max_len``, every count is halved
(rounding up) and the code rebuilt; where halving no longer changes the
counts, a near-balanced code is used. Lengths under ``min_len`` are
raised to it. Symbols are then ordered by (length, symbol), and the
code of length ``l`` starts at ``firstcode[l - 1]``, where
``firstcode[longest - 1] = 0`` and ``firstcode[l - 1] =
ceil((firstcode[l] + numl[l]) / 2)``. Serialised as: compressed_int
(longest), ``longest`` compressed_ints (codes of each length),
compressed_int (alphabet size), the ordered symbols in 8 bits each.
"""

from __future__ import annotations

import heapq

import numpy as np


def _lengths(counts: np.ndarray) -> np.ndarray:
    n = counts.size
    heap = [(int(c), i) for i, c in enumerate(counts)]
    heapq.heapify(heap)
    parent = np.full(2 * n - 1, -1, np.int64)
    nxt = n
    while len(heap) > 1:
        c1, a = heapq.heappop(heap)
        c2, b = heapq.heappop(heap)
        parent[a] = parent[b] = nxt
        heapq.heappush(heap, (c1 + c2, nxt))
        nxt += 1
    depth = np.zeros(2 * n - 1, np.int64)
    for node in range(nxt - 2, -1, -1):
        depth[node] = depth[parent[node]] + 1
    return depth[:n]


def _limited_lengths(counts: np.ndarray, max_len: int) -> np.ndarray:
    c = counts.astype(np.int64)
    while True:
        lengths = _lengths(c)
        if lengths.max() <= max_len:
            return lengths
        halved = (c + 1) // 2
        if (halved == c).all():
            d = int(np.ceil(np.log2(c.size)))
            lengths = np.full(c.size, d, np.int64)
            lengths[np.argsort(-c, kind="stable")[: (1 << d) - c.size]] = d - 1
            return lengths
        c = halved


class Table:
    """``symbols``/``lengths`` in canonical order, ``code``/``length``
    indexed by byte value, and the serialised form's numbers."""

    def __init__(self, hist: np.ndarray, max_len: int, min_len: int):
        present = np.flatnonzero(hist)
        lengths = _limited_lengths(hist[present], max_len)
        if lengths.size > 1:
            lengths = np.maximum(lengths, min_len)
        order = np.argsort(lengths, kind="stable")
        self.symbols = present[order]
        self.lengths = lengths[order]
        self.longest = int(self.lengths.max())
        self.numl = np.bincount(self.lengths,
                                minlength=self.longest + 1)[1:]
        first = np.zeros(self.longest, np.int64)
        for l in range(self.longest - 1, 0, -1):
            first[l - 1] = (first[l] + self.numl[l] + 1) // 2
        start = np.concatenate([[0], np.cumsum(self.numl)[:-1]])
        rank = np.arange(self.symbols.size) - start[self.lengths - 1]
        self.code = np.zeros(256, np.int64)
        self.length = np.zeros(256, np.int64)
        self.code[self.symbols] = first[self.lengths - 1] + rank
        self.length[self.symbols] = self.lengths

    def write(self, bits) -> None:
        bits.compressed_int(self.longest)
        for n in self.numl.tolist():
            bits.compressed_int(n)
        bits.compressed_int(int(self.symbols.size))
        for s in self.symbols.tolist():
            bits.int(s, 8)
