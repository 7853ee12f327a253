"""Rank/Select over bit vectors (reference ``ds/Rank.hpp``,
``ds/Select.hpp``, broadword helpers ``ds/rank_64bit.hpp`` /
``ds/select_64bit.hpp``).

Array re-formulation: the bit vector is a packed uint64 array; rank uses
block popcount prefix sums (the reference's superblock/block scheme
collapses into one vectorized cumsum per 64-bit block), select combines
a searchsorted over the block ranks with an in-block popcount scan.
All operations accept scalar or vector arguments.

Copy of ``tudocomp_tpu/ds/rank_select.py``: its ``SparseISA`` and
``CompressedLCP`` serve ``lzss_lcp(ds=compressed)``.
"""

from __future__ import annotations

import numpy as np


def _popcount64(x: np.ndarray) -> np.ndarray:
    x = x.copy()
    x = x - ((x >> np.uint64(1)) & np.uint64(0x5555555555555555))
    x = (x & np.uint64(0x3333333333333333)) + (
        (x >> np.uint64(2)) & np.uint64(0x3333333333333333)
    )
    x = (x + (x >> np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    with np.errstate(over="ignore"):  # broadword multiply wraps by design
        return (x * np.uint64(0x0101010101010101)) >> np.uint64(56)


class BitVector:
    """Bit vector with O(1) rank and O(log n) select."""

    def __init__(self, bits):
        self.bits = np.asarray(bits, bool)
        self.n = self.bits.size
        padded = np.concatenate(
            [self.bits, np.zeros((-self.n) % 64, bool)]
        )
        le = np.packbits(padded.reshape(-1, 8)[:, ::-1]).astype(np.uint64)
        self.words = (
            le.reshape(-1, 8)
            * (np.uint64(1) << (np.uint64(8) * np.arange(8, dtype=np.uint64)))
        ).sum(axis=1, dtype=np.uint64)
        counts = _popcount64(self.words)
        self.block_rank = np.concatenate(
            [[0], np.cumsum(counts)]
        ).astype(np.int64)  # rank before each block
        self.total_ones = int(self.block_rank[-1])
        self._one_positions = None

    def rank1(self, i):
        """Number of 1s in bits[0..i) (exclusive, like the cumulative
        convention; i in [0, n])."""
        i = np.asarray(i, np.int64)
        if len(self.words) == 0:
            return np.zeros_like(i)
        block = i >> 6
        off = (i & 63).astype(np.uint64)
        word = self.words[np.minimum(block, len(self.words) - 1)]
        mask = np.where(
            off > 0,
            (np.uint64(1) << off) - np.uint64(1),
            np.uint64(0),
        )
        inblock = _popcount64(word & mask).astype(np.int64)
        full = self.block_rank[np.minimum(block, len(self.words))]
        return np.where(
            i >= self.n,
            self.total_ones,
            full + np.where(block < len(self.words), inblock, 0),
        )

    def select1(self, k):
        """Position of the k-th 1 (1-indexed, reference convention)."""
        if self._one_positions is None:
            self._one_positions = np.flatnonzero(self.bits)
        k = np.asarray(k, np.int64)
        return self._one_positions[k - 1]


class SparseISA:
    """ISA in O(n/t) extra space (reference ``ds/SparseISA.hpp:16-120``):
    ISA[i] is the predecessor of ``i`` on its SA permutation cycle. Every
    t-th cycle node carries a *backward* shortcut to the previous
    shortcut node; a lookup walks forward, takes at most one shortcut,
    and terminates within O(t) steps."""

    def __init__(self, sa: np.ndarray, t: int = 3):
        self.sa = np.asarray(sa, np.int64)
        n = self.sa.size
        self.t = t
        has = np.zeros(n, bool)
        visited = np.zeros(n, bool)
        cycles = []
        for start in range(n):
            if visited[start]:
                continue
            cycle = [start]
            visited[start] = True
            j = int(self.sa[start])
            while j != start:
                visited[j] = True
                cycle.append(j)
                j = int(self.sa[j])
            cycles.append(cycle)
            if len(cycle) > t:
                for k in range(0, len(cycle), t):
                    has[cycle[k]] = True
        self.has_shortcut = BitVector(has)
        shortcuts = np.zeros(self.has_shortcut.total_ones, np.int64)
        for cycle in cycles:
            prev = cycle[0]
            for v in cycle:
                if has[v] and v != cycle[0]:
                    shortcuts[int(self.has_shortcut.rank1(v))] = prev
                    prev = v
            if has[cycle[0]]:
                shortcuts[int(self.has_shortcut.rank1(cycle[0]))] = prev
        self.shortcuts = shortcuts

    def __getitem__(self, i: int) -> int:
        j = int(i)
        may_jump = True
        while int(self.sa[j]) != i:
            if may_jump and self.has_shortcut.bits[j]:
                j = int(self.shortcuts[int(self.has_shortcut.rank1(j))])
                may_jump = False
            else:
                j = int(self.sa[j])
        return j


class CompressedLCP:
    """Fischer WeeLCP: PLCP as a 2n-bit unary bitvector + select
    (reference ``ds/CompressedLCP.hpp``, ``ds/LCPSada.hpp:153-186``)."""

    def __init__(self, sa: np.ndarray, plcp: np.ndarray):
        self.sa = np.asarray(sa, np.int64)
        n = self.sa.size
        # bitvector: for i in 0..n-1, write (plcp[i]-plcp[i-1]+1) zeros
        # then a one  =>  position of the i-th one = 2i + plcp[i]... the
        # standard sparse encoding: bit at 2i + plcp[i] (monotone)
        ones = 2 * np.arange(n, dtype=np.int64) + np.asarray(
            plcp, np.int64
        )
        bits = np.zeros(2 * n + 1, bool)
        bits[ones] = True
        self.bv = BitVector(bits)

    def plcp(self, i):
        """PLCP[i] = select1(i+1) - 2i."""
        return self.bv.select1(np.asarray(i, np.int64) + 1) - 2 * np.asarray(
            i, np.int64
        )

    def __getitem__(self, sa_rank: int) -> int:
        """LCP[rank] = PLCP[SA[rank]]."""
        return int(self.plcp(int(self.sa[sa_rank])))
