"""ESP ``d_coding`` family: succinct codings of the SLP right-child array.

Copy of ``tudocomp_tpu/compressors/esp_dcoding.py`` for the port, with
the same bits. ``optimal`` runs the port's host library
(``tdc_monotone_decompose`` in ``csrc/host/esp.cpp``) alone: no Python
loop stands behind it.

Re-implements the reference's pluggable D-array coders
(``esp/DRCoder.hpp:12-513``) for the dep-sorted SLP coder — the SEA'17
contribution. Members (CLI names match the reference):

- ``wavelet_tree`` — the D values as a prefix-counting wavelet tree
  (``esp/wt_pc.hpp:19-86``): level ``l`` stores each value's bit
  ``depth-1-l`` with the level laid out in stable order of the values'
  ``l``-bit prefixes. Pure numpy stable sorts both ways.
- ``succinct`` (DMonotonSubseq, ``esp/DRCoder.hpp:154-240`` +
  ``esp/MonotoneSubsequences.hpp``) — the reference default: write D in
  sorted order as unary deltas (B array), decompose the sort permutation
  into monotone subsequences (direction bitvector ``b``), and code the
  per-element subsequence ids ``Dpi`` (rank domain) and ``Dsi``
  (position domain) with a nested d_coding (default wavelet tree) at
  ``bits_for(#subsequences - 1)`` width. Recovery pairs, per
  subsequence, ascending ranks with ascending (``b=0``) or descending
  (``b=1``) positions — a fully vectorized grouped join here, replacing
  the reference's linked-list walk
  (``MonotoneSubsequences.hpp:698-751``).
- ``huffman``/``arithmetic`` — entropy coding over the (large-alphabet)
  D values (``esp/HuffmanCoder.hpp``/``ArithmeticCoder.hpp``
  semantics; wire format is this framework's own).
- ``range_fit`` (``esp/DRCoder.hpp:513+``, default options) — per
  position, D fits in ``bits_for(runmax - suffixmin)`` bits; the
  suffix-min and bit-range arrays are sent with the unary-diff block
  (with its unary-vs-RLE-binary escape), then values at adaptive
  widths.

Subsequence decomposition strategies (``esp/SubseqStrategy.hpp``):
``optimal`` = rounds extracting the longest increasing-or-decreasing
subsequence (patience piles with parent links, native C kernel
``tdc_monotone_decompose``); ``greedy`` = one-pass first-fit piles.
Any valid decomposition decodes identically — the choice only affects
the subsequence count and hence the nested coder's bit width.
"""

from __future__ import annotations

import numpy as np

from tudocomp_tpu_torch import native
from tudocomp_tpu_torch.coders.huffman import gen_codelengths_limited
from tudocomp_tpu_torch.debug import check_kraft
from tudocomp_tpu_torch.io.bitio import BitReader, BitWriter
from tudocomp_tpu_torch.meta import Algorithm, Meta
from tudocomp_tpu_torch.utils.bits import bits_for, bits_for_arr

# -- wavelet tree (wt_pc layout) ---------------------------------------------


def wt_encode(out: BitWriter, v: np.ndarray, depth: int) -> None:
    v = np.asarray(v, np.int64)
    n = v.size
    ones = np.ones(n, np.int64)
    for level in range(depth):
        if level == 0:
            bits = (v >> (depth - 1)) & 1
        else:
            order = np.argsort(v >> (depth - level), kind="stable")
            bits = (v[order] >> (depth - 1 - level)) & 1
        out.write_tokens(bits.astype(np.uint64), ones)


def wt_decode(inp: BitReader, depth: int, n: int) -> np.ndarray:
    pref = np.zeros(n, np.int64)
    for _ in range(depth):
        bits = inp.read_bit_array(n).astype(np.int64)
        order = np.argsort(pref, kind="stable")
        level_bits = np.empty(n, np.int64)
        level_bits[order] = bits
        pref = (pref << 1) | level_bits
    return pref


class DWaveletTree(Algorithm):
    """``esp/DRCoder.hpp:96-152`` — raw wavelet-tree levels."""

    @classmethod
    def meta(cls):
        return Meta("d_coding", "wavelet_tree", "Wavelet tree coding")

    def encode(self, rhs: np.ndarray, out: BitWriter, width: int) -> None:
        out.write_compressed_int(width)
        wt_encode(out, np.asarray(rhs, np.int64), width)

    def decode(self, inp: BitReader, width: int, count: int) -> np.ndarray:
        depth = inp.read_compressed_int()
        return wt_decode(inp, depth, count)


# -- monotone subsequence decomposition --------------------------------------


class SubSeqOptimal(Algorithm):
    @classmethod
    def meta(cls):
        return Meta("subseq", "optimal", "Longest-first decomposition")

    def decompose(self, sis: np.ndarray):
        return native.monotone_decompose(sis)


class SubSeqGreedy(Algorithm):
    """One-pass first-fit piles (cheap, more subsequences)."""

    @classmethod
    def meta(cls):
        return Meta("subseq", "greedy", "First-fit pile decomposition")

    def decompose(self, sis: np.ndarray):
        vals = np.asarray(sis, np.int64).tolist()
        dpi = np.empty(sis.size, np.int64)
        piles: list[tuple[int, int]] = []  # (direction, last value)
        for i, v in enumerate(vals):
            placed = False
            for j, (d, last) in enumerate(piles):
                if (d == 0 and last < v) or (d == 1 and last > v):
                    piles[j] = (d, v)
                    dpi[i] = j
                    placed = True
                    break
            if not placed:
                dpi[i] = len(piles)
                # open the pile in the direction its next element would
                # extend (one-step lookahead): a descending run opens
                # ONE decreasing pile instead of a pile per element
                d = 1 if i + 1 < len(vals) and vals[i + 1] < v else 0
                piles.append((d, v))
        b = np.asarray([d for d, _ in piles], np.uint8)
        return dpi, b


def recover_D(Dpi, Dsi, b, Bde) -> np.ndarray:
    """Vectorized inverse of the decomposition
    (``MonotoneSubsequences.hpp:698-751`` semantics)."""
    Dpi = np.asarray(Dpi, np.int64)
    Dsi = np.asarray(Dsi, np.int64)
    b = np.asarray(b, np.int64)
    n = Dpi.size
    nb = max(int(b.size), int(Dpi.max(initial=0)) + 1)
    order_pi = np.argsort(Dpi, kind="stable")
    order_si = np.argsort(Dsi, kind="stable")
    cnt = np.bincount(Dpi, minlength=nb)
    gstart = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    slot = np.arange(n)
    g = Dpi[order_pi]
    within = slot - gstart[g]
    rev_slot = gstart[g] + cnt[g] - 1 - within
    bb = np.zeros(nb, np.int64)
    bb[: b.size] = b
    pi_slot = np.where(bb[g] == 1, rev_slot, slot)
    D = np.empty(n, np.int64)
    D[order_si] = np.asarray(Bde, np.int64)[order_pi[pi_slot]]
    return D


class DMonotonSubseq(Algorithm):
    """``esp/DRCoder.hpp:154-287`` — the SEA'17 succinct D coding."""

    @classmethod
    def meta(cls):
        m = Meta("d_coding", "succinct", "Monotone-subsequence coding")
        m.option_submeta("subseq", "subseq", default="optimal")
        # the reference's inner coder set is slp_d_coder_2 = {DPlain,
        # DHuffman, DWaveletTree} (registry_config.py:183-187)
        m.option_submeta(
            "dx_coder", "d_coding", default="wavelet_tree",
            accepts=("plain", "huffman", "wavelet_tree"),
        )
        return m

    def encode(self, rhs: np.ndarray, out: BitWriter, width: int) -> None:
        rhs = np.asarray(rhs, np.int64)
        sis = np.argsort(rhs, kind="stable")
        # B array: sorted D values as unary deltas
        svals = rhs[sis]
        out.write_unary_array(
            np.diff(np.concatenate([[0], svals])).astype(np.uint64)
        )
        dpi, b = self.env.instantiate("subseq").decompose(sis)
        out.write_compressed_int(int(b.size))
        out.write_tokens(
            b.astype(np.uint64), np.ones(b.size, np.int64)
        )
        dsi = np.empty_like(dpi)
        dsi[sis] = dpi
        dcombined = np.concatenate([dpi, dsi])
        dwidth = bits_for(max(int(b.size) - 1, 0))
        self.env.instantiate("dx_coder").encode(dcombined, out, dwidth)

    def decode(self, inp: BitReader, width: int, count: int) -> np.ndarray:
        bde = np.cumsum(inp.read_unary_array(count))
        b_size = inp.read_compressed_int()
        b = inp.read_bit_array(b_size)
        dwidth = bits_for(max(b_size - 1, 0))
        dcombined = self.env.instantiate("dx_coder").decode(
            inp, dwidth, 2 * count
        )
        dpi = dcombined[:count]
        dsi = dcombined[count:]
        return recover_D(dpi, dsi, b, bde)


# -- generic large-alphabet canonical Huffman --------------------------------


def _canonical_codes(lengths: np.ndarray):
    """(code, order) for sorted-by-(length, index) canonical assignment
    with the framework's MG firstcode recurrence (ceil division)."""
    order = np.argsort(lengths, kind="stable")
    ls = lengths[order].astype(np.int64)
    longest = int(ls.max())
    numl = np.bincount(ls, minlength=longest + 1)[1:]
    fc = np.zeros(longest, np.int64)
    for i in range(longest - 1, 0, -1):
        fc[i - 1] = (fc[i] + numl[i] + 1) // 2
    start_of_len = np.concatenate([[0], np.cumsum(numl)[:-1]])
    rank = np.arange(ls.size) - start_of_len[ls - 1]
    codes_sorted = fc[ls - 1] + rank
    codes = np.empty(ls.size, np.int64)
    codes[order] = codes_sorted
    return codes, fc


class DHuffman(Algorithm):
    """``esp/DRCoder.hpp:12-38`` semantics: canonical Huffman over the
    distinct D values (alphabet is the value set, not bytes)."""

    @classmethod
    def meta(cls):
        return Meta("d_coding", "huffman", "Huffman-coded D values")

    def encode(self, rhs: np.ndarray, out: BitWriter, width: int) -> None:
        rhs = np.asarray(rhs, np.int64)
        uniq, inv, counts = np.unique(
            rhs, return_inverse=True, return_counts=True
        )
        out.write_compressed_int(int(uniq.size))
        deltas = np.diff(np.concatenate([[-1], uniq]))  # >= 1
        out.write_gamma_array(deltas.astype(np.uint64))
        if uniq.size <= 1:
            return
        # LUT decode needs longest <= 20 (1M-entry table); alphabets up
        # to 2^20 distinct values are far beyond any real SLP
        lengths = gen_codelengths_limited(counts, 20)
        check_kraft(lengths)
        out.write_int_array(lengths.astype(np.uint64), 5)
        codes, _ = _canonical_codes(lengths)
        out.write_tokens(
            codes[inv].astype(np.uint64), lengths[inv].astype(np.int64)
        )

    def decode(self, inp: BitReader, width: int, count: int) -> np.ndarray:
        sigma = inp.read_compressed_int()
        deltas = np.asarray(
            [inp.read_elias_gamma() for _ in range(sigma)], np.int64
        )
        uniq = np.cumsum(deltas) - 1
        if sigma == 0:
            return np.zeros(0, np.int64)
        if sigma == 1:
            return np.full(count, uniq[0], np.int64)
        lengths = inp.read_int_array(5, sigma).astype(np.int64)
        codes, _ = _canonical_codes(lengths)
        # full-depth LUT over the *rank* alphabet, then the jump-chain
        # trick from coders/huffman.py:fast_decode
        k = int(lengths.max())
        lut_rank = np.zeros(1 << k, np.int64)
        lut_len = np.zeros(1 << k, np.int64)
        spans = 1 << (k - lengths)
        starts = codes * spans
        for r in range(sigma):
            lut_rank[starts[r] : starts[r] + spans[r]] = r
            lut_len[starts[r] : starts[r] + spans[r]] = lengths[r]
        bits = inp._bits[inp.pos :].astype(np.int64)
        nbits = bits.size
        padded = np.concatenate([bits, np.zeros(k, np.int64)])
        window = np.zeros(nbits, np.int64)
        for j in range(k):
            window = (window << 1) | padded[j : j + nbits]
        rank_at = lut_rank[window]
        len_at = lut_len[window]
        sentinel = nbits
        jump = np.minimum(
            np.arange(nbits, dtype=np.int64) + len_at, sentinel
        )
        jump = np.concatenate([jump, [sentinel]])
        pos = np.zeros(count, np.int64)
        i = np.arange(count, dtype=np.int64)
        bshift = 0
        while (1 << bshift) <= count:
            mask = (i >> bshift) & 1 == 1
            pos[mask] = jump[pos[mask]]
            jump = jump[np.minimum(jump, sentinel)]
            bshift += 1
        if count and pos.max(initial=0) >= nbits:
            raise ValueError("huffman decode ran past end of stream")
        out = uniq[rank_at[pos]]
        consumed = (
            int(pos[-1] + len_at[pos[-1]]) if count else 0
        )
        inp.pos += consumed
        return out


# -- arithmetic (static range coder over value ranks) ------------------------


class DArithmetic(Algorithm):
    """``esp/DRCoder.hpp:39-65`` semantics: static arithmetic coding of
    the D values (carryless 32-bit range coder, byte renormalized)."""

    @classmethod
    def meta(cls):
        return Meta("d_coding", "arithmetic", "Arithmetic-coded D values")

    TOP = 1 << 24
    BOT = 1 << 16

    def encode(self, rhs: np.ndarray, out: BitWriter, width: int) -> None:
        rhs = np.asarray(rhs, np.int64)
        uniq, inv, counts = np.unique(
            rhs, return_inverse=True, return_counts=True
        )
        out.write_compressed_int(int(uniq.size))
        deltas = np.diff(np.concatenate([[-1], uniq]))
        out.write_gamma_array(deltas.astype(np.uint64))
        out.write_gamma_array(counts.astype(np.uint64))
        if uniq.size <= 1:
            return
        cum = np.concatenate([[0], np.cumsum(counts)])
        total = int(cum[-1])
        low, rng = 0, 0xFFFFFFFF
        payload = bytearray()
        for r in inv.tolist():
            rng //= total
            low = (low + int(cum[r]) * rng) & 0xFFFFFFFF
            rng *= int(counts[r])
            while True:
                if (low ^ (low + rng)) < self.TOP:
                    pass
                elif rng < self.BOT:
                    rng = (-low) & (self.BOT - 1)
                else:
                    break
                payload.append((low >> 24) & 0xFF)
                low = (low << 8) & 0xFFFFFFFF
                rng = (rng << 8) & 0xFFFFFFFF
        for _ in range(4):
            payload.append((low >> 24) & 0xFF)
            low = (low << 8) & 0xFFFFFFFF
        out.write_compressed_int(len(payload))
        out.write_int_array(
            np.frombuffer(bytes(payload), np.uint8).astype(np.uint64), 8
        )

    def decode(self, inp: BitReader, width: int, count: int) -> np.ndarray:
        sigma = inp.read_compressed_int()
        deltas = np.asarray(
            [inp.read_elias_gamma() for _ in range(sigma)], np.int64
        )
        uniq = np.cumsum(deltas) - 1
        counts = np.asarray(
            [inp.read_elias_gamma() for _ in range(sigma)], np.int64
        )
        if sigma == 0:
            return np.zeros(0, np.int64)
        if sigma == 1:
            return np.full(count, uniq[0], np.int64)
        nbytes = inp.read_compressed_int()
        payload = inp.read_int_array(8, nbytes).astype(np.int64)
        cum = np.concatenate([[0], np.cumsum(counts)])
        total = int(cum[-1])
        pos = 0
        code = 0
        for _ in range(4):
            code = (code << 8) | int(payload[pos])
            pos += 1
        low, rng = 0, 0xFFFFFFFF
        out = np.empty(count, np.int64)
        cum_list = cum.tolist()
        for i in range(count):
            rng //= total
            target = ((code - low) & 0xFFFFFFFF) // rng
            # binary search the rank
            import bisect

            r = bisect.bisect_right(cum_list, target) - 1
            r = min(r, sigma - 1)
            out[i] = r
            low = (low + cum_list[r] * rng) & 0xFFFFFFFF
            rng *= int(counts[r])
            while True:
                if (low ^ (low + rng)) < self.TOP:
                    pass
                elif rng < self.BOT:
                    rng = (-low) & (self.BOT - 1)
                else:
                    break
                code = ((code << 8) | int(
                    payload[pos] if pos < nbytes else 0
                )) & 0xFFFFFFFF
                pos += 1
                low = (low << 8) & 0xFFFFFFFF
                rng = (rng << 8) & 0xFFFFFFFF
        return uniq[out]


# -- range fit ----------------------------------------------------------------


def _unary_diff_encode(out: BitWriter, vec: np.ndarray, bit_width: int,
                       val_width: int, sign: bool) -> None:
    """Unary-diff block with the RLE-binary escape
    (``esp/DRCoder.hpp:291-436`` semantics)."""
    vec = np.asarray(vec, np.int64)
    diffs = np.diff(np.concatenate([[0], vec]))
    absd = np.abs(diffs)
    bits_unary = vec.size + int(absd.sum()) + (
        int((absd != 0).sum()) if sign else 0
    )
    # RLE-binary alternative: one (count, value) pair per value change;
    # run counts are capped at 2**bit_width - 1 (they share the value
    # field width), so long runs split into several pairs
    run_cap = (1 << min(bit_width, 62)) - 1
    if vec.size:
        boundary = np.concatenate([[True], diffs[1:] != 0])
        starts = np.flatnonzero(boundary)
        runs = np.diff(np.concatenate([starts, [vec.size]]))
        vals = vec[starts]
        n_pieces = -(-runs // run_cap)
        changes = int(n_pieces.sum())
    else:
        changes = 0
    bits_binary = changes * (bit_width + val_width)
    use_unary = bits_unary <= bits_binary
    out.write_bit(use_unary)
    if use_unary:
        out.write_unary_array(absd.astype(np.uint64))
        if sign:
            nz = diffs[absd != 0]
            out.write_tokens(
                (nz > 0).astype(np.uint64), np.ones(nz.size, np.int64)
            )
    elif vec.size:
        pvals = np.repeat(vals, n_pieces)
        pruns = np.full(pvals.size, run_cap, np.int64)
        last = np.cumsum(n_pieces) - 1
        pruns[last] = runs - (n_pieces - 1) * run_cap
        tv = np.empty(pvals.size * 2, np.uint64)
        tl = np.empty(pvals.size * 2, np.int64)
        tv[0::2] = pruns.astype(np.uint64)
        tl[0::2] = bit_width
        tv[1::2] = pvals.astype(np.uint64)
        tl[1::2] = val_width
        out.write_tokens(tv, tl)


def _unary_diff_decode(inp: BitReader, count: int, bit_width: int,
                       val_width: int, sign: bool) -> np.ndarray:
    if inp.read_bit():
        absd = inp.read_unary_array(count)
        if sign:
            nz = int((absd != 0).sum())
            signs = inp.read_bit_array(nz).astype(np.int64) * 2 - 1
            d = absd.copy()
            d[absd != 0] *= signs
        else:
            d = absd
        return np.cumsum(d)
    out = np.empty(count, np.int64)
    i = 0
    while i < count:
        c = inp.read_int(bit_width)
        v = inp.read_int(val_width)
        if c <= 0:
            raise ValueError("malformed unary-diff block (zero run)")
        out[i : i + c] = v
        i += c
    return out


class DRangeFit(Algorithm):
    """``esp/DRCoder.hpp:513+`` (default options: no threshold, no wt,
    no zero_min): suffix-min + running-max adaptive bit widths."""

    @classmethod
    def meta(cls):
        return Meta("d_coding", "range_fit", "Adaptive-range D coding")

    def encode(self, rhs: np.ndarray, out: BitWriter, width: int) -> None:
        rhs = np.asarray(rhs, np.int64)
        n = rhs.size
        mins = np.minimum.accumulate(rhs[::-1])[::-1]
        maxs = np.maximum.accumulate(rhs)
        ranges = bits_for_arr((maxs - mins).astype(np.uint64)).astype(
            np.int64
        )
        _unary_diff_encode(out, mins, width, width, sign=False)
        _unary_diff_encode(out, ranges, width, 7, sign=True)
        out.write_tokens((rhs - mins).astype(np.uint64), ranges)

    def decode(self, inp: BitReader, width: int, count: int) -> np.ndarray:
        mins = _unary_diff_decode(inp, count, width, width, sign=False)
        ranges = _unary_diff_decode(inp, count, width, 7, sign=True)
        vals = inp.read_var_int_array(ranges).astype(np.int64)
        return vals + mins
