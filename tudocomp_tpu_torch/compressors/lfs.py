"""LFS: longest-first substitution grammar compression.

The port's copy of ``tudocomp_tpu/compressors/lfs.py``, with the same
options, headers and bytes. The parses, the SimST and BST rule
computations and the bit-coder and Huffman decoders run in the host
library (``csrc/host/lfs.cpp``), which raises when it cannot be built.
The Python walks stay only where the JAX package takes them for another
reason than a missing library: SimST's and BST's loops where their host
call overflows, and the decode loops of the ``ascii`` literal coder (or
of a Huffman table too deep for a decode LUT).

Reference: ``compressors/lfs/`` (``LFSCompressor.hpp``,
``ESAStrategy.hpp``, ``STStrategy.hpp``, ``EncodeStrategy.hpp``).
Repeatedly pick the longest repeating factor (LRF) with >= 2
non-overlapping live occurrences, make it a dictionary rule, and replace
its occurrences with non-terminals.

Strategies (``computing_strat=``): ``esa`` finds LRFs from SA/LCP bins
(longest first); ``st`` walks suffix-tree internal nodes by string depth.
Both produce (dictionary, occurrence list) for the shared coding
strategy.

Wire format (= reference ``EncodeStrategy``): rule lengths as a delta
chain closed by the last length (len coder, gamma by default), rule
strings as literals, then the start string as ``0 literal`` /
``1 rule-id`` tokens (lit coder, huffman by default).
"""

from __future__ import annotations

import numpy as np

from tudocomp_tpu_torch import native
from tudocomp_tpu_torch.coders import UNIVERSAL_CODER_NAMES
from tudocomp_tpu_torch.coders.base import Literals
from tudocomp_tpu_torch.coders.huffman import HuffmanCoder
from tudocomp_tpu_torch.coders.simple import BitCoder
from tudocomp_tpu_torch.compressors.base import Compressor
from tudocomp_tpu_torch.ds.suffix import TextDS
from tudocomp_tpu_torch.ds.suffix_tree import SuffixTree
from tudocomp_tpu_torch.io.bitio import BitReader, BitWriter
from tudocomp_tpu_torch.meta import Algorithm, Meta
from tudocomp_tpu_torch.ranges import Range, bit_r, literal_r
from tudocomp_tpu_torch.registry import REGISTRY

UINT32_R = Range(0xFFFFFFFF)


def _native_rules(text: bytes, min_lrf: int):
    """Both LRF strategies: the host single-layer longest-first parse
    (``tdc_lfs_parse``, an lcp-interval sweep over SA/LCP — the ESA
    formulation of the suffix-tree walk; reference
    ``lfs/ESAStrategy.hpp`` / ``lfs/STStrategy.hpp`` compute the same
    longest-first rule set from the same node set).  Returns
    (dictionary, occurrences)."""
    n = len(text) - 1  # strip the appended sentinel
    if n < min_lrf:
        return [], []
    ds = TextDS(text)
    fl_nts, fl_off, nts_start, nts_len = native.lfs_parse(
        ds.require_sa(), ds.require_lcp(), n, min_lrf
    )
    dictionary = [
        (int(s), int(ln))
        for s, ln in zip(nts_start.tolist(), nts_len.tolist())
    ]
    occurrences = []
    lens = nts_len.tolist()
    for p in np.flatnonzero(fl_nts).tolist():
        rid = int(fl_nts[p]) - 1
        occurrences.append((p, rid, lens[rid]))
    occurrences.sort()
    return dictionary, occurrences


class ESAStrategy(Algorithm):
    """LRFs from SA/LCP, longest first (reference ``ESAStrategy.hpp``)."""

    @classmethod
    def meta(cls):
        m = Meta("lfs_comp", "esa", "ESA-based LRF computation")
        m.option_dynamic("min_lrf", 2)
        return m

    def compute_rules(self, text: bytes):
        return _native_rules(text, self.env.option("min_lrf").as_int())


class STStrategy(Algorithm):
    """LRFs from suffix-tree internal nodes by string depth
    (reference ``STStrategy.hpp``)."""

    @classmethod
    def meta(cls):
        m = Meta("lfs_comp", "st", "Suffix-tree LRF computation")
        m.option_dynamic("min_lrf", 2)
        return m

    def compute_rules(self, text: bytes):
        return _native_rules(text, self.env.option("min_lrf").as_int())


class SimSTStrategy(Algorithm):
    """Simulated suffix tree (reference ``SimSTStrategy.hpp:25-229``):
    nodes binned by string depth, occurrence lists merged from children
    on first touch, and — the behavioral difference from ``st`` — a
    node whose occurrences are cut short by already-replaced tails is
    re-binned at a reduced length (``min_shorter``) when that prefix is
    still an LRF longer than the parent's depth, so partially-covered
    repeats are substituted at reduced length. ``min_shorter`` is one
    monotone accumulator shared across the node's occurrences — each
    dead-tail occurrence only advances it from its current value, not
    from 1 — exactly mirroring the reference's quirky single-variable
    scan (``SimSTStrategy.hpp:61-67``), so the re-bin length can exceed
    some occurrences' true live prefix."""

    @classmethod
    def meta(cls):
        m = Meta("lfs_comp", "sim_st", "Simulated-ST LRF computation")
        m.option_dynamic("min_lrf", 2)
        return m

    def compute_rules(self, text: bytes):
        min_lrf = self.env.option("min_lrf").as_int()
        st = SuffixTree(text)
        n = st.n
        fast = native.lfs_simst(
            st.parent, st.sdepth, st.is_leaf, st.suffix, n, min_lrf
        )
        if fast is not None:
            return fast
        nn = len(st.parent)
        children: list[list[int]] = [[] for _ in range(nn)]
        for v in range(1, nn):
            children[int(st.parent[v])].append(v)
        max_depth = 0
        bins: dict[int, list[int]] = {}
        for v in range(nn):
            if not st.is_leaf[v] and v != st.root:
                d = int(st.sdepth[v])
                bins.setdefault(d, []).append(v)
                max_depth = max(max_depth, d)
        dead = np.zeros(n, bool)
        node_begins: dict[int, list[int]] = {}
        dictionary: list[tuple[int, int]] = []
        occurrences: list[tuple[int, int, int]] = []

        def begins(v: int) -> list[int]:
            got = node_begins.get(v)
            if got is not None:
                return got
            # iterative post-order: build descendants first (deep trees
            # of run-heavy inputs would blow Python recursion)
            stack, order = [v], []
            while stack:
                u = stack.pop()
                order.append(u)
                for c in children[u]:
                    if not st.is_leaf[c] and c not in node_begins:
                        stack.append(c)
            for u in reversed(order):
                if u in node_begins:
                    continue
                merged = []
                for c in children[u]:
                    if st.is_leaf[c]:
                        p = int(st.suffix[c])
                        if not dead[p]:
                            merged.append(p)
                    else:
                        merged.extend(node_begins[c])
                        node_begins[c] = []
                merged.sort()  # selection walks positions ascending
                node_begins[u] = merged
            return node_begins[v]

        for length in range(max_depth, min_lrf - 1, -1):
            queue = bins.get(length, [])
            for v in queue:
                poss = begins(v)
                selected = []
                not_selected = []
                last = -length - 1
                min_shorter = 1
                for p in poss:
                    if (
                        last + length <= p and not dead[p]
                        and not dead[p + length - 1]
                    ):
                        selected.append(p)
                        last = p
                    else:
                        not_selected.append(p)
                    if not dead[p] and dead[p + length - 1]:
                        while (
                            p + min_shorter < n
                            and not dead[p + min_shorter]
                        ):
                            min_shorter += 1
                # re-add at the shortest live prefix (reference :72-88)
                if min_shorter > 1 and min_shorter < length \
                        and min_shorter >= min_lrf:
                    parent_depth = int(st.sdepth[int(st.parent[v])])
                    if parent_depth < min_shorter:
                        bins.setdefault(min_shorter, []).append(v)
                if len(selected) >= 2:
                    node_begins[v] = not_selected
                    rule_id = len(dictionary)
                    dictionary.append((int(selected[0]), length))
                    for p in selected:
                        dead[p : p + length] = True
                        occurrences.append((p, rule_id, length))
        occurrences.sort()
        return dictionary, occurrences


class BSTStrategy(Algorithm):
    """Binary (first-child/next-sibling) suffix tree walk (reference
    ``BSTStrategy.hpp:25-120`` over ``BinarySuffixTree``): string
    depths computed by explicit child-chain recursion, per-node
    beginning positions merged from the chain on demand, greedy
    non-overlapping selection with dead-position filtering of the
    retained list. No shorter-prefix re-binning (unlike ``sim_st``)."""

    @classmethod
    def meta(cls):
        m = Meta("lfs_comp", "bst", "Binary-ST LRF computation")
        m.option_dynamic("min_lrf", 2)
        return m

    def compute_rules(self, text: bytes):
        min_lrf = self.env.option("min_lrf").as_int()
        st = SuffixTree(text)
        n = st.n
        fast = native.lfs_bst(
            st.parent, st.sdepth, st.suffix, n, min_lrf
        )
        if fast is not None:
            return fast
        nn = len(st.parent)
        # first-child / next-sibling representation
        first_child = [0] * nn
        next_sibling = [0] * nn
        for v in range(nn - 1, 0, -1):  # prepend keeps child order
            p = int(st.parent[v])
            next_sibling[v] = first_child[p]
            first_child[p] = v
        bins: dict[int, list[int]] = {}
        max_depth = 0
        stack = [int(st.root)]
        while stack:  # explicit DFS over the child chains
            v = stack.pop()
            if first_child[v] != 0:
                d = int(st.sdepth[v])
                if d > 0:
                    bins.setdefault(d, []).append(v)
                    max_depth = max(max_depth, d)
                c = first_child[v]
                while c != 0:
                    stack.append(c)
                    c = next_sibling[c]
        dead = np.zeros(n, bool)
        beginning_positions: dict[int, list[int]] = {}
        dictionary: list[tuple[int, int]] = []
        occurrences: list[tuple[int, int, int]] = []

        def positions(v: int) -> list[int]:
            got = beginning_positions.get(v)
            if got is not None:
                return got
            stack, order = [v], []
            while stack:
                u = stack.pop()
                order.append(u)
                c = first_child[u]
                while c != 0:
                    if first_child[c] != 0 \
                            and c not in beginning_positions:
                        stack.append(c)
                    c = next_sibling[c]
            for u in reversed(order):
                if u in beginning_positions:
                    continue
                merged = []
                c = first_child[u]
                while c != 0:
                    if first_child[c] == 0:  # leaf
                        p = int(st.suffix[c])
                        if not dead[p]:
                            merged.append(p)
                    else:
                        merged.extend(beginning_positions[c])
                        beginning_positions[c] = []
                    c = next_sibling[c]
                merged.sort()
                beginning_positions[u] = merged
            return beginning_positions[v]

        for length in range(max_depth, min_lrf - 1, -1):
            for v in bins.get(length, []):
                poss = positions(v)
                selected = []
                not_selected = []
                last = -length - 1
                for p in poss:
                    if (
                        last + length <= p and not dead[p]
                        and not dead[p + length - 1]
                    ):
                        selected.append(p)
                        last = p
                    elif not dead[p]:  # drop dead heads (ref :105-112)
                        not_selected.append(p)
                if len(selected) >= 2:
                    beginning_positions[v] = not_selected
                    rule_id = len(dictionary)
                    dictionary.append((int(selected[0]), length))
                    for p in selected:
                        dead[p : p + length] = True
                        occurrences.append((p, rule_id, length))
        occurrences.sort()
        return dictionary, occurrences


class EncodeStrategy(Algorithm):
    """Shared coding strategy (reference ``EncodeStrategy.hpp``)."""

    @classmethod
    def meta(cls):
        m = Meta("lfs_comp_enc", "lfs_encode_strat", "LFS encoding")
        m.option_submeta(
            "lfs_lit_coder", "coder", default="huff",
            accepts=("ascii", "bit", "huff"),
        )
        m.option_submeta(
            "lfs_len_coder", "coder", default="gamma",
            accepts=UNIVERSAL_CODER_NAMES,
        )
        return m

    def encode(self, text: np.ndarray, dictionary, occurrences) -> bytes:
        out = BitWriter()
        lit_env = self.env.env_for_option("lfs_lit_coder")
        lit_coder = lit_env.cls.Encoder(
            lit_env, out, Literals(text, np.arange(text.size))
        )
        len_env = self.env.env_for_option("lfs_len_coder")
        len_coder = len_env.cls.Encoder(len_env, out, Literals())

        # dictionary rule lengths: first absolute, then deltas, closed by
        # the last length (decoder subtracts down to zero)
        if dictionary:
            first_len = dictionary[0][1]
            s_length_r = Range(first_len)
            len_coder.encode(first_len, UINT32_R)
            lens_arr = np.asarray([l for _, l in dictionary], np.int64)
            deltas = np.concatenate(
                [lens_arr[:-1] - lens_arr[1:], lens_arr[-1:]]
            )
            len_coder.encode_array(deltas.astype(np.uint64), s_length_r)
        else:
            len_coder.encode(0, UINT32_R)
        # rule strings (one bulk literal encode)
        if dictionary:
            offs = np.asarray([o for o, _ in dictionary], np.int64)
            lens = np.asarray([l for _, l in dictionary], np.int64)
            tot = int(lens.sum())
            ramp = np.arange(tot) - np.repeat(
                np.cumsum(lens) - lens, lens
            )
            lit_coder.encode_array(
                text[np.repeat(offs, lens) + ramp], literal_r
            )
        # start string: interleaved (flag, literal | rule-id) events,
        # assembled as one token stream for bit/huff literal coders
        dict_r = Range(len(dictionary))
        fast = self._encode_start_fast(
            text, occurrences, lit_coder, dict_r
        )
        if not fast:
            pos = 0
            for start, rule_id, length in occurrences:
                while pos < start:
                    lit_coder.encode(0, bit_r)
                    lit_coder.encode(int(text[pos]), literal_r)
                    pos += 1
                lit_coder.encode(1, bit_r)
                lit_coder.encode(rule_id, dict_r)
                pos += length
            while pos < text.size:
                lit_coder.encode(0, bit_r)
                lit_coder.encode(int(text[pos]), literal_r)
                pos += 1
        lit_coder.finish()
        return out.getvalue()

    @staticmethod
    def _encode_start_fast(text, occurrences, lit_coder, dict_r) -> bool:
        """Vectorized start-string emission for bit/huff literal
        coders (per-event Python encode calls dominate otherwise)."""
        if isinstance(lit_coder, HuffmanCoder.Encoder):
            table = lit_coder.table
            if table is None:
                lit_code = np.arange(256, dtype=np.uint64)
                lit_len = np.full(256, 8, np.int64)
            else:
                lit_code = np.asarray(table.sym_code, np.uint64)
                lit_len = np.asarray(table.sym_len, np.int64)
        elif isinstance(lit_coder, BitCoder.Encoder):
            lit_code = np.arange(256, dtype=np.uint64)
            lit_len = np.full(256, 8, np.int64)
        else:
            return False
        n = text.size
        covered = np.zeros(n, bool)
        if occurrences:
            occ = np.asarray(occurrences, np.int64)
            starts, ids, lens = occ[:, 0], occ[:, 1], occ[:, 2]
            tot = int(lens.sum())
            ramp = np.arange(tot) - np.repeat(np.cumsum(lens) - lens,
                                              lens)
            covered[np.repeat(starts, lens) + ramp] = True
        else:
            starts = ids = np.zeros(0, np.int64)
        lit_pos = np.flatnonzero(~covered)
        chars = text[lit_pos]
        w_id = dict_r.bits
        # two tokens per event; merge literal/rule events by position
        ev_pos = np.concatenate([lit_pos, starts])
        order = np.argsort(ev_pos, kind="stable")
        nev = ev_pos.size
        tv = np.empty(2 * nev, np.uint64)
        tl = np.empty(2 * nev, np.int64)
        flags = np.concatenate([
            np.zeros(lit_pos.size, np.uint64),
            np.ones(starts.size, np.uint64),
        ])[order]
        vals = np.concatenate([
            lit_code[chars],
            ids.astype(np.uint64),
        ])[order]
        lens_tok = np.concatenate([
            lit_len[chars],
            np.full(starts.size, w_id, np.int64),
        ])[order]
        tv[0::2] = flags
        tl[0::2] = 1
        tv[1::2] = vals
        tl[1::2] = lens_tok
        lit_coder.out.write_tokens(tv, tl)
        return True

    def decode(self, data: bytes) -> bytes:
        inp = BitReader(data)
        lit_env = self.env.env_for_option("lfs_lit_coder")
        lit_dec = lit_env.cls.Decoder(lit_env, inp)
        len_env = self.env.env_for_option("lfs_len_coder")
        len_dec = len_env.cls.Decoder(len_env, inp)

        symbol_length = len_dec.decode(UINT32_R)
        s_length_r = Range(symbol_length)
        dict_lengths = [symbol_length]
        while symbol_length > 0:
            delta = len_dec.decode(s_length_r)
            symbol_length -= delta
            dict_lengths.append(symbol_length)
        dict_lengths.pop()
        dict_r = Range(len(dict_lengths))

        fast = self._decode_fast(lit_dec, dict_lengths, dict_r)
        if fast is not None:
            return fast

        dictionary = []
        for length in dict_lengths:
            dictionary.append(
                bytes(lit_dec.decode(literal_r) for _ in range(length))
            )
        out = bytearray()
        while not lit_dec.eof():
            if lit_dec.decode(bit_r):
                out += dictionary[lit_dec.decode(dict_r)]
            else:
                out.append(lit_dec.decode(literal_r))
        return bytes(out)

    @staticmethod
    def _decode_fast(lit_dec, dict_lengths, dict_r):
        """Host rule-string + start-string walk
        (``tdc_lfs_start_decode``) for bit/huff literal coders."""
        return EncodeStrategy._decode_fast_with(
            lit_dec, dict_lengths, dict_r, "lfs_start_decode"
        )

    @staticmethod
    def _decode_fast_with(lit_dec, dict_lengths, dict_r, fn_name):
        if isinstance(lit_dec, HuffmanCoder.Decoder):
            if lit_dec.table is not None:
                try:
                    lut_sym, lut_len = lit_dec.table.build_lut()
                except ValueError:
                    return None
                lut = (lut_sym, lut_len, lit_dec.table.longest)
            else:
                lut = None
        elif isinstance(lit_dec, BitCoder.Decoder):
            lut = None
        else:
            return None
        rd = lit_dec.inp
        got = getattr(native, fn_name)(
            np.packbits(rd._bits), rd.total, rd.pos, lut, dict_r.bits,
            np.asarray(dict_lengths, np.int64),
        )
        rd.pos = rd.total
        return got


class LFSCompressor(Compressor):
    @classmethod
    def meta(cls):
        m = Meta("compressor", "lfs_comp", "LFS compression scheme")
        m.option_submeta("computing_strat", "lfs_comp", default="esa")
        m.option_submeta(
            "coding_strat", "lfs_comp_enc", default="lfs_encode_strat"
        )
        m.needs_sentinel_terminator()
        return m

    def compress(self, data: bytes) -> bytes:
        text = np.frombuffer(data, np.uint8)
        if text.size > 1:
            strat = self.env.instantiate("computing_strat")
            dictionary, occurrences = strat.compute_rules(data)
        else:
            dictionary, occurrences = [], []
        coding = self.env.instantiate("coding_strat")
        return coding.encode(text, dictionary, occurrences)

    def decompress(self, data: bytes) -> bytes:
        coding = self.env.instantiate("coding_strat")
        return coding.decode(data)


class LFS2Compressor(Compressor):
    """Two-layer longest-first substitution (reference
    ``lfs/LFS2Compressor.hpp:36-330``): suffix-tree nodes processed by
    string depth descending; occurrences substitute either in the text
    (first layer) or *inside an earlier rule's definition* (second
    layer), so rules nest. The parse runs in the host kernel
    ``tdc_lfs2_parse`` over our SA/LCP lcp-interval sweep (the reference
    uses sdsl's cst; tie order between equal-depth nodes differs, the
    algorithm is the same). Wire format mirrors the reference: gamma
    delta-chained rule lengths closed by a zero, rules encoded backward
    (refs always point to higher ids), then the start symbol — both as
    (flag bit, ref | literal) token streams under the huffman/gamma
    coder pair."""

    @classmethod
    def meta(cls):
        m = Meta("compressor", "lfs2", "LFS2 compression scheme")
        m.option_submeta(
            "lfs2_lit_coder", "coder", default="huff",
            accepts=("ascii", "bit", "huff"),
        )
        m.option_submeta(
            "lfs2_len_coder", "coder", default="gamma",
            accepts=UNIVERSAL_CODER_NAMES,
        )
        m.option_dynamic("min_lrf", 5)
        m.needs_sentinel_terminator()
        return m

    def _parse(self, data: bytes, min_lrf: int):
        n = len(data) - 1  # strip the appended sentinel
        ds = TextDS(data)
        return native.lfs2_parse(
            ds.require_sa(), ds.require_lcp(), n, min_lrf
        )

    def compress(self, data: bytes) -> bytes:
        text = np.frombuffer(data, np.uint8)
        min_lrf = self.env.option("min_lrf").as_int()
        n = text.size - 1
        if n >= min_lrf:
            fl_nts, fl_off, sl_nts, nts_start, nts_len = self._parse(
                data, min_lrf
            )
        else:
            fl_nts = np.zeros(max(n, 0), np.uint32)
            fl_off = np.zeros(max(n, 0), np.uint32)
            sl_nts = np.zeros(max(n, 0), np.uint32)
            nts_start = np.zeros(0, np.int64)
            nts_len = np.zeros(0, np.int64)
        count = nts_start.size

        # literal pre-pass for the huffman table: unsubstituted text
        # positions (incl. the sentinel, which is always a literal) +
        # unsubstituted rule-definition positions
        full_mask = np.ones(text.size, bool)
        full_mask[:n] = fl_off[:n] == 0
        lit1 = text[full_mask]
        dict_lit = []
        for k in range(count):
            s, ln = int(nts_start[k]), int(nts_len[k])
            seg = text[s : s + ln]
            dict_lit.append(seg[sl_nts[s : s + ln] == 0])
        literals = np.concatenate([lit1] + dict_lit) if n else lit1

        out = BitWriter()
        lit_env = self.env.env_for_option("lfs2_lit_coder")
        lit_coder = lit_env.cls.Encoder(
            lit_env, out, Literals(literals, np.arange(literals.size))
        )
        len_env = self.env.env_for_option("lfs2_len_coder")
        len_coder = len_env.cls.Encoder(len_env, out, Literals())

        if count:
            first_len = int(nts_len[0])
            s_length_r = Range(first_len)
            len_coder.encode(first_len, UINT32_R)
            last = first_len
            for k in range(1, count):
                len_coder.encode(last - int(nts_len[k]), s_length_r)
                last = int(nts_len[k])
            len_coder.encode(last, s_length_r)
        else:
            len_coder.encode(0, UINT32_R)

        dict_r = Range(count)
        sl_list = sl_nts.tolist()
        fl_list = fl_nts.tolist()
        # rules, backward (refs point to higher ids)
        for k in range(count - 1, -1, -1):
            s, ln = int(nts_start[k]), int(nts_len[k])
            pos = s
            while pos < s + ln:
                ref = sl_list[pos]
                if ref > 0:
                    lit_coder.encode(1, bit_r)
                    lit_coder.encode(ref, dict_r)
                    pos += int(nts_len[ref - 1])
                else:
                    lit_coder.encode(0, bit_r)
                    lit_coder.encode(int(text[pos]), literal_r)
                    pos += 1
        # start symbol (runs to text.size: the sentinel is a literal)
        pos = 0
        while pos < text.size:
            ref = fl_list[pos] if pos < n else 0
            if ref > 0:
                lit_coder.encode(1, bit_r)
                lit_coder.encode(ref, dict_r)
                pos += int(nts_len[ref - 1])
            else:
                lit_coder.encode(0, bit_r)
                lit_coder.encode(int(text[pos]), literal_r)
                pos += 1
        lit_coder.finish()
        return out.getvalue()

    def decompress(self, data: bytes) -> bytes:
        inp = BitReader(data)
        lit_env = self.env.env_for_option("lfs2_lit_coder")
        lit_dec = lit_env.cls.Decoder(lit_env, inp)
        len_env = self.env.env_for_option("lfs2_len_coder")
        len_dec = len_env.cls.Decoder(len_env, inp)

        symbol_length = len_dec.decode(UINT32_R)
        s_length_r = Range(symbol_length)
        dict_lengths = [symbol_length]
        while symbol_length > 0:
            symbol_length -= len_dec.decode(s_length_r)
            dict_lengths.append(symbol_length)
        dict_lengths.pop()
        count = len(dict_lengths)
        dict_r = Range(count)
        fast = EncodeStrategy._decode_fast_with(
            lit_dec, dict_lengths, dict_r, "lfs2_decode"
        )
        if fast is not None:
            return fast
        rules: list[bytes] = [b""] * count
        for k in range(count - 1, -1, -1):
            size_cur = dict_lengths[k]
            parts = []
            while size_cur > 0:
                if lit_dec.decode(bit_r):
                    ref = lit_dec.decode(dict_r) - 1
                    parts.append(rules[ref])
                    size_cur -= dict_lengths[ref]
                else:
                    parts.append(bytes([lit_dec.decode(literal_r)]))
                    size_cur -= 1
            rules[k] = b"".join(parts)
        out = bytearray()
        while not lit_dec.eof():
            if lit_dec.decode(bit_r):
                out += rules[lit_dec.decode(dict_r) - 1]
            else:
                out.append(lit_dec.decode(literal_r))
        return bytes(out)


class LFS2BSTCompressor(LFS2Compressor):
    """Reference ``lfs/LFS2BSTCompressor.hpp``: the same two-layer
    algorithm over a binary suffix tree — our lcp-interval sweep serves
    both, so this registers the name with identical semantics."""

    @classmethod
    def meta(cls):
        m = Meta("compressor", "lfs2bst", "LFS2 with binary suffix tree")
        m.option_submeta(
            "lfs2_lit_coder", "coder", default="huff",
            accepts=("ascii", "bit", "huff"),
        )
        m.option_submeta(
            "lfs2_len_coder", "coder", default="gamma",
            accepts=UNIVERSAL_CODER_NAMES,
        )
        m.option_dynamic("min_lrf", 5)
        m.needs_sentinel_terminator()
        return m


for _cls in (ESAStrategy, STStrategy, SimSTStrategy, BSTStrategy,
             EncodeStrategy, LFSCompressor, LFS2Compressor,
             LFS2BSTCompressor):
    REGISTRY.register(_cls)
