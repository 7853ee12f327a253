"""ESP: grammar compression by Edit-Sensitive Parsing.

Copy of ``tudocomp_tpu/compressors/esp.py`` for the port, with the same
options, defaults, headers and bytes. ``rounds=host`` runs the port's
host library (``csrc/host/esp.cpp``); the Python round loop below
(``esp_rounds_loop``) runs where that library returns no grammar (a
full rule buffer, ``n >= 2**31``) and is what the ``ipd`` dictionaries
drive. ``rounds=device`` runs ``ops/esp.py`` on the ``Env``'s torch
device. SLP derivation and the dependency sort run in the host library
alone (no Python loop stands behind them).

Reference: ``compressors/EspCompressor.hpp`` + ``compressors/esp/``
(round loop ``EspContextImpl.hpp:14-165``, metablocks
``meta_blocks.hpp:34-187``, alphabet reduction labels ``esp_math.hpp``,
landmark spanner ``landmarks.hpp:29-80``, 1-block merging
``BlockAdjust.hpp``, grammar dedup ``GrammarRules.hpp:16-80``, output
format ``PlainSLPCoder.hpp``).

Each round splits the current symbol string into *metablocks*:

- type 1: maximal runs of >= 2 equal symbols — split eagerly 3,3,...,
  with remainder 4 -> 2+2;
- type 2: the remaining segments — an ``iter_log(alphabet)``-length
  prefix is split like type 1 (as "type 3"), the suffix goes through
  iterated alphabet reduction (XOR-ctz labels) down to alphabet <= 3,
  landmark marking (local maxima, then isolated local minima) and
  landmark-spanned 2/3-blocks with ties to the right.

Blocks of length 1 (possible at segment edges) merge with a neighbor
(2/3; 4 -> 2+2). Every block becomes a deduplicated binary SLP rule
(3-blocks as two rules); rounds repeat on the rule-id string until one
symbol remains. All round computations here are vectorized numpy — the
per-round work is elementwise/stencil over the round string, which is
also the device formulation (SURVEY.md §7 step 7).

Wire format = reference ``PlainSLPCoder``: 6-bit rule bit width, root
rule id, then (left, right) pairs at that width. Terminals are 0..255,
rules start at 256.
"""

from __future__ import annotations

import numpy as np

from tudocomp_tpu_torch import native
from tudocomp_tpu_torch.compressors.base import Compressor
from tudocomp_tpu_torch.io.bitio import BitReader, BitWriter
from tudocomp_tpu_torch.meta import Algorithm, Meta
from tudocomp_tpu_torch.stats import StatPhase
from tudocomp_tpu_torch.utils.bits import bits_for


def iter_log(n: int) -> int:
    """Reference ``esp_math.hpp:iter_log`` (paper-tuned log*)."""
    if n < 7:
        return 0
    if n < 9:
        return 1
    if n < 17:
        return 2
    if n < 257:
        return 3
    return 4


def _label(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """Alphabet-reduction label: 2*ctz(l^r) + bit(ctz, r)."""
    diff = left ^ right
    # ctz via bit tricks (diff != 0 guaranteed: neighbors differ)
    ctz = np.zeros(diff.shape, np.int64)
    d = diff.copy()
    for shift in (32, 16, 8, 4, 2, 1):
        mask = (d & ((np.int64(1) << shift) - 1)) == 0
        ctz += np.where(mask, shift, 0)
        d = np.where(mask, d >> shift, d)
    bit = (right >> ctz) & 1
    return 2 * ctz + bit


def _split_eager13(length: int) -> list[int]:
    """3,3,...,remainder split (reference ``eager_mb13``)."""
    out = []
    rest = length
    while rest > 4:
        out.append(3)
        rest -= 3
    if rest == 4:
        out += [2, 2]
    elif rest:
        out.append(rest)  # 3, 2 or 1
    return out


def _landmark_blocks(seg: np.ndarray, tie_to_right: bool = True) -> list[int]:
    """2/3-block lengths for a type-2 suffix via alphabet reduction +
    landmarks. ``seg`` values are the *reduced* labels (alphabet <= 3,
    no adjacent equal)."""
    m = seg.size
    if m == 1:
        return [1]
    left = np.concatenate([[np.int64(-1)], seg[:-1]])
    right = np.concatenate([seg[1:], [np.int64(-1)]])
    high = (seg > left) & (seg > right)
    lowleft = np.concatenate([[np.int64(4)], seg[:-1]])
    lowright = np.concatenate([seg[1:], [np.int64(4)]])
    low = (seg < lowleft) & (seg < lowright)
    landmarks = high.copy()
    # isolated local minima become landmarks too
    lm_left = np.concatenate([[False], landmarks[:-1]])
    lm_right = np.concatenate([landmarks[1:], [False]])
    landmarks |= low & ~lm_left & ~lm_right
    # landmark spanner (reference ``landmark_spanner``): each landmark
    # spans [i-1, i+1] clipped; adjacent overlaps resolve by the tie rule;
    # continuity is enforced (every position belongs to some block) and
    # any over-long span re-splits eagerly.
    idx = np.flatnonzero(landmarks).tolist()
    if not idx:
        return _split_eager13(m)
    spans = []
    for i in idx:
        l = i - 1 if i > 0 else i
        r = i + 1 if i < m - 1 else i
        if spans:
            if l == spans[-1][1]:  # overlap with previous span
                if tie_to_right:
                    spans[-1][1] -= 1
                else:
                    l += 1
            l = spans[-1][1] + 1  # force continuity over gaps
            if l > r:
                continue
        else:
            l = 0
        spans.append([l, r])
    spans[-1][1] = m - 1
    blocks: list[int] = []
    for l, r in spans:
        blocks.extend(_split_eager13(r - l + 1))
    return blocks


def _reduce_alphabet(seg: np.ndarray, passes: int) -> np.ndarray:
    """Iterated label reduction, then 6 -> 3 neighbor-avoiding remap."""
    buf = seg.astype(np.int64)
    for _ in range(passes):
        buf = _label(buf[:-1], buf[1:])
    # reduce alphabet {0..5} to {0..2}: replace 3,4,5 by the smallest
    # value not equal to either neighbor (sequential small loop per value)
    for to_replace in (3, 4, 5):
        hits = np.flatnonzero(buf == to_replace)
        for i in hits.tolist():
            e = 0
            neigh = []
            if i > 0:
                neigh.append(buf[i - 1])
            if i < buf.size - 1:
                neigh.append(buf[i + 1])
            for n in neigh:
                if n == e:
                    e += 1
            for n in neigh:
                if n == e:
                    e += 1
            buf[i] = e
    return buf


def _merge_one_blocks(blocks: list[list[int]]) -> list[int]:
    """Merge length-1 blocks with a neighbor so all are 2/3
    (behavioral equivalent of reference ``BlockAdjust.hpp``: 1+1 -> 2,
    1+2 -> 3, 1+3 -> 2+2)."""
    out: list[int] = []
    for length, _type in blocks:
        out.append(length)
        while len(out) >= 2 and (out[-1] == 1 or out[-2] == 1):
            b = out.pop()
            a = out.pop()
            total = a + b
            if total == 4:
                out.extend([2, 2])
            else:
                out.append(total)
    # a sole length-1 block only happens for round strings of length 1,
    # which the round loop terminates on before splitting
    return out


def esp_rounds(data: bytes, ipd=None):
    """Run ESP to completion. Returns (rules: int64[R,2], root, empty).

    The host library's ``tdc_esp_rounds`` (a bit-identical mirror of
    ``esp_rounds_loop``, with its own open-addressing pair table) builds
    the grammar; where it returns none, ``esp_rounds_loop`` runs with
    the pair dictionary ``ipd`` (reference ``ipd=`` option; every
    dictionary produces the identical grammar)."""
    if len(data) > 0:
        got = native.esp_rounds(data)
        if got is not None:
            rules, root = got
            return rules, root, False
    return esp_rounds_loop(data, ipd)


def esp_rounds_loop(data: bytes, ipd=None):
    """The round loop in Python over the pair dictionary ``ipd``
    (``std_unordered_map`` by default): (rules, root, empty)."""
    if ipd is None:
        from tudocomp_tpu_torch.registry import create_algo

        ipd = create_algo(StdUnorderedMapIPD)
    lookup, store = ipd.make()
    s = np.frombuffer(data, np.uint8).astype(np.int64)
    rule_list: list[tuple[int, int]] = []

    def rule_id(a: int, b: int) -> int:
        key = (a, b)
        rid = lookup(key)
        if rid is None:
            rid = 256 + len(rule_list)
            store(key, rid)
            rule_list.append(key)
        return rid

    alphabet = 256
    if s.size == 0:
        return np.zeros((0, 2), np.int64), 0, True
    while s.size > 1:
        # -- metablock classification -----------------------------------
        boundary = np.concatenate([[True], s[1:] != s[:-1]])
        starts = np.flatnonzero(boundary)
        lens = np.diff(np.append(starts, s.size))
        blocks: list[list[int]] = []  # (len, type)
        i = 0
        r = 0
        while r < starts.size:
            if lens[r] >= 2:  # type 1: repeating run
                for L in _split_eager13(int(lens[r])):
                    blocks.append([L, 1])
                r += 1
            else:  # group consecutive length-1 runs: type 2 segment
                r2 = r
                while r2 < starts.size and lens[r2] == 1:
                    r2 += 1
                seg = s[starts[r] : starts[r2 - 1] + 1]
                p = min(iter_log(alphabet), seg.size)
                for L in _split_eager13(p):
                    blocks.append([L, 3])
                if p < seg.size:
                    reduced = _reduce_alphabet(seg, p)
                    for L in _landmark_blocks(reduced):
                        blocks.append([L, 2])
                r = r2
        lens_adj = _merge_one_blocks(blocks)
        # -- blocks -> rules -------------------------------------------
        new_syms = []
        pos = 0
        for L in lens_adj:
            if L == 2:
                new_syms.append(rule_id(int(s[pos]), int(s[pos + 1])))
            else:
                inner = rule_id(int(s[pos]), int(s[pos + 1]))
                new_syms.append(rule_id(inner, int(s[pos + 2])))
            pos += L
        assert pos == s.size, (pos, s.size)
        alphabet = 256 + len(rule_list)
        s = np.asarray(new_syms, np.int64)
    root = int(s[0])
    return np.asarray(rule_list, np.int64).reshape(-1, 2), root, False


def derive_text(rules: np.ndarray, root: int, empty: bool) -> bytes:
    if empty:
        return b""
    return native.slp_derive(np.asarray(rules, np.int64), int(root))


class PlainSLPCoder(Algorithm):
    """Reference ``esp/PlainSLPCoder.hpp`` format."""

    @classmethod
    def meta(cls):
        return Meta("slp_coder", "plain", "Plain SLP encoding")

    def encode(self, rules: np.ndarray, root: int, empty: bool) -> bytes:
        out = BitWriter()
        if empty:
            out.write_int(0, 6)
            return out.getvalue()
        max_val = rules.shape[0] + 256 - 1
        width = bits_for(max_val)
        out.write_int(width, 6)
        out.write_int(root, width)
        flat = rules.reshape(-1).astype(np.uint64)
        out.write_int_array(flat, width)
        return out.getvalue()

    def decode(self, data: bytes):
        inp = BitReader(data)
        width = inp.read_int(6)
        if width == 0:
            return np.zeros((0, 2), np.int64), 0, True
        root = inp.read_int(width)
        count = (inp.total - inp.pos) // (2 * width)
        flat = inp.read_int_array(width, 2 * count).astype(np.int64)
        return flat.reshape(-1, 2), root, False


class DPlain(Algorithm):
    """RHS coded as fixed-width ints (reference ``DRCoder.hpp:66``)."""

    @classmethod
    def meta(cls):
        return Meta("d_coding", "plain", "Plain fixed-width D coding")

    def encode(self, rhs: np.ndarray, out: BitWriter, width: int) -> None:
        out.write_int_array(rhs.astype(np.uint64), width)

    def decode(self, inp: BitReader, width: int, count: int) -> np.ndarray:
        return inp.read_int_array(width, count).astype(np.int64)


class DDiff(Algorithm):
    """RHS coded as signed unary deltas (reference ``DRCoder.hpp:485``
    ``encode_unary_diff`` behavior re-specified: sign bit + gamma)."""

    @classmethod
    def meta(cls):
        return Meta("d_coding", "diff", "Unary-diff D coding")

    def encode(self, rhs: np.ndarray, out: BitWriter, width: int) -> None:
        last = 0
        for v in rhs.tolist():
            d = v - last
            out.write_bit(1 if d < 0 else 0)
            out.write_elias_gamma(abs(d) + 1)
            last = v

    def decode(self, inp: BitReader, width: int, count: int) -> np.ndarray:
        vals = np.zeros(count, np.int64)
        last = 0
        for i in range(count):
            neg = inp.read_bit()
            mag = inp.read_elias_gamma() - 1
            last = last - mag if neg else last + mag
            vals[i] = last
        return vals


def slp_dep_sort(rules: np.ndarray, root: int):
    """Renumber rules so left-hand children are non-decreasing
    (reference ``SLPDepSort.hpp``; the permutation differs, the decoded
    grammar is identical).

    The host library's single-pass construction: a min-heap keyed by
    each rule's *new* left-child id, ties by old id. A popped key is
    always <= every later insertion (a newly assigned rule inserts key
    ``256 + assignment_index``, which exceeds any key popped so far), so
    assignment order = sorted lhs. Raises ``ValueError`` on a cycle.
    """
    r = np.asarray(rules, np.int64)
    if r.shape[0] == 0:
        return r.copy(), root
    return native.slp_dep_sort(r, root)


class SortedSLPCoder(Algorithm):
    """Dependency-sorted SLP encoding (reference
    ``esp/SortedSLPCoder.hpp``): after dep-sorting, left children are
    non-decreasing and code as unary deltas; right children go through
    the pluggable ``d_coding``. Header mirrors the reference (6-bit
    width, max value, root)."""

    @classmethod
    def meta(cls):
        m = Meta("slp_coder", "sorted", "Dependency-sorted SLP encoding")
        # reference default: DMonotonSubseq (esp/SortedSLPCoder.hpp:9)
        m.option_submeta("d_coding", "d_coding", default="succinct")
        return m

    def encode(self, rules: np.ndarray, root: int, empty: bool) -> bytes:
        out = BitWriter()
        if empty:
            out.write_int(0, 6)
            return out.getvalue()
        rules, root = slp_dep_sort(np.asarray(rules, np.int64), root)
        max_val = rules.shape[0] + 256 - 1
        width = bits_for(max_val)
        out.write_int(width, 6)
        out.write_int(max_val, width)
        out.write_int(root, width)
        if root < 256:
            return out.getvalue()
        # left children: non-decreasing -> unary deltas from 0
        lhs = rules[:, 0]
        deltas = np.diff(np.concatenate([[0], lhs]))
        out.write_unary_array(deltas.astype(np.uint64))
        d = self.env.instantiate("d_coding")
        d.encode(rules[:, 1], out, width)
        return out.getvalue()


    def decode(self, data: bytes):
        inp = BitReader(data)
        width = inp.read_int(6)
        if width == 0:
            return np.zeros((0, 2), np.int64), 0, True
        max_val = inp.read_int(width)
        root = inp.read_int(width)
        count = max_val - 256 + 1
        if root < 256 or count <= 0:
            return np.zeros((0, 2), np.int64), root, False
        lhs = np.cumsum(inp.read_unary_array(count))
        d = self.env.instantiate("d_coding")
        rhs = d.decode(inp, width, count)
        return np.stack([lhs, rhs], axis=1), root, False


class StdUnorderedMapIPD(Algorithm):
    """Library hash table pair dictionary (reference
    ``esp/StdUnorderedMapIPD.hpp`` = std::unordered_map; here the
    Python dict). The host library's round loop keeps its own
    open-addressing table; these dictionaries drive
    ``esp_rounds_loop``."""

    @classmethod
    def meta(cls):
        return Meta("ipd", "std_unordered_map", "Hash map pair dictionary")

    def make(self):
        table: dict[tuple[int, int], int] = {}
        return table.get, table.__setitem__


class HashMapIPD(Algorithm):
    """Open-addressing pair dictionary over the hash framework
    (reference ``esp/HashMapIPD.hpp``; ``utils/hash.py`` HashMap)."""

    @classmethod
    def meta(cls):
        return Meta("ipd", "hash_map", "Custom hash map pair dictionary")

    def make(self):
        from tudocomp_tpu_torch.utils.hash import HashMap

        m = HashMap()

        def lookup(key):
            return m.get((key[0] << 32) | key[1])

        def store(key, rid):
            m.insert((key[0] << 32) | key[1], rid)

        return lookup, store


class DynamicSizeIPD(Algorithm):
    """Bit-width-adaptive pair dictionary (reference
    ``esp/DynamicSizeIPD.hpp``): keys and values live in bit-packed
    ``IntVector`` storage at the minimal width for the current symbol
    range, re-packing to wider words as the grammar grows."""

    @classmethod
    def meta(cls):
        return Meta("ipd", "dynamic_size", "Bit-width-adaptive IPD")

    class _Table:
        def __init__(self):
            from tudocomp_tpu_torch.ds.int_vector import IntVector

            self._iv = IntVector
            self.sym_w = 9  # current symbol width (>= bits_for(256))
            self.cap = 64
            self.size = 0
            # keys stored +1 so packed 0 = empty slot
            self.keys = IntVector(
                np.zeros(self.cap, np.uint64), 2 * self.sym_w + 1
            )
            self.vals = IntVector(
                np.zeros(self.cap, np.uint64), self.sym_w
            )

        def _hash(self, k: int) -> int:
            k = (k ^ (k >> 30)) * 0xBF58476D1CE4E5B9 & (2**64 - 1)
            k = (k ^ (k >> 27)) * 0x94D049BB133111EB & (2**64 - 1)
            return (k ^ (k >> 31)) % self.cap

        def _pack(self, a: int, b: int) -> int:
            return ((a << self.sym_w) | b) + 1

        def _regrow(self, sym_w=None, cap=None):
            old_keys = self.keys.as_array()
            old_vals = self.vals.as_array()
            live = old_keys != 0
            w = self.sym_w
            ab = old_keys[live] - 1
            pairs = [
                (int(k) >> w, int(k) & ((1 << w) - 1))
                for k in ab.tolist()
            ]
            rids = old_vals[live].tolist()
            self.sym_w = sym_w or self.sym_w
            self.cap = cap or self.cap
            self.keys = self._iv(
                np.zeros(self.cap, np.uint64), 2 * self.sym_w + 1
            )
            self.vals = self._iv(
                np.zeros(self.cap, np.uint64), self.sym_w
            )
            self.size = 0
            for (a, b), r in zip(pairs, rids):
                self.store((a, b), int(r))

        def lookup(self, key):
            a, b = key
            if max(a, b) >> self.sym_w:
                return None  # symbol wider than any stored key
            k = self._pack(a, b)
            s = self._hash(k)
            while True:
                cur = int(self.keys[s])
                if cur == 0:
                    return None
                if cur == k:
                    return int(self.vals[s])
                s = (s + 1) % self.cap

        def store(self, key, rid):
            a, b = key
            need = max(
                self.sym_w,
                int(max(a, b, rid)).bit_length(),
            )
            if need > self.sym_w:
                self._regrow(sym_w=need)
            if (self.size + 1) * 2 > self.cap:
                self._regrow(cap=self.cap * 2)
            k = self._pack(a, b)
            s = self._hash(k)
            while int(self.keys[s]) != 0:
                if int(self.keys[s]) == k:
                    self.vals[s] = rid
                    return
                s = (s + 1) % self.cap
            self.keys[s] = k
            self.vals[s] = rid
            self.size += 1

    def make(self):
        t = self._Table()
        return t.lookup, t.store


class EspCompressor(Compressor):
    @classmethod
    def meta(cls):
        m = Meta("compressor", "esp", "ESP based grammar compression")
        # deliberate divergence: the reference defaults to the plain SLP
        # coder (EspCompressor.hpp:25). Measured on the 1 MiB suite
        # corpora (docs/BENCHMARKS.md), the dep-sorted coder with the
        # range_fit d_coding wins on every corpus (english 41%, dna 51%,
        # repetitive 2.6% vs plain-SLP 74%), so that is the default; the
        # reference's own sorted default (succinct) remains selectable.
        m.option_submeta(
            "slp_coder", "slp_coder", default="sorted(d_coding=range_fit)"
        )
        m.option_submeta("ipd", "ipd", default="std_unordered_map")
        # rounds=host: the host library's round loop (tdc_esp_rounds).
        # rounds=device: whole-round array passes on the Env's torch
        #   device (ops/esp.py) — grammar bit-identical to host, so the
        #   container format is unchanged.
        m.option_dynamic("rounds", "host")
        return m

    def compress(self, data: bytes) -> bytes:
        with StatPhase("ESP Algorithm"):
            if self.env.option("rounds").as_string() == "device":
                from tudocomp_tpu_torch.ops.esp import esp_rounds_device

                rules, root, empty = esp_rounds_device(
                    data, device=self.env.torch_device)
            else:
                rules, root, empty = esp_rounds(
                    data, ipd=self.env.instantiate("ipd")
                )
            StatPhase.log("SLP size", int(rules.shape[0]))
        coder = self.env.instantiate("slp_coder")
        return coder.encode(rules, root, empty)

    def decompress(self, data: bytes) -> bytes:
        coder = self.env.instantiate("slp_coder")
        rules, root, empty = coder.decode(data)
        return derive_text(rules, root, empty)


from tudocomp_tpu_torch.compressors.esp_dcoding import (  # noqa: E402
    DArithmetic,
    DHuffman,
    DMonotonSubseq,
    DRangeFit,
    DWaveletTree,
    SubSeqGreedy,
    SubSeqOptimal,
)

#: every class of the ESP family, registered by the ``compressors``
#: package
ESP_CLASSES = (PlainSLPCoder, SortedSLPCoder, DPlain, DDiff,
               DWaveletTree, DMonotonSubseq, DHuffman, DArithmetic,
               DRangeFit, SubSeqOptimal, SubSeqGreedy,
               StdUnorderedMapIPD, HashMapIPD, DynamicSizeIPD,
               EspCompressor)
