"""Re-Pair grammar compression.

The port's copy of ``tudocomp_tpu/compressors/repair.py``, with the same
options, header and bytes: the grammar comes from the host library
(``csrc/host/repair.cpp``), or from the numpy rounds below where the
JAX package takes them too (inputs of 2^31 bytes and more, a rule
overflow); the stream decodes in the host library.

Reference: ``compressors/RePairCompressor.hpp:96-340``. Each round
replaces the most frequent digram with a fresh non-terminal; the wire
format is: ``len_r(num_rules)``, then per rule two symbols (bit flag:
0 = 8-bit terminal, 1 = rule id in ``Range(i)``), then the start rule's
symbols with rule ids in ``Range(num_rules)``.

Re-derivation notes (array program, not a pointer-list translation):
- each round works on a *compacted* symbol array: digram counting is a
  vectorized ``np.unique`` over ``left << 32 | right`` pairs,
- replacement takes the greedy leftmost non-overlapping occurrence set
  (every other index within consecutive-match runs) — the same result
  as the reference's sequential next-pointer walk,
- ties on the max count break by smallest digram value (the reference's
  tie-break is scan-order-dependent, i.e. implementation-defined).
"""

from __future__ import annotations

import numpy as np

from tudocomp_tpu_torch import native
from tudocomp_tpu_torch.coders import (
    NON_CONSUMING_CODER_NAMES,
    native_code_kind,
)
from tudocomp_tpu_torch.coders.base import Literals
from tudocomp_tpu_torch.coders.huffman import HuffmanCoder
from tudocomp_tpu_torch.coders.simple import BitCoder
from tudocomp_tpu_torch.compressors.base import Compressor
from tudocomp_tpu_torch.compressors.lzss import _literal_tokens
from tudocomp_tpu_torch.io.bitio import BitReader, BitWriter
from tudocomp_tpu_torch.meta import Meta
from tudocomp_tpu_torch.ranges import Range, bit_r, len_r, literal_r
from tudocomp_tpu_torch.utils.bits import bits_for, bits_for_arr

SIGMA = 256


def repair_grammar(text: np.ndarray, max_rules: int):
    """Returns (start: int64[], rules: list[(left, right)]).

    Fast path: the host near-linear kernel (``tdc_repair``,
    occurrence lists + lazy max-heap). Fallback, where that returns no
    grammar (2^31 bytes and more, a rule overflow): the vectorized
    round-rescan below. Tie-breaking between equal-count digrams
    differs (host: insertion order; numpy: smallest digram value) —
    both are valid greedy Re-Pair grammars, the wire format is
    self-describing either way."""
    got = native.repair(text, max_rules)
    if got is not None:
        return got
    arr = text.astype(np.int64)
    rules: list[tuple[int, int]] = []
    while len(rules) < max_rules and arr.size >= 2:
        pairs = (arr[:-1] << 32) | arr[1:]
        uniq, counts = np.unique(pairs, return_counts=True)
        best = int(counts.argmax())
        if counts[best] < 2:
            break
        # ties: np.unique is sorted, argmax returns the smallest digram
        target = uniq[best]
        matches = np.flatnonzero(pairs == target)
        # greedy leftmost non-overlapping: in each run of consecutive
        # match indices, take every other one
        run_start = np.concatenate(
            [[0], np.cumsum(np.diff(matches) > 1)]
        ) if matches.size else np.zeros(0, np.int64)
        first_of_run = np.zeros(matches.size, np.int64)
        if matches.size:
            starts = np.flatnonzero(
                np.concatenate([[True], np.diff(matches) > 1])
            )
            first_of_run = matches[starts][run_start]
        take = matches[((matches - first_of_run) % 2) == 0]
        if take.size == 0:
            break
        new_sym = SIGMA + len(rules)
        rules.append((int(target >> 32), int(target & 0xFFFFFFFF)))
        arr[take] = new_sym
        keep = np.ones(arr.size, bool)
        keep[take + 1] = False
        arr = arr[keep]
    return arr, rules


class RePairCompressor(Compressor):
    @classmethod
    def meta(cls):
        m = Meta("compressor", "repair", "Re-Pair compression")
        m.option_submeta(
            "coder", "coder", default="bit",
            accepts=NON_CONSUMING_CODER_NAMES,
        )
        m.option_dynamic("max_rules", 0)
        return m

    def compress(self, data: bytes) -> bytes:
        text = np.frombuffer(data, np.uint8)
        max_rules = self.env.option("max_rules").as_int() or (1 << 62)
        start, rules = repair_grammar(text, max_rules)
        # literals: terminals left in the start rule + rule terminals
        rule_syms = np.array(
            [s for lr in rules for s in lr], np.int64
        )
        lit_vals = np.concatenate(
            [
                start[start < SIGMA],
                rule_syms[rule_syms < SIGMA] if rule_syms.size else
                np.zeros(0, np.int64),
            ]
        ).astype(np.uint8)
        out = BitWriter()
        coder = self.coder_encoder(
            out, Literals(lit_vals, np.arange(lit_vals.size))
        )

        def encode_sym(x: int, r: Range) -> None:
            if x < SIGMA:
                coder.encode(0, bit_r)
                coder.encode(x, literal_r)
            else:
                coder.encode(1, bit_r)
                coder.encode(x - SIGMA, r)

        coder.encode(len(rules), len_r)
        if self._encode_bulk(coder, out, rules, start):
            return out.getvalue()
        for i, (left, right) in enumerate(rules):
            r = Range(i)
            encode_sym(left, r)
            encode_sym(right, r)
        grammar_r = Range(len(rules))
        for x in start.tolist():
            encode_sym(x, grammar_r)
        coder.finish()
        return out.getvalue()

    @staticmethod
    def _encode_bulk(coder, out, rules, start) -> bool:
        """One write_tokens call for the whole rule+start stream
        (bit / huffman coders: binary non-literal fields). Bit-exact
        with the scalar loop."""
        if not isinstance(
            coder, (BitCoder.Encoder, HuffmanCoder.Encoder)
        ):
            return False
        nr = len(rules)
        rsyms = (
            np.array(rules, np.int64).reshape(-1)
            if nr else np.zeros(0, np.int64)
        )
        widths = np.concatenate([
            np.repeat(bits_for_arr(np.arange(max(nr, 1))[:nr]), 2)
            .astype(np.int64),
            np.full(start.size, bits_for(nr), np.int64),
        ])
        syms = np.concatenate([rsyms, start.astype(np.int64)])
        is_rule = syms >= SIGMA
        values = np.zeros(2 * syms.size, np.uint64)
        lens = np.zeros(2 * syms.size, np.int64)
        values[0::2] = is_rule
        lens[0::2] = 1
        values[1::2] = np.where(is_rule, syms - SIGMA, 0)
        lens[1::2] = np.where(is_rule, widths, 0)
        if (~is_rule).any():
            lv, ll = _literal_tokens(
                coder, syms[~is_rule].astype(np.uint8)
            )
            lit_slots = 2 * np.flatnonzero(~is_rule) + 1
            values[lit_slots] = lv
            lens[lit_slots] = ll
        out.write_tokens(values, lens)
        coder.finish()
        return True

    def decompress(self, data: bytes) -> bytes:
        reader = BitReader(data)
        decoder = self.coder_decoder(reader)
        lut = None
        if isinstance(decoder, HuffmanCoder.Decoder) \
                and decoder.table is not None:
            lut_sym, lut_len = decoder.table.build_lut()
            lut = (lut_sym, lut_len, decoder.table.longest)
        got = native.repair_decode(
            np.packbits(reader._bits), reader.total, reader.pos,
            lut, out_hint=16 * len(data),
            code_kind=native_code_kind(decoder) or 0,
        )
        reader.pos = reader.total
        return got
