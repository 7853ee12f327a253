"""LZ78U: LZ78 factorization over the suffix tree (SEA'17).

The port's copy of ``tudocomp_tpu/compressors/lz78u.py``, with the same
options, header and bytes. Reference: ``compressors/LZ78UCompressor.hpp``
+ ``compressors/lz78u/``. One factor per freshly visited suffix-tree
node; a factor is ``(ref to parent factor, edge-label string)``. Labels
of length >= ``threshold`` are themselves sub-factorized against
already-assigned node factors (with 0-escaped cut values when a
sub-reference overshoots).

Strategies (``comp=``): ``streaming`` writes refs/separators/characters
as they are produced with two interleaved coders (ref coder + string
coder, 0-terminated label strings); ``buffering`` records the emission
stream and replays it at the end so the string coder can build a real
literal table (reference ``StreamingStrategy.hpp`` /
``BufferingStrategy.hpp``). Wire format matches the reference stream
structure exactly.

The suffix-tree walk and the stream decode run in the host library
(``csrc/host/lz78u.cpp``), which raises when it cannot be built: the
JAX package's Python walk and decode loop, which it takes only without
its library, have no copy here.
"""

from __future__ import annotations

import numpy as np

from tudocomp_tpu_torch import native
from tudocomp_tpu_torch.coders import (
    NON_CONSUMING_CODER_NAMES,
    UNIVERSAL_CODER_NAMES,
    native_code_kind,
)
from tudocomp_tpu_torch.coders.base import Literals
from tudocomp_tpu_torch.coders.huffman import HuffmanCoder
from tudocomp_tpu_torch.coders.simple import BitCoder
from tudocomp_tpu_torch.compressors.base import Compressor
from tudocomp_tpu_torch.compressors.lzss import _literal_tokens
from tudocomp_tpu_torch.ds.suffix_tree import SuffixTree
from tudocomp_tpu_torch.io.bitio import BitReader, BitWriter
from tudocomp_tpu_torch.meta import Algorithm, Meta
from tudocomp_tpu_torch.ranges import Range, len_r, literal_r
from tudocomp_tpu_torch.registry import REGISTRY
from tudocomp_tpu_torch.utils.bits import bits_for_arr


class StreamingStrategy(Algorithm):
    @classmethod
    def meta(cls):
        m = Meta("lz78u_strategy", "streaming", "Streaming LZ78U strategy")
        m.option_submeta(
            "string_coder", "coder", default="bit",
            accepts=UNIVERSAL_CODER_NAMES,
        )
        return m

    use_literals = False  # string coder gets no literals


class BufferingStrategy(Algorithm):
    @classmethod
    def meta(cls):
        m = Meta("lz78u_strategy", "buffering", "Buffering LZ78U strategy")
        m.option_submeta(
            "string_coder", "coder", default="bit",
            accepts=NON_CONSUMING_CODER_NAMES,
        )
        return m

    use_literals = True  # string coder gets the full literal pre-pass


class LZ78UCompressor(Compressor):
    @classmethod
    def meta(cls):
        m = Meta("compressor", "lz78u", "Lempel-Ziv 78 U")
        m.option_submeta("comp", "lz78u_strategy", default="buffering")
        m.option_submeta(
            "coder", "coder", accepts=UNIVERSAL_CODER_NAMES
        )
        m.option_dynamic("threshold", 3)
        m.needs_sentinel_terminator()
        m.escapes(0)
        return m

    # -- compression ---------------------------------------------------------

    def compress(self, data: bytes) -> bytes:
        threshold = self.env.option("threshold").as_int()
        st = SuffixTree(data)
        return self._encode_events(*native.lz78u_parse(
            st.parent, st.sdepth, st.is_leaf, st.leaf_of_rank, st.isa,
            np.frombuffer(data, np.uint8), threshold,
        ))

    def _encode_events(self, kind, value, aux) -> bytes:
        """Encode the host parse's event stream (kind 0 ref with its
        range's max in ``aux``, -1 for ``len_r``; 1 separator bit; 2
        char). For binary-field coders (bit / huffman) the whole stream
        is one vectorized write_tokens call; other coders replay the
        events scalar."""
        strategy = self.env.instantiate("comp")
        out = BitWriter()
        ref_env = self.env.env_for_option("coder")
        ref_coder = ref_env.cls.Encoder(ref_env, out, Literals())
        sc_env = strategy.env.env_for_option("string_coder")
        chars = value[kind == 2].astype(np.uint8)
        lits = (
            Literals(chars, np.arange(chars.size))
            if type(strategy).use_literals else Literals()
        )
        string_coder = sc_env.cls.Encoder(sc_env, out, lits)
        bulk = isinstance(
            ref_coder, (BitCoder.Encoder, HuffmanCoder.Encoder)
        ) and isinstance(
            string_coder, (BitCoder.Encoder, HuffmanCoder.Encoder)
        )
        if bulk:
            values = np.zeros(kind.size, np.uint64)
            lens = np.zeros(kind.size, np.int32)
            is_ref = kind == 0
            is_sep = kind == 1
            is_char = kind == 2
            values[is_ref] = value[is_ref].astype(np.uint64)
            ref_aux = aux[is_ref]
            lens[is_ref] = np.where(
                ref_aux >= 0,
                bits_for_arr(np.maximum(ref_aux, 0)).astype(np.int32),
                len_r.bits,
            )
            values[is_sep] = value[is_sep].astype(np.uint64)
            lens[is_sep] = 1
            cv, cl = _literal_tokens(string_coder, chars)
            values[is_char] = cv
            lens[is_char] = cl
            out.write_tokens(values, lens)
            return out.getvalue()
        for k_, v_, a_ in zip(
            kind.tolist(), value.tolist(), aux.tolist()
        ):
            if k_ == 0:
                ref_coder.encode(v_, Range(a_) if a_ >= 0 else len_r)
            elif k_ == 1:
                out.write_bit(v_)
            else:
                string_coder.encode(v_, literal_r)
        return out.getvalue()

    # -- decompression -------------------------------------------------------

    def decompress(self, data: bytes) -> bytes:
        strategy = self.env.instantiate("comp")
        inp = BitReader(data)
        ref_env = self.env.env_for_option("coder")
        ref_coder = ref_env.cls.Decoder(ref_env, inp)
        sc_env = strategy.env.env_for_option("string_coder")
        string_coder = sc_env.cls.Decoder(sc_env, inp)
        lut = None
        if isinstance(string_coder, HuffmanCoder.Decoder) \
                and string_coder.table is not None:
            lut_sym, lut_len = string_coder.table.build_lut()
            lut = (lut_sym, lut_len, string_coder.table.longest)
        got = native.lz78u_decode(
            np.packbits(inp._bits), inp.total, inp.pos, lut,
            out_hint=16 * len(data),
            ref_kind=native_code_kind(ref_coder) or 0,
            str_kind=native_code_kind(string_coder) or 0,
        )
        inp.pos = inp.total
        return got


for _cls in (StreamingStrategy, BufferingStrategy, LZ78UCompressor):
    REGISTRY.register(_cls)
