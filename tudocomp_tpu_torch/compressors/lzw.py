"""LZW compressor.

The port's copy of ``tudocomp_tpu/compressors/lzw.py``, with the same
options, header and bytes. Format matches the reference
``compressors/LZWCompressor.hpp``: the dictionary is pre-seeded with all
256 byte roots; each factor emits only ``ref in Range(factor_count +
256)`` (adaptive width). Decoding is the classic (prefix-code, last-char)
dictionary replay including the self-referential ``k == dict_size`` case
(``lzw/LZWDecoding.hpp:13-99``). ``dict_size`` (0 = unlimited) resets the
dictionary when reached, checked *before* reading each code, mirroring
the reference decode loop. As for ``lz78``, every trie gives one parse,
so parse, encode and decode run in the host library
(``csrc/host/lz78.cpp``) for every trie, coder and ``dict_size``.
"""

from __future__ import annotations

import numpy as np

from tudocomp_tpu_torch import native
from tudocomp_tpu_torch.coders import UNIVERSAL_CODER_NAMES, option_code_kind
from tudocomp_tpu_torch.compressors.base import Compressor
from tudocomp_tpu_torch.compressors.lz78 import (
    _lz78_compress_buffered, _lz78_compress_stream, _lz78_decompress_stream,
)
from tudocomp_tpu_torch.io.bitio import BitReader
from tudocomp_tpu_torch.meta import Meta


class LZWCompressor(Compressor):
    @classmethod
    def meta(cls):
        m = Meta("compressor", "lzw", "Lempel-Ziv-Welch")
        m.option_submeta(
            "coder", "coder", default="bit",
            accepts=UNIVERSAL_CODER_NAMES,
        )
        m.option_submeta("lz78trie", "lz78trie", default="ternary")
        m.option_dynamic("dict_size", 0)
        return m

    def compress(self, data: bytes) -> bytes:
        return _lz78_compress_buffered(self, data, lzw=True)

    def decompress(self, data: bytes) -> bytes:
        reader = BitReader(data)
        return native.lzw_stream_decode(
            np.packbits(reader._bits), reader.total, reader.pos,
            option_code_kind(self.env),
            self.env.option("dict_size").as_int() or (1 << 32),
        )

    supports_streaming = True

    def compress_stream(self, fin, fout) -> None:
        _lz78_compress_stream(self, fin, fout, lzw=True)

    def decompress_stream(self, fin, fout) -> None:
        _lz78_decompress_stream(self, fin, fout, lzw=True)
