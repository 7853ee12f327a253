"""Literal pass-through into any coder.

The port's copy of ``tudocomp_tpu/compressors/literal.py``. Reference:
``compressors/LiteralEncoder.hpp:11-42`` (CLI name ``encode``):
compress = encode every input byte in the literal range; decompress =
decode literals until the bit stream is exhausted. The Huffman tail is
counted and decoded by the port's host library.
"""

from __future__ import annotations

import numpy as np

from tudocomp_tpu_torch import native
from tudocomp_tpu_torch.coders.base import Literals
from tudocomp_tpu_torch.compressors.base import Compressor
from tudocomp_tpu_torch.io.bitio import BitReader, BitWriter
from tudocomp_tpu_torch.meta import Meta
from tudocomp_tpu_torch.ranges import literal_r


class LiteralEncoder(Compressor):
    @classmethod
    def meta(cls):
        m = Meta(
            "compressor",
            "encode",
            "Simply encodes the input's individual characters",
        )
        m.option_submeta("coder", "coder", default="bit")
        return m

    def compress(self, data: bytes) -> bytes:
        view = np.frombuffer(data, dtype=np.uint8)
        out = BitWriter()
        coder = self.coder_encoder(out, Literals(view))
        coder.encode_array(view, literal_r)
        coder.finish()
        return out.getvalue()

    def decompress(self, data: bytes) -> bytes:
        inp = BitReader(data)
        coder = self.coder_decoder(inp)
        if hasattr(coder, "decode_remaining_literals"):
            return coder.decode_remaining_literals()
        if getattr(coder, "table", None) is not None:
            # huffman: the whole tail by the host library's LUT walk
            payload = np.packbits(inp._bits[inp.pos :])
            remaining_bits = inp.total - inp.pos
            count = self._count_huffman_symbols(coder, payload,
                                                remaining_bits)
            if count is not None:
                return coder.table.fast_decode(payload, count).tobytes()
        chunks = []
        while not coder.eof():
            chunks.append(coder.decode(literal_r))
        return bytes(chunks)

    @staticmethod
    def _count_huffman_symbols(coder, payload, remaining_bits):
        """The symbol count of the tail (the bulk decoder needs it up
        front); None where the table has no full LUT."""
        try:
            _, lut_len = coder.table.build_lut()
        except ValueError:
            return None
        return native.huffman_count(
            payload, remaining_bits, lut_len, coder.table.longest
        )
