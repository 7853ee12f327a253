"""Move-to-front transform (byte-level).

Format matches the reference ``compressors/MTFCompressor.hpp``: a 256-entry
recency table initialized to the identity; each byte is replaced by its
table index, then moved to the front.

The port's copy of ``tudocomp_tpu/compressors/mtf.py``: the Python
functions are the specification; the compressor runs the port's host
library (``csrc/host/literal.cpp``), whole or chunk by chunk with the
table carried across chunks.
"""

from __future__ import annotations

import numpy as np

from tudocomp_tpu_torch import native
from tudocomp_tpu_torch.compressors.base import Compressor
from tudocomp_tpu_torch.meta import Meta


def mtf_encode(data: bytes) -> bytes:
    table = list(range(256))
    out = bytearray(len(data))
    index = table.index
    for i, c in enumerate(data):
        j = index(c)
        out[i] = j
        if j:
            del table[j]
            table.insert(0, c)
    return bytes(out)


def mtf_decode(data: bytes) -> bytes:
    table = list(range(256))
    out = bytearray(len(data))
    for i, j in enumerate(data):
        c = table[j]
        out[i] = c
        if j:
            del table[j]
            table.insert(0, c)
    return bytes(out)


class MTFCompressor(Compressor):
    @classmethod
    def meta(cls):
        return Meta("compressor", "mtf", "Move To Front Compressor")

    def compress(self, data: bytes) -> bytes:
        return native.mtf_encode(data)

    def decompress(self, data: bytes) -> bytes:
        return native.mtf_decode(data)


#: streaming chunk size (state is the 256-entry table; RSS stays O(CHUNK))
STREAM_CHUNK = 1 << 22


def _mtf_stream(fin, fout, decode: bool) -> None:
    table = np.arange(256, dtype=np.uint8)
    while True:
        chunk = fin.read(STREAM_CHUNK)
        if not chunk:
            return
        fout.write(native.mtf_stream(chunk, table, decode=decode))


def _add_streaming():
    """Streaming one-pass mode (reference ``as_stream()`` parity,
    ``io/Input.hpp:199-208``): O(1) carried state, output byte-identical
    to the buffered path."""

    MTFCompressor.supports_streaming = True
    MTFCompressor.compress_stream = (
        lambda self, fin, fout: _mtf_stream(fin, fout, False)
    )
    MTFCompressor.decompress_stream = (
        lambda self, fin, fout: _mtf_stream(fin, fout, True)
    )


_add_streaming()
