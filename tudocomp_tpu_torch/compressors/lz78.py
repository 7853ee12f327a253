"""LZ78 compressor.

The port's copy of ``tudocomp_tpu/compressors/lz78.py``, with the same
options, header and bytes. Format matches the reference
``compressors/LZ78Compressor.hpp``: each factor is ``(ref in
Range(factor_count), literal)`` — the reference bit width grows with the
number of factors emitted so far. The final partial phrase is emitted as
``(parent_id, last_char)``. Decoding replays ``(index, literal)`` pairs,
unrolling each phrase backward through parent pointers.

``dict_size`` (0 = unlimited) resets the dictionary when reached; the
reference marks its reset path broken (``LZ78Compressor.hpp:108``), ours is
implemented symmetrically in the decoder. Every trie of ``lz78trie`` is
an exact (node, byte) -> id map that hands out ids in insertion order and
grows by one node a factor, so all of them give one parse and reset at
the same factor: parse, encode and decode run in the host library
(``csrc/host/lz78.cpp``) for every trie, coder and ``dict_size``, the
buffered path through the one-pass stream handles. The library raises
where it cannot be built.
"""

from __future__ import annotations

import io

import numpy as np

from tudocomp_tpu_torch import native
from tudocomp_tpu_torch.coders import UNIVERSAL_CODER_NAMES, option_code_kind
from tudocomp_tpu_torch.compressors.base import Compressor
from tudocomp_tpu_torch.io.bitio import BitReader, StreamBitSink
from tudocomp_tpu_torch.meta import Meta


class LZ78Compressor(Compressor):
    @classmethod
    def meta(cls):
        m = Meta("compressor", "lz78", "Lempel-Ziv 78")
        m.option_submeta(
            "coder", "coder", default="bit",
            accepts=UNIVERSAL_CODER_NAMES,
        )
        m.option_submeta("lz78trie", "lz78trie", default="ternary")
        m.option_dynamic("dict_size", 0)
        return m

    def compress(self, data: bytes) -> bytes:
        return _lz78_compress_buffered(self, data, lzw=False)

    def decompress(self, data: bytes) -> bytes:
        reader = BitReader(data)
        return native.lz78_stream_decode(
            np.packbits(reader._bits), reader.total, reader.pos,
            option_code_kind(self.env),
            self.env.option("dict_size").as_int(),
        )

    supports_streaming = True

    def compress_stream(self, fin, fout) -> None:
        _lz78_compress_stream(self, fin, fout, lzw=False)

    def decompress_stream(self, fin, fout) -> None:
        _lz78_decompress_stream(self, fin, fout, lzw=False)


#: streaming chunk size (state is the O(dict) trie handle; RSS stays
#: O(CHUNK + dict))
STREAM_CHUNK = 1 << 22


def _lz78_compress_buffered(self, data: bytes, *, lzw: bool) -> bytes:
    """The buffered encode: the one-pass stream encode over the bytes in
    memory, so the host output buffer stays one chunk's size."""
    fout = io.BytesIO()
    _lz78_compress_stream(self, io.BytesIO(data), fout, lzw=lzw)
    return fout.getvalue()


def _lz78_compress_stream(self, fin, fout, *, lzw: bool) -> None:
    """One-pass streaming encode for LZ78/LZW (reference ``as_stream()``
    parity: ``LZ78Compressor.hpp:67`` / ``LZWCompressor.hpp:42`` read the
    input byte stream once). The trie + growing code width carry across
    chunks in a host handle (the mtf-table pattern with O(dict) state);
    per-chunk bit runs splice through ``StreamBitSink`` — output
    byte-identical for every chunking."""
    stream = native.Lz78Stream(lzw, self.env.option("dict_size").as_int(),
                               option_code_kind(self.env))
    sink = StreamBitSink(fout)
    try:
        while True:
            chunk = fin.read(STREAM_CHUNK)
            final = not chunk
            packed, nbits = stream.feed(chunk, final)
            sink.append_packed(packed, nbits)
            if final:
                break
    finally:
        stream.close()
    sink.close()


def _lz78_decompress_stream(self, fin, fout, *, lzw: bool) -> None:
    """One-pass streaming decode for LZ78/LZW, mirroring the reference
    decompressors' single pass (``LZ78Compressor.hpp:16-38`` replays
    (ref, literal) pairs; ``lzw/LZWDecoding.hpp:13-49`` decode_step).
    The undecoded bit tail + the O(dict) (parent, char) expansion state
    carry across chunks in a host handle; factor expansion walks
    chains backward so output streams out without output-history
    buffering — byte-identical to the buffered decode at every
    chunking."""
    stream = native.Lz78DecStream(lzw,
                                  self.env.option("dict_size").as_int(),
                                  option_code_kind(self.env))
    try:
        while True:
            chunk = fin.read(STREAM_CHUNK)
            final = not chunk
            out = stream.feed(chunk, final)
            if out:
                fout.write(out)
            if final:
                break
    finally:
        stream.close()
