"""Identity compressor (reference ``compressors/NoopCompressor.hpp``).

The port's copy of ``tudocomp_tpu/compressors/noop.py``.
"""

from tudocomp_tpu_torch.compressors.base import Compressor
from tudocomp_tpu_torch.meta import Meta


class NoopCompressor(Compressor):
    @classmethod
    def meta(cls):
        m = Meta("compressor", "noop")
        m.option_dynamic("mode", "stream")
        m.option_dynamic("debug", False)
        return m

    def compress(self, data: bytes) -> bytes:
        return bytes(data)

    def decompress(self, data: bytes) -> bytes:
        return bytes(data)

    # one-pass identity streaming (the reference's default
    # mode="stream" copies Input::as_stream -> Output,
    # NoopCompressor.hpp:29-44)
    supports_streaming = True

    def compress_stream(self, fin, fout) -> None:
        while True:
            chunk = fin.read(1 << 20)
            if not chunk:
                return
            fout.write(chunk)

    decompress_stream = compress_stream
