"""Compressor base class.

Reference counterpart: ``Compressor.hpp:19-43``. A compressor maps raw
bytes to a compressed byte stream and back. Input restrictions (escaping /
sentinel) are applied by the *caller* (container/CLI/test harness), exactly
like the reference driver wraps ``Input``/``Output`` — compressors may
assume their declared restrictions hold.

The port's copy of ``tudocomp_tpu/compressors/base.py``.
"""

from __future__ import annotations

from tudocomp_tpu_torch.coders.base import Literals
from tudocomp_tpu_torch.meta import Algorithm


class Compressor(Algorithm):
    def compress(self, data: bytes) -> bytes:  # pragma: no cover - abstract
        raise NotImplementedError

    def decompress(self, data: bytes) -> bytes:  # pragma: no cover
        raise NotImplementedError

    # -- coder plumbing -------------------------------------------------------

    def coder_encoder(self, writer, literals: Literals, option="coder"):
        sub = self.env.env_for_option(option)
        return sub.cls.Encoder(sub, writer, literals)

    def coder_decoder(self, reader, option="coder"):
        sub = self.env.env_for_option(option)
        return sub.cls.Decoder(sub, reader)
