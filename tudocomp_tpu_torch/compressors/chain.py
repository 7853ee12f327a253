"""Chain compressor: function composition of two compressors.

Reference: ``tudocomp_driver/ChainCompressor.hpp:14-101``. The driver's
``a:b:c`` sugar folds into nested chains. The chain itself applies each
stage's input restrictions: on compress, every stage's input is escaped for
that stage; on decompress (stages reversed), every stage's output is
un-escaped. The chain declares no restrictions of its own.
"""

from __future__ import annotations

from tudocomp_tpu_torch.compressors.base import Compressor
from tudocomp_tpu_torch.io.restrictions import escape, unescape
from tudocomp_tpu_torch.meta import Meta


class ChainCompressor(Compressor):
    manages_sub_restrictions = True

    @classmethod
    def meta(cls):
        m = Meta("compressor", "chain", "Chains two compressors")
        m.option_submeta("first", "compressor")
        m.option_submeta("second", "compressor")
        return m

    def _stage(self, option):
        comp = self.env.instantiate(option)
        reg = self.env.registry
        if reg is not None:
            restr = reg.restrictions_of(comp.env)
        else:
            restr = comp.env.cls.meta().restrictions
        return comp, restr

    def compress(self, data: bytes) -> bytes:
        first, r1 = self._stage("first")
        second, r2 = self._stage("second")
        mid = first.compress(escape(data, r1))
        return second.compress(escape(mid, r2))

    def decompress(self, data: bytes) -> bytes:
        first, r1 = self._stage("first")
        second, r2 = self._stage("second")
        mid = unescape(second.decompress(data), r2)
        return unescape(first.decompress(mid), r1)
