"""The TBC2 segment codec as a registered compressor.

``tbc2`` wraps the port's ``models/blockcodec.BlockCodec`` (per-segment
RLE + shared canonical Huffman, self-describing TBC2 container), as
``tudocomp_tpu/compressors/tbc2.py`` wraps the JAX one, so that
``python -m tudocomp_tpu_torch.cli -a "tbc2(min_code_len=4)" FILE`` runs
it. The options and their order are the JAX package's, so the header
(``tbc2(offset=0, min_code_len=3, dec=auto)`` by default) and the
container read the same in both packages:

- ``offset``        RLE run-length bias (container header field)
- ``min_code_len``  Huffman minimum code length, 3..8 (``TDC_MIN_CODE_LEN``
                    overrides it, as in the JAX package)
- ``dec``           decoder: ``auto``, ``pallas`` and ``scan`` decode
                    with ``decompress_device`` (K4) on the Env's torch
                    device, except that ``auto`` on a CPU device decodes
                    on host cores, as ``host`` always does
                    (``BlockCodec.decompress``)

The codec runs on the Env's ``torch_device`` under the port's device
rule (``tudocomp_tpu_torch/device.py``). The JAX package's TPU layout knobs
(``TDC_PACK_*``, ``TDC_OFFS_IMPL``, ``TDC_DEC_KERNEL``) have no
counterpart here: the port's kernels have one layout each.
"""

from __future__ import annotations

from tudocomp_tpu_torch.compressors.base import Compressor
from tudocomp_tpu_torch.meta import Meta
from tudocomp_tpu_torch.models.blockcodec import BlockCodec

#: the decoder choices of the JAX package's ``tbc2``; the port adds none,
#: so every header it writes decodes there
DEC_VALUES = ("auto", "pallas", "scan", "host")


class TBC2Compressor(Compressor):
    @classmethod
    def meta(cls):
        m = Meta(
            "compressor",
            "tbc2",
            "device segment codec: per-segment RLE + shared canonical "
            "Huffman (TBC2 container; models/blockcodec.py)",
        )
        m.option_dynamic("offset", 0)
        m.option_dynamic("min_code_len", 3)
        m.option_dynamic("dec", "auto")
        return m

    def _dec(self) -> str:
        dec = self.env.option("dec").as_string()
        if dec not in DEC_VALUES:
            raise ValueError(
                f"tbc2: dec must be one of {', '.join(DEC_VALUES)}, "
                f"not {dec!r}"
            )
        return dec

    def _codec(self) -> BlockCodec:
        return BlockCodec(
            device=self.env.torch_device,
            offset=self.env.option("offset").as_int(),
            min_code_len=self.env.option("min_code_len").as_int(),
        )

    def compress(self, data: bytes) -> bytes:
        self._dec()
        return self._codec().compress(data)

    def decompress(self, data: bytes) -> bytes:
        dec = self._dec()
        codec = self._codec()
        if dec == "host" or (dec == "auto" and codec.device.type == "cpu"):
            return codec.decompress(data)
        return codec.decompress_device(data)
