"""Compressors of the port: transform input bytes to a compressed stream
and back.

Importing this package registers them, their strategies, the coders
(the non-consuming ones, ``arithmetic`` and ``sle``), the hash-table
framework (``utils/hash.py``) and the generators with the port's
registry. It holds what the port has so far: ``noop``, ``encode``,
``rle``, ``mtf``, ``tbc2``, ``bwt``, ``chain``, ``blocks``,
``lzss_lcp``, ``lcpcomp`` and ``esp`` with its SLP coders, ``d_coding``
and ``ipd`` families; the other families of ``tudocomp_tpu/compressors``
join as they are ported.
"""

import tudocomp_tpu_torch.utils.hash  # noqa: F401 — registers the framework
from tudocomp_tpu_torch.coders import ALL_CODERS
from tudocomp_tpu_torch.compressors.base import Compressor  # noqa: F401
from tudocomp_tpu_torch.compressors.blocks import BlocksCompressor
from tudocomp_tpu_torch.compressors.bwt import BWTCompressor
from tudocomp_tpu_torch.compressors.chain import ChainCompressor
from tudocomp_tpu_torch.compressors.esp import ESP_CLASSES
from tudocomp_tpu_torch.compressors.lcpcomp import LCPCOMP_CLASSES
from tudocomp_tpu_torch.compressors.literal import LiteralEncoder
from tudocomp_tpu_torch.compressors.lzss import LZSSLCPCompressor
from tudocomp_tpu_torch.compressors.mtf import MTFCompressor
from tudocomp_tpu_torch.compressors.noop import NoopCompressor
from tudocomp_tpu_torch.compressors.rle import RunLengthEncoder
from tudocomp_tpu_torch.compressors.tbc2 import TBC2Compressor
from tudocomp_tpu_torch.generators import register_generators
from tudocomp_tpu_torch.registry import REGISTRY

for _coder in ALL_CODERS:
    REGISTRY.register(_coder)

for _comp in (NoopCompressor, LiteralEncoder, RunLengthEncoder,
              MTFCompressor, BWTCompressor, ChainCompressor,
              LZSSLCPCompressor, BlocksCompressor, TBC2Compressor,
              *LCPCOMP_CLASSES, *ESP_CLASSES):
    REGISTRY.register(_comp)

register_generators(REGISTRY)
