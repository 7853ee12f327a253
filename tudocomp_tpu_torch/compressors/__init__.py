"""Compressors of the port: transform input bytes to a compressed stream
and back.

Importing this package registers them, their strategies, the coders,
the LZ78 tries, the hash-table framework (``utils/hash.py``) and the
generators with the port's registry: every family of
``tudocomp_tpu/compressors``, so that the port's ``-l`` and
``Registry.all_configurations`` equal the JAX package's.
"""

import tudocomp_tpu_torch.utils.hash  # noqa: F401 — registers the framework
from tudocomp_tpu_torch.coders import ALL_CODERS
from tudocomp_tpu_torch.compressors.base import Compressor  # noqa: F401
from tudocomp_tpu_torch.compressors.blocks import BlocksCompressor
from tudocomp_tpu_torch.compressors.bwt import BWTCompressor
from tudocomp_tpu_torch.compressors.chain import ChainCompressor
from tudocomp_tpu_torch.compressors.esp import ESP_CLASSES
from tudocomp_tpu_torch.compressors.lcpcomp import LCPCOMP_CLASSES
from tudocomp_tpu_torch.compressors.lfs import LFSCompressor  # noqa: F401
from tudocomp_tpu_torch.compressors.literal import LiteralEncoder
from tudocomp_tpu_torch.compressors.lz78 import LZ78Compressor
from tudocomp_tpu_torch.compressors.lz78_trie import ALL_TRIES
from tudocomp_tpu_torch.compressors.lz78u import LZ78UCompressor  # noqa: F401
from tudocomp_tpu_torch.compressors.lzss import (
    LZSSLCPCompressor,
    LZSSSlidingWindowCompressor,
)
from tudocomp_tpu_torch.compressors.lzw import LZWCompressor
from tudocomp_tpu_torch.compressors.mtf import MTFCompressor
from tudocomp_tpu_torch.compressors.noop import NoopCompressor
from tudocomp_tpu_torch.compressors.repair import RePairCompressor
from tudocomp_tpu_torch.compressors.rle import RunLengthEncoder
from tudocomp_tpu_torch.compressors.tbc2 import TBC2Compressor
from tudocomp_tpu_torch.generators import register_generators
from tudocomp_tpu_torch.registry import REGISTRY

for _coder in ALL_CODERS:
    REGISTRY.register(_coder)

for _trie in ALL_TRIES:
    REGISTRY.register(_trie)

# lfs.py and lz78u.py register their own families at import
for _comp in (NoopCompressor, LiteralEncoder, RunLengthEncoder,
              MTFCompressor, BWTCompressor, ChainCompressor,
              LZSSSlidingWindowCompressor, LZSSLCPCompressor,
              LZ78Compressor, LZWCompressor, RePairCompressor,
              BlocksCompressor, TBC2Compressor, *LCPCOMP_CLASSES,
              *ESP_CLASSES):
    REGISTRY.register(_comp)

register_generators(REGISTRY)
