"""tudocomp-tpu on PyTorch and CUDA: the TBC2 segment codec and the
chunked bit packers, with hand-written Hopper kernels (``csrc/``), and
every compressor family of the JAX package ``tudocomp_tpu``
(``compressors/``), byte-compatible with it. Imports torch and numpy, never JAX
and nothing of the JAX package: the host code it needs (bit I/O, the
Huffman table, vbyte, the host library in ``csrc/host/``) has its own
copy here. Its front end (registry, CLI, stats) is
``python -m tudocomp_tpu_torch.cli``."""

__version__ = "0.1.0"

from tudocomp_tpu_torch.models import BlockCodec, device_tables

__all__ = ["BlockCodec", "device_tables"]
