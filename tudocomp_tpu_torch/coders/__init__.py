"""Coders of the port: bit-level integer encode/decode dispatched on
Range types.

Copy of ``tudocomp_tpu/coders/__init__.py``: the non-consuming coders
(the universal ones and ``huff``) and the consuming ``arithmetic`` and
``sle``, which buffer literals before emitting and cannot be interleaved
with other coders on one stream. Each coder class has nested
``Encoder``/``Decoder`` classes (reference: ``Coder.hpp`` + ``coders/``).
"""

from tudocomp_tpu_torch.coders.arithmetic import ArithmeticCoder
from tudocomp_tpu_torch.coders.huffman import HuffmanCoder
from tudocomp_tpu_torch.coders.simple import (
    ASCIICoder,
    BitCoder,
    EliasDeltaCoder,
    EliasGammaCoder,
    TernaryCoder,
)
from tudocomp_tpu_torch.coders.sle import SLECoder

#: the coders usable for any value stream, interleaved freely, and the
#: entropy coder that pre-scans literals but emits inline
NON_CONSUMING_CODERS = [ASCIICoder, BitCoder, EliasGammaCoder,
                        EliasDeltaCoder, TernaryCoder, HuffmanCoder]

#: the entropy coders that consume (buffer) literals
CONSUMING_ENTROPY_CODERS = [ArithmeticCoder, SLECoder]

#: CLI-enumeration name sets (reference ``etc/registry_config.py:12-37``)
UNIVERSAL_CODER_NAMES = ("ascii", "bit", "gamma", "delta", "ternary")
NON_CONSUMING_CODER_NAMES = UNIVERSAL_CODER_NAMES + ("huff",)
LCPCOMP_CODER_NAMES = ("ascii", "huff", "sle")

#: every coder the port registers
ALL_CODERS = NON_CONSUMING_CODERS + CONSUMING_ENTROPY_CODERS


#: the coders with a pure-VLC field format and their int-code kinds in
#: the host library (``BitRd.read_code``, ``TdcBitWr.put_code``)
_CODE_KIND_CODERS = ((BitCoder, 0), (EliasGammaCoder, 1),
                     (EliasDeltaCoder, 2), (TernaryCoder, 3), (ASCIICoder, 4))

#: coder name -> int-code kind, for the host stream coders, which hold no
#: decoder instance
CODE_KINDS = {cls.meta().name: kind for cls, kind in _CODE_KIND_CODERS}


def native_code_kind(decoder):
    """Map a decoder instance to the host library's int-code kind
    (``BitRd.read_code``): 0 bit, 1 gamma, 2 delta, 3 ternary,
    4 ascii; None for coders without a pure-VLC field format."""
    for cls, kind in _CODE_KIND_CODERS:
        if isinstance(decoder, cls.Decoder):
            return kind
    return None


def option_code_kind(env, option: str = "coder") -> int:
    """The int-code kind of the coder that ``env``'s ``option`` names;
    the families that call it accept only ``UNIVERSAL_CODER_NAMES``."""
    return CODE_KINDS[env.env_for_option(option).cls.meta().name]
