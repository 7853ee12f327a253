"""Value-range hints for coders.

Copy of ``tudocomp_tpu/ranges.py``, which mirrors the reference's
``Range.hpp:16-115``: a ``Range`` carries ``min`` and ``max`` and is used
by coders to pick a bit representation per encode call. Subclasses are
*type tags* coders dispatch on:

- ``Range``                — generic; default coder uses bits_for(max-min) bits
- ``MinDistributedRange``  — values skew small; universal coders may exploit
- ``BitRange``             — exactly one bit
- ``LiteralRange``         — a byte literal (entropy coders compress these)
- ``LengthRange``          — a text length / index
"""

from tudocomp_tpu_torch.utils.bits import bits_for


class Range:
    __slots__ = ("min", "max")

    def __init__(self, a, b=None):
        if b is None:
            self.min, self.max = 0, int(a)
        else:
            self.min, self.max = int(a), int(b)

    @property
    def bits(self) -> int:
        """Bits used by the default (range-optimal binary) representation."""
        return bits_for(self.max - self.min)

    def __repr__(self):
        return f"{type(self).__name__}({self.min}, {self.max})"


class MinDistributedRange(Range):
    pass


class BitRange(Range):
    def __init__(self):
        super().__init__(0, 1)


class LiteralRange(Range):
    def __init__(self):
        super().__init__(0, 255)


class LengthRange(Range):
    """Range of valid text lengths (reference len_t is 32-bit by default)."""

    def __init__(self):
        super().__init__(0, 2**32 - 1)


bit_r = BitRange()
literal_r = LiteralRange()
len_r = LengthRange()
