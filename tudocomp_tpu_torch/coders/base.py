"""Encoder/Decoder base classes with Range dispatch.

Copy of ``tudocomp_tpu/coders/base.py``. Default semantics (reference
``Coder.hpp:61-77,127-142``): a value in ``Range(min,max)`` is written as
``v - min`` in ``bits_for(max-min)`` bits; a ``BitRange`` value is a
single bit. Subclasses override per-range behavior by re-implementing
``encode``/``decode`` (checking the most specific range type first —
Python's stand-in for C++ overload resolution).

Vectorized variants (``encode_array``/``decode_array``) are the hot path:
they map straight onto the token-stream IR.
"""

from __future__ import annotations

import numpy as np

from tudocomp_tpu_torch.meta import Algorithm
from tudocomp_tpu_torch.ranges import BitRange, Range


class Literals:
    """Literal pre-pass for entropy coders (reference ``Literal.hpp``).

    ``chars`` is a uint8 array of every literal the compressor will encode,
    in encode order (positions available for coders that need them).
    """

    def __init__(self, chars=None, positions=None):
        self.chars = (
            np.zeros(0, np.uint8)
            if chars is None
            else np.asarray(chars, dtype=np.uint8)
        )
        self.positions = positions


class Encoder(Algorithm):
    is_consuming = False

    def __init__(self, env, out, literals: Literals):
        super().__init__(env)
        self.out = out
        self.literals = literals

    def encode(self, v, r: Range) -> None:
        if isinstance(r, BitRange):
            self.out.write_bit(bool(v))
        else:
            self.out.write_int(int(v) - r.min, r.bits)

    def encode_array(self, values, r: Range) -> None:
        values = np.asarray(values, dtype=np.uint64)
        if isinstance(r, BitRange):
            # normalize truthiness like the scalar path's bool(v):
            # raw `values & 1` would flip e.g. 2 -> bit 0
            self.out.write_int_array(
                (values != 0).astype(np.uint64), 1
            )
        else:
            self.out.write_int_array(values - np.uint64(r.min), r.bits)

    def finish(self) -> None:
        """Flush buffered state (consuming coders override)."""


class Decoder(Algorithm):
    is_consuming = False

    def __init__(self, env, inp):
        super().__init__(env)
        self.inp = inp

    def eof(self) -> bool:
        return self.inp.eof()

    def decode(self, r: Range) -> int:
        if isinstance(r, BitRange):
            return self.inp.read_bit()
        return r.min + self.inp.read_int(r.bits)

    def decode_array(self, r: Range, count: int) -> np.ndarray:
        if isinstance(r, BitRange):
            return self.inp.read_int_array(1, count)
        return self.inp.read_int_array(r.bits, count) + np.uint64(r.min)
