"""The universal coders: ascii, bit, gamma, delta, ternary.

Copy of ``tudocomp_tpu/coders/simple.py``. Formats match the reference
coders exactly (``coders/ASCIICoder.hpp``, ``BitCoder.hpp``,
``EliasGammaCoder.hpp``, ``EliasDeltaCoder.hpp``, ``TernaryCoder.hpp``):
the bit coder uses range-optimal binary everywhere; gamma/delta/ternary
code every non-bit range with their integer code (including literals);
ascii writes decimal text.
"""

from __future__ import annotations

import numpy as np

from tudocomp_tpu_torch import native
from tudocomp_tpu_torch.coders import base
from tudocomp_tpu_torch.meta import Algorithm, Meta
from tudocomp_tpu_torch.ranges import (
    BitRange, LiteralRange, Range, literal_r,
)


def _fixed8_remaining(decoder) -> bytes:
    """Whole-tail literal decode for 8-bit-per-literal streams."""
    rd = decoder.inp
    rem = rd.total - rd.pos
    if rem % 8:
        return _loop_remaining(decoder)
    return rd.read_int_array(8, rem // 8).astype(np.uint8).tobytes()


def _loop_remaining(decoder) -> bytes:
    out = bytearray()
    while not decoder.eof():
        out.append(decoder.decode(literal_r))
    return bytes(out)


def _vlc_remaining(decoder, kind: int) -> bytes:
    """Whole-tail literal decode through the host library's VLC walker
    (``tdc_vlc_literals``); a tail that is not a literal stream (a value
    above 255, a code cut short) takes the per-symbol loop."""
    rd = decoder.inp
    got = native.vlc_literals(np.packbits(rd._bits), rd.total, rd.pos,
                              kind)
    if got is None:
        return _loop_remaining(decoder)
    rd.pos = rd.total
    return got


class BitCoder(Algorithm):
    @classmethod
    def meta(cls):
        return Meta("coder", "bit", "Encoding using range-optimal bit widths")

    class Encoder(base.Encoder):
        pass

    class Decoder(base.Decoder):
        def decode_remaining_literals(self) -> bytes:
            return _fixed8_remaining(self)


class ASCIICoder(Algorithm):
    """Ints as decimal text + ':' terminator; bits as '0'/'1' bytes."""

    @classmethod
    def meta(cls):
        return Meta("coder", "ascii", "Simple ASCII encoding")

    class Encoder(base.Encoder):
        def encode(self, v, r: Range) -> None:
            if isinstance(r, BitRange):
                self.out.write_int(ord("1") if v else ord("0"), 8)
            elif isinstance(r, LiteralRange):
                self.out.write_int(int(v) & 0xFF, 8)
            else:
                for ch in str(int(v)):
                    self.out.write_int(ord(ch), 8)
                self.out.write_int(ord(":"), 8)

        def encode_array(self, values, r: Range) -> None:
            values = np.asarray(values, dtype=np.uint64)
            if isinstance(r, LiteralRange):
                self.out.write_int_array(values & np.uint64(0xFF), 8)
            elif isinstance(r, BitRange):
                for v in values.tolist():
                    self.encode(v, r)
            else:
                # decimal text + ':' per int, emitted as one byte array
                blob = ":".join(
                    str(int(v)) for v in values.tolist()
                ) + ":" if values.size else ""
                self.out.write_int_array(
                    np.frombuffer(blob.encode(), np.uint8)
                    .astype(np.uint64), 8,
                )

    class Decoder(base.Decoder):
        def decode(self, r: Range) -> int:
            if isinstance(r, BitRange):
                return 0 if self.inp.read_int(8) == ord("0") else 1
            if isinstance(r, LiteralRange):
                return self.inp.read_int(8)
            digits = []
            while True:
                c = self.inp.read_int(8)
                if not (ord("0") <= c <= ord("9")):
                    break
                digits.append(chr(c))
            return int("".join(digits)) if digits else 0

        def decode_remaining_literals(self) -> bytes:
            return _fixed8_remaining(self)

        def decode_array(self, r: Range, count: int) -> np.ndarray:
            if isinstance(r, LiteralRange):
                return self.inp.read_int_array(8, count)
            return np.array(
                [self.decode(r) for _ in range(count)], np.uint64
            )


class EliasGammaCoder(Algorithm):
    @classmethod
    def meta(cls):
        return Meta("coder", "gamma", "Elias-gamma encoding")

    class Encoder(base.Encoder):
        def encode(self, v, r: Range) -> None:
            if isinstance(r, BitRange):
                self.out.write_bit(bool(v))
            else:
                self.out.write_elias_gamma(int(v))

        def encode_array(self, values, r: Range) -> None:
            if isinstance(r, BitRange):
                super().encode_array(values, r)
            else:
                self.out.write_gamma_array(np.asarray(values, np.uint64))

    class Decoder(base.Decoder):
        def decode(self, r: Range) -> int:
            if isinstance(r, BitRange):
                return self.inp.read_bit()
            return self.inp.read_elias_gamma()

        def decode_array(self, r: Range, count: int) -> np.ndarray:
            if isinstance(r, BitRange):
                return super().decode_array(r, count)
            return np.array(
                [self.inp.read_elias_gamma() for _ in range(count)],
                np.uint64,
            )

        def decode_remaining_literals(self) -> bytes:
            return _vlc_remaining(self, 1)


class EliasDeltaCoder(Algorithm):
    @classmethod
    def meta(cls):
        return Meta("coder", "delta", "Elias-delta encoding")

    class Encoder(base.Encoder):
        def encode(self, v, r: Range) -> None:
            if isinstance(r, BitRange):
                self.out.write_bit(bool(v))
            else:
                self.out.write_elias_delta(int(v))

        def encode_array(self, values, r: Range) -> None:
            if isinstance(r, BitRange):
                super().encode_array(values, r)
            else:
                self.out.write_delta_array(np.asarray(values, np.uint64))

    class Decoder(base.Decoder):
        def decode(self, r: Range) -> int:
            if isinstance(r, BitRange):
                return self.inp.read_bit()
            return self.inp.read_elias_delta()

        def decode_array(self, r: Range, count: int) -> np.ndarray:
            if isinstance(r, BitRange):
                return super().decode_array(r, count)
            return np.array(
                [self.inp.read_elias_delta() for _ in range(count)],
                np.uint64,
            )

        def decode_remaining_literals(self) -> bytes:
            return _vlc_remaining(self, 2)


class TernaryCoder(Algorithm):
    @classmethod
    def meta(cls):
        return Meta("coder", "ternary", "Ternary encoding")

    class Encoder(base.Encoder):
        def encode(self, v, r: Range) -> None:
            if isinstance(r, BitRange):
                self.out.write_bit(bool(v))
            else:
                self.out.write_ternary(int(v))

        def encode_array(self, values, r: Range) -> None:
            if isinstance(r, BitRange):
                super().encode_array(values, r)
                return
            self.out.write_ternary_array(np.asarray(values, np.uint64))

    class Decoder(base.Decoder):
        def decode(self, r: Range) -> int:
            if isinstance(r, BitRange):
                return self.inp.read_bit()
            return self.inp.read_ternary()

        def decode_array(self, r: Range, count: int) -> np.ndarray:
            if isinstance(r, BitRange):
                return super().decode_array(r, count)
            return np.array(
                [self.inp.read_ternary() for _ in range(count)], np.uint64
            )

        def decode_remaining_literals(self) -> bytes:
            return _vlc_remaining(self, 3)
