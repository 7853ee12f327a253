"""Arithmetic (integer range) coder over literals.

The port's copy of ``tudocomp_tpu/coders/arithmetic.py``, with the same
bits: the whole literal stream is encoded and decoded by the port's host
library (``csrc/host/literal.cpp``); the scalar interval walk below
serves streams that mix literals with other values or are read symbol
by symbol.

Scheme mirrors the reference ``coders/ArithmeticCoder.hpp``: a *consuming*
coder — it needs the literal histogram up front and buffers interval state:

- codebook header: literal count, codebook size, then (symbol, normalized
  cumulative count) pairs; cumulative counts are divided by the minimum
  symbol count.
- encoding narrows a 64-bit interval ``[lower, upper)`` per literal using
  the normalized cumulative table; when the range underflows the total
  interval parts, the current ``lower`` is flushed as a 64-bit code and the
  interval restarts ("flush-and-restart" blocks).
- after the final literal the last code plus an all-ones dummy code is
  written.
- non-literal ranges fall back to range-optimal binary.

Divergences from the reference (documented per SURVEY.md hard-part #1):
the reference stores the codebook size in 8 bits (wraps for a 256-symbol
alphabet) and derives the literal total from cumulative index 254; we store
16 bits and the true total. The flush/restart schedule is identical, so
block boundaries align between our encoder and decoder.
"""

from __future__ import annotations

import numpy as np

from tudocomp_tpu_torch import native
from tudocomp_tpu_torch.coders import base
from tudocomp_tpu_torch.meta import Algorithm, Meta
from tudocomp_tpu_torch.ranges import LiteralRange, Range, literal_r

_UMAX = (1 << 64) - 1


def _offset(range_, cum, total):
    if total == 0:
        raise ValueError(
            "arithmetic coder: literal encoded without a literal "
            "pre-pass — this consuming coder needs the full literal "
            "stream up front (see the coder taxonomy in coders/__init__)"
        )
    # guard against 64-bit overflow exactly like the reference's two regimes
    if range_ <= total:
        return range_ * cum // total
    return range_ // total * cum


class ArithmeticCoder(Algorithm):
    is_consuming = True

    @classmethod
    def meta(cls):
        return Meta("coder", "arithmetic", "Simple range encoding")

    class Encoder(base.Encoder):
        is_consuming = True

        def __init__(self, env, out, literals):
            super().__init__(env, out, literals)
            counts = np.bincount(literals.chars, minlength=256)
            self.literal_count = int(counts.sum())
            self.literal_counter = 0
            self.lower = 0
            self.upper = _UMAX
            nonzero = np.flatnonzero(counts)
            self.symbols = nonzero
            if nonzero.size:
                mn = int(counts[nonzero].min())
                cum = np.cumsum(counts) // mn
                self.cum = cum  # normalized cumulative counts, full alphabet
                self.total = int(cum[255])
            else:
                self.cum = np.zeros(256, np.int64)
                self.total = 0
            self.min_range = self.total
            # codebook header: fixed 32-bit fields (widened from the
            # reference's 8); write_int masks silently, so fail loudly
            # past 2^32 instead of wrapping into a corrupt stream
            if self.literal_count >= 1 << 32 or self.total >= 1 << 32:
                raise ValueError(
                    "arithmetic coder: literal count exceeds the "
                    "32-bit codebook header"
                )
            out.write_int(self.literal_count, 32)
            out.write_int(int(nonzero.size), 16)
            for s in nonzero.tolist():
                out.write_int(s, 8)
                out.write_int(int(self.cum[s]), 32)

        def encode(self, v, r: Range) -> None:
            if not isinstance(r, LiteralRange):
                super().encode(v, r)
                return
            v = int(v) & 0xFF
            self.literal_counter += 1
            rng = self.upper - self.lower
            if rng < self.min_range:
                self.out.write_int(self.lower, 64)
                self.lower, self.upper = 0, _UMAX
                rng = _UMAX
            self.upper = self.lower + _offset(
                rng, int(self.cum[v]), self.total
            )
            if v != 0:
                self.lower = self.lower + _offset(
                    rng, int(self.cum[v - 1]), self.total
                )
            if self.literal_counter == self.literal_count:
                self.out.write_int(self.lower, 64)
                self.out.write_int(_UMAX, 64)  # dummy terminator

        def encode_array(self, values, r: Range) -> None:
            if not isinstance(r, LiteralRange):
                super().encode_array(values, r)
                return
            values = np.asarray(values, np.uint8)
            if self.literal_counter == 0 and values.size == \
                    self.literal_count and values.size:
                # the whole stream at once: the host library emits the
                # identical 64-bit block-code sequence
                codes = native.arith_encode(
                    values, self.cum.astype(np.uint64), self.total
                )
                self.out.write_int_array(codes, 64)
                self.literal_counter = self.literal_count
                return
            for v in values.tolist():
                self.encode(v, r)

    class Decoder(base.Decoder):
        is_consuming = True

        def __init__(self, env, inp):
            super().__init__(env, inp)
            self.literal_count = inp.read_int(32)
            sigma = inp.read_int(16)
            self.symbols = []
            self.cums = []
            for _ in range(sigma):
                self.symbols.append(inp.read_int(8))
                self.cums.append(inp.read_int(32))
            self.total = self.cums[-1] if self.cums else 0
            self.min_range = self.total
            self.literal_counter = 0
            self.buffer: list[int] = []
            self.buf_pos = 0

        def eof(self) -> bool:
            return self.buf_pos >= len(self.buffer) and self.inp.eof()

        def _decode_block(self, code: int) -> None:
            lower, upper = 0, _UMAX
            out = []
            rng = upper - lower
            while self.min_range <= rng and (
                self.literal_counter < self.literal_count
            ):
                interval_lower = lower
                for sym, cum in zip(self.symbols, self.cums):
                    upper = lower + _offset(rng, cum, self.total)
                    if code < upper:
                        out.append(sym)
                        lower = interval_lower
                        break
                    interval_lower = upper
                self.literal_counter += 1
                rng = upper - lower
            self.buffer = out
            self.buf_pos = 0

        def decode(self, r: Range) -> int:
            if not isinstance(r, LiteralRange):
                return super().decode(r)
            if self.buf_pos >= len(self.buffer):
                code = self.inp.read_int(64)
                if code != _UMAX:
                    self._decode_block(code)
            v = self.buffer[self.buf_pos]
            self.buf_pos += 1
            if self.buf_pos >= len(self.buffer):
                code = self.inp.read_int(64)
                if code != _UMAX:
                    self._decode_block(code)
            return v

        def decode_array(self, r: Range, count: int) -> np.ndarray:
            return np.array(
                [self.decode(r) for _ in range(count)], np.uint64
            )

        def decode_remaining_literals(self) -> bytes:
            """Whole-stream literal decode by the host library's
            block-code walk; a stream already partly read takes the
            per-symbol interval scan."""
            remaining = self.literal_count - self.literal_counter
            rd = self.inp
            if (
                self.buffer[self.buf_pos:] or self.literal_counter
                or remaining <= 0
            ):
                out = bytearray()
                while not self.eof():
                    out.append(self.decode(literal_r))
                return bytes(out)
            payload = np.packbits(rd._bits)
            got = native.arith_decode(
                payload, rd.total, rd.pos,
                np.asarray(self.symbols, np.uint8),
                np.asarray(self.cums, np.uint64),
                self.total, remaining,
            )
            rd.pos = rd.total
            self.literal_counter = self.literal_count
            return got.tobytes()
