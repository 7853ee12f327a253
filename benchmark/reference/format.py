"""Byte and bit encodings of the tudocomp wire formats, written out plainly.

- ``vbyte``: little-endian 7-bit groups, one a byte; a byte's top bit is
  set where more bytes follow (tudocomp's ``util/vbyte.hpp``).
- The bit stream of a header: bits written most significant first into
  bytes; ``compressed_int`` writes 7-bit groups, low group first, each
  after one bit that says whether another group follows; a finished
  stream ends with the finalization byte convention (below).
- Escaping: a compressor may forbid some bytes in its input and ask for
  a ``\\0`` sentinel; the forbidden bytes (``\\0`` among them where the
  sentinel is asked for) and the escape byte itself become two-byte
  pairs, and one ``\\0`` is appended (tudocomp's ``io/EscapeMap.hpp``).
"""

from __future__ import annotations

import numpy as np

#: replacement bytes, in order of preference (bytes illegal in UTF-8)
ESCAPE_POOL = [255, 254, 192, 193, 245, 246, 247, 248, 249, 250, 251, 252,
               253]


def vbyte(v: int) -> bytes:
    out = bytearray()
    while True:
        low, v = v & 0x7F, v >> 7
        out.append(low | 0x80 if v else low)
        if not v:
            return bytes(out)


def read_vbyte(data, pos: int) -> tuple[int, int]:
    """``(value, position after it)``."""
    value = shift = 0
    while True:
        b = data[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, pos


class Bits:
    """A bit stream written most significant bit first."""

    def __init__(self):
        self.bits: list[int] = []

    def int(self, v: int, width: int) -> None:
        self.bits += [(v >> (width - 1 - i)) & 1 for i in range(width)]

    def bit(self, b) -> None:
        self.bits.append(1 if b else 0)

    def compressed_int(self, v: int) -> None:
        while True:
            group, v = v & 0x7F, v >> 7
            self.bit(v > 0)
            self.int(group, 7)
            if not v:
                return

    def finish(self) -> bytes:
        """The stream with the finalization byte: ``k`` = total bits mod
        8; ``k == 0`` appends a zero byte, ``k <= 5`` writes ``k`` into
        the last byte's low three bits (which are padding), ``k >= 6``
        appends a byte holding ``k``."""
        total = len(self.bits)
        packed = np.packbits(np.array(self.bits, np.uint8)).tobytes()
        k = total % 8
        if k == 0:
            return packed + b"\x00"
        if k <= 5:
            return packed[:-1] + bytes([packed[-1] | k])
        return packed + bytes([k])


def escape(data: bytes, forbidden=(), sentinel: bool = False) -> bytes:
    """``data`` escaped for a compressor that forbids the bytes
    ``forbidden`` and (``sentinel``) wants a unique ``\\0`` at its end."""
    esc = list(forbidden)
    if sentinel and 0 not in esc:
        esc = [0] + esc
    if not esc:
        return data + (b"\x00" if sentinel else b"")
    pool = [b for b in ESCAPE_POOL if b not in esc]
    pool += [b for b in range(256) if b not in esc and b not in pool]
    repl = pool[: len(esc) + 1]
    esc = [repl[0]] + esc  # the escape byte escapes itself first
    second = np.arange(256, dtype=np.int64)
    is_esc = np.zeros(256, bool)
    for e, r in zip(esc, repl):
        second[e], is_esc[e] = r, True
    a = np.frombuffer(data, np.uint8)
    hit = is_esc[a]
    out = np.empty(a.size + int(hit.sum()), np.uint8)
    pos = np.arange(a.size) + np.cumsum(hit) - hit
    out[pos] = np.where(hit, repl[0], a)
    out[pos[hit] + 1] = second[a[hit]]
    return out.tobytes() + (b"\x00" if sentinel else b"")
