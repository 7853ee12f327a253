"""Bit-packed integer vectors.

The port's copy of ``tudocomp_tpu/ds/int_vector.py`` (``ipd=dynamic_size``
stores its pair table in them). Reference counterpart: ``ds/IntVector.hpp:175-556`` (``IntVector<uint_t<N>>``
/ ``BitVector`` / ``DynamicIntVector`` with runtime ``width()``
re-packing) — the reference's universal storage type. Array re-design:
a numpy-backed fixed-width bit-packed vector with vectorized pack/unpack
(the device-side equivalent is the bitpack kernel's token stream), width
re-packing, and ``bits_for``-style auto-width.
"""

from __future__ import annotations

import numpy as np

from tudocomp_tpu_torch.utils.bits import bits_for


class IntVector:
    """Fixed-width bit-packed vector of unsigned ints (width <= 64).

    Storage is MSB-first within a big-endian byte buffer, matching the
    framework's wire conventions, so ``to_bytes`` of an 8-bit vector is
    the plain byte string.
    """

    def __init__(self, values=None, width: int = 64):
        if not 1 <= width <= 64:
            raise ValueError("width must be in [1, 64]")
        self._width = width
        arr = (
            np.zeros(0, np.uint64)
            if values is None
            else np.array(values, np.uint64)  # own copy: set_width /
            # compress return independent vectors, and a caller's
            # uint64 array must not alias our mutable storage
        )
        self._check(arr)
        self._data = arr  # canonical unpacked form; packing on demand

    # -- core ----------------------------------------------------------------

    def _check(self, arr: np.ndarray) -> None:
        if arr.size and self._width < 64:
            if int(arr.max()) >> self._width:
                raise ValueError(
                    f"value does not fit width {self._width}"
                )

    @property
    def width(self) -> int:
        return self._width

    def set_width(self, width: int) -> "IntVector":
        """Re-pack to a new width (reference ``width(w)``)."""
        out = IntVector(self._data, width)
        return out

    def compress(self) -> "IntVector":
        """Shrink to ``bits_for(max)`` (reference ``compress()``)."""
        w = bits_for(int(self._data.max())) if self._data.size else 1
        return self.set_width(w)

    def __len__(self) -> int:
        return self._data.size

    def bit_size(self) -> int:
        return self._data.size * self._width

    def __getitem__(self, i):
        return self._data[i]

    def __setitem__(self, i, v) -> None:
        v = np.asarray(v, np.uint64)
        self._check(np.atleast_1d(v))
        self._data[i] = v

    def append(self, v: int) -> None:
        self._check(np.asarray([v], np.uint64))
        self._data = np.append(self._data, np.uint64(v))

    def as_array(self) -> np.ndarray:
        return self._data

    # -- packing -------------------------------------------------------------

    def to_bytes(self) -> bytes:
        """MSB-first bit-packed bytes, zero-padded to a byte boundary."""
        w = self._width
        n = self._data.size
        if n == 0:
            return b""
        bits = (
            (self._data[:, None] >> np.arange(w - 1, -1, -1, dtype=np.uint64))
            & np.uint64(1)
        ).astype(np.uint8).reshape(-1)
        return np.packbits(bits).tobytes()

    @classmethod
    def from_bytes(cls, data: bytes, width: int, count: int) -> "IntVector":
        bits = np.unpackbits(np.frombuffer(data, np.uint8))[: width * count]
        chunks = bits.reshape(count, width).astype(np.uint64)
        weights = np.uint64(1) << np.arange(
            width - 1, -1, -1, dtype=np.uint64
        )
        return cls((chunks * weights).sum(axis=1, dtype=np.uint64), width)


class BitVector(IntVector):
    """Width-1 specialization (reference ``BitVector``)."""

    def __init__(self, values=None):
        super().__init__(values, width=1)


class DynamicIntVector(IntVector):
    """Auto-widening vector (reference ``DynamicIntVector``): appends
    grow the width as needed instead of raising."""

    def __init__(self, values=None, width: int = 1):
        arr = np.asarray(
            [] if values is None else values, np.uint64
        )
        need = bits_for(int(arr.max())) if arr.size else width
        super().__init__(arr, max(width, need))

    def append(self, v: int) -> None:
        need = bits_for(int(v))
        if need > self._width:
            self._width = need
        self._data = np.append(self._data, np.uint64(v))
