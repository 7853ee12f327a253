"""Byte-aligned varint ("vbyte") coding.

Copy of ``tudocomp_tpu/utils/vbyte.py``: little-endian 7-bit groups,
one per byte; a byte's MSB is set iff more bytes follow (the reference's
``util/vbyte.hpp:11-38``).
"""

from __future__ import annotations

import numpy as np


def write_vbyte(out: bytearray, v: int) -> None:
    v = int(v)
    while True:
        byte = v & 0x7F
        v >>= 7
        out.append(byte | 0x80 if v > 0 else byte)
        if v <= 0:
            break


def read_vbyte(data, pos: int):
    """Returns (value, new_pos)."""
    ret = 0
    shift = 0
    while True:
        byte = data[pos]
        pos += 1
        ret |= (byte & 0x7F) << shift
        shift += 7
        if not byte & 0x80:
            return ret, pos


def encode_vbyte_array(values: np.ndarray) -> np.ndarray:
    """Vectorized vbyte encode of a uint64 array -> uint8 byte array."""
    values = np.asarray(values, dtype=np.uint64)
    if values.size == 0:
        return np.zeros(0, np.uint8)
    # number of 7-bit groups per value
    nbytes = np.ones(values.shape, np.int64)
    v = values.copy()
    for _ in range(9):
        v >>= np.uint64(7)
        nbytes += (v > 0).astype(np.int64)
    ends = np.cumsum(nbytes)
    total = int(ends[-1])
    offs = ends - nbytes
    out = np.zeros(total, np.uint8)
    # group index within each value via position - start offset
    idx = np.arange(total, dtype=np.int64)
    owner = np.searchsorted(ends, idx, side="right")
    group = idx - offs[owner]
    chunk = (values[owner] >> (group.astype(np.uint64) * np.uint64(7))) & np.uint64(0x7F)
    more = idx != ends[owner] - 1
    out[:] = chunk.astype(np.uint8) | (more.astype(np.uint8) << 7)
    return out
