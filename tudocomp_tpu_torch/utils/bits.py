"""Bit-width helpers.

Copy of ``tudocomp_tpu/utils/bits.py``; semantics mirror the reference
framework's ``util.hpp`` (``bits_for``: ``util.hpp:194``): ``bits_for(n)``
is the number of bits needed to store ``n``, at least 1, so
``bits_for(0) == bits_for(1) == 1``.
"""

from __future__ import annotations

import numpy as np


def bits_for(n: int) -> int:
    """Number of bits required to store the value ``n`` (>= 1)."""
    if n < 0:
        raise ValueError("bits_for requires a non-negative integer")
    return max(1, int(n).bit_length())


def bits_for_arr(n: np.ndarray) -> np.ndarray:
    """Vectorized bits_for over a numpy integer array (result uint8)."""
    n = np.asarray(n)
    out = np.zeros(n.shape, dtype=np.uint8)
    v = n.astype(np.uint64).copy()
    # binary count of leading-bit position via repeated halving of shift width
    for shift in (32, 16, 8, 4, 2, 1):
        mask = v >= (np.uint64(1) << np.uint64(shift))
        out[mask] += np.uint8(shift)
        v[mask] >>= np.uint64(shift)
    out += 1  # v is now 0 or 1; width of remaining bit
    np.maximum(out, 1, out=out)
    return out
