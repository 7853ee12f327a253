"""Debug and paranoid invariant checks (reference ``IF_DEBUG`` /
``IF_PARANOID``).

The checks of ``tudocomp_tpu/debug.py`` that the port's suffix, BWT and
ESP code runs, copied. ``TDC_DEBUG=1`` arms the cheap ones and
``TDC_PARANOID=1`` (which implies debug) all of them; both are read
once at import (the test suite sets them); production runs pay nothing:

- ``check_kraft``: Kraft equality of an optimal code-length vector
  (``HuffmanCoder.hpp:143-166``; debug level);
- ``assert_permutation``: permutation validity (``util.hpp:449-473``);
- ``check_lf``: the BWT LF-mapping invariant (``ds/bwt.hpp:55-65``).
"""

from __future__ import annotations

import os

import numpy as np

PARANOID = os.environ.get("TDC_PARANOID", "0") not in ("", "0")
DEBUG = PARANOID or os.environ.get("TDC_DEBUG", "0") not in ("", "0")


class InvariantError(AssertionError):
    pass


def check_kraft(lengths: np.ndarray) -> None:
    """Kraft equality of an optimal code-length vector (debug level)."""
    if not DEBUG or lengths.size == 0:
        return
    ls = np.asarray(lengths, np.int64)
    if (ls <= 0).any() or (ls > 63).any():
        raise InvariantError(f"invalid code lengths: {ls}")
    kraft = (np.exp2(-ls.astype(np.float64))).sum()
    if abs(kraft - 1.0) > 1e-9:
        raise InvariantError(f"Kraft sum {kraft} != 1 for {ls}")


def assert_permutation(arr: np.ndarray, n: int | None = None) -> None:
    """``arr`` is a permutation of [0, n) (paranoid level)."""
    if not PARANOID:
        return
    a = np.asarray(arr, np.int64)
    if n is None:
        n = a.size
    if a.size != n:
        raise InvariantError(f"permutation size {a.size} != {n}")
    seen = np.zeros(n, bool)
    if (a < 0).any() or (a >= n).any():
        raise InvariantError("permutation value out of range")
    seen[a] = True
    if not seen.all():
        raise InvariantError("permutation misses values")


def check_lf(lf: np.ndarray, bwt: np.ndarray) -> None:
    """LF-mapping invariant: LF is a permutation and characters map in
    nondecreasing rank order within equal symbols (paranoid level)."""
    if not PARANOID:
        return
    assert_permutation(lf)
    b = np.asarray(bwt)
    order = np.argsort(np.asarray(lf, np.int64), kind="stable")
    sorted_chars = b[order]
    if (np.diff(sorted_chars.astype(np.int64)) < 0).any():
        raise InvariantError("LF does not sort BWT characters")
