"""Paranoid invariant checks (reference ``IF_PARANOID``).

The checks of ``tudocomp_tpu/debug.py`` that the port's suffix and BWT
code runs, copied. ``TDC_PARANOID=1`` (read once at import; the test
suite sets it) arms them; production runs pay nothing:

- ``assert_permutation``: permutation validity (``util.hpp:449-473``);
- ``check_lf``: the BWT LF-mapping invariant (``ds/bwt.hpp:55-65``).
"""

from __future__ import annotations

import os

import numpy as np

PARANOID = os.environ.get("TDC_PARANOID", "0") not in ("", "0")


class InvariantError(AssertionError):
    pass


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
