"""Burrows-Wheeler transform on the host.

The port's copy of ``tudocomp_tpu/ds/bwt.py``'s transform and LF map
(reference ``ds/bwt.hpp:20-98``): forward ``BWT[i] = text[(SA[i] - 1)
mod n]``, a gather; the LF mapping is the inverse of the BWT's stable
argsort. The decode walk itself is the host library's
(``native.bwt_decode``).
"""

from __future__ import annotations

import numpy as np


def bwt_forward(text: np.ndarray, sa: np.ndarray) -> np.ndarray:
    t = np.asarray(text, np.uint8)
    return t[(sa - 1) % t.size] if t.size else t


def compute_lf(bwt: np.ndarray) -> np.ndarray:
    """LF[i] = C[bwt[i]] + rank of i among equal symbols (stable)."""
    order = np.argsort(bwt, kind="stable")
    lf = np.empty(bwt.size, np.int64)
    lf[order] = np.arange(bwt.size)
    return lf
