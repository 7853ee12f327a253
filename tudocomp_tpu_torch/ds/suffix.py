"""Host suffix array.

The part of ``tudocomp_tpu/ds/suffix.py`` that the port's ``bwt`` runs:
``suffix_array`` by the host library's SA-IS (``csrc/host/suffix.cpp``,
the same construction the JAX package runs when its native library is
built; the port has no Python fallback). The rest of that module (ISA,
Phi, PLCP, LCP, ``TextDS``) comes with the factorizers that use it.
"""

from __future__ import annotations

import numpy as np

from tudocomp_tpu_torch import native
from tudocomp_tpu_torch.debug import assert_permutation


def suffix_array(text) -> np.ndarray:
    """Suffix array of ``text`` (bytes or u8 array): int32 for n < 2^31."""
    t = np.frombuffer(bytes(text), np.uint8) if isinstance(
        text, (bytes, bytearray)
    ) else np.asarray(text, dtype=np.uint8)
    if t.size == 0:
        return np.zeros(0, np.int64)
    sa = native.suffix_array(t)
    assert_permutation(sa, t.size)  # paranoid (util.hpp:449-473)
    return sa

