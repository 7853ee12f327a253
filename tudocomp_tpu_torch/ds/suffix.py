"""Text data structures: SA / ISA / Phi / PLCP / LCP (host).

Copy of ``tudocomp_tpu/ds/suffix.py`` (re-design of the reference's
provider stack ``ds/SADivSufSort.hpp``, ``ds/ISAFromSA.hpp``,
``ds/PhiFromSA.hpp``, ``ds/PLCPFromPhi.hpp``, ``ds/LCPFromPLCP.hpp``).
The suffix array comes from the host library's SA-IS and the PLCP from
its Phi walk (``csrc/host/``, the constructions the JAX package runs
when its native library is built); the port has no Python fallback.

All providers operate on a text that ends with a unique 0 sentinel when
used by compressors that declare it (BWT, lzss_lcp).
"""

from __future__ import annotations

import numpy as np

from tudocomp_tpu_torch import native
from tudocomp_tpu_torch.debug import assert_permutation
from tudocomp_tpu_torch.ds.rank_select import CompressedLCP, SparseISA


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



def inverse_suffix_array(sa: np.ndarray) -> np.ndarray:
    """ISA: inverse permutation (reference ``ISAFromSA.hpp:30-39``)."""
    isa = np.empty_like(sa)
    isa[sa] = np.arange(sa.size, dtype=sa.dtype)
    return isa


def phi_array(sa: np.ndarray) -> np.ndarray:
    """Phi[sa[i]] = sa[i-1]; Phi[sa[0]] = sa[n-1].

    (Reference ``PhiFromSA.hpp:33-45``.)
    """
    phi = np.empty_like(sa)
    phi[sa[1:]] = sa[:-1]
    if sa.size:
        phi[sa[0]] = sa[-1]
    return phi


def plcp_array(text, phi: np.ndarray) -> np.ndarray:
    """PLCP via Kärkkäinen's Phi-algorithm (amortized O(n); reference
    ``PLCPFromPhi.hpp`` / ``LCPSada.hpp:38-58``)."""
    t = np.frombuffer(bytes(text), np.uint8) if isinstance(
        text, (bytes, bytearray)
    ) else np.asarray(text, dtype=np.uint8)
    return native.plcp(t, phi)


def lcp_array(sa: np.ndarray, plcp: np.ndarray) -> np.ndarray:
    """LCP[i] = PLCP[SA[i]] (reference ``LCPFromPLCP.hpp:36-52``); LCP[0]=0."""
    lcp = plcp[sa]
    if lcp.size:
        lcp[0] = 0
    return lcp


class TextDS:
    """On-demand SA/ISA/Phi/PLCP/LCP facade (reference ``ds/TextDS.hpp``).

    Construction is lazy: each structure is built on first access, reusing
    previously built ones.
    """

    def __init__(self, text: bytes):
        self.text = np.frombuffer(bytes(text), np.uint8)
        self._sa = None
        self._isa = None
        self._phi = None
        self._plcp = None
        self._lcp = None
        self._isa_sparse = None
        self._lcp_compressed = None

    @property
    def size(self) -> int:
        return self.text.size

    def require_sa(self) -> np.ndarray:
        if self._sa is None:
            self._sa = suffix_array(self.text)
        return self._sa

    def require_isa(self) -> np.ndarray:
        if self._isa is None:
            self._isa = inverse_suffix_array(self.require_sa())
        return self._isa

    def require_phi(self) -> np.ndarray:
        if self._phi is None:
            self._phi = phi_array(self.require_sa())
        return self._phi

    def require_plcp(self) -> np.ndarray:
        if self._plcp is None:
            self._plcp = plcp_array(self.text, self.require_phi())
            # Phi is a pure construction helper for PLCP — drop it
            # immediately (reference release lifecycle); a later
            # require_phi rebuilds in one scan if ever needed
            self._phi = None
        return self._plcp

    def require_lcp(self) -> np.ndarray:
        if self._lcp is None:
            self._lcp = lcp_array(self.require_sa(), self.require_plcp())
        return self._lcp

    def discard(self, *names: str) -> None:
        """Drop cached structures (reference ``TextDS`` release/discard
        lifecycle, ``ds/TextDS.hpp:247-292``): construction helpers like
        Phi/PLCP can be freed once LCP exists."""
        for name in names:
            setattr(self, f"_{name}", None)

    # -- compressed-space degree (reference TextDS.hpp compressed_space:
    # structures answer point queries from o(n)-extra-bit storage) ------

    def require_isa_sparse(self, t: int = 3):
        """ISA as a SparseISA (every t-th entry + cycle walking,
        reference ``ds/SparseISA.hpp``)."""
        if self._isa_sparse is None:
            self._isa_sparse = SparseISA(self.require_sa(), t)
        return self._isa_sparse

    def require_lcp_compressed(self):
        """LCP answered from the bit-compressed PLCP encoding
        (reference ``ds/CompressedLCP.hpp`` / LCPForwardIterator)."""
        if self._lcp_compressed is None:
            self._lcp_compressed = CompressedLCP(
                self.require_sa(), self.require_plcp()
            )
        return self._lcp_compressed
