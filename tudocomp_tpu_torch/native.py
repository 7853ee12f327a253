"""Host TBC2 parse and decode, the host Huffman decode, the host suffix
array and the host BWT decode.

Bindings of ``csrc/host/tbc2.cpp`` and ``csrc/host/suffix.cpp`` (built
by ``_build.build_host``); counterparts of ``tudocomp_tpu/native.py``'s
``tbc2_parse``, ``tbc2_decode``, ``huffman_decode``, ``suffix_array``
(its SA-IS) and ``bwt_decode``. A failed build raises: there is no
Python fallback.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from tudocomp_tpu_torch import _build

_EMPTY_LUT = np.zeros(1, np.uint8)


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def huffman_decode(payload: np.ndarray, count: int, lut_sym: np.ndarray,
                   lut_len: np.ndarray, k: int) -> np.ndarray:
    """Decode ``count`` symbols from an MSB-first payload with a full
    ``k``-bit decode LUT (``HuffmanTable.build_lut``)."""
    payload = np.ascontiguousarray(payload, np.uint8)
    lut_sym = np.ascontiguousarray(lut_sym, np.uint8)
    lut_len = np.ascontiguousarray(lut_len, np.uint8)
    out = np.empty(count, np.uint8)
    got = _build.host_lib().tdc_huffman_decode(
        _ptr(payload), payload.size, count, _ptr(lut_sym), _ptr(lut_len),
        k, _ptr(out),
    )
    if got < 0:
        raise ValueError("malformed huffman stream")
    return out


def tbc2_parse(data: bytes, pos: int, nseg: int):
    """Parse ``nseg`` TBC2 frames starting at ``pos``. Returns
    ``(counts u32, flags u8, poff i64, pbytes i64)``."""
    buf = np.frombuffer(data, np.uint8)
    counts = np.empty(max(nseg, 1), np.uint32)
    flags = np.empty(max(nseg, 1), np.uint8)
    poff = np.empty(max(nseg, 1), np.int64)
    pbytes = np.empty(max(nseg, 1), np.int64)
    got = _build.host_lib().tdc_tbc2_parse(
        _ptr(buf), buf.size, pos, nseg, _ptr(counts), _ptr(flags),
        _ptr(poff), _ptr(pbytes),
    )
    if got < 0:
        raise ValueError("malformed TBC2 container")
    return counts[:nseg], flags[:nseg], poff[:nseg], pbytes[:nseg]


def tbc2_decode(data: bytes, counts, flags, poff, pbytes, orig_len: int,
                seg: int, table, offset: int) -> bytes:
    """Decode every TBC2 segment on host cores: the library call drops
    the interpreter lock, so a thread pool runs segment ranges in
    parallel."""
    lib = _build.host_lib()
    buf = np.frombuffer(data, np.uint8)
    counts = np.ascontiguousarray(counts, np.uint32)
    flags = np.ascontiguousarray(flags, np.uint8)
    poff = np.ascontiguousarray(poff, np.int64)
    pbytes = np.ascontiguousarray(pbytes, np.int64)
    nseg = counts.size
    if table is not None:
        lut_sym, lut_len = table.build_lut()
        k = table.longest
    else:
        lut_sym = lut_len = _EMPTY_LUT
        k = 0
    out = np.empty(orig_len, np.uint8)

    def run(lo: int, hi: int) -> int:
        return lib.tdc_tbc2_decode(
            _ptr(buf), _ptr(counts), _ptr(flags), _ptr(poff), _ptr(pbytes),
            lo, hi, _ptr(lut_sym), _ptr(lut_len), k, seg, orig_len, offset,
            _ptr(out),
        )

    if nseg >= 64:
        nw = min(os.cpu_count() or 4, 16)
        step = -(-nseg // nw)
        with ThreadPoolExecutor(nw) as ex:
            rets = list(ex.map(lambda lo: run(lo, min(lo + step, nseg)),
                               range(0, nseg, step)))
    else:
        rets = [run(0, nseg)]
    if any(r < 0 for r in rets):
        raise ValueError("malformed TBC2 payload")
    return out.tobytes()


def suffix_array(text: np.ndarray) -> np.ndarray:
    """Suffix array of the bytes ``text`` by SA-IS (linear time): int32
    for n < 2^31, int64 above, as the JAX package's."""
    t = np.ascontiguousarray(text, np.uint8)
    if t.size < (1 << 31):
        out = np.empty(t.size, np.int32)
        _build.host_lib().tdc_suffix_array_sais32(_ptr(t), t.size, _ptr(out))
    else:
        out = np.empty(t.size, np.int64)
        _build.host_lib().tdc_suffix_array_sais(_ptr(t), t.size, _ptr(out))
    return out


def bwt_decode(bwt_bytes: bytes) -> bytes:
    """Inverse BWT of a 0-sentineled text's transform by the LF walk;
    returns the text without its sentinel."""
    inp = np.frombuffer(bwt_bytes, np.uint8)
    if inp.size <= 1:
        return b""
    out = np.empty(inp.size - 1, np.uint8)
    _build.host_lib().tdc_bwt_decode(_ptr(inp), _ptr(out), inp.size)
    return out.tobytes()
