"""Host TBC2 parse and decode, the host Huffman decode, the host suffix
array, the host BWT decode and the host LZ77 (factorizer, PLCP,
factor-stream decode, VLC literal tail).

Bindings of ``csrc/host/tbc2.cpp``, ``csrc/host/suffix.cpp`` and
``csrc/host/lzss.cpp`` (built by ``_build.build_host``); counterparts
of ``tudocomp_tpu/native.py``'s ``tbc2_parse``, ``tbc2_decode``,
``huffman_decode``, ``suffix_array`` (its SA-IS), ``bwt_decode``,
``lzss_lcp_factorize``, ``plcp``, ``lzss_decode_stream`` and
``vlc_literals``. A failed build raises: there is no Python fallback.
"""

from __future__ import annotations

import ctypes
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


def lzss_lcp_factorize(sa, isa, lcp, threshold: int):
    """PSV/NSV factorization over SA/ISA/LCP. Returns (pos, src, len)
    arrays of the inputs' index dtype (int32 or int64)."""
    lib = _build.host_lib()
    dt = np.int32 if np.asarray(sa).dtype == np.int32 else np.int64
    fn = (lib.tdc_lzss_lcp_factorize32 if dt == np.int32
          else lib.tdc_lzss_lcp_factorize)
    sa = np.ascontiguousarray(sa, dt)
    isa = np.ascontiguousarray(isa, dt)
    lcp = np.ascontiguousarray(lcp, dt)
    n = sa.size
    # each factor advances the scan by >= max(1, threshold) positions
    cap = max(16, n // max(1, threshold) + 1)
    pos = np.empty(cap, dt)
    src = np.empty(cap, dt)
    length = np.empty(cap, dt)
    got = fn(_ptr(sa), _ptr(isa), _ptr(lcp), n, threshold, _ptr(pos),
             _ptr(src), _ptr(length), cap)
    if got < 0:
        raise RuntimeError("factor buffer overflow")
    return pos[:got], src[:got], length[:got]


def plcp(text: np.ndarray, phi: np.ndarray) -> np.ndarray:
    """Karkkainen PLCP; the output dtype follows ``phi`` (int32 for
    n < 2^31)."""
    lib = _build.host_lib()
    t = np.ascontiguousarray(text, np.uint8)
    if np.asarray(phi).dtype == np.int32:
        ph = np.ascontiguousarray(phi, np.int32)
        out = np.empty(t.size, np.int32)
        lib.tdc_plcp32(_ptr(t), _ptr(ph), t.size, _ptr(out))
    else:
        ph = np.ascontiguousarray(phi, np.int64)
        out = np.empty(t.size, np.int64)
        lib.tdc_plcp(_ptr(t), _ptr(ph), t.size, _ptr(out))
    return out


def lzss_decode_stream(payload, nbits, start_bit, n, flen_min,
                       w_src, w_len, w_dist, lut=None, mode=0,
                       code_kind=0):
    """Factor-stream decode. mode 0 -> text bytes; mode 1 ->
    (literals, pos, src, len). ``code_kind``: 0 = fixed widths (with
    Huffman LUT literals when ``lut`` is given), 1/2/3/4 =
    gamma/delta/ternary/ascii fields. A malformed stream raises
    ``ValueError``, an overflow of the output ``RuntimeError``."""
    payload = np.ascontiguousarray(payload, np.uint8)
    if lut is None:
        lut_sym = lut_len = _EMPTY_LUT
        k = 0
    else:
        lut_sym, lut_len, k = lut
        lut_sym = np.ascontiguousarray(lut_sym, np.uint8)
        lut_len = np.ascontiguousarray(lut_len, np.uint8)
    out_cap = max(64, n + 64)
    out = np.empty(out_cap, np.uint8)
    fcap = max(16, n + 1)
    fpos = np.empty(fcap, np.int64)
    fsrc = np.empty(fcap, np.int64)
    flen = np.empty(fcap, np.int64)
    nfac = ctypes.c_int64(0)
    got = _build.host_lib().tdc_lzss_decode(
        _ptr(payload), nbits, start_bit, n, flen_min, w_src, w_len,
        w_dist, _ptr(lut_sym), _ptr(lut_len), k, mode, code_kind,
        _ptr(out), out_cap, _ptr(fpos), _ptr(fsrc), _ptr(flen), fcap,
        ctypes.addressof(nfac),
    )
    if got == -2:
        raise ValueError("malformed factor stream")
    if got < 0:
        raise RuntimeError("factor decode overflow")
    if mode == 0:
        return out[:got].tobytes()
    m = nfac.value
    return out[:got], fpos[:m], fsrc[:m], flen[:m]


def vlc_literals(payload: np.ndarray, nbits: int, start_bit: int,
                 kind: int):
    """Decode a whole gamma(1)/delta(2)/ternary(3) literal tail; None on
    a stream that is not a literal tail (the caller walks it symbol by
    symbol)."""
    payload = np.ascontiguousarray(payload, np.uint8)
    cap = max(64, nbits)
    while True:
        out = np.empty(cap, np.uint8)
        got = _build.host_lib().tdc_vlc_literals(
            _ptr(payload), nbits, start_bit, kind, _ptr(out), cap)
        if got == -2:
            return None
        if got >= 0:
            return out[:got].tobytes()
        cap *= 4
