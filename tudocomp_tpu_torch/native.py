"""Host TBC2 parse and decode, the host Huffman decode and count, the
host suffix array, the host BWT decode, the host LZ77 (factorizer, PLCP,
factor-stream decode, VLC literal tail), the host lcpcomp (arrays, heap
and bulldozer factorizers, compact decode), the host SLE coder, the host
ESP (round loop, SLP derivation and dependency sort, monotone
decomposition), MTF, RLE decode, the arithmetic coder, the
sliding-window LZSS, LZ78 and LZW, Re-Pair, LZ78U, the suffix tree and
LFS.

Bindings of ``csrc/host/*.cpp`` (built by ``_build.build_host``);
counterparts of ``tudocomp_tpu/native.py``'s ``tbc2_parse``,
``tbc2_decode``, ``huffman_decode``, ``huffman_count``, ``suffix_array``
(its SA-IS), ``bwt_decode``, ``lzss_lcp_factorize``, ``plcp``,
``lzss_decode_stream``, ``vlc_literals``, ``lcpcomp_factorize``,
``lcpcomp_compact_decode``, ``lcpcomp_bulldozer``, ``sle_rank``,
``sle_run_tokens``, ``sle_decode``, ``factor_stream_sle_encode``,
``lzss_decode_stream_sle``, ``esp_rounds``, ``slp_derive``,
``slp_dep_sort``, ``monotone_decompose``, ``mtf_encode``,
``mtf_decode``, ``mtf_stream``, ``rle_decode``, ``rle_decode_stream``,
``arith_encode``, ``arith_decode``, ``lzss_window_decode``,
``lzss_window_encode_stream``, ``LzssDecStream``,
``lz78_stream_decode``, ``lzw_stream_decode``, ``Lz78Stream``,
``Lz78DecStream``, ``repair``, ``repair_decode``, ``lz78u_parse``,
``lz78u_decode``, ``suffix_tree``, ``lfs_parse``, ``lfs2_parse``,
``lfs_simst``, ``lfs_bst``, ``lfs_start_decode`` and ``lfs2_decode``. A
failed build raises: there is no Python fallback. A wrapper returns None
only where the JAX wrapper does for a reason other than a missing
library, which sends its caller down the same Python path:
``esp_rounds`` (no input, ``n >= 2**31``, a full rule buffer),
``repair`` (``n >= 2**31``, a rule overflow), ``lfs_simst`` and
``lfs_bst`` (an occurrence overflow).
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


def lcpcomp_factorize(sa, isa, lcp, threshold: int, strategy="arrays"):
    """lcpcomp ``arrays`` or ``heap`` factorization over SA/ISA/LCP (the
    LCP is copied, the library truncates its copy). Returns (pos, src,
    len) arrays of the inputs' index dtype (int32 or int64)."""
    lib = _build.host_lib()
    dt = np.int32 if np.asarray(sa).dtype == np.int32 else np.int64
    name = "tdc_lcpcomp_" + ("heap" if strategy == "heap" else "arrays")
    fn = getattr(lib, name + ("32" if dt == np.int32 else ""))
    sa = np.ascontiguousarray(sa, dt)
    isa = np.ascontiguousarray(isa, dt)
    lcp = np.array(lcp, dt)
    n = sa.size
    # every factor zeroes >= threshold LCP entries, so the count is
    # bounded by n / max(1, threshold)
    cap = max(16, n // max(1, threshold) + 1)
    pos = np.empty(cap, dt)
    src = np.empty(cap, dt)
    length = np.empty(cap, dt)
    got = fn(_ptr(sa), _ptr(isa), _ptr(lcp), n, threshold, _ptr(pos),
             _ptr(src), _ptr(length), cap)
    if got < 0:
        raise RuntimeError("factor buffer overflow")
    return pos[:got], src[:got], length[:got]


def lcpcomp_bulldozer(sa, lcp, threshold: int):
    """The bulldozer interval sweep: (pos, src, len) int64 arrays."""
    sa = np.ascontiguousarray(sa, np.int64)
    lcp = np.ascontiguousarray(lcp, np.int64)
    n = sa.size
    cap = max(16, n + 1)
    fpos = np.empty(cap, np.int64)
    fsrc = np.empty(cap, np.int64)
    flen = np.empty(cap, np.int64)
    got = _build.host_lib().tdc_lcpcomp_bulldozer(
        _ptr(sa), _ptr(lcp), n, threshold, _ptr(fpos), _ptr(fsrc),
        _ptr(flen), cap)
    if got < 0:
        raise RuntimeError("factor buffer overflow")
    return fpos[:got], fsrc[:got], flen[:got]


def lcpcomp_compact_decode(n, lit_bytes, lit_pos, fpos, fsrc, flen) -> bytes:
    """CompactDec's forward-bucket resolution of ``n`` bytes."""
    lit_bytes = np.ascontiguousarray(lit_bytes, np.uint8)
    lit_pos = np.ascontiguousarray(lit_pos, np.int64)
    fpos = np.ascontiguousarray(fpos, np.int64)
    fsrc = np.ascontiguousarray(fsrc, np.int64)
    flen = np.ascontiguousarray(flen, np.int64)
    out = np.empty(n, np.uint8)
    got = _build.host_lib().tdc_lcpcomp_compact(
        n, _ptr(lit_bytes), _ptr(lit_pos), lit_pos.size, _ptr(fpos),
        _ptr(fsrc), _ptr(flen), fpos.size, _ptr(out))
    if got == -2:
        raise ValueError("malformed lcpcomp factor stream")
    if got == -3:
        raise ValueError("unresolvable lcpcomp factor chain")
    return out.tobytes()


def sle_rank(chars: np.ndarray, kk: int, max_kmers: int, max_lits: int):
    """SLE rank tables: (k-mer keys int64, literal bytes u8), each by
    descending count, ties by value."""
    chars = np.ascontiguousarray(chars, np.uint8)
    keys = np.empty(max(1, max_kmers), np.int64)
    lits = np.empty(max(1, max_lits), np.uint8)
    n_lits = ctypes.c_int64(0)
    nk = _build.host_lib().tdc_sle_rank(
        _ptr(chars), chars.size, kk, _ptr(keys), max_kmers, _ptr(lits),
        max_lits, ctypes.addressof(n_lits))
    return keys[:nk], lits[: n_lits.value]


def sle_run_tokens(buf: np.ndarray, limit: int, sorted_keys: np.ndarray,
                   key_rank: np.ndarray, kk: int, lit_rank: np.ndarray):
    """SLE greedy-matcher tokens for the emissions of one literal run
    that start below ``limit``: (consumed, values u64, lens i64)."""
    buf = np.ascontiguousarray(buf, np.uint8)
    sorted_keys = np.ascontiguousarray(sorted_keys, np.int64)
    key_rank = np.ascontiguousarray(key_rank, np.int64)
    lit_rank = np.ascontiguousarray(lit_rank, np.int32)
    n = buf.size
    cap = 3 * max(1, n) + 4
    values = np.empty(cap, np.uint64)
    lens = np.empty(cap, np.int64)
    ntok = ctypes.c_int64(0)
    got = _build.host_lib().tdc_sle_run_tokens(
        _ptr(buf), n, limit, _ptr(sorted_keys), _ptr(key_rank),
        sorted_keys.size, kk, _ptr(lit_rank), _ptr(values), _ptr(lens),
        cap, ctypes.addressof(ntok))
    if got < 0:
        raise RuntimeError("sle token overflow")
    m = ntok.value
    return int(got), values[:m], lens[:m]


def _sle_tables(kmers: bytes, lits: bytes):
    """The k-mer and literal tables as u8 arrays (one zero byte when
    empty: the library reads no entry of an empty table)."""
    km = np.frombuffer(kmers, np.uint8) if kmers else np.zeros(1, np.uint8)
    lt = np.frombuffer(lits, np.uint8) if lits else np.zeros(1, np.uint8)
    return km, lt


def sle_decode(payload, nbits, start_bit, kmers: bytes, n_kmers, k,
               lits: bytes) -> bytes:
    """Decode an SLE literal stream from ``start_bit`` to ``nbits``."""
    payload = np.ascontiguousarray(payload, np.uint8)
    km, lt = _sle_tables(kmers, lits)
    cap = max(64, nbits)
    while True:
        out = np.empty(cap, np.uint8)
        got = _build.host_lib().tdc_sle_decode(
            _ptr(payload), nbits, start_bit, _ptr(km), n_kmers, k, _ptr(lt),
            len(lits), _ptr(out), cap)
        if got == -2:
            raise ValueError("malformed sle stream")
        if got >= 0:
            return out[:got].tobytes()
        cap *= 4


def factor_stream_sle_encode(text: np.ndarray, fpos, fsrc, flen,
                             w_src: int, w_len: int, w_dist: int,
                             flen_min: int, sorted_keys, key_rank,
                             kk: int, lit_rank):
    """The factor-stream body after its 4 header fields, with SLE-coded
    gap literals: (values u64, lens i64) tokens."""
    text = np.ascontiguousarray(text, np.uint8)
    fpos = np.ascontiguousarray(fpos, np.int64)
    fsrc = np.ascontiguousarray(fsrc, np.int64)
    flen = np.ascontiguousarray(flen, np.int64)
    sorted_keys = np.ascontiguousarray(sorted_keys, np.int64)
    key_rank = np.ascontiguousarray(key_rank, np.int64)
    lit_rank = np.ascontiguousarray(lit_rank, np.int32)
    gap_bytes = text.size - int(flen.sum())
    cap = 3 * max(1, gap_bytes) + 4 * fpos.size + 8
    values = np.empty(cap, np.uint64)
    lens = np.empty(cap, np.int64)
    got = _build.host_lib().tdc_factor_stream_sle(
        _ptr(text), text.size, _ptr(fpos), _ptr(fsrc), _ptr(flen),
        fpos.size, w_src, w_len, w_dist, flen_min, _ptr(sorted_keys),
        _ptr(key_rank), sorted_keys.size, kk, _ptr(lit_rank), _ptr(values),
        _ptr(lens), cap)
    if got < 0:
        raise RuntimeError("sle factor-stream token overflow")
    return values[:got], lens[:got]


def lzss_decode_stream_sle(payload, nbits, start_bit, n, flen_min,
                           w_src, w_len, w_dist, kmers: bytes, kk: int,
                           lits: bytes, mode=0):
    """Factor-stream decode with SLE-coded gap literals; returns as
    :func:`lzss_decode_stream` does."""
    payload = np.ascontiguousarray(payload, np.uint8)
    km, lt = _sle_tables(kmers, lits)
    out_cap = max(64, n + 64)
    out = np.empty(out_cap, np.uint8)
    fcap = max(16, n + 1)
    fpos = np.empty(fcap, np.int64)
    fsrc = np.empty(fcap, np.int64)
    flen = np.empty(fcap, np.int64)
    nfac = ctypes.c_int64(0)
    got = _build.host_lib().tdc_lzss_decode_sle(
        _ptr(payload), nbits, start_bit, n, flen_min, w_src, w_len, w_dist,
        _ptr(km), len(kmers) // kk if kmers else 0, kk, _ptr(lt),
        len(lits), mode, _ptr(out), out_cap, _ptr(fpos), _ptr(fsrc),
        _ptr(flen), fcap, ctypes.addressof(nfac))
    if got == -2:
        raise ValueError("malformed sle factor stream")
    if got < 0:
        raise RuntimeError("factor decode overflow")
    if mode == 0:
        return out[:got].tobytes()
    m = nfac.value
    return out[:got], fpos[:m], fsrc[:m], flen[:m]


def huffman_count(payload: np.ndarray, nbits: int, lut_len: np.ndarray,
                  k: int) -> int:
    """The count of symbols decodable from the first ``nbits`` bits of
    an MSB-first payload with a full ``k``-bit length LUT."""
    payload = np.ascontiguousarray(payload, np.uint8)
    lut_len = np.ascontiguousarray(lut_len, np.uint8)
    got = _build.host_lib().tdc_huffman_count(_ptr(payload), nbits,
                                              _ptr(lut_len), k)
    if got < 0:
        raise ValueError("malformed huffman stream")
    return int(got)


def esp_rounds(data: bytes):
    """The whole ESP grammar (bit-identical to ``esp_rounds``' Python
    loop): (rules int64[R, 2], root), or None for no input, for
    ``n >= 2**31`` and when the rule buffer fills."""
    n = len(data)
    if n == 0 or n >= (1 << 31):
        return None
    buf = np.frombuffer(data, np.uint8)
    cap = n + 16
    rules_out = np.empty(2 * cap, np.int32)
    root = ctypes.c_int64(0)
    got = _build.host_lib().tdc_esp_rounds(
        _ptr(buf), n, _ptr(rules_out), cap, ctypes.addressof(root))
    if got < 0:
        return None
    rules = rules_out[: 2 * got].astype(np.int64).reshape(-1, 2)
    return rules, int(root.value)


def slp_derive(pairs: np.ndarray, root: int) -> bytes:
    """Expand a binary SLP (terminals below 256) from ``root``."""
    pairs = np.ascontiguousarray(pairs, np.int64).reshape(-1)
    cap = 1 << 16
    while True:
        out = np.empty(cap, np.uint8)
        got = _build.host_lib().tdc_slp_derive(
            _ptr(pairs), pairs.size // 2, root, _ptr(out), cap)
        if got == -2:
            raise ValueError("invalid SLP rule reference")
        if got >= 0:
            return out[:got].tobytes()
        cap *= 4


def slp_dep_sort(rules: np.ndarray, root: int):
    """Dependency sort (the permutation of ``slp_dep_sort``'s heap):
    (sorted rules, new root)."""
    rules = np.ascontiguousarray(rules, np.int64)
    n = rules.shape[0]
    out = np.empty((max(n, 1), 2), np.int64)
    new_root = ctypes.c_int64(0)
    got = _build.host_lib().tdc_slp_dep_sort(
        _ptr(rules), n, root, _ptr(out), ctypes.addressof(new_root))
    if got < 0:
        raise ValueError("SLP dependency cycle")
    return out[:n], int(new_root.value)


def monotone_decompose(sis: np.ndarray):
    """Rounds of the longest monotone subsequence of a permutation:
    (Dpi int64, b u8 directions)."""
    sis = np.ascontiguousarray(sis, np.int64)
    n = sis.size
    dpi = np.empty(max(n, 1), np.int64)
    b = np.empty(max(n, 1), np.uint8)
    got = _build.host_lib().tdc_monotone_decompose(
        _ptr(sis), n, _ptr(dpi), _ptr(b), max(n, 1))
    if got < 0:
        raise RuntimeError("decomposition overflow")
    return dpi[:n], b[:got]


def _mtf(fn_name: str, data: bytes) -> bytes:
    inp = np.frombuffer(data, np.uint8)
    out = np.empty(inp.size, np.uint8)
    getattr(_build.host_lib(), fn_name)(_ptr(inp), _ptr(out), inp.size)
    return out.tobytes()


def mtf_encode(data: bytes) -> bytes:
    return _mtf("tdc_mtf_encode", data)


def mtf_decode(data: bytes) -> bytes:
    return _mtf("tdc_mtf_decode", data)


def mtf_stream(data: bytes, table: np.ndarray, decode: bool = False) -> bytes:
    """One MTF chunk with the carried 256-entry table (u8, updated in
    place)."""
    if table.dtype != np.uint8 or table.size != 256 \
            or not table.flags.c_contiguous:
        raise ValueError("mtf_stream needs a contiguous u8[256] table")
    inp = np.frombuffer(data, np.uint8)
    out = np.empty(inp.size, np.uint8)
    lib = _build.host_lib()
    fn = lib.tdc_mtf_decode_s if decode else lib.tdc_mtf_encode_s
    fn(_ptr(inp), _ptr(out), inp.size, _ptr(table))
    return out.tobytes()


def rle_decode(arr: np.ndarray, offset: int = 0) -> bytes:
    """Decode a whole RLE stream (``compressors/rle.py``'s format)."""
    inp = np.ascontiguousarray(arr, np.uint8)
    cap = max(64, inp.size * 4)
    while True:
        out = np.empty(cap, np.uint8)
        got = _build.host_lib().tdc_rle_decode(_ptr(inp), inp.size,
                                               _ptr(out), cap, offset)
        if got == -2:
            raise ValueError("malformed RLE stream")
        if got >= 0:
            return out[:got].tobytes()
        cap *= 4


def rle_decode_stream(chunk: np.ndarray, offset: int, prev: int,
                      final: bool):
    """Decode one RLE chunk: (out bytes, consumed, prev'). The
    unconsumed tail (a token cut by the chunk's end) is fed again with
    the next chunk."""
    inp = np.ascontiguousarray(chunk, np.uint8)
    cap = max(4096, inp.size * 4)
    while True:
        out = np.empty(cap, np.uint8)
        prev_io = ctypes.c_int64(prev)
        consumed = ctypes.c_int64(0)
        got = _build.host_lib().tdc_rle_decode_s(
            _ptr(inp), inp.size, _ptr(out), cap, offset,
            ctypes.addressof(prev_io), 1 if final else 0,
            ctypes.addressof(consumed))
        if got == -2:
            raise ValueError("malformed RLE stream")
        if got >= 0:
            return out[:got].tobytes(), int(consumed.value), \
                int(prev_io.value)
        cap *= 4


def arith_encode(data: np.ndarray, cum: np.ndarray, total: int):
    """The arithmetic coder's 64-bit block codes of a literal stream,
    the final lower and the terminator included."""
    data = np.ascontiguousarray(data, np.uint8)
    cum = np.ascontiguousarray(cum, np.uint64)
    cap = max(16, data.size // 4 + 16)
    while True:
        out = np.empty(cap, np.uint64)
        got = _build.host_lib().tdc_arith_encode(
            _ptr(data), data.size, _ptr(cum), total, _ptr(out), cap)
        if got >= 0:
            return out[:got]
        cap *= 4


def arith_decode(payload: np.ndarray, nbits: int, start_bit: int,
                 syms: np.ndarray, cums: np.ndarray, total: int,
                 count: int) -> np.ndarray:
    """Decode ``count`` literals from the arithmetic block stream;
    raises ``ValueError`` on a malformed stream."""
    payload = np.ascontiguousarray(payload, np.uint8)
    syms = np.ascontiguousarray(syms, np.uint8)
    cums = np.ascontiguousarray(cums, np.uint64)
    out = np.empty(max(1, count), np.uint8)
    got = _build.host_lib().tdc_arith_decode(
        _ptr(payload), nbits, start_bit, _ptr(syms), _ptr(cums), syms.size,
        total, count, _ptr(out))
    if got == -2:
        raise ValueError("malformed arithmetic stream")
    return out[:count]


# ---- lz78 and lzw (csrc/host/lz78.cpp) ------------------------------------

def _stream_decode(fn_name, payload, nbits, start_bit, code_kind,
                   dict_max) -> bytes:
    payload = np.ascontiguousarray(payload, np.uint8)
    fn = getattr(_build.host_lib(), fn_name)
    cap = max(64, nbits * 2 + 64)
    while True:
        out = np.empty(cap, np.uint8)
        got = fn(_ptr(payload), nbits, start_bit, code_kind, dict_max,
                 _ptr(out), cap)
        if got == -2:
            raise ValueError("malformed stream")
        if got >= 0:
            return out[:got].tobytes()
        cap *= 4


def lz78_stream_decode(payload, nbits, start_bit, code_kind,
                       dict_max) -> bytes:
    """Whole-stream LZ78 decode for any code kind (growing ref widths,
    dictionary reset)."""
    return _stream_decode("tdc_lz78_stream_decode", payload, nbits,
                          start_bit, code_kind, dict_max)


def lzw_stream_decode(payload, nbits, start_bit, code_kind,
                      dict_max) -> bytes:
    """Whole-stream LZW decode (the prefix-code dictionary with the
    self-referential case and the reset lag)."""
    return _stream_decode("tdc_lzw_stream_decode", payload, nbits,
                          start_bit, code_kind, dict_max)


def _chunk_array(chunk: bytes):
    """A chunk as (u8 array, length); an empty chunk passes one zero
    byte and length 0."""
    if not chunk:
        return np.zeros(1, np.uint8), 0
    inp = np.frombuffer(chunk, np.uint8)
    return inp, inp.size


class _Handle:
    """A host stream handle, freed by :meth:`close` (or at collection)."""

    _free = ""

    def __init__(self, new_fn: str, *args):
        self._lib = _build.host_lib()
        self._h = getattr(self._lib, new_fn)(*args)
        if not self._h:
            raise MemoryError(f"{new_fn} failed")

    def close(self) -> None:
        if self._h:
            getattr(self._lib, self._free)(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class Lz78Stream(_Handle):
    """Stateful streaming LZ78/LZW parse and encode (``tdc_lz78s_*``):
    the dictionary, walk node and factor counter live in the handle;
    each :meth:`feed` returns the chunk's completed factors as a
    (packed, nbits) bit run for ``StreamBitSink``. Equal to the buffered
    compressors' bytes for every chunking."""

    _free = "tdc_lz78s_free"

    def __init__(self, lzw: bool, dict_limit: int, code_kind: int):
        super().__init__("tdc_lz78s_new", int(lzw), dict_limit)
        self._kind = code_kind

    def feed(self, chunk: bytes, final: bool):
        inp, n = _chunk_array(chunk)
        # worst case a factor: an ascii ref (<= 20 digits and ':') and a
        # raw literal, 176 bits; plus the final flush factor
        cap_bits = (n + 2) * 184 + 64
        out = np.zeros((cap_bits + 7) // 8, np.uint8)
        got = self._lib.tdc_lz78s_feed(self._h, _ptr(inp), n,
                                       1 if final else 0, self._kind,
                                       _ptr(out), cap_bits)
        if got < 0:
            raise ValueError("lz78 stream encode overflow")
        return out, int(got)


class _DecStream(_Handle):
    """Stateful streaming decode: each :meth:`feed` decodes every token
    completed inside the chunk (rolling back to the token start on a bit
    underrun) and returns the decoded bytes."""

    _feed = _take = _malformed = _failure = ""

    def feed(self, chunk: bytes, final: bool) -> bytes:
        inp, n = _chunk_array(chunk)
        got = getattr(self._lib, self._feed)(self._h, _ptr(inp), n,
                                             1 if final else 0)
        if got == -2:
            raise ValueError(self._malformed)
        if got < 0:
            raise ValueError(self._failure)
        out = np.zeros(max(1, int(got)), np.uint8)
        took = getattr(self._lib, self._take)(self._h, _ptr(out), int(got))
        assert took == got
        return out[:got].tobytes()


class Lz78DecStream(_DecStream):
    """Streaming LZ78/LZW decode (``tdc_lz78ds_*``): the bit tail and the
    O(dict) (parent, char) expansion state live in the handle."""

    _free, _feed, _take = "tdc_lz78ds_free", "tdc_lz78ds_feed", \
        "tdc_lz78ds_take"
    _malformed = "malformed lz78/lzw stream"
    _failure = "lz78 stream decode failure"

    def __init__(self, lzw: bool, dict_limit: int, code_kind: int):
        super().__init__("tdc_lz78ds_new", int(lzw), dict_limit, code_kind)


# ---- sliding-window lzss (csrc/host/lzss_window.cpp) ----------------------


def lzss_window_decode(payload: np.ndarray, nbits: int, start_bit: int,
                       window: int, code_kind: int) -> bytes:
    """Decode the sliding-window LZSS stream; raises on malformed
    input."""
    payload = np.ascontiguousarray(payload, np.uint8)
    cap = max(64, nbits * 2 + 64)
    while True:
        out = np.empty(cap, np.uint8)
        got = _build.host_lib().tdc_lzss_window_decode(
            _ptr(payload), nbits, start_bit, window, code_kind, _ptr(out),
            cap)
        if got == -2:
            raise ValueError("malformed lzss stream")
        if got >= 0:
            return out[:got].tobytes()
        cap *= 4


def lzss_window_encode_stream(buf: np.ndarray, start: int, abs_base: int,
                              final: bool, window: int, threshold: int,
                              code_kind: int):
    """Factorize and encode positions [start, limit) of one chunk buffer
    (limit = len - window unless final): (packed, nbits, next_i). The
    call keeps no state, so an overflowing buffer grows and the call
    runs again; raises on a window below 0 or a threshold below 1."""
    buf = np.ascontiguousarray(buf, np.uint8)
    cap_bits = max(64, buf.size - start) * 18 + 256
    next_i = ctypes.c_int64(0)
    while True:
        out = np.zeros((cap_bits + 7) // 8, np.uint8)
        got = _build.host_lib().tdc_lzss_window_encode_s(
            _ptr(buf), buf.size, start, abs_base, 1 if final else 0,
            window, threshold, code_kind, _ptr(out), cap_bits,
            ctypes.addressof(next_i))
        if got == -2:
            raise ValueError("lzss stream encode: bad window or threshold")
        if got >= 0:
            return out, int(got), int(next_i.value)
        cap_bits *= 4


class LzssDecStream(_DecStream):
    """Streaming sliding-window LZSS decode (``tdc_lzssds_*``): an
    O(window) output tail and the undecoded bit tail live in the
    handle."""

    _free, _feed, _take = "tdc_lzssds_free", "tdc_lzssds_feed", \
        "tdc_lzssds_take"
    _malformed = "malformed lzss stream"
    _failure = "lzss stream decode failure"

    def __init__(self, window: int, code_kind: int):
        super().__init__("tdc_lzssds_new", window, code_kind)


# ---- repair (csrc/host/repair.cpp) ----------------------------------------


def _lut_arrays(lut):
    """(lut_sym, lut_len, k) of a Huffman LUT, or the empty LUT and
    k = 0 for plain 8-bit literals."""
    if lut is None:
        return _EMPTY_LUT, _EMPTY_LUT, 0
    lut_sym, lut_len, k = lut
    return (np.ascontiguousarray(lut_sym, np.uint8),
            np.ascontiguousarray(lut_len, np.uint8), k)


def repair(text: np.ndarray, max_rules: int):
    """Re-Pair grammar by the near-linear host kernel: (start int64,
    rules [(left, right)]), or None at 2^31 bytes and more or when the
    rule buffer overflows (the caller's numpy rounds take over)."""
    if text.size >= (1 << 31):
        return None
    text = np.ascontiguousarray(text, np.uint8)
    n = text.size
    rules_cap = max(16, n // 2 + 1)
    rules_out = np.empty(2 * rules_cap, np.int32)
    start_out = np.empty(max(n, 1), np.int32)
    start_len = ctypes.c_int64(0)
    got = _build.host_lib().tdc_repair(
        _ptr(text), n, min(max_rules, rules_cap), _ptr(rules_out),
        rules_cap, _ptr(start_out), ctypes.addressof(start_len))
    if got < 0:
        return None
    pairs = rules_out[: 2 * got].reshape(-1, 2)
    rules = [(int(a), int(b)) for a, b in pairs.tolist()]
    return start_out[: start_len.value].astype(np.int64), rules


def _grow_decode(fn_name: str, what: str, payload, out_hint: int,
                 *args) -> bytes:
    payload = np.ascontiguousarray(payload, np.uint8)
    fn = getattr(_build.host_lib(), fn_name)
    cap = max(4096, out_hint)
    while True:
        out = np.empty(cap, np.uint8)
        got = fn(_ptr(payload), *args, _ptr(out), cap)
        if got == -2:
            raise ValueError(f"malformed {what} stream")
        if got >= 0:
            return out[:got].tobytes()
        cap *= 4


def repair_decode(payload, nbits, start_bit, lut, out_hint: int,
                  code_kind: int = 0) -> bytes:
    """Re-Pair stream decode."""
    lut_sym, lut_len, k = _lut_arrays(lut)
    return _grow_decode("tdc_repair_decode", "repair", payload, out_hint,
                        nbits, start_bit, _ptr(lut_sym), _ptr(lut_len), k,
                        code_kind)


# ---- lz78u (csrc/host/lz78u.cpp) ------------------------------------------


def lz78u_parse(parent, sdepth, is_leaf, leaf_of_rank, isa,
                text: np.ndarray, threshold: int):
    """LZ78U suffix-tree factorization event stream:
    (kind u8, value, aux) arrays."""
    dt = np.int32 if np.asarray(parent).dtype == np.int32 else np.int64
    lib = _build.host_lib()
    fn = lib.tdc_lz78u_parse32 if dt == np.int32 else lib.tdc_lz78u_parse
    parent = np.ascontiguousarray(parent, dt)
    sdepth = np.ascontiguousarray(sdepth, dt)
    is_leaf = np.ascontiguousarray(np.asarray(is_leaf).astype(np.uint8))
    leaf_of_rank = np.ascontiguousarray(leaf_of_rank, dt)
    isa = np.ascontiguousarray(isa, dt)
    text = np.ascontiguousarray(text, np.uint8)
    n = text.size
    # ~3 events a char; grow on overflow
    cap = 4 * max(64, n)
    while True:
        kind = np.empty(cap, np.uint8)
        value = np.empty(cap, dt)
        aux = np.empty(cap, dt)
        got = fn(_ptr(parent), _ptr(sdepth), _ptr(is_leaf),
                 _ptr(leaf_of_rank), _ptr(isa), _ptr(text), n, parent.size,
                 threshold, _ptr(kind), _ptr(value), _ptr(aux), cap)
        if got >= 0:
            break
        cap *= 2
        if cap > 64 * max(64, n):
            raise RuntimeError("lz78u event overflow")
    return kind[:got].copy(), value[:got].copy(), aux[:got].copy()


def lz78u_decode(payload, nbits, start_bit, lut, out_hint: int,
                 ref_kind: int = 0, str_kind: int = 0) -> bytes:
    """LZ78U stream decode; ``ref_kind``/``str_kind`` are the ref and
    string coders' int-code kinds."""
    lut_sym, lut_len, k = _lut_arrays(lut)
    return _grow_decode("tdc_lz78u_decode", "lz78u", payload, out_hint,
                        nbits, start_bit, _ptr(lut_sym), _ptr(lut_len), k,
                        ref_kind, str_kind)


# ---- suffix tree and lfs (csrc/host/lfs.cpp) ------------------------------


def suffix_tree(sa: np.ndarray, lcp: np.ndarray):
    """The lcp-interval suffix tree: (parent, sdepth, is_leaf, suffix,
    leaf_of_rank, node_count)."""
    dt = np.int32 if np.asarray(sa).dtype == np.int32 else np.int64
    lib = _build.host_lib()
    fn = lib.tdc_suffix_tree32 if dt == np.int32 else lib.tdc_suffix_tree
    sa = np.ascontiguousarray(sa, dt)
    lcp = np.ascontiguousarray(lcp, dt)
    n = sa.size
    cap = 2 * n + 2
    parent = np.empty(cap, dt)
    sdepth = np.empty(cap, dt)
    is_leaf = np.empty(cap, np.uint8)
    suffix = np.empty(cap, dt)
    leaf_of_rank = np.empty(max(1, n), dt)
    m = fn(_ptr(sa), _ptr(lcp), n, _ptr(parent), _ptr(sdepth),
           _ptr(is_leaf), _ptr(suffix), _ptr(leaf_of_rank))
    return (parent[:m], sdepth[:m], is_leaf[:m].astype(bool), suffix[:m],
            leaf_of_rank[:n], m)


def _lfs_parse(fn_name: str, what: str, sa, lcp, n: int, min_lrf: int):
    sa = np.ascontiguousarray(sa, np.int64)
    lcp = np.ascontiguousarray(lcp, np.int64)
    fl_nts = np.zeros(max(n, 1), np.uint32)
    fl_off = np.zeros(max(n, 1), np.uint32)
    sl_nts = np.zeros(max(n, 1), np.uint32)
    sl_dead = np.zeros(max(n, 1), np.uint8)
    cap = max(16, n // 2 + 1)
    nts_start = np.empty(cap, np.int64)
    nts_len = np.empty(cap, np.int64)
    got = getattr(_build.host_lib(), fn_name)(
        _ptr(sa), _ptr(lcp), sa.size, n, min_lrf, _ptr(fl_nts),
        _ptr(fl_off), _ptr(sl_nts), _ptr(sl_dead), _ptr(nts_start),
        _ptr(nts_len), cap)
    if got < 0:
        raise RuntimeError(f"{what} NT buffer overflow")
    return fl_nts, fl_off, sl_nts, nts_start[:got], nts_len[:got]


def lfs2_parse(sa, lcp, n_text: int, min_lrf: int):
    """LFS2 two-layer parse: (fl_nts, fl_off, sl_nts, nts_start,
    nts_len)."""
    return _lfs_parse("tdc_lfs2_parse", "lfs2", sa, lcp, n_text, min_lrf)


def lfs_parse(sa, lcp, n_text: int, min_lrf: int):
    """Single-layer longest-first parse of the LFS st/esa strategies
    (rules need >= 2 first-layer occurrences): (fl_nts, fl_off,
    nts_start, nts_len)."""
    fl_nts, fl_off, _, nts_start, nts_len = _lfs_parse(
        "tdc_lfs_parse", "lfs", sa, lcp, n_text, min_lrf)
    return fl_nts, fl_off, nts_start, nts_len


def _lfs_rules(fn_name: str, arrays, n: int, min_lrf: int):
    """Run an LRF computation (``tdc_lfs_simst``/``tdc_lfs_bst``) over
    the suffix tree's ``arrays`` (parent first): (dictionary,
    occurrences), or None when its occurrence buffer overflows (the
    caller's Python walk takes over)."""
    d_cap = max(16, n + 1)
    o_cap = max(16, 2 * n + 1)
    d_start = np.empty(d_cap, np.int64)
    d_len = np.empty(d_cap, np.int64)
    o_pos = np.empty(o_cap, np.int64)
    o_rule = np.empty(o_cap, np.int64)
    o_len = np.empty(o_cap, np.int64)
    nd = ctypes.c_int64(0)
    got = getattr(_build.host_lib(), fn_name)(
        *[_ptr(a) for a in arrays], arrays[0].size, n, min_lrf,
        _ptr(d_start), _ptr(d_len), d_cap, _ptr(o_pos), _ptr(o_rule),
        _ptr(o_len), o_cap, ctypes.addressof(nd))
    if got < 0:
        return None
    m = nd.value
    dictionary = list(zip(d_start[:m].tolist(), d_len[:m].tolist()))
    order = np.lexsort((o_rule[:got], o_pos[:got]))
    occurrences = [
        (int(o_pos[i]), int(o_rule[i]), int(o_len[i])) for i in order
    ]
    return dictionary, occurrences


def lfs_simst(parent, sdepth, is_leaf, suffix, n, min_lrf):
    """SimST LRF computation, as ``SimSTStrategy``'s Python walk:
    (dictionary, occurrences), or None on an occurrence overflow."""
    return _lfs_rules("tdc_lfs_simst", (
        np.ascontiguousarray(parent, np.int64),
        np.ascontiguousarray(sdepth, np.int64),
        np.ascontiguousarray(np.asarray(is_leaf).astype(np.uint8)),
        np.ascontiguousarray(suffix, np.int64),
    ), n, min_lrf)


def lfs_bst(parent, sdepth, suffix, n, min_lrf):
    """BST LRF computation, as ``BSTStrategy``'s Python walk:
    (dictionary, occurrences), or None on an occurrence overflow."""
    return _lfs_rules("tdc_lfs_bst", (
        np.ascontiguousarray(parent, np.int64),
        np.ascontiguousarray(sdepth, np.int64),
        np.ascontiguousarray(suffix, np.int64),
    ), n, min_lrf)


def _lfs_decode(fn_name: str, what: str, payload, nbits, start_bit, lut,
                w_id, dict_lens) -> bytes:
    lut_sym, lut_len, k = _lut_arrays(lut)
    lens = np.ascontiguousarray(dict_lens, np.int64)
    return _grow_decode(fn_name, what, payload, nbits * 2 + 64, nbits,
                        start_bit, _ptr(lut_sym), _ptr(lut_len), k, w_id,
                        _ptr(lens), lens.size)


def lfs_start_decode(payload, nbits, start_bit, lut, w_id,
                     dict_lens: np.ndarray) -> bytes:
    """Decode the LFS rule strings and start string (flags and literals
    or rule ids); ``lut`` is (sym, len, k), or None for plain 8-bit
    literals."""
    return _lfs_decode("tdc_lfs_start_decode", "lfs", payload, nbits,
                       start_bit, lut, w_id, dict_lens)


def lfs2_decode(payload, nbits, start_bit, lut, w_id,
                dict_lens: np.ndarray) -> bytes:
    """Decode the LFS2 two-layer rule set and start stream."""
    return _lfs_decode("tdc_lfs2_decode", "lfs2", payload, nbits,
                       start_bit, lut, w_id, dict_lens)
