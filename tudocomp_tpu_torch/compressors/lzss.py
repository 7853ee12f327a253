"""LZSS/LZ77 compressors and the shared factor-stream format.

The port's counterpart of ``tudocomp_tpu/compressors/lzss.py``, with the
same options, headers and bytes:

1. the factor-stream wire format (``lzss/LZSSCoding.hpp:19-140``): header
   ``n, flen_min, flen_max, fdist_max`` then, per factor, a gap flag bit
   [+ gap length], the gap literals, and ``(src, len)``; trailing literals
   after the last factor get a final gap record.
2. ``lzss_lcp`` — LZ77 via SA+ISA+LCP with naive PSV/NSV selection
   (``LZSSLCPCompressor.hpp:42-124``) on the host (``comp=psv``), or the
   exact (``comp=device``) or q-gram class (``comp=device_fast``)
   matcher of ``ops/lzss.py`` on the Env's torch device; decoded by the
   host library's back-reference walk (``dec=host``) or by pointer
   doubling on the device (``dec=device``).
3. ``lzss`` — sliding-window greedy factorization
   (``LZSSSlidingWindowCompressor.hpp:39-143``), encoded and decoded on
   the host, in one pass over a file too.

The host parts run the port's host library (``csrc/host/lzss.cpp``,
``csrc/host/sle.cpp``, ``csrc/host/lzss_window.cpp``), which raises when
it cannot be built: there is no Python token walk behind it. The factor
stream also carries ``lcpcomp`` (``compressors/lcpcomp.py``), whose
coders include the consuming ``sle``.
"""

from __future__ import annotations

import io
from dataclasses import dataclass

import numpy as np

from tudocomp_tpu_torch import native
from tudocomp_tpu_torch.coders import (
    NON_CONSUMING_CODER_NAMES,
    UNIVERSAL_CODER_NAMES,
    native_code_kind,
    option_code_kind,
)
from tudocomp_tpu_torch.coders.base import Literals
from tudocomp_tpu_torch.coders.huffman import HuffmanCoder
from tudocomp_tpu_torch.coders.simple import BitCoder
from tudocomp_tpu_torch.coders.sle import K as SLE_K, SLECoder
from tudocomp_tpu_torch.compressors.base import Compressor
from tudocomp_tpu_torch.device import resolve_device
from tudocomp_tpu_torch.ds.suffix import TextDS
from tudocomp_tpu_torch.io.bitio import BitReader, BitWriter, StreamBitSink
from tudocomp_tpu_torch.meta import Meta
from tudocomp_tpu_torch.ops.lzss import (
    factorize_device, resolve_factors_device,
)
from tudocomp_tpu_torch.ranges import (
    MinDistributedRange, Range, bit_r, len_r, literal_r,
)


@dataclass
class Factor:
    pos: int
    src: int
    len: int


class FactorBuffer:
    """Sorted factor buffer with min/max length tracking.

    Array-backed: bulk producers (the factorizers) hand whole
    (pos, src, len) arrays over via :meth:`extend_arrays`; scalar
    ``append`` stages into lists. ``arrays()`` is the canonical view."""

    def __init__(self):
        self._pos: list[int] = []
        self._src: list[int] = []
        self._len: list[int] = []
        self._arr = None  # (pos, src, len) int64 arrays once merged
        self.shortest = None
        self.longest = 0

    def append(self, pos: int, src: int, length: int) -> None:
        if self._arr is not None:
            a = self._arr
            self._pos = a[0].tolist()
            self._src = a[1].tolist()
            self._len = a[2].tolist()
            self._arr = None
        self._pos.append(pos)
        self._src.append(src)
        self._len.append(length)
        self.shortest = (
            length if self.shortest is None else min(self.shortest, length)
        )
        self.longest = max(self.longest, length)

    def extend_arrays(self, pos, src, length) -> None:
        """Bulk append from parallel arrays (factorizer output)."""
        pos = np.asarray(pos, np.int64)
        src = np.asarray(src, np.int64)
        length = np.asarray(length, np.int64)
        if pos.size == 0:
            return
        merged = (
            (pos, src, length) if self._arr is None and not self._pos
            else tuple(
                np.concatenate([a, b])
                for a, b in zip(self.arrays(), (pos, src, length))
            )
        )
        self._arr = merged
        self._pos = self._src = self._len = []
        lo = int(length.min())
        self.shortest = lo if self.shortest is None else min(
            self.shortest, lo
        )
        self.longest = max(self.longest, int(length.max()))

    def arrays(self):
        """(pos, src, len) int64 arrays in current order."""
        if self._arr is None:
            self._arr = (
                np.array(self._pos, np.int64),
                np.array(self._src, np.int64),
                np.array(self._len, np.int64),
            )
            self._pos = self._src = self._len = []
        return self._arr

    @property
    def factors(self) -> list[Factor]:
        p, s, l = self.arrays()
        return [
            Factor(*t)
            for t in zip(p.tolist(), s.tolist(), l.tolist())
        ]

    def __len__(self):
        return self._arr[0].size if self._arr is not None else len(self._pos)

    def __iter__(self):
        return iter(self.factors)

    def sort(self) -> None:
        p, s, l = self.arrays()
        order = np.argsort(p, kind="stable")
        self._arr = (p[order], s[order], l[order])

    def flatten(self) -> None:
        """Rewrite factor sources that point into other factors to their
        transitive origin (reference ``LZSSFactors.hpp:79-132``).
        Vectorized: each round jumps every still-contained source one
        level toward its origin (Jacobi form of the sequential rewrite;
        containment guarantees the same fixed point). Requires factors
        sorted by position (``lcpcomp`` sorts first, as the reference
        does before its flatten pass)."""
        pos, src, lng = self.arrays()
        if pos.size == 0:
            return
        end = int(pos[-1] + lng[-1])
        # fmap[p] = 1 + id of the factor covering p, else 0 — built by
        # a forward-fill of start markers masked by a +-1 diff-scan
        # coverage (the former per-covered-position repeat+ramp arrays
        # were 32 transient bytes/char at 100 MB)
        dt = np.int32 if end < (1 << 31) else np.int64
        fmap = np.zeros(end, dt)
        fmap[pos] = np.arange(1, pos.size + 1, dtype=dt)
        np.maximum.accumulate(fmap, out=fmap)
        delta = np.zeros(end + 1, np.int8)
        delta[pos] += 1
        delta[pos + lng] -= 1
        covered = np.cumsum(delta[:end], dtype=np.int8) > 0
        del delta
        fmap[~covered] = 0
        del covered
        src = src.copy()
        # iterate to the sequential fixed point: blocked intermediate
        # factors (containment fails at some chain level) prevent true
        # pointer doubling, so rounds are capped at the factor count —
        # the scalar algorithm's own worst-case chain length. A few
        # rounds on natural text; a periodic stretch takes about one
        # round per period of its length (17,475 rounds at 4 MiB of
        # bench.make_corpus, whose half is a text of period 124).
        for _ in range(pos.size + 2):
            inside = src < end
            fi = np.where(inside, fmap[np.minimum(src, end - 1)], 0)
            hit = fi > 0
            if not hit.any():
                break
            s_idx = fi - 1
            d = src - pos[s_idx]
            ok = hit & (d + lng <= lng[s_idx])
            if not ok.any():
                break
            nxt = np.where(ok, src[s_idx] + d, src)
            if np.array_equal(nxt, src):
                break
            src = nxt
        self._arr = (pos, src, lng)


def uncovered_literals(text: np.ndarray, factors: FactorBuffer) -> Literals:
    """Literal iterator skipping factor-covered positions (reference
    ``lzss/LZSSLiterals.hpp:10-50``): coverage from a +-1 diff scan over
    the (non-overlapping) factor intervals."""
    pos, _, lng = factors.arrays()
    delta = np.zeros(text.size + 1, np.int8)
    if pos.size:
        delta[pos] += 1
        delta[pos + lng] -= 1  # start==prior end accumulates via +=/-=
    covered = np.cumsum(delta[: text.size], dtype=np.int8) > 0
    keep = ~covered
    return Literals(text[keep], np.flatnonzero(keep))


def _literal_tokens(coder, byts: np.ndarray):
    """(values u64, lens i32) for a literal byte array under ``coder``
    (bit coder / degenerate huffman: plain 8-bit; huffman: table)."""
    if isinstance(coder, HuffmanCoder.Encoder) and coder.table is not None:
        return (
            coder.table.sym_code[byts].astype(np.uint64),
            coder.table.sym_len[byts].astype(np.int32),
        )
    return byts.astype(np.uint64), np.full(byts.size, 8, np.int32)


def _encode_factors_bulk(coder, text, factors, text_r, flen_r, fdist_r):
    """Vectorized factor-stream body: one write_tokens call for the whole
    interleaved (flag, [gap, literals...], src, len) sequence. Bit-exact
    with the scalar loop; applies for bit/huffman coders, whose field
    widths are fixed per stream."""
    pos, src, lng = factors.arrays()
    n = text.size
    prev_end = np.concatenate([[0], (pos + lng)[:-1]])
    gaps = pos - prev_end
    tail = n - int((pos + lng)[-1]) if pos.size else n

    w_src, w_len, w_dist = text_r.bits, flen_r.bits, fdist_r.bits
    has_gap = gaps > 0
    slots = 1 + np.where(has_gap, 1 + gaps, 0) + 2
    offs = np.concatenate([[0], np.cumsum(slots)[:-1]])
    total = int(slots.sum()) + (2 + tail if tail else 0)
    values = np.zeros(total, np.uint64)
    lens = np.zeros(total, np.int32)
    # flags
    values[offs] = has_gap
    lens[offs] = 1
    # gap distances
    g_off = offs[has_gap] + 1
    values[g_off] = gaps[has_gap].astype(np.uint64)
    lens[g_off] = w_dist
    # gap literals (concatenated per-factor text slices)
    if has_gap.any():
        gsz = gaps[has_gap]
        ramp = np.arange(int(gsz.sum())) - np.repeat(np.cumsum(gsz) - gsz,
                                                     gsz)
        lit_slots = np.repeat(g_off + 1, gsz) + ramp
        lit_text = np.repeat(prev_end[has_gap], gsz) + ramp
        lv, ll = _literal_tokens(coder, text[lit_text])
        values[lit_slots] = lv
        lens[lit_slots] = ll
    # src / len
    s_off = offs + 1 + np.where(has_gap, 1 + gaps, 0)
    values[s_off] = src.astype(np.uint64)
    lens[s_off] = w_src
    values[s_off + 1] = (lng - flen_r.min).astype(np.uint64)
    lens[s_off + 1] = w_len
    # trailing literal run
    if tail:
        base = int(slots.sum())
        values[base] = 1
        lens[base] = 1
        values[base + 1] = tail
        lens[base + 1] = w_dist
        lv, ll = _literal_tokens(coder, text[n - tail :])
        values[base + 2 :] = lv
        lens[base + 2 :] = ll
    coder.out.write_tokens(values, lens)


def encode_factor_text(coder, text: np.ndarray, factors: FactorBuffer):
    """Shared factor-stream encoder (``lzss/LZSSCoding.hpp:19-92``): the
    bulk token build for the bit and huff coders, the host library's
    token build for ``sle`` while it holds no pending literal, the scalar
    loop for ascii, gamma, delta and ternary (and for a stream without
    factors)."""
    n = int(text.size)
    flen_min = factors.shortest if factors.shortest is not None else 0
    flen_max = factors.longest
    fpos, _, flng = factors.arrays()
    if fpos.size:
        prev_end = np.concatenate([[0], (fpos + flng)[:-1]])
        fdist_max = max(
            int((fpos - prev_end).max()),
            n - int(fpos[-1] + flng[-1]),
        )
    else:
        fdist_max = n

    text_r = Range(n)
    flen_r = MinDistributedRange(flen_min, flen_max)
    fdist_r = Range(fdist_max)

    coder.encode(n, len_r)
    coder.encode(flen_min, text_r)
    coder.encode(flen_max, text_r)
    coder.encode(fdist_max, text_r)

    if len(factors) and isinstance(
        coder, (BitCoder.Encoder, HuffmanCoder.Encoder)
    ):
        _encode_factors_bulk(coder, text, factors, text_r, flen_r, fdist_r)
        coder.finish()
        return

    if len(factors) and isinstance(coder, SLECoder.Encoder) \
            and not coder._pending:
        coder.out.write_tokens(*native.factor_stream_sle_encode(
            text, *factors.arrays(),
            text_r.bits, flen_r.bits, fdist_r.bits, flen_r.min,
            coder._sorted_keys, coder._key_rank, SLE_K,
            coder._lit_rank32,
        ))
        return

    p = 0
    for f in factors:
        if f.pos == p:
            coder.encode(0, bit_r)
        else:
            coder.encode(1, bit_r)
            coder.encode(f.pos - p, fdist_r)
            coder.encode_array(text[p : f.pos], literal_r)
            p = f.pos
        coder.encode(f.src, text_r)
        coder.encode(f.len, flen_r)
        p += f.len
    if p < n:
        coder.encode(1, bit_r)
        coder.encode(n - p, fdist_r)
        coder.encode_array(text[p:n], literal_r)
    coder.finish()


def _read_stream_header(decoder):
    """The four header fields: ``(n, text_r, flen_r, fdist_r)``."""
    n = decoder.decode(len_r)
    text_r = Range(n)
    flen_min = decoder.decode(text_r)
    flen_max = decoder.decode(text_r)
    flen_r = MinDistributedRange(flen_min, flen_max)
    fdist_r = Range(decoder.decode(text_r))
    return n, text_r, flen_r, fdist_r


def decode_stream_native(decoder, n, flen_r, text_r, fdist_r, mode=0):
    """The host library's factor-stream walk from the decoder's bit
    position. Mode 0 returns the reconstructed text bytes; mode 1
    returns ``(literals, fpos, fsrc, flen)``. None for an ``sle``
    decoder that holds a buffered k-mer tail (the caller walks the
    stream symbol by symbol)."""
    rd = decoder.inp
    if isinstance(decoder, SLECoder.Decoder):
        if decoder.buffer:
            return None
        res = native.lzss_decode_stream_sle(
            np.packbits(rd._bits), rd.total, rd.pos, n, flen_r.min,
            text_r.bits, flen_r.bits, fdist_r.bits,
            b"".join(decoder.kmers), SLE_K, bytes(decoder.lits), mode=mode,
        )
        rd.pos = rd.total
        return res
    lut = None
    if isinstance(decoder, HuffmanCoder.Decoder):
        kind = 0
        if decoder.table is not None:
            lut_sym, lut_len = decoder.table.build_lut()
            lut = (lut_sym, lut_len, decoder.table.longest)
    else:
        kind = native_code_kind(decoder)
        if kind is None:
            raise ValueError(
                f"no factor-stream decoder for {type(decoder).__qualname__}"
            )
    res = native.lzss_decode_stream(
        np.packbits(rd._bits), rd.total, rd.pos, n, flen_r.min,
        text_r.bits, flen_r.bits, fdist_r.bits, lut, mode=mode,
        code_kind=kind,
    )
    rd.pos = rd.total
    return res


def parse_factor_arrays(decoder):
    """Parse a factor stream into arrays without resolving the copies:
    returns ``(total, literals u8, fpos, fsrc, flen)`` in stream order."""
    n, text_r, flen_r, fdist_r = _read_stream_header(decoder)
    lit_bytes, fpos, fsrc, flens = decode_stream_native(
        decoder, n, flen_r, text_r, fdist_r, mode=1)
    return int(lit_bytes.size + flens.sum()), lit_bytes, fpos, fsrc, flens


def decode_factor_text_device(decoder, device) -> bytes:
    """Factor-stream decode with the copy resolution on ``device``: token
    parse on the host (the mode-1 walk), then per-position pointer
    doubling (``ops/lzss.py:resolve_factors_device``) — bit-identical to
    the host back-buffer (reference ``lzss/LZSSCoding.hpp:95-140``)."""
    total, literals, fpos, fsrc, flens = parse_factor_arrays(decoder)
    return resolve_factors_device(literals, fpos, fsrc, flens, total,
                                  device=device)


def decode_factor_text(decoder) -> bytes:
    """Shared factor-stream decoder with a back-reference buffer
    (``lzss/LZSSCoding.hpp:95-140`` + ``LZSSDecodeBackBuffer.hpp``)."""
    n, text_r, flen_r, fdist_r = _read_stream_header(decoder)
    return decode_stream_native(decoder, n, flen_r, text_r, fdist_r, mode=0)


def factorize_lcp(text: np.ndarray, threshold: int,
                  compressed: bool = False) -> FactorBuffer:
    """LZ77 factorization via SA/ISA/LCP with naive PSV/NSV scans
    (reference ``LZSSLCPCompressor.hpp:60-115``; PSV preferred on ties).
    ``ds=plain`` runs the host library's loop; ``compressed`` selects the
    compressed-space TextDS degree (ISA point queries through SparseISA,
    LCP through the compressed PLCP encoding) and the same loop in
    Python over them."""
    ds = TextDS(text.tobytes())
    factors = FactorBuffer()
    if not compressed:
        lcp = ds.require_lcp()
        # Phi/PLCP only exist to build LCP (ds/TextDS.hpp release
        # lifecycle)
        ds.discard("phi", "plcp")
        factors.extend_arrays(*native.lzss_lcp_factorize(
            ds.require_sa(), ds.require_isa(), lcp, threshold,
        ))
        return factors
    sa = ds.require_sa()
    isa = ds.require_isa_sparse()
    lcp = ds.require_lcp_compressed()
    n = text.size
    i = 0
    while i + 1 < n:
        cur = isa[i]
        # PSV: scan up, including current lcp, while suffixes start later
        psv_lcp = lcp[cur]
        psv_pos = cur - 1
        if psv_lcp > 0:
            while psv_pos >= 0 and sa[psv_pos] > sa[cur]:
                psv_lcp = min(psv_lcp, lcp[psv_pos])
                psv_pos -= 1
        # NSV: scan down, excluding current
        nsv_lcp = 0
        nsv_pos = cur + 1
        if nsv_pos < n:
            nsv_lcp = float("inf")
            while True:
                nsv_lcp = min(nsv_lcp, lcp[nsv_pos])
                if sa[nsv_pos] < sa[cur]:
                    break
                nsv_pos += 1
                if nsv_pos >= n:
                    nsv_lcp = 0
                    break
        max_lcp = max(psv_lcp, nsv_lcp)
        if max_lcp >= threshold:
            max_pos = psv_pos if max_lcp == psv_lcp else nsv_pos
            factors.append(i, sa[max_pos], int(max_lcp))
            i += int(max_lcp)
        else:
            i += 1
    return factors


class LZSSLCPCompressor(Compressor):
    @classmethod
    def meta(cls):
        m = Meta("compressor", "lzss_lcp", "LZSS Factorization using LCP")
        m.option_submeta(
            "coder", "coder", default="bit",
            accepts=NON_CONSUMING_CODER_NAMES,
        )
        m.option_dynamic("threshold", 3)
        m.option_dynamic("ds", "plain")
        # comp=psv: reference PSV/NSV scan over SA/LCP (exact, host).
        # comp=device: exact longest-previous-factor on the device
        #   (ops/lzss.py) — the same per-position answers as JAX's.
        # comp=device_fast: q-gram class heuristic matcher (cheaper,
        #   slightly worse ratio) — an alternative valid parse.
        m.option_dynamic("comp", "psv")
        # dec=host: host back-buffer walk. dec=device: copy resolution
        #   as pointer-doubling rounds on the device (bit-identical).
        m.option_dynamic("dec", "host")
        m.needs_sentinel_terminator()
        return m

    def compress(self, data: bytes) -> bytes:
        if not data.endswith(b"\x00"):
            raise ValueError("lzss_lcp requires a sentineled input")
        threshold = self.env.option("threshold").as_int()
        text = np.frombuffer(data, np.uint8)
        comp = self.env.option("comp").as_string()
        if comp in ("device", "device_fast"):
            factors = FactorBuffer()
            factors.extend_arrays(*factorize_device(
                text, threshold, exact=(comp == "device"),
                device=resolve_device(self.env.torch_device),
            ))
        else:
            factors = factorize_lcp(
                text, threshold,
                compressed=(
                    self.env.option("ds").as_string() == "compressed"
                ),
            )
        out = BitWriter()
        coder = self.coder_encoder(out, uncovered_literals(text, factors))
        encode_factor_text(coder, text, factors)
        return out.getvalue()

    def decompress(self, data: bytes) -> bytes:
        decoder = self.coder_decoder(BitReader(data))
        if self.env.option("dec").as_string() == "device":
            return decode_factor_text_device(
                decoder, resolve_device(self.env.torch_device))
        return decode_factor_text(decoder)


# --- sliding window ---------------------------------------------------------


class LZSSSlidingWindowCompressor(Compressor):
    """Sliding-window greedy factorization
    (``LZSSSlidingWindowCompressor.hpp:39-143``): window w (default 16),
    threshold t (default 3); factors are ``(bit 1, delta in Range(pos),
    len in Range(w))``, literals ``(bit 0, literal)``; bit widths grow
    with the absolute position (adaptive ranges). At position i the
    candidates start in [max(0, i-w), i), the longest match wins, ties
    to the leftmost candidate, and matches may overlap i.

    Documented divergence: match lengths are capped at ``window``. The
    reference lets matches inside its initial 2w buffer exceed the
    window yet encodes the length in ``Range(window)``
    (``LZSSSlidingWindowCompressor.hpp:74-88``), silently wrapping the
    field and corrupting its own stream for small windows; the cap
    keeps every emitted factor representable.

    Encoded and decoded by the host library
    (``csrc/host/lzss_window.cpp``), the buffered encode through the
    one-pass stream encoder over the bytes in memory."""

    @classmethod
    def meta(cls):
        m = Meta(
            "compressor",
            "lzss",
            "Lempel-Ziv-Storer-Szymanski (Sliding Window)",
        )
        m.option_submeta(
            "coder", "coder", default="bit",
            accepts=UNIVERSAL_CODER_NAMES,
        )
        m.option_dynamic("window", 16)
        m.option_dynamic("threshold", 3)
        return m

    def compress(self, data: bytes) -> bytes:
        fout = io.BytesIO()
        self.compress_stream(io.BytesIO(data), fout)
        return fout.getvalue()

    def decompress(self, data: bytes) -> bytes:
        rd = BitReader(data)
        return native.lzss_window_decode(
            np.packbits(rd._bits), rd.total, rd.pos,
            self.env.option("window").as_int(), option_code_kind(self.env),
        )

    supports_streaming = True

    def compress_stream(self, fin, fout) -> None:
        """One-pass O(window)-memory streaming encode (reference
        ``as_stream()`` parity: the reference factorizer itself only ever
        holds a 2*window buffer, ``LZSSSlidingWindowCompressor.hpp:51-56``).
        Chunks are factorized with full look-ahead (positions past
        ``len - window`` defer to the next chunk), the adaptive delta
        width uses absolute positions, and per-chunk bit runs splice
        through ``StreamBitSink`` — the same bytes for every chunking.

        A window below 1 has no candidates and a threshold below 1
        admits the same matches as 1 (a match has at least one byte),
        so both are raised to those values for the host encoder; the
        container keeps the options as given."""
        window = max(0, self.env.option("window").as_int())
        threshold = max(1, self.env.option("threshold").as_int())
        kind = option_code_kind(self.env)
        sink = StreamBitSink(fout)
        context = np.zeros(0, np.uint8)
        abs_base = 0
        start = 0
        while True:
            chunk = fin.read(STREAM_CHUNK)
            final = not chunk
            buf = np.concatenate(
                [context, np.frombuffer(chunk, np.uint8)]
            )
            packed, nbits, next_i = native.lzss_window_encode_stream(
                buf, start, abs_base, final, window, threshold, kind
            )
            sink.append_packed(packed, nbits)
            if final:
                break
            keep_from = max(0, next_i - window)
            context = buf[keep_from:]
            abs_base += keep_from
            start = next_i - keep_from
        sink.close()

    def decompress_stream(self, fin, fout) -> None:
        """One-pass O(window)-memory streaming decode: back-copies reach
        at most ``window`` bytes, so the host handle keeps just the
        output tail + the undecoded bit tail across chunks (token
        rollback at chunk edges; absolute-position delta widths).
        Byte-identical to the buffered decode at every chunking."""
        stream = native.LzssDecStream(self.env.option("window").as_int(),
                                      option_code_kind(self.env))
        try:
            while True:
                chunk = fin.read(STREAM_CHUNK)
                final = not chunk
                out = stream.feed(chunk, final)
                if out:
                    fout.write(out)
                if final:
                    break
        finally:
            stream.close()


#: streaming chunk size for the sliding-window path (state kept across
#: chunks: the last 2*window bytes + the partial output byte)
STREAM_CHUNK = 1 << 22
