// Host sliding-window LZSS of the torch port: the whole-input decoder,
// the chunked encoder (which serves the buffered and the one-pass
// encode), and the stream decoder handle.
//
// Copies of the JAX package's native runtime (native/tdc_native.cpp:
// tdc_lzss_window_decode :3056-3092, tdc_lzss_window_encode_s :3762-3804,
// TdcLzssDS with tdc_lzssds_new/free/feed/take :4156-4256, over
// bitrw.hpp's TdcBitWr and BitRd), so that the port's lzss needs nothing
// of that package; tdc_lzssds_free returns 0 where the original returns
// void, since every entry point of the host library returns int64
// (tdc_lzssds_new returns the handle). Two changes:
// tdc_lzss_window_encode_s accepts a window of 0 (every position a
// literal, as the JAX package's Python coder loop encodes it), and
// tdc_lzssds_feed takes, in a non-final feed, only the tokens that end
// before its last bit, so that an ascii code cut at the chunk edge is not
// decoded short (the original rejects such an lzss(coder=ascii) stream as
// malformed). Built with the host compiler by _build.py into csrc/build/
// and bound with ctypes by native.py.

#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

#include "bitrw.hpp"

extern "C" {

// Mirror decoder. Returns the text length, -1 if out_cap too small,
// -2 on malformed input.
int64_t tdc_lzss_window_decode(const uint8_t* payload, int64_t nbits,
                               int64_t start_bit, int64_t window,
                               int code_kind, uint8_t* out,
                               int64_t out_cap) {
    if (window < 1) return -2;
    BitRd rd{payload, nbits, start_bit};
    const int w_len = int(tdc_bits_for((uint64_t)window));
    int64_t cursor = 0;
    while (rd.pos < nbits) {
        int64_t flag = rd.read_flag(code_kind);
        if (flag < 0) return -2;
        if (flag) {
            int64_t delta = rd.read_code(
                code_kind, int(tdc_bits_for((uint64_t)cursor)));
            int64_t len = rd.read_code(code_kind, w_len);
            if (delta < 0 || len < 0) return -2;
            int64_t src = cursor - delta;
            if (src < 0 || src >= cursor) return -2;
            if (cursor + len > out_cap) return -1;
            for (int64_t k = 0; k < len; k++)
                out[cursor + k] = out[src + k];
            cursor += len;
        } else {
            int64_t c;
            if (code_kind == 1 || code_kind == 2 || code_kind == 3) {
                c = rd.read_code(code_kind, 8);
            } else {
                if (rd.pos + 8 > nbits) return -2;
                c = rd.read(8);
            }
            if (c < 0 || c > 255) return -2;
            if (cursor >= out_cap) return -1;
            out[cursor++] = (uint8_t)c;
        }
    }
    return cursor;
}

// Sliding-window LZSS factorize+encode over a chunk buffer t[0..n)
// whose byte 0 sits at absolute input position abs_base. Factorizes
// positions in [start, limit) where limit = final_chunk ? n :
// n - window (so every decision sees its full look-ahead and equals
// the whole-buffer parse); the adaptive delta field width uses the
// ABSOLUTE position (reference Range(fpos),
// LZSSSlidingWindowCompressor.hpp:86). Returns bits written into out
// (each chunk's stream starts at bit 0; the caller splices them),
// -1 if cap_bits too small, -2 on bad parameters.
// *next_i <- first unfactorized buffer index (>= limit; a final factor
// may overshoot limit).
int64_t tdc_lzss_window_encode_s(const uint8_t* t, int64_t n,
                                 int64_t start, int64_t abs_base,
                                 int final_chunk, int64_t window,
                                 int64_t threshold, int code_kind,
                                 uint8_t* out, int64_t cap_bits,
                                 int64_t* next_i) {
    if (window < 0 || threshold < 1 || start < 0) return -2;
    TdcBitWr wr{out, cap_bits, 0};
    const int64_t w_len = tdc_bits_for((uint64_t)window);
    int64_t limit = final_chunk ? n : n - window;
    int64_t i = start;
    while (i < limit) {
        int64_t buf_end = i + window;
        if (buf_end > n) buf_end = n;
        int64_t best_len = 0, best_src = 0;
        int64_t lo = i - window;
        if (lo < 0) lo = 0;
        for (int64_t k = lo; k < i; k++) {
            int64_t j = 0;
            while (i + j < buf_end && t[k + j] == t[i + j]) j++;
            if (j >= threshold && j > best_len) { best_len = j; best_src = k; }
        }
        if (best_len > 0) {
            if (wr.put_flag(code_kind, 1)) return -1;
            if (wr.put_code(code_kind, (uint64_t)(i - best_src),
                            tdc_bits_for((uint64_t)(abs_base + i))))
                return -1;
            if (wr.put_code(code_kind, (uint64_t)best_len, w_len))
                return -1;
            i += best_len;
        } else {
            if (wr.put_flag(code_kind, 0)) return -1;
            if (code_kind == 1 || code_kind == 2 || code_kind == 3) {
                if (wr.put_code(code_kind, t[i], 8)) return -1;
            } else {
                if (wr.put(t[i], 8)) return -1;
            }
            i++;
        }
    }
    *next_i = i;
    return wr.pos;
}

}  // extern "C"

// ---- streaming LZSS sliding-window decode --------------------------------
// One-pass decode of the lzss window token stream (flag, delta, len |
// flag, literal): back-copies reach at most `window` bytes, so the
// handle keeps an O(window) output tail plus the undecoded bit tail.
// Field widths follow the ABSOLUTE output position (the encoder's
// Range(fpos) convention, LZSSSlidingWindowCompressor.hpp:86).

struct TdcLzssDS {
    std::vector<uint8_t> pend;
    int64_t bit_off = 0;
    int64_t window = 0;
    int code_kind = 0;
    int64_t abs = 0;          // absolute output cursor
    std::vector<uint8_t> buf; // O(window) history + undrained output
    int64_t drained = 0;      // buf[0..drained) already returned
};

extern "C" {

void* tdc_lzssds_new(int64_t window, int code_kind) {
    if (window < 1) return nullptr;
    TdcLzssDS* s = new (std::nothrow) TdcLzssDS();
    if (!s) return nullptr;
    s->window = window;
    s->code_kind = code_kind;
    return s;
}

int64_t tdc_lzssds_free(void* h) {
    delete static_cast<TdcLzssDS*>(h);
    return 0;
}

int64_t tdc_lzssds_feed(void* h, const uint8_t* in, int64_t n,
                        int final_chunk) {
    TdcLzssDS* s = static_cast<TdcLzssDS*>(h);
    s->pend.insert(s->pend.end(), in, in + n);
    int64_t nbits;
    const int hold = 2;
    if (final_chunk) {
        int64_t nb = int64_t(s->pend.size());
        if (nb == 0) return int64_t(s->buf.size()) - s->drained;
        int f = s->pend[size_t(nb - 1)] & 7;
        if (f >= 6) nbits = 8 * (nb - 2) + f;
        else if (f) nbits = 8 * (nb - 1) + f;
        else nbits = 8 * (nb - 1);
        if (nbits < 0) nbits = 0;
    } else {
        if (int64_t(s->pend.size()) <= hold)
            return int64_t(s->buf.size()) - s->drained;
        nbits = 8 * (int64_t(s->pend.size()) - hold);
    }
    // a non-final feed takes only tokens that end before its last
    // bit: an ascii int that meets the held-back boundary stops
    // there without its terminator and would decode short (the
    // JAX package's copy accepts it and decodes wrong bytes)
    const int64_t lim = final_chunk ? nbits : nbits - 1;
    BitRd rd{s->pend.data(), nbits, s->bit_off};
    const int w_len = int(tdc_bits_for((uint64_t)s->window));
    while (rd.pos < nbits) {
        int64_t save = rd.pos;
        int64_t flag = rd.read_flag(s->code_kind);
        if (flag < 0 || rd.pos > lim) { rd.pos = save; break; }
        if (flag) {
            int64_t delta = rd.read_code(
                s->code_kind, int(tdc_bits_for((uint64_t)s->abs)));
            if (delta < 0 || rd.pos > lim) { rd.pos = save; break; }
            int64_t len = rd.read_code(s->code_kind, w_len);
            if (len < 0 || rd.pos > lim) { rd.pos = save; break; }
            if (delta < 1 || delta > s->abs || delta > s->window ||
                len < 1 || len > s->window)
                return -2;
            for (int64_t k = 0; k < len; k++) {
                s->buf.push_back(
                    s->buf[s->buf.size() - size_t(delta)]
                );
            }
            s->abs += len;
        } else {
            int64_t c;
            if (s->code_kind == 1 || s->code_kind == 2 ||
                s->code_kind == 3) {
                c = rd.read_code(s->code_kind, 8);
            } else {
                c = rd.read(8);
            }
            if (c < 0 || rd.pos > lim) { rd.pos = save; break; }
            if (c > 255) return -2;
            s->buf.push_back((uint8_t)c);
            s->abs += 1;
        }
    }
    s->bit_off = rd.pos;
    int64_t drop = s->bit_off >> 3;
    if (drop > 0) {
        s->pend.erase(s->pend.begin(), s->pend.begin() + drop);
        s->bit_off &= 7;
    }
    if (final_chunk && rd.pos < nbits) return -2;
    return int64_t(s->buf.size()) - s->drained;
}

int64_t tdc_lzssds_take(void* h, uint8_t* dst, int64_t cap) {
    TdcLzssDS* s = static_cast<TdcLzssDS*>(h);
    int64_t m = int64_t(s->buf.size()) - s->drained;
    if (m > cap) return -1;
    if (m) memcpy(dst, s->buf.data() + s->drained, size_t(m));
    s->drained = int64_t(s->buf.size());
    // trim: keep only the last `window` bytes of history
    if (int64_t(s->buf.size()) > s->window) {
        int64_t cut = int64_t(s->buf.size()) - s->window;
        s->buf.erase(s->buf.begin(), s->buf.begin() + cut);
        s->drained -= cut;
    }
    return m;
}

}  // extern "C"
