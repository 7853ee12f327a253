// Host LZ77 of the torch port: the PSV/NSV factorizer over SA/ISA/LCP,
// Karkkainen's PLCP, the shared factor-stream decoder and the VLC
// literal walker.
//
// Copies of the JAX package's native runtime (native/tdc_native.cpp:
// lzss_lcp_factorize_impl with tdc_lzss_lcp_factorize/32, tdc_plcp/32,
// tdc_lzss_decode over bitrw.hpp's BitRd, tdc_vlc_literals), so that
// the port's lzss_lcp needs nothing of that package. Built with the host compiler
// by _build.py into csrc/build/ and bound with ctypes by native.py.
// Every entry point returns int64, as the host library's others do.

#include <cstdint>

#include "bitrw.hpp"

// ---- lzss_lcp factorization ------------------------------------------
// Naive PSV/NSV factorization over SA/ISA/LCP (reference
// LZSSLCPCompressor.hpp:60-115). Returns the factor count, or -1 when
// the output arrays are too small.

template <typename I>
static int64_t lzss_lcp_factorize_impl(const I* sa, const I* isa,
                                       const I* lcp, int64_t n,
                                       int64_t threshold,
                                       I* out_pos, I* out_src,
                                       I* out_len, int64_t cap) {
    int64_t count = 0;
    int64_t i = 0;
    while (i + 1 < n) {
        int64_t cur = isa[i];
        int64_t psv_lcp = lcp[cur];
        int64_t psv_pos = cur - 1;
        if (psv_lcp > 0) {
            while (psv_pos >= 0 && sa[psv_pos] > sa[cur]) {
                if (lcp[psv_pos] < psv_lcp) psv_lcp = lcp[psv_pos];
                psv_pos--;
            }
        }
        int64_t nsv_lcp = 0;
        int64_t nsv_pos = cur + 1;
        if (nsv_pos < n) {
            nsv_lcp = INT64_MAX;
            while (true) {
                if (lcp[nsv_pos] < nsv_lcp) nsv_lcp = lcp[nsv_pos];
                if (sa[nsv_pos] < sa[cur]) break;
                nsv_pos++;
                if (nsv_pos >= n) { nsv_lcp = 0; break; }
            }
        }
        int64_t max_lcp = psv_lcp > nsv_lcp ? psv_lcp : nsv_lcp;
        if (max_lcp >= threshold) {
            int64_t max_pos = (max_lcp == psv_lcp) ? psv_pos : nsv_pos;
            if (count >= cap) return -1;
            out_pos[count] = I(i);
            out_src[count] = sa[max_pos];
            out_len[count] = I(max_lcp);
            count++;
            i += max_lcp;
        } else {
            i++;
        }
    }
    return count;
}

// ---- PLCP (Karkkainen's Phi algorithm) -------------------------------

template <typename I>
static void tdc_plcp_impl(const uint8_t* text, const I* phi, int64_t n,
                          I* plcp) {
    int64_t l = 0;
    for (int64_t i = 0; i < n; i++) {
        int64_t j = phi[i];
        while (i + l < n && j + l < n && text[i + l] == text[j + l]) l++;
        plcp[i] = I(l);
        if (l) l--;
    }
}

extern "C" {

int64_t tdc_lzss_lcp_factorize(const int64_t* sa, const int64_t* isa,
                               const int64_t* lcp, int64_t n,
                               int64_t threshold,
                               int64_t* out_pos, int64_t* out_src,
                               int64_t* out_len, int64_t cap) {
    return lzss_lcp_factorize_impl<int64_t>(
        sa, isa, lcp, n, threshold, out_pos, out_src, out_len, cap);
}

int64_t tdc_lzss_lcp_factorize32(const int32_t* sa, const int32_t* isa,
                                 const int32_t* lcp, int64_t n,
                                 int64_t threshold,
                                 int32_t* out_pos, int32_t* out_src,
                                 int32_t* out_len, int64_t cap) {
    return lzss_lcp_factorize_impl<int32_t>(
        sa, isa, lcp, n, threshold, out_pos, out_src, out_len, cap);
}

int64_t tdc_plcp(const uint8_t* text, const int64_t* phi, int64_t n,
                 int64_t* plcp) {
    tdc_plcp_impl<int64_t>(text, phi, n, plcp);
    return 0;
}

int64_t tdc_plcp32(const uint8_t* text, const int32_t* phi, int64_t n,
                   int32_t* plcp) {
    tdc_plcp_impl<int32_t>(text, phi, n, plcp);
    return 0;
}

// ---- factor-stream decode (lzss/LZSSCoding.hpp:95-140) ---------------
// Walks the token stream that compressors/lzss.py:encode_factor_text
// writes, from the bit offset after the 4 header fields. Literals decode
// with the canonical-Huffman LUT when k > 0, with the coder's integer
// code for gamma/delta/ternary, plain 8-bit otherwise.
// mode 0: back-reference text reconstruction into out (returns length).
// mode 1: collect factors/literals only: out receives the literal bytes;
//   fpos/fsrc/flen receive factors; *nfac_out gets the count; returns
//   the literal count. Returns -1 on overflow, -2 on a malformed stream.

int64_t tdc_lzss_decode(const uint8_t* payload, int64_t nbits,
                        int64_t start_bit, int64_t n, int64_t flen_min,
                        int w_src, int w_len, int w_dist,
                        const uint8_t* lut_sym, const uint8_t* lut_len,
                        int k, int mode, int code_kind,
                        uint8_t* out, int64_t out_cap,
                        int64_t* fpos, int64_t* fsrc, int64_t* flen,
                        int64_t fcap, int64_t* nfac_out) {
    BitRd rd{payload, nbits, start_bit};
    int64_t cursor = 0;   // text position
    int64_t lits = 0;     // literal count (mode 1)
    int64_t nfac = 0;
    auto read_literal = [&]() -> int {
        if (code_kind == 1 || code_kind == 2 || code_kind == 3) {
            int64_t v = rd.read_code(code_kind, 8);
            if (v < 0 || v > 255) return -1;
            return int(v);
        }
        if (k > 0) {
            // peek k bits (zero padded), LUT walk
            int64_t save = rd.pos;
            int64_t w = rd.read(k);
            int len = lut_len[w];
            if (len == 0) return -1;
            rd.pos = save + len;
            return lut_sym[w];
        }
        return int(rd.read(8));
    };
    while (rd.pos < nbits) {
        int64_t flag = rd.read_flag(code_kind);
        if (flag < 0) return -2;
        if (flag) {
            if (rd.pos >= nbits) break;
            int64_t num = rd.read_code(code_kind, w_dist);
            if (num < 0) return -2;
            for (int64_t i = 0; i < num; i++) {
                int c = read_literal();
                if (c < 0) return -2;
                if (mode == 0) {
                    if (cursor >= out_cap) return -1;
                    out[cursor++] = uint8_t(c);
                } else {
                    if (lits >= out_cap) return -1;
                    out[lits++] = uint8_t(c);
                    cursor++;
                }
            }
        }
        if (rd.pos >= nbits) break;
        int64_t src = rd.read_code(code_kind, w_src);
        int64_t len0 = rd.read_code(code_kind, w_len);
        if (src < 0 || len0 < 0) return -2;
        // MinDistributedRange: the fixed-width coder stores v - min;
        // the VLC coders (gamma/delta/ternary/ascii) store v verbatim
        int64_t len = code_kind == 0 ? len0 + flen_min : len0;
        if (mode == 0) {
            if (cursor + len > out_cap || src + len > out_cap) return -1;
            if (src < 0 || src >= cursor) return -2;  // back-references only
            for (int64_t i = 0; i < len; i++)
                out[cursor + i] = out[src + i];  // overlap-safe fwd copy
            cursor += len;
        } else {
            if (nfac >= fcap) return -1;
            fpos[nfac] = cursor; fsrc[nfac] = src; flen[nfac] = len;
            nfac++;
            cursor += len;
        }
    }
    if (nfac_out) *nfac_out = nfac;
    return (mode == 0) ? cursor : lits;
}

// ---- VLC literal tail -------------------------------------------------
// Decodes a whole gamma(1)/delta(2)/ternary(3) literal tail (mirrors
// io/bitio.py read_elias_gamma / read_elias_delta / read_ternary). Returns
// the literal count, -1 if cap is too small, -2 on a malformed or
// misaligned stream.

static inline int tdc_vlc_bit(const uint8_t* p, int64_t pos) {
    return (p[pos >> 3] >> (7 - (pos & 7))) & 1;
}

int64_t tdc_vlc_literals(const uint8_t* p, int64_t nbits, int64_t pos,
                         int kind, uint8_t* out, int64_t cap) {
    int64_t m = 0;
    while (pos < nbits) {
        uint64_t v = 0;
        if (kind == 1 || kind == 2) {
            // unary: zeros then a 1 (read_unary), giving the bit count
            int64_t zeros = 0;
            while (pos < nbits && !tdc_vlc_bit(p, pos)) { zeros++; pos++; }
            if (pos >= nbits) return -2;  // unary ran past the end
            pos++;                        // the terminating 1
            int64_t width = zeros;
            if (kind == 2) {              // delta: gamma gives the width
                if (pos + width > nbits) return -2;
                uint64_t g = 0;
                for (int64_t b = 0; b < width; b++)
                    g = (g << 1) | (uint64_t)tdc_vlc_bit(p, pos + b);
                pos += width;
                width = (int64_t)g;
            }
            if (width > 63 || pos + width > nbits) return -2;
            for (int64_t b = 0; b < width; b++)
                v = (v << 1) | (uint64_t)tdc_vlc_bit(p, pos + b);
            pos += width;
        } else if (kind == 3) {
            // base-3 digits in 2-bit codes, terminator 0b11 (read_ternary)
            if (pos + 2 > nbits) return -2;
            unsigned mod = (unsigned)((tdc_vlc_bit(p, pos) << 1) |
                                      tdc_vlc_bit(p, pos + 1));
            pos += 2;
            if (mod < 3) {
                uint64_t b3 = 1;
                for (;;) {
                    v += mod * b3;
                    b3 *= 3;
                    if (pos + 2 > nbits) return -2;
                    mod = (unsigned)((tdc_vlc_bit(p, pos) << 1) |
                                     tdc_vlc_bit(p, pos + 1));
                    pos += 2;
                    if (mod == 3) break;
                }
                v += 1;
            }
        } else {
            return -2;
        }
        if (v > 255) return -2;  // not a literal stream
        if (m >= cap) return -1;
        out[m++] = (uint8_t)v;
    }
    return m;
}

}  // extern "C"
