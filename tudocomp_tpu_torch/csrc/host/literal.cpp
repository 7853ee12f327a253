// Host kernels of the port's literal-stream compressors: MTF (whole
// buffers and chunks with carried table state), the chunked RLE decode
// of the one-pass stream path, the Huffman symbol count of `encode`'s
// bulk decode, and the arithmetic coder's block-code encoder and
// decoder.
//
// Copies of the JAX package's native runtime (native/tdc_native.cpp:
// tdc_mtf_encode, tdc_mtf_decode, tdc_mtf_encode_s, tdc_mtf_decode_s,
// tdc_rle_decode_s, tdc_huffman_count, tdc_arith_encode,
// tdc_arith_decode), so that the port needs nothing of that package; the
// MTF entry points return 0 where the originals return void, since every
// entry point of the host library returns int64. The whole-buffer RLE
// decode is csrc/host/tbc2.cpp's. Built with the host compiler by
// _build.py into csrc/build/ and bound with ctypes by native.py.

#include <cstdint>
#include <cstring>

extern "C" {

// ---- MTF ----------------------------------------------------------------

int64_t tdc_mtf_encode(const uint8_t* in, uint8_t* out, int64_t n) {
    uint8_t table[256];
    for (int i = 0; i < 256; i++) table[i] = uint8_t(i);
    for (int64_t i = 0; i < n; i++) {
        uint8_t c = in[i];
        uint8_t j = 0;
        while (table[j] != c) j++;
        out[i] = j;
        memmove(table + 1, table, j);
        table[0] = c;
    }
    return 0;
}

int64_t tdc_mtf_decode(const uint8_t* in, uint8_t* out, int64_t n) {
    uint8_t table[256];
    for (int i = 0; i < 256; i++) table[i] = uint8_t(i);
    for (int64_t i = 0; i < n; i++) {
        uint8_t j = in[i];
        uint8_t c = table[j];
        out[i] = c;
        memmove(table + 1, table, j);
        table[0] = c;
    }
    return 0;
}

// MTF with caller-owned table state (256 bytes, identity-initialized by
// the caller before the first chunk).
int64_t tdc_mtf_encode_s(const uint8_t* in, uint8_t* out, int64_t n,
                         uint8_t* table) {
    for (int64_t i = 0; i < n; i++) {
        uint8_t c = in[i];
        uint8_t j = 0;
        while (table[j] != c) j++;
        out[i] = j;
        memmove(table + 1, table, j);
        table[0] = c;
    }
    return 0;
}

int64_t tdc_mtf_decode_s(const uint8_t* in, uint8_t* out, int64_t n,
                         uint8_t* table) {
    for (int64_t i = 0; i < n; i++) {
        uint8_t j = in[i];
        uint8_t c = table[j];
        out[i] = c;
        memmove(table + 1, table, j);
        table[0] = c;
    }
    return 0;
}

// ---- RLE stream decode ----------------------------------------------------

// RLE decode over a chunk, carrying `prev` across calls. Stops cleanly
// before a token whose vbyte run-length is cut by the chunk end when
// final_chunk == 0 (the caller re-feeds the tail with the next chunk).
// Returns bytes produced; *consumed <- input bytes consumed.
// -1: out_cap too small (caller grows and retries the same chunk),
// -2: malformed stream.
int64_t tdc_rle_decode_s(const uint8_t* in, int64_t n, uint8_t* out,
                         int64_t out_cap, int64_t offset,
                         int64_t* prev_io, int final_chunk,
                         int64_t* consumed) {
    int64_t o = 0;
    int64_t i = 0;
    int64_t prev = *prev_io;
    while (i < n) {
        int64_t tok = i;
        uint8_t c = in[i++];
        if (int64_t(c) == prev) {
            uint64_t run = 0;
            int shift = 0;
            bool terminated = false;
            while (i < n) {
                uint8_t b = in[i++];
                if (shift > 63) return -2;
                if (shift == 63 && (b & 0x7F) > 1) return -2;
                run |= uint64_t(b & 0x7F) << shift;
                shift += 7;
                if (!(b & 0x80)) { terminated = true; break; }
            }
            if (!terminated) {
                if (final_chunk) return -2;
                i = tok;  // hold the whole token for the next chunk
                break;
            }
            if (offset < 0 || run < uint64_t(offset)) return -2;
            run -= uint64_t(offset);
            if (o >= out_cap ||
                run > uint64_t(out_cap) || o + 1 + int64_t(run) > out_cap) {
                *consumed = tok;
                *prev_io = prev;
                return -1;
            }
            out[o++] = c;
            memset(out + o, c, size_t(run));
            o += int64_t(run);
            prev = int64_t(c);
        } else {
            if (o >= out_cap) {
                *consumed = tok;
                *prev_io = prev;
                return -1;
            }
            out[o++] = c;
            prev = int64_t(c);
        }
    }
    *consumed = i;
    *prev_io = prev;
    return o;
}

// ---- Huffman symbol count -------------------------------------------------
// Count symbols decodable from the payload until bits are exhausted.
int64_t tdc_huffman_count(const uint8_t* payload, int64_t nbits,
                          const uint8_t* lut_len, int k) {
    int64_t pos = 0;
    int64_t count = 0;
    while (pos < nbits) {
        int64_t w = 0;
        for (int i = 0; i < k; i++) {
            int64_t b = (pos + i < nbits)
                ? ((payload[(pos + i) >> 3] >> (7 - ((pos + i) & 7))) & 1)
                : 0;
            w = (w << 1) | b;
        }
        uint8_t len = lut_len[w];
        if (len == 0) return -1;
        pos += len;
        count++;
    }
    return count;
}


// ---- arithmetic coder ----------------------------------------------------
// Mirrors of coders/arithmetic.py (flush-and-restart 64-bit blocks;
// reference semantics coders/ArithmeticCoder.hpp:72-144). The
// literal-only stream layout (everything after the codebook header) is a
// plain sequence of 64-bit MSB-first code words, one per block, then the
// final lower and ~0.

static inline uint64_t tdc_arith_offset(uint64_t range, uint64_t cum,
                                        uint64_t total) {
    if (range <= total)
        return (uint64_t)((unsigned __int128)range * cum / total);
    return range / total * cum;
}

// data[n] -> out_codes (64-bit block codes incl. the final lower + ~0
// terminator). cum[256] = normalized cumulative counts. Returns the
// number of code words, or -1 if cap is too small.
int64_t tdc_arith_encode(const uint8_t* data, int64_t n,
                         const uint64_t* cum, uint64_t total,
                         uint64_t* out_codes, int64_t cap) {
    const uint64_t UMAX = ~0ull;
    if (n <= 0 || total == 0) return 0;
    uint64_t lower = 0, upper = UMAX;
    const uint64_t min_range = total;
    int64_t m = 0;
    for (int64_t i = 0; i < n; i++) {
        unsigned v = data[i];
        uint64_t rng = upper - lower;
        if (rng < min_range) {
            if (m >= cap) return -1;
            out_codes[m++] = lower;
            lower = 0;
            upper = UMAX;
            rng = UMAX;
        }
        upper = lower + tdc_arith_offset(rng, cum[v], total);
        if (v != 0) lower = lower + tdc_arith_offset(rng, cum[v - 1], total);
    }
    if (m + 2 > cap) return -1;
    out_codes[m++] = lower;
    out_codes[m++] = UMAX;
    return m;
}

// Decode `count` literals from the MSB-first bit stream starting at
// start_bit. syms/cums are the codebook's sigma (symbol, cumulative)
// pairs in symbol order. Returns 0, or -2 on a malformed stream.
int64_t tdc_arith_decode(const uint8_t* payload, int64_t nbits,
                         int64_t start_bit, const uint8_t* syms,
                         const uint64_t* cums, int64_t sigma,
                         uint64_t total, int64_t count, uint8_t* out) {
    const uint64_t UMAX = ~0ull;
    if (count <= 0) return 0;
    if (total == 0 || sigma <= 0) return -2;
    const uint64_t min_range = total;
    int64_t counter = 0;
    int64_t pos = start_bit;
    while (counter < count) {
        if (pos + 64 > nbits) return -2;
        uint64_t code = 0;
        for (int b = 0; b < 64; b++) {
            code = (code << 1) |
                   (uint64_t)((payload[(pos + b) >> 3] >>
                               (7 - ((pos + b) & 7))) & 1);
        }
        pos += 64;
        if (code == UMAX) return -2;  // premature terminator
        uint64_t lower = 0, upper = UMAX;
        uint64_t rng = UMAX;
        while (min_range <= rng && counter < count) {
            uint64_t interval_lower = lower;
            int matched = 0;
            for (int64_t j = 0; j < sigma; j++) {
                upper = lower + tdc_arith_offset(rng, cums[j], total);
                if (code < upper) {
                    out[counter] = syms[j];
                    lower = interval_lower;
                    matched = 1;
                    break;
                }
                interval_lower = upper;
            }
            if (!matched) return -2;  // code outside every interval
            counter++;
            rng = upper - lower;
        }
    }
    return 0;
}

}  // extern "C"
