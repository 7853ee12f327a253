// Host TBC2 frame parser and segment decoder of the torch port.
//
// Copies of the JAX package's native runtime (native/tdc_native.cpp:
// tdc_rle_decode, tdc_huffman_decode, tdc_tbc2_parse, tdc_tbc2_decode),
// so that the port needs nothing of that package. Built with the host
// compiler by _build.py into csrc/build/ and bound with ctypes. The
// container format is described in models/blockcodec.py.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---- RLE decode -------------------------------------------------------
// Decodes the capped-run format (cc + vbyte(run-2+offset)). Returns the
// number of output bytes, or -1 if out_cap would be exceeded, -2 on a
// malformed stream.

int64_t tdc_rle_decode(const uint8_t* in, int64_t n, uint8_t* out,
                       int64_t out_cap, int64_t offset) {
    int64_t o = 0;
    int64_t i = 0;
    int prev = -1;
    while (i < n) {
        uint8_t c = in[i++];
        if (o >= out_cap) return -1;
        out[o++] = c;
        if (int(c) == prev) {
            uint64_t run = 0;
            int shift = 0;
            bool terminated = false;
            while (i < n) {
                uint8_t b = in[i++];
                if (shift > 63) return -2;  // vbyte continuation overflow
                if (shift == 63 && (b & 0x7F) > 1) return -2;
                run |= uint64_t(b & 0x7F) << shift;
                shift += 7;
                if (!(b & 0x80)) { terminated = true; break; }
            }
            // input ended mid-vbyte: reject instead of using the partial
            // value
            if (!terminated) return -2;
            if (offset < 0 || run < uint64_t(offset)) return -2;
            run -= uint64_t(offset);
            if (run > uint64_t(out_cap) || o + int64_t(run) > out_cap) return -1;
            memset(out + o, c, size_t(run));
            o += int64_t(run);
            prev = int(c);  // the reference keeps prev armed after a run
        } else {
            prev = int(c);
        }
    }
    return o;
}

// ---- canonical Huffman decode ----------------------------------------
// MSB-first payload; lut_sym/lut_len are 2^k entries (full-depth LUT).
// Returns bits consumed, or -1 on error.

int64_t tdc_huffman_decode(const uint8_t* payload, int64_t payload_len,
                           int64_t count, const uint8_t* lut_sym,
                           const uint8_t* lut_len, int k,
                           uint8_t* out) {
    uint64_t window = 0;
    int have = 0;
    int64_t pos = 0;  // next payload byte
    int64_t bits_used = 0;
    for (int64_t i = 0; i < count; i++) {
        while (have < k && pos < payload_len) {
            window = (window << 8) | payload[pos++];
            have += 8;
        }
        if (have < k) {  // pad with zeros at stream end
            window <<= (k - have);
            have = k;
        }
        uint64_t idx = (window >> (have - k)) & ((1ULL << k) - 1);
        uint8_t len = lut_len[idx];
        if (len == 0 || len > have) return -1;
        out[i] = lut_sym[idx];
        have -= len;
        bits_used += len;
    }
    return bits_used;
}

// ---- TBC2 container ---------------------------------------------------
// Per-segment framing: vbyte(count<<2 | rle_raw<<1 | huff_raw),
// vbyte(payload_bytes), payload.

static inline int64_t tbc2_read_vbyte(const uint8_t* d, int64_t n,
                                      int64_t* pos, uint64_t* out) {
    uint64_t v = 0;
    int shift = 0;
    while (*pos < n) {
        uint8_t b = d[(*pos)++];
        if (shift > 63) return -2;
        v |= uint64_t(b & 0x7F) << shift;
        shift += 7;
        if (!(b & 0x80)) { *out = v; return 0; }
    }
    return -2;
}

// Fills the per-segment arrays; returns the position after the last
// frame, or -2 on a malformed container.
int64_t tdc_tbc2_parse(const uint8_t* data, int64_t n, int64_t pos,
                       int64_t nseg, uint32_t* counts, uint8_t* flags,
                       int64_t* poff, int64_t* pbytes) {
    for (int64_t i = 0; i < nseg; i++) {
        uint64_t m1, m2;
        if (tbc2_read_vbyte(data, n, &pos, &m1) < 0) return -2;
        if (tbc2_read_vbyte(data, n, &pos, &m2) < 0) return -2;
        // a count past 32 bits would alias under the uint32_t store, and
        // a payload length >= 2^63 would wrap pos negative
        if ((m1 >> 2) > 0xFFFFFFFFull) return -2;
        if (m2 > uint64_t(n)) return -2;
        counts[i] = uint32_t(m1 >> 2);
        flags[i] = uint8_t(m1 & 3);
        poff[i] = pos;
        pbytes[i] = int64_t(m2);
        pos += int64_t(m2);
        if (pos > n) return -2;
    }
    return pos;
}

// Decodes segments [lo, hi). out holds orig_len bytes; segment i writes
// out[i*seg .. i*seg + min(seg, orig_len - i*seg)). Returns 0, or -2 on
// malformed input. Touches no Python object: callers run disjoint
// ranges on several threads.
int64_t tdc_tbc2_decode(const uint8_t* data, const uint32_t* counts,
                        const uint8_t* flags, const int64_t* poff,
                        const int64_t* pbytes, int64_t lo, int64_t hi,
                        const uint8_t* lut_sym, const uint8_t* lut_len,
                        int k, int64_t seg, int64_t orig_len,
                        int64_t offset, uint8_t* out) {
    std::vector<uint8_t> syms(size_t(2 * seg));
    for (int64_t i = lo; i < hi; i++) {
        int64_t n_out = orig_len - i * seg;
        if (n_out > seg) n_out = seg;
        if (n_out <= 0) break;
        int64_t cnt = int64_t(counts[i]);
        if (cnt > 2 * seg) return -2;
        const uint8_t* payload = data + poff[i];
        int64_t pb = pbytes[i];
        const uint8_t* sp;
        if (flags[i] & 1) {  // huff_raw: verbatim symbol bytes
            if (cnt > pb) return -2;
            sp = payload;
        } else {
            if (k <= 0) return -2;
            if (tdc_huffman_decode(payload, pb, cnt, lut_sym, lut_len,
                                   k, syms.data()) < 0)
                return -2;
            sp = syms.data();
        }
        uint8_t* dst = out + i * seg;
        if (flags[i] & 2) {  // rle_raw: symbols are output bytes
            if (cnt < n_out) return -2;
            memcpy(dst, sp, size_t(n_out));
        } else {
            int64_t got = tdc_rle_decode(sp, cnt, dst, n_out, offset);
            if (got != n_out) return -2;
        }
    }
    return 0;
}

}  // extern "C"
