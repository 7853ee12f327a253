// MSB-first bit reader and writer of the host library, shared by its
// stream coders (csrc/host/lzss.cpp, lzss_window.cpp, lz78.cpp,
// repair.cpp, lz78u.cpp, lfs.cpp).
//
// Copies of the JAX package's native runtime (native/tdc_native.cpp:
// BitRd, TdcBitWr, tdc_bits_for). The integer code kinds are the ones
// of coders/__init__.py:native_code_kind: 0 fixed width, 1 Elias gamma,
// 2 Elias delta, 3 ternary, 4 ascii decimal.

#pragma once

#include <cstdint>

struct BitRd {
    const uint8_t* p;
    int64_t nbits;
    int64_t pos;
    inline int64_t read(int w) {
        if (w == 0) return 0;
        int64_t v = 0;
        for (int i = 0; i < w; i++) {
            int64_t b = (pos < nbits)
                ? ((p[pos >> 3] >> (7 - (pos & 7))) & 1) : 0;
            v = (v << 1) | b;
            pos++;
        }
        return v;
    }
    // variable-length integer codes (mirror io/bitio.py readers);
    // every reader returns -1 on a truncated/overlong code
    inline int64_t read_unary() {
        int64_t z = 0;
        while (pos < nbits &&
               !((p[pos >> 3] >> (7 - (pos & 7))) & 1)) { z++; pos++; }
        if (pos >= nbits) return -1;
        pos++;  // the terminating 1
        return z;
    }
    inline int64_t read_gamma() {
        int64_t m = read_unary();
        if (m < 0 || m > 62 || pos + m > nbits) return -1;
        return read(int(m));
    }
    inline int64_t read_delta() {
        int64_t m = read_gamma();
        if (m < 0 || m > 62 || pos + m > nbits) return -1;
        return read(int(m));
    }
    inline int64_t read_ternary() {
        if (pos + 2 > nbits) return -1;
        int64_t mod = read(2);
        int64_t v = 0;
        if (mod < 3) {
            int64_t b3 = 1;
            for (;;) {
                v += mod * b3;
                b3 *= 3;
                if (pos + 2 > nbits) return -1;
                mod = read(2);
                if (mod == 3) break;
                if (b3 > (int64_t(1) << 60)) return -1;
            }
            v += 1;
        }
        return v;
    }
    inline int64_t read_ascii_int() {
        // decimal digits then one terminator byte (ASCIICoder)
        int64_t v = 0;
        bool any = false;
        for (;;) {
            if (pos + 8 > nbits) return any ? v : -1;
            int64_t c = read(8);
            if (c < '0' || c > '9') break;
            any = true;
            if (v > (int64_t(1) << 55)) return -1;
            v = v * 10 + (c - '0');
        }
        return v;
    }
    // kind: 0 = fixed width w, 1 = gamma, 2 = delta, 3 = ternary,
    // 4 = ascii decimal
    inline int64_t read_code(int kind, int w) {
        switch (kind) {
            case 0: return read(w);
            case 1: return read_gamma();
            case 2: return read_delta();
            case 3: return read_ternary();
            default: return read_ascii_int();
        }
    }
    // the coders' BitRange: 1 bit, except ascii's '0'/'1' byte
    inline int64_t read_flag(int kind) {
        if (kind == 4) {
            if (pos + 8 > nbits) return -1;
            return read(8) == '0' ? 0 : 1;
        }
        return read(1);
    }
};

// Bit writer of the one-pass encoders: put() of width w, the VLC
// family by code kind; each put returns -1 once cap_bits is full.
struct TdcBitWr {
    uint8_t* p;
    int64_t cap_bits;
    int64_t pos;
    inline int put(uint64_t v, int64_t w) {
        if (pos + w > cap_bits) return -1;
        for (int64_t i = w - 1; i >= 0; i--) {
            uint64_t b = (v >> i) & 1;
            int64_t q = pos >> 3;
            int r = int(7 - (pos & 7));
            p[q] = (uint8_t)((p[q] & ~(1u << r)) | (unsigned(b) << r));
            pos++;
        }
        return 0;
    }
    inline int put_gamma(uint64_t v) {
        int64_t nb = v ? 64 - __builtin_clzll(v) : 1;
        if (put(1, nb + 1)) return -1;  // unary(nb): nb zeros then 1
        return put(v, nb);
    }
    inline int put_delta(uint64_t v) {
        int64_t nb = v ? 64 - __builtin_clzll(v) : 1;
        if (put_gamma((uint64_t)nb)) return -1;
        return put(v, nb);
    }
    inline int put_ternary(uint64_t v) {
        if (v) {
            v -= 1;
            for (;;) {
                if (put(v % 3, 2)) return -1;
                v /= 3;
                if (!v) break;
            }
        }
        return put(3, 2);
    }
    inline int put_ascii_int(uint64_t v) {
        char buf[24];
        int m = 0;
        do { buf[m++] = char('0' + v % 10); v /= 10; } while (v);
        for (int i = m - 1; i >= 0; i--)
            if (put((uint64_t)(unsigned char)buf[i], 8)) return -1;
        return put(':', 8);
    }
    // fixed width w for kind 0, else the VLC family
    inline int put_code(int kind, uint64_t v, int64_t w) {
        switch (kind) {
            case 0: return put(v, w);
            case 1: return put_gamma(v);
            case 2: return put_delta(v);
            case 3: return put_ternary(v);
            default: return put_ascii_int(v);
        }
    }
    inline int put_flag(int kind, int v) {
        if (kind == 4) return put(v ? '1' : '0', 8);
        return put(v, 1);
    }
};

static inline int64_t tdc_bits_for(uint64_t v) {
    return v ? 64 - __builtin_clzll(v) : 1;
}
