// Host SLE coder of the torch port: the rank tables, the greedy k-mer
// token emitter, the literal-stream decoder, and the factor-stream
// encoder and decoder with SLE-coded gap literals.
//
// Copies of the JAX package's native runtime (native/tdc_native.cpp:
// tdc_sle_rank, tdc_gamma_tok with tdc_sle_run_tokens, tdc_sle_decode,
// tdc_factor_stream_sle, tdc_lzss_decode_sle), so that the port's sle
// coder needs nothing of that package. Built with the host compiler by
// _build.py into csrc/build/ and bound with ctypes by native.py. Every
// entry point returns int64, as the host library's others do.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// MSB-first bit reader (the fixed-width read of csrc/host/lzss.cpp's
// BitRd); reads past nbits give zero bits.
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
};

}  // namespace

extern "C" {

// ---- SLE rank tables ---------------------------------------------------
// Rank tables (coders/sle.py _rank_tables): top-255 k-gram keys with
// count > 1 ordered by (-count, key), and all present literals ordered by
// (-count, byte). kk <= 4. Returns the k-mer count; *n_lits_out gets the
// literal count.
int64_t tdc_sle_rank(const uint8_t* chars, int64_t n, int kk,
                     int64_t* kmer_keys_out, int64_t max_kmers,
                     uint8_t* lits_out, int64_t max_lits,
                     int64_t* n_lits_out) {
    // literal counts
    int64_t lit_cnt[256] = {0};
    for (int64_t i = 0; i < n; i++) lit_cnt[chars[i]]++;
    struct LC { int64_t cnt; int b; };
    std::vector<LC> lcs;
    for (int b = 0; b < 256; b++)
        if (lit_cnt[b]) lcs.push_back({lit_cnt[b], b});
    std::sort(lcs.begin(), lcs.end(), [](const LC& a, const LC& b) {
        return a.cnt != b.cnt ? a.cnt > b.cnt : a.b < b.b;
    });
    int64_t nl = std::min<int64_t>(int64_t(lcs.size()), max_lits);
    for (int64_t i = 0; i < nl; i++) lits_out[i] = uint8_t(lcs[i].b);
    *n_lits_out = nl;
    // k-gram counts via sort of packed keys
    int64_t nk = 0;
    if (n >= kk && kk >= 1 && kk <= 4) {
        std::vector<uint32_t> keys(size_t(n - kk + 1));
        uint32_t key = 0;
        for (int j = 0; j < kk; j++) key = (key << 8) | chars[j];
        uint32_t mask = kk < 4 ? ((uint32_t(1) << (8 * kk)) - 1)
                               : 0xFFFFFFFFu;
        keys[0] = key;
        for (int64_t i = kk; i < n; i++) {
            key = ((key << 8) | chars[i]) & mask;
            keys[size_t(i - kk + 1)] = key;
        }
        std::sort(keys.begin(), keys.end());
        struct KC { int64_t cnt; uint32_t key; };
        std::vector<KC> kcs;
        for (size_t i = 0; i < keys.size();) {
            size_t j = i;
            while (j < keys.size() && keys[j] == keys[i]) j++;
            if (j - i > 1) kcs.push_back({int64_t(j - i), keys[i]});
            i = j;
        }
        std::sort(kcs.begin(), kcs.end(), [](const KC& a, const KC& b) {
            return a.cnt != b.cnt ? a.cnt > b.cnt : a.key < b.key;
        });
        nk = std::min<int64_t>(int64_t(kcs.size()), max_kmers);
        for (int64_t i = 0; i < nk; i++)
            kmer_keys_out[i] = int64_t(kcs[i].key);
    }
    return nk;
}

// ---- SLE literal-stream decode ---------------------------------------
// Decodes the SLE literal stream until bits are exhausted (flag 1:
// gamma k-mer rank; flag 0 + 1: gamma literal rank; else raw byte).
// Returns output length, -1 on overflow, -2 on malformed input.

int64_t tdc_sle_decode(const uint8_t* payload, int64_t nbits,
                       int64_t start_bit, const uint8_t* kmers,
                       int64_t n_kmers, int kk, const uint8_t* lits,
                       int64_t n_lits, uint8_t* out, int64_t out_cap) {
    BitRd rd{payload, nbits, start_bit};
    int64_t o = 0;
    auto read_gamma = [&]() -> int64_t {
        int zeros = 0;
        while (rd.pos < rd.nbits && rd.read(1) == 0) zeros++;
        return rd.read(zeros);
    };
    while (rd.pos < nbits) {
        if (rd.read(1)) {
            int64_t r = read_gamma();
            if (r >= n_kmers) return -2;
            if (o + kk > out_cap) return -1;
            memcpy(out + o, kmers + r * kk, size_t(kk));
            o += kk;
        } else if (rd.pos >= nbits) {
            break;
        } else if (rd.read(1)) {
            int64_t r = read_gamma();
            if (r >= n_lits) return -2;
            if (o >= out_cap) return -1;
            out[o++] = lits[r];
        } else {
            if (o >= out_cap) return -1;
            out[o++] = uint8_t(rd.read(8));
        }
    }
    return o;
}

// ---- SLE token emission + SLE factor-stream decode ----------------------
// Host-side SLE coder kernels (coders/sle.py). Bit-identical to the
// Python scalar emitter: per emission either (flag=1, gamma(kmer rank))
// or (flag=0, flag, gamma(lit rank) | raw byte). Gamma of v is one token
// of value (1<<b)|v and length 2b+1 with b = bits_for(v) >= 1

static inline uint64_t tdc_gamma_tok(int64_t v, int64_t* len_out) {
    int b = 1;
    while ((uint64_t(v) >> b) != 0) b++;
    *len_out = 2 * int64_t(b) + 1;
    return (uint64_t(1) << b) | uint64_t(v);
}

// Greedy 3-gram matcher over one literal run buf[0..n); emits tokens for
// emissions starting strictly below `limit`. Appends to values/lens at
// *ntok_inout. Returns the consumed byte count, or -1 on token overflow.
int64_t tdc_sle_run_tokens(const uint8_t* buf, int64_t n, int64_t limit,
                           const int64_t* sorted_keys,
                           const int64_t* key_rank, int64_t n_kmers,
                           int kk, const int32_t* lit_rank,
                           uint64_t* values, int64_t* lens, int64_t cap,
                           int64_t* ntok_inout) {
    int64_t nt = *ntok_inout;
    int64_t i = 0;
    while (i < limit) {
        int64_t rank = -1;
        if (n_kmers > 0 && i + kk <= n) {
            int64_t key = 0;
            for (int j = 0; j < kk; j++) key = (key << 8) | buf[i + j];
            int64_t lo = 0, hi = n_kmers;
            while (lo < hi) {
                int64_t mid = (lo + hi) >> 1;
                if (sorted_keys[mid] < key) lo = mid + 1; else hi = mid;
            }
            if (lo < n_kmers && sorted_keys[lo] == key)
                rank = key_rank[lo];
        }
        if (rank >= 0) {
            if (nt + 2 > cap) return -1;
            values[nt] = 1; lens[nt] = 1; nt++;
            int64_t gl; uint64_t gv = tdc_gamma_tok(rank, &gl);
            values[nt] = gv; lens[nt] = gl; nt++;
            i += kk;
        } else {
            if (nt + 3 > cap) return -1;
            values[nt] = 0; lens[nt] = 1; nt++;
            int32_t lr = lit_rank[buf[i]];
            if (lr >= 0) {
                values[nt] = 1; lens[nt] = 1; nt++;
                int64_t gl; uint64_t gv = tdc_gamma_tok(lr, &gl);
                values[nt] = gv; lens[nt] = gl; nt++;
            } else {
                values[nt] = 0; lens[nt] = 1; nt++;
                values[nt] = buf[i]; lens[nt] = 8; nt++;
            }
            i += 1;
        }
    }
    *ntok_inout = nt;
    return i;
}

// Whole factor-stream body under the SLE coder (lzss/LZSSCoding.hpp
// layout after the 4 header fields): per factor a gap flag bit,
// [gap length in w_dist bits, SLE gap literal tokens], src in w_src
// bits, (len - flen_min) in w_len bits; then a trailing literal run.
// Each gap is matched independently (the scalar coder flushes `final`
// before every non-literal field). Returns the token count or -1.
int64_t tdc_factor_stream_sle(const uint8_t* text, int64_t n,
                              const int64_t* fpos, const int64_t* fsrc,
                              const int64_t* flen, int64_t nfac,
                              int w_src, int w_len, int w_dist,
                              int64_t flen_min,
                              const int64_t* sorted_keys,
                              const int64_t* key_rank, int64_t n_kmers,
                              int kk, const int32_t* lit_rank,
                              uint64_t* values, int64_t* lens,
                              int64_t cap) {
    int64_t nt = 0;
    int64_t p = 0;
    auto emit_gap = [&](int64_t start, int64_t glen) -> bool {
        if (nt + 2 > cap) return false;
        values[nt] = 1; lens[nt] = 1; nt++;
        values[nt] = uint64_t(glen); lens[nt] = w_dist; nt++;
        int64_t got = tdc_sle_run_tokens(
            text + start, glen, glen, sorted_keys, key_rank, n_kmers,
            kk, lit_rank, values, lens, cap, &nt);
        return got == glen;
    };
    for (int64_t f = 0; f < nfac; f++) {
        if (fpos[f] == p) {
            if (nt + 1 > cap) return -1;
            values[nt] = 0; lens[nt] = 1; nt++;
        } else {
            if (!emit_gap(p, fpos[f] - p)) return -1;
            p = fpos[f];
        }
        if (nt + 2 > cap) return -1;
        values[nt] = uint64_t(fsrc[f]); lens[nt] = w_src; nt++;
        values[nt] = uint64_t(flen[f] - flen_min); lens[nt] = w_len; nt++;
        p += flen[f];
    }
    if (p < n) {
        if (!emit_gap(p, n - p)) return -1;
    }
    return nt;
}

// Factor-stream decode with SLE-coded gap literals (modes as in
// tdc_lzss_decode). Returns -2 on malformed input, -1 on overflow.
int64_t tdc_lzss_decode_sle(const uint8_t* payload, int64_t nbits,
                            int64_t start_bit, int64_t n,
                            int64_t flen_min, int w_src, int w_len,
                            int w_dist, const uint8_t* kmers,
                            int64_t n_kmers, int kk,
                            const uint8_t* lits, int64_t n_lits,
                            int mode, uint8_t* out, int64_t out_cap,
                            int64_t* fpos, int64_t* fsrc, int64_t* flen,
                            int64_t fcap, int64_t* nfac_out) {
    if (kk < 1 || kk > 8) return -2;
    BitRd rd{payload, nbits, start_bit};
    int64_t cursor = 0;
    int64_t litc = 0;
    int64_t nfac = 0;
    auto read_gamma = [&]() -> int64_t {
        int zeros = 0;
        while (rd.pos < rd.nbits && rd.read(1) == 0) zeros++;
        return rd.read(zeros);
    };
    uint8_t run[8];
    while (rd.pos < nbits) {
        int64_t flag = rd.read(1);
        if (flag) {
            if (rd.pos >= nbits) break;
            int64_t num = rd.read(w_dist);
            int64_t produced = 0;
            while (produced < num) {
                int64_t take;
                if (rd.read(1)) {
                    int64_t r = read_gamma();
                    if (r >= n_kmers || produced + kk > num) return -2;
                    memcpy(run, kmers + r * kk, size_t(kk));
                    take = kk;
                } else if (rd.read(1)) {
                    int64_t r = read_gamma();
                    if (r >= n_lits) return -2;
                    run[0] = lits[r];
                    take = 1;
                } else {
                    run[0] = uint8_t(rd.read(8));
                    take = 1;
                }
                for (int64_t j = 0; j < take; j++) {
                    if (mode == 0) {
                        if (cursor >= out_cap) return -1;
                        out[cursor++] = run[j];
                    } else {
                        if (litc >= out_cap) return -1;
                        out[litc++] = run[j];
                        cursor++;
                    }
                }
                produced += take;
            }
        }
        if (rd.pos >= nbits) break;
        int64_t src = rd.read(w_src);
        int64_t len = rd.read(w_len) + flen_min;
        if (mode == 0) {
            if (cursor + len > out_cap || src + len > out_cap) return -1;
            if (src < 0 || src >= cursor) return -2;
            for (int64_t i = 0; i < len; i++)
                out[cursor + i] = out[src + i];
            cursor += len;
        } else {
            if (nfac >= fcap) return -1;
            fpos[nfac] = cursor; fsrc[nfac] = src; flen[nfac] = len;
            nfac++;
            cursor += len;
        }
    }
    if (nfac_out) *nfac_out = nfac;
    return (mode == 0) ? cursor : litc;
}

}  // extern "C"
