// Host LZ78 and LZW of the torch port: the whole-stream decoders for
// every integer code kind, and the one-pass stream encoder and decoder
// handles, which also serve the buffered encode.
//
// Copies of the JAX package's native runtime (native/tdc_native.cpp:
// mix :177-181, tdc_lz78_stream_decode :3104-3141,
// tdc_lzw_stream_decode :3143-3200, TdcLz78S with tdc_lz78s_new/free/feed :3820-3974, TdcLz78DS with
// tdc_lz78ds_new/free/feed/take :3991-4145), so that the port's lz78
// and lzw need nothing of that package; the handles' free functions
// return 0 where the originals return void, since every entry point of
// the host library returns int64 (the new functions return the
// handle). One change: tdc_lz78ds_feed takes, in a non-final feed, only
// the tokens that end before its last bit, so that an ascii code cut at
// the chunk edge is not decoded short (the original decodes such an
// lzw(coder=ascii) stream into wrong bytes). Built with the host
// compiler by _build.py into csrc/build/ and bound with ctypes by
// native.py.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

#include "bitrw.hpp"

// 64-bit finalizer mix of the dictionary keys (parent << 8) | char
static inline uint64_t mix(uint64_t x) {
    x ^= x >> 33; x *= 0xff51afd7ed558ccdULL;
    x ^= x >> 33; x *= 0xc4ceb9fe1a85ec53ULL;
    x ^= x >> 33; return x;
}

// ---------------------------------------------------------------------------
// LZ78 / LZW whole-stream decode for any integer code kind (incl. the
// growing Range(count) fixed widths and the dictionary reset), mirrors
// compressors/lz78.py decompress / lzw.py decompress exactly.
// ---------------------------------------------------------------------------

extern "C" {

int64_t tdc_lz78_stream_decode(const uint8_t* p, int64_t nbits,
                               int64_t pos0, int code_kind,
                               int64_t dict_max, uint8_t* out,
                               int64_t cap) {
    BitRd rd{p, nbits, pos0};
    std::vector<int64_t> start, len;
    int64_t cursor = 0, fc = 0;
    while (rd.pos < nbits) {
        int64_t ref = rd.read_code(
            code_kind, int(tdc_bits_for((uint64_t)fc)));
        if (ref < 0 || rd.pos >= nbits) return -2;
        int64_t c;
        if (code_kind == 1 || code_kind == 2 || code_kind == 3) {
            c = rd.read_code(code_kind, 8);
        } else {
            if (rd.pos + 8 > nbits) return -2;
            c = rd.read(8);
        }
        if (c < 0 || c > 255) return -2;
        if (ref > fc) return -2;  // must point to an emitted factor
        int64_t plen = ref ? len[size_t(ref - 1)] + 1 : 1;
        if (cursor + plen > cap) return -1;
        if (ref)
            memcpy(out + cursor, out + start[size_t(ref - 1)],
                   size_t(len[size_t(ref - 1)]));
        out[cursor + plen - 1] = (uint8_t)c;
        start.push_back(cursor);
        len.push_back(plen);
        cursor += plen;
        fc++;
        if (dict_max && fc + 1 == dict_max) {
            start.clear();
            len.clear();
            fc = 0;
        }
    }
    return cursor;
}

int64_t tdc_lzw_stream_decode(const uint8_t* p, int64_t nbits,
                              int64_t pos0, int code_kind,
                              int64_t dict_max, uint8_t* out,
                              int64_t cap) {
    BitRd rd{p, nbits, pos0};
    const int64_t NONE = -1;
    std::vector<int32_t> pref;
    std::vector<uint8_t> lastc;
    auto reset = [&] {
        pref.assign(256, int32_t(NONE));
        lastc.resize(256);
        for (int j = 0; j < 256; j++) lastc[size_t(j)] = (uint8_t)j;
    };
    reset();
    int64_t counter = 0, i = NONE, cursor = 0;
    const int64_t reset_after = dict_max - 256;
    std::vector<uint8_t> tmp;
    auto rebuild = [&](int64_t k) {
        tmp.clear();
        while (k != NONE) {
            tmp.push_back(lastc[size_t(k)]);
            k = pref[size_t(k)];
        }
        std::reverse(tmp.begin(), tmp.end());
    };
    for (;;) {
        if (reset_after > 0 && counter == reset_after) {
            reset();
            counter = 0;
            i = NONE;
        }
        if (rd.pos >= nbits) break;
        int64_t k = rd.read_code(
            code_kind, int(tdc_bits_for((uint64_t)(counter + 256))));
        if (k < 0) return -2;
        counter++;
        if (k > (int64_t)pref.size()) return -2;
        if (k == (int64_t)pref.size()) {
            if (i == NONE) return -2;  // self-reference with no prior
            rebuild(i);
            uint8_t f0 = tmp[0];
            pref.push_back((int32_t)i);
            lastc.push_back(f0);
            rebuild(k);
        } else {
            rebuild(k);
            if (i != NONE) {
                pref.push_back((int32_t)i);
                lastc.push_back(tmp[0]);
            }
        }
        if (cursor + (int64_t)tmp.size() > cap) return -1;
        memcpy(out + cursor, tmp.data(), tmp.size());
        cursor += (int64_t)tmp.size();
        i = k;
    }
    return cursor;
}

}  // extern "C"

// ---- streaming LZ78/LZW parse+encode ------------------------------------
// Reference parity: LZ78/LZW stream one pass via as_stream()
// (compressors/LZ78Compressor.hpp:67, LZWCompressor.hpp:42). A heap-held
// handle carries the dictionary (open-addressing hash keyed by
// (parent << 8) | char, grown by rehash), the current node walk, and the
// factor counter across caller-sized chunks; each feed() encodes the
// factors completed inside the chunk as a bit run starting at bit 0
// (the caller splices runs through StreamBitSink). Token format and the
// dict_size reset mirror the JAX package's trie walks in
// compressors/lz78.py and lzw.py compress() exactly (reset when the trie
// size reaches dict_max; LZ78 size = factors + root, LZW size = factors
// + 256 roots).

struct TdcLz78S {
    std::vector<uint64_t> keys;
    std::vector<uint32_t> vals;
    uint64_t mask = 0;
    int64_t used = 0;
    int lzw = 0;
    int64_t dict_limit = 0;
    uint32_t next_id = 1;    // LZ78 fresh id (0 = root)
    uint32_t lzw_next = 256; // LZW fresh id (roots preseeded)
    uint32_t node = 0;       // current walk node
    uint32_t parent = 0;     // LZ78: node's parent for the tail factor
    uint8_t last_c = 0;
    int lzw_active = 0;      // LZW: a walk is open
    int64_t factor_count = 0;
};

static void tdc78s_rehash(TdcLz78S* s, size_t ncap) {
    std::vector<uint64_t> keys(ncap, ~0ULL);
    std::vector<uint32_t> vals(ncap, 0);
    uint64_t mask = uint64_t(ncap) - 1;
    for (size_t i = 0; i < s->keys.size(); i++) {
        if (s->keys[i] == ~0ULL) continue;
        uint64_t h = mix(s->keys[i]) & mask;
        while (keys[h] != ~0ULL) h = (h + 1) & mask;
        keys[h] = s->keys[i];
        vals[h] = s->vals[i];
    }
    s->keys.swap(keys);
    s->vals.swap(vals);
    s->mask = mask;
}

extern "C" {

void* tdc_lz78s_new(int lzw, int64_t dict_limit) {
    TdcLz78S* s = new (std::nothrow) TdcLz78S();
    if (!s) return nullptr;
    size_t cap = 1 << 16;
    if (dict_limit > 0) {  // bounded dictionary: size for it up front
        size_t want = size_t(4 * dict_limit + 1024);
        while (cap < want && cap < (size_t(1) << 28)) cap <<= 1;
    }
    s->keys.assign(cap, ~0ULL);
    s->vals.assign(cap, 0);
    s->mask = uint64_t(cap) - 1;
    s->lzw = lzw;
    s->dict_limit = dict_limit;
    return s;
}

int64_t tdc_lz78s_free(void* h) {
    delete static_cast<TdcLz78S*>(h);
    return 0;
}

// Feed one chunk; encode completed factors into `out` (bits from 0).
// final_chunk == 1 additionally flushes the trailing partial phrase.
// Returns bits written, or -1 if cap_bits is too small.
int64_t tdc_lz78s_feed(void* h, const uint8_t* in, int64_t n,
                       int final_chunk, int code_kind,
                       uint8_t* out, int64_t cap_bits) {
    TdcLz78S* s = static_cast<TdcLz78S*>(h);
    TdcBitWr wr{out, cap_bits, 0};

    auto find_or_insert = [&](uint32_t par, uint8_t c,
                              uint32_t fresh) -> int64_t {
        if (uint64_t(s->used + 1) * 2 > s->keys.size())
            tdc78s_rehash(s, s->keys.size() * 2);
        uint64_t key = (uint64_t(par) << 8) | c;
        uint64_t hh = mix(key) & s->mask;
        while (true) {
            if (s->keys[hh] == ~0ULL) {
                s->keys[hh] = key;
                s->vals[hh] = fresh;
                s->used++;
                return -1;  // inserted
            }
            if (s->keys[hh] == key) return int64_t(s->vals[hh]);
            hh = (hh + 1) & s->mask;
        }
    };
    auto reset_dict = [&]() {
        std::fill(s->keys.begin(), s->keys.end(), ~0ULL);
        s->used = 0;
        s->factor_count = 0;
    };
    auto emit_ref = [&](uint32_t ref, uint64_t range_max) -> int {
        return wr.put_code(code_kind, ref, tdc_bits_for(range_max));
    };
    auto emit_lit = [&](uint8_t c) -> int {
        if (code_kind == 1 || code_kind == 2 || code_kind == 3)
            return wr.put_code(code_kind, c, 8);
        return wr.put(c, 8);  // bit/ascii: raw byte
    };

    for (int64_t i = 0; i < n; i++) {
        uint8_t c = in[i];
        s->last_c = c;
        if (!s->lzw) {
            int64_t child = find_or_insert(s->node, c, s->next_id);
            if (child < 0) {
                if (emit_ref(s->node, uint64_t(s->factor_count)))
                    return -1;
                if (emit_lit(c)) return -1;
                s->factor_count++;
                s->next_id++;
                s->parent = s->node = 0;
                // trie.size (= next_id) reached dict_size -> reset
                if (s->dict_limit &&
                    s->next_id == uint32_t(s->dict_limit)) {
                    reset_dict();
                    s->next_id = 1;
                }
            } else {
                s->parent = s->node;
                s->node = uint32_t(child);
            }
        } else {
            if (!s->lzw_active) {
                s->node = c;
                s->lzw_active = 1;
                continue;
            }
            int64_t child = find_or_insert(s->node, c, s->lzw_next);
            if (child < 0) {
                if (emit_ref(s->node,
                             uint64_t(s->factor_count) + 256))
                    return -1;
                s->factor_count++;
                s->lzw_next++;
                s->node = c;  // walk restarts at root c (kept across reset)
                // trie.size (= lzw_next) reached dict_size -> reset
                if (s->dict_limit &&
                    s->lzw_next == uint32_t(s->dict_limit)) {
                    reset_dict();
                    s->lzw_next = 256;
                }
            } else {
                s->node = uint32_t(child);
            }
        }
    }
    if (final_chunk) {
        if (!s->lzw) {
            if (s->node != 0) {
                if (emit_ref(s->parent, uint64_t(s->factor_count)))
                    return -1;
                if (emit_lit(s->last_c)) return -1;
                s->node = 0;
            }
        } else if (s->lzw_active) {
            if (emit_ref(s->node, uint64_t(s->factor_count) + 256))
                return -1;
            s->lzw_active = 0;
        }
    }
    return wr.pos;
}

}  // extern "C"

// ---- streaming LZ78/LZW decode ------------------------------------------
// One-pass decode parity with the reference decompressors
// (LZ78Compressor.hpp:16-38 replays (ref, literal) pairs;
// LZWCompressor.hpp uses lzw::decode_step): a heap-held handle carries
// the undecoded bit tail plus the O(dict) expansion state across
// chunks. Factor expansion walks the (parent, char) chains backward —
// no reliance on output history, so output streams out chunk by chunk
// (total walk cost equals the output size). The final-byte convention
// (io/spec.md Finalization) needs the stream's last two bytes, so two
// bytes are held back until the final feed. Token decode rolls back to
// the token start on bit underrun (the VLC readers return -1 and the
// fixed-width reader overshoots nbits detectably).

struct TdcLz78DS {
    std::vector<uint8_t> pend;  // undecoded payload tail
    int64_t bit_off = 0;        // consumed bits within pend[0]
    int lzw = 0;
    int code_kind = 0;
    int64_t dict_max = 0;
    // LZ78: factor (ref, char); LZW: (pref, lastc) + open prev code
    std::vector<int32_t> ref;
    std::vector<uint8_t> ch;
    std::vector<int32_t> pref;
    std::vector<uint8_t> lastc;
    int64_t lzw_prev = -1;
    int64_t fc = 0, counter = 0;
    std::vector<uint8_t> tmp, out;

    void lzw_reset() {
        pref.assign(256, -1);
        lastc.resize(256);
        for (int j = 0; j < 256; j++) lastc[size_t(j)] = (uint8_t)j;
    }
};

extern "C" {

void* tdc_lz78ds_new(int lzw, int64_t dict_max, int code_kind) {
    TdcLz78DS* s = new (std::nothrow) TdcLz78DS();
    if (!s) return nullptr;
    s->lzw = lzw;
    s->dict_max = dict_max;
    s->code_kind = code_kind;
    if (lzw) s->lzw_reset();
    return s;
}

int64_t tdc_lz78ds_free(void* h) {
    delete static_cast<TdcLz78DS*>(h);
    return 0;
}

// Feed a compressed chunk; decoded bytes accumulate in the handle
// (drain with tdc_lz78ds_take). Returns the number of decoded bytes
// now available, or -2 on a malformed stream.
int64_t tdc_lz78ds_feed(void* h, const uint8_t* in, int64_t n,
                        int final_chunk) {
    TdcLz78DS* s = static_cast<TdcLz78DS*>(h);
    s->pend.insert(s->pend.end(), in, in + n);
    int64_t nbits;
    const int hold = 2;  // final-byte convention needs the last bytes
    if (final_chunk) {
        // io/bitio.py parse_stream over the full remaining tail
        int64_t nb = int64_t(s->pend.size());
        if (nb == 0) return int64_t(s->out.size());
        int f = s->pend[size_t(nb - 1)] & 7;
        if (f >= 6) nbits = 8 * (nb - 2) + f;
        else if (f) nbits = 8 * (nb - 1) + f;
        else nbits = 8 * (nb - 1);
        if (nbits < 0) nbits = 0;
    } else {
        if (int64_t(s->pend.size()) <= hold)
            return int64_t(s->out.size());
        nbits = 8 * (int64_t(s->pend.size()) - hold);
    }
    // a non-final feed takes only tokens that end before its last
    // bit: an ascii int that meets the held-back boundary stops
    // there without its terminator and would decode short (the
    // JAX package's copy accepts it and decodes wrong bytes)
    const int64_t lim = final_chunk ? nbits : nbits - 1;
    BitRd rd{s->pend.data(), nbits, s->bit_off};
    while (rd.pos < nbits) {
        int64_t save = rd.pos;
        if (!s->lzw) {
            int64_t r = rd.read_code(
                s->code_kind, int(tdc_bits_for((uint64_t)s->fc)));
            if (r < 0 || rd.pos >= nbits) { rd.pos = save; break; }
            int64_t c;
            if (s->code_kind == 1 || s->code_kind == 2 ||
                s->code_kind == 3) {
                c = rd.read_code(s->code_kind, 8);
            } else {
                c = rd.read(8);
            }
            if (c < 0 || rd.pos > lim) { rd.pos = save; break; }
            if (c > 255 || r > s->fc) return -2;  // malformed
            // expand: chain walk (no output-history dependence)
            s->tmp.clear();
            s->tmp.push_back((uint8_t)c);
            for (int64_t k = r; k > 0; k = s->ref[size_t(k - 1)])
                s->tmp.push_back(s->ch[size_t(k - 1)]);
            s->out.insert(s->out.end(), s->tmp.rbegin(),
                          s->tmp.rend());
            s->ref.push_back(int32_t(r));
            s->ch.push_back((uint8_t)c);
            s->fc++;
            // trie size = factors + root
            if (s->dict_max && s->fc + 1 == s->dict_max) {
                s->ref.clear();
                s->ch.clear();
                s->fc = 0;
            }
        } else {
            if (s->dict_max > 256 &&
                s->counter == s->dict_max - 256) {
                s->lzw_reset();
                s->counter = 0;
                s->lzw_prev = -1;
            }
            int64_t k = rd.read_code(
                s->code_kind,
                int(tdc_bits_for((uint64_t)(s->counter + 256))));
            if (k < 0 || rd.pos > lim) { rd.pos = save; break; }
            int64_t have = int64_t(s->pref.size());
            if (k > have) return -2;  // malformed
            s->counter++;
            // rebuild string of code k (or prev + first(prev) for the
            // self-referential fresh-code case), reference
            // lzw/LZWDecoding.hpp:13-49
            s->tmp.clear();
            if (k == have) {
                if (s->lzw_prev < 0) return -2;
                int64_t q = s->lzw_prev;
                while (q >= 0) {
                    s->tmp.push_back(s->lastc[size_t(q)]);
                    q = s->pref[size_t(q)];
                }
                uint8_t first = s->tmp.back();
                std::reverse(s->tmp.begin(), s->tmp.end());
                s->tmp.push_back(first);
            } else {
                int64_t q = k;
                while (q >= 0) {
                    s->tmp.push_back(s->lastc[size_t(q)]);
                    q = s->pref[size_t(q)];
                }
                std::reverse(s->tmp.begin(), s->tmp.end());
            }
            s->out.insert(s->out.end(), s->tmp.begin(), s->tmp.end());
            if (s->lzw_prev >= 0) {
                s->pref.push_back(int32_t(s->lzw_prev));
                s->lastc.push_back(s->tmp.front());
            }
            s->lzw_prev = k;
        }
    }
    s->bit_off = rd.pos;
    // drop fully-consumed bytes from the tail
    int64_t drop = s->bit_off >> 3;
    if (drop > 0) {
        s->pend.erase(s->pend.begin(), s->pend.begin() + drop);
        s->bit_off &= 7;
    }
    if (final_chunk && rd.pos < nbits) return -2;  // stuck mid-stream
    return int64_t(s->out.size());
}

// Copy and clear the decoded bytes accumulated by feed().
int64_t tdc_lz78ds_take(void* h, uint8_t* dst, int64_t cap) {
    TdcLz78DS* s = static_cast<TdcLz78DS*>(h);
    int64_t m = int64_t(s->out.size());
    if (m > cap) return -1;
    if (m) memcpy(dst, s->out.data(), size_t(m));
    s->out.clear();
    return m;
}

}  // extern "C"
