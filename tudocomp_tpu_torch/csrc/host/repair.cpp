// Host Re-Pair of the torch port: the near-linear grammar construction
// and the stream decoder.
//
// Copies of the JAX package's native runtime (native/tdc_native.cpp:
// repair_detail with tdc_repair :1287-1475, tdc_repair_decode
// :2527-2611, over bitrw.hpp's BitRd), so that the port's repair needs
// nothing of that package. Built with the host compiler by _build.py
// into csrc/build/ and bound with ctypes by native.py.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

#include "bitrw.hpp"

// ---- Re-Pair grammar construction -------------------------------------
// Larsson/Moffat-style near-linear Re-Pair (reference
// RePairCompressor.hpp:96-340 does O(n) rescan rounds; this replaces
// the rescans with neighbor links + per-digram occurrence lists + a
// lazy max-heap, so total work is O(n log n)).
//
// Structures over the symbol array:
//   sym[i]   current symbol at slot i (-1 = removed)
//   nxt/prv  doubly-linked active-slot list
//   od_nxt/od_prv  occurrence list links: slots holding the same digram
//   hash map digram(left<<32|right) -> {count, head, tail}
//   heap     lazy max-heap of (count, entry); stale tops are skipped
// Replacing digram D at slot i (right partner j=nxt[i]): the left
// neighbor digram at prv[i] and right digram at j are unlinked and
// decremented, slot j is removed, and the two digrams created around
// the fresh non-terminal are inserted. Occurrences are processed in
// slot order, each re-validated (overlaps like "aaa" self-destruct).

namespace repair_detail {

struct DigramEntry {
    uint64_t key;
    int64_t count;
    int32_t head, tail;
    int64_t best;   // high-water count already pushed into the heap
    int64_t epoch;  // last rule index that touched this entry
};

struct DigramMap {
    std::vector<DigramEntry> entries;
    std::vector<int32_t> table;  // open addressing -> entry idx, -1 empty
    uint64_t mask;

    explicit DigramMap(int64_t n) {
        uint64_t cap = 64;
        while (cap < uint64_t(2 * n)) cap <<= 1;
        table.assign(cap, -1);
        mask = cap - 1;
        entries.reserve(size_t(n / 2 + 16));
    }
    int32_t find_or_add(uint64_t key) {
        uint64_t h = key * 0x9E3779B97F4A7C15ull;
        uint64_t s = (h >> 32) & mask;
        while (true) {
            int32_t e = table[s];
            if (e < 0) {
                table[s] = int32_t(entries.size());
                entries.push_back({key, 0, -1, -1, 0, -1});
                return table[s];
            }
            if (entries[size_t(e)].key == key) return e;
            s = (s + 1) & mask;
        }
    }
};

}  // namespace repair_detail

extern "C" {

// Returns num_rules (>= 0), or -1 if rules_cap was exceeded.
// rules_out holds pairs (left, right); symbols >= 256 are rule ids + 256.
// start_out receives the compacted start sequence, *start_len_out its
// length.
int64_t tdc_repair(const uint8_t* text, int64_t n, int64_t max_rules,
                   int32_t* rules_out, int64_t rules_cap,
                   int32_t* start_out, int64_t* start_len_out) {
    using repair_detail::DigramMap;
    if (n <= 0) { *start_len_out = 0; return 0; }
    size_t un = size_t(n);
    // Interleaved per-position records: the replacement loop hops the
    // text list (sym/nxt/prv) and the occurrence list (od_*) at random
    // positions, so splitting these across six arrays cost ~6 cache
    // lines per hop; two 12-byte structs cost at most two. od_ent
    // memoizes the digram-map entry a position is linked under, so
    // occ_remove needs NO hash probe (the round-3 version re-hashed
    // the digram on every removal — ~3 probes per replacement).
    struct Node { int32_t sym, nxt, prv; };
    struct Occ { int32_t od_nxt, od_prv, od_ent; };
    std::vector<Node> nd(un);
    std::vector<Occ> oc(un, {-1, -1, -1});
    for (int64_t i = 0; i < n; i++) {
        nd[size_t(i)].sym = text[i];
        nd[size_t(i)].nxt = (i + 1 < n) ? int32_t(i + 1) : -1;
        nd[size_t(i)].prv = int32_t(i - 1);
    }
    DigramMap map(n);
    std::priority_queue<uint64_t> heap;  // count<<32 | entry idx

    auto key_at = [&](int64_t i) -> uint64_t {
        return (uint64_t(uint32_t(nd[size_t(i)].sym)) << 32) |
               uint32_t(nd[size_t(nd[size_t(i)].nxt)].sym);
    };
    auto link = [&](int64_t i, int32_t e) {
        auto& en = map.entries[size_t(e)];
        oc[size_t(i)] = {-1, en.tail, e};
        if (en.tail >= 0) oc[size_t(en.tail)].od_nxt = int32_t(i);
        else en.head = int32_t(i);
        en.tail = int32_t(i);
        en.count++;
    };
    // Deferred heap maintenance: pops only ever happen between rules
    // (the replacement loop never pops), so pushing intermediate
    // high-water counts during a rule is pure churn — the round-3
    // version pushed every increment and paid 31M stale pops on
    // english.10MB (97% of all pops, ~70% of total runtime). Instead,
    // each rule records the set of touched entries (epoch-deduped) and
    // pushes ONE key per entry whose live count exceeds its pushed
    // high-water after the rule completes. The lazy-deletion invariant
    // (every entry keeps a heap key >= its live count; stale pops
    // re-arm the live count) and therefore the valid-pop order are
    // byte-for-byte unchanged.
    std::vector<int32_t> touched;
    int64_t epoch = 0;
    auto touch = [&](int32_t e) {
        auto& en = map.entries[size_t(e)];
        if (en.epoch != epoch) {
            en.epoch = epoch;
            touched.push_back(e);
        }
    };
    auto occ_append = [&](int64_t i) {
        int32_t e = map.find_or_add(key_at(i));
        link(i, e);
        touch(e);
    };
    auto occ_remove = [&](int64_t i) {
        auto& o = oc[size_t(i)];
        int32_t e = o.od_ent;
        auto& en = map.entries[size_t(e)];
        int32_t p = o.od_prv, q = o.od_nxt;
        if (p >= 0) oc[size_t(p)].od_nxt = q; else en.head = q;
        if (q >= 0) oc[size_t(q)].od_prv = p; else en.tail = p;
        o = {-1, -1, -1};
        en.count--;
        touch(e);
    };

    for (int64_t i = 0; i + 1 < n; i++)
        link(i, map.find_or_add(key_at(i)));
    for (size_t e = 0; e < map.entries.size(); e++) {
        auto& en = map.entries[e];
        en.best = en.count;
        if (en.count >= 2)
            heap.push((uint64_t(en.count) << 32) | uint32_t(e));
    }

    int64_t num_rules = 0;
    std::vector<int64_t> occs;
    while (num_rules < max_rules && !heap.empty()) {
        uint64_t top = heap.top();
        heap.pop();
        int32_t e = int32_t(top & 0xFFFFFFFFu);
        int64_t cnt = int64_t(top >> 32);
        auto& en = map.entries[size_t(e)];
        if (en.count != cnt) {  // stale: re-arm the live count
            en.best = en.count;
            if (en.count >= 2)
                heap.push((uint64_t(en.count) << 32) | uint32_t(e));
            continue;
        }
        if (cnt < 2) break;             // true maximum below threshold
        uint64_t key = en.key;
        int32_t a = int32_t(key >> 32), b = int32_t(key & 0xFFFFFFFFu);
        if (num_rules >= rules_cap) return -1;
        int32_t fresh = int32_t(256 + num_rules);
        rules_out[2 * num_rules] = a;
        rules_out[2 * num_rules + 1] = b;
        num_rules++;
        occs.clear();
        for (int32_t it = en.head; it >= 0; it = oc[size_t(it)].od_nxt)
            occs.push_back(it);
        std::sort(occs.begin(), occs.end());
        for (int64_t i : occs) {
            // re-validate: an earlier replacement this round (overlap
            // like "aaa") may have destroyed this occurrence
            if (nd[size_t(i)].sym != a) continue;
            int32_t j = nd[size_t(i)].nxt;
            if (j < 0 || nd[size_t(j)].sym != b) continue;
            int32_t l = nd[size_t(i)].prv, r = nd[size_t(j)].nxt;
            if (l >= 0) occ_remove(l);
            if (r >= 0) occ_remove(j);
            occ_remove(i);
            nd[size_t(i)].sym = fresh;
            nd[size_t(j)].sym = -1;
            nd[size_t(i)].nxt = r;
            if (r >= 0) nd[size_t(r)].prv = int32_t(i);
            if (l >= 0) occ_append(l);
            if (r >= 0) occ_append(i);
        }
        for (int32_t te : touched) {
            auto& ten = map.entries[size_t(te)];
            if (ten.count > ten.best) {
                ten.best = ten.count;
                heap.push((uint64_t(ten.count) << 32) | uint32_t(te));
            }
        }
        touched.clear();
        epoch++;
    }

    int64_t m = 0;
    for (int32_t i = 0; i >= 0; i = nd[size_t(i)].nxt)
        start_out[m++] = nd[size_t(i)].sym;
    *start_len_out = m;
    return num_rules;
}

}  // extern "C"

// ---- Re-Pair stream decode -----------------------------------------------
// Mirrors compressors/repair.py decompress: 32-bit rule count, then per
// rule i two symbols (flag bit + literal | (id - 256) in bits_for(i)
// bits), then start symbols in bits_for(num_rules) bits; grammar
// expansion by explicit stack. Literals via canonical-huffman LUT when
// k > 0 else plain 8-bit. Returns output length, -1 overflow, -2
// malformed.

extern "C" {

int64_t tdc_repair_decode(const uint8_t* payload, int64_t nbits,
                          int64_t start_bit, const uint8_t* lut_sym,
                          const uint8_t* lut_len, int k, int code_kind,
                          uint8_t* out, int64_t out_cap) {
    BitRd rd{payload, nbits, start_bit};
    auto bits_for = [](int64_t v) -> int {
        int b = 1;
        while ((uint64_t(v) >> b) != 0) b++;
        return b;
    };
    auto read_int = [&](int w) -> int64_t {
        if (code_kind == 0) return rd.read(w);
        return rd.read_code(code_kind, w);
    };
    auto read_literal = [&]() -> int {
        if (code_kind == 1 || code_kind == 2 || code_kind == 3) {
            int64_t v = rd.read_code(code_kind, 8);
            if (v < 0 || v > 255) return -1;
            return int(v);
        }
        if (k > 0) {
            int64_t save = rd.pos;
            int64_t w = rd.read(k);
            int len = lut_len[w];
            if (len == 0) return -1;
            rd.pos = save + len;
            return lut_sym[w];
        }
        return int(rd.read(8));
    };
    int64_t nr = read_int(32);
    // every rule body costs >= 2 stream bits, so a valid nr is bounded
    // by the remaining bits; a looser check would let a malformed
    // count allocate 16*nr bytes (bad_alloc would escape the C ABI)
    if (nr < 0 || 2 * nr > nbits - rd.pos) return -2;
    std::vector<int64_t> L(static_cast<size_t>(nr));
    std::vector<int64_t> R(static_cast<size_t>(nr));
    for (int64_t i = 0; i < nr; i++) {
        int w = bits_for(i);
        for (int side = 0; side < 2; side++) {
            int64_t x;
            int64_t fl = rd.read_flag(code_kind);
            if (fl < 0) return -2;
            if (fl) {
                x = 256 + read_int(w);
                if (x - 256 >= i) return -2;  // forward rule reference
            } else {
                int c = read_literal();
                if (c < 0) return -2;
                x = c;
            }
            (side ? R : L)[size_t(i)] = x;
        }
    }
    int w = bits_for(nr);
    int64_t o = 0;
    std::vector<int64_t> stack;
    while (rd.pos < nbits) {
        int64_t x;
        int64_t fl = rd.read_flag(code_kind);
        if (fl < 0) return -2;
        if (fl) {
            x = 256 + read_int(w);
            if (x - 256 >= nr) return -2;
        } else {
            int c = read_literal();
            if (c < 0) return -2;
            x = c;
        }
        stack.clear();
        stack.push_back(x);
        while (!stack.empty()) {
            int64_t s = stack.back();
            stack.pop_back();
            if (s < 256) {
                if (o >= out_cap) return -1;
                out[o++] = uint8_t(s);
            } else {
                stack.push_back(R[size_t(s - 256)]);
                stack.push_back(L[size_t(s - 256)]);
            }
        }
    }
    return o;
}

}  // extern "C"
