// Host ESP of the torch port: the round loop, SLP derivation, the SLP
// dependency sort and the monotone-subsequence decomposition of the
// succinct D coding.
//
// Copies of the JAX package's native runtime (native/tdc_native.cpp:
// tdc_esp_rounds with its esp_detail helpers, tdc_slp_derive,
// tdc_slp_dep_sort, tdc_monotone_decompose with patience_lis), so that
// the port's ESP needs nothing of that package. Built with the host
// compiler by _build.py into csrc/build/ and bound with ctypes by
// native.py. Every entry point returns int64, as the host library's
// others do.

#include <algorithm>
#include <cstdint>
#include <queue>
#include <utility>
#include <vector>

// ---- ESP round loop -----------------------------------------------------
// Mirror of compressors/esp.py:esp_rounds (reference
// compressors/EspCompressor.hpp round structure, esp_math.hpp iter_log,
// landmark_spanner, BlockAdjust). Bit-for-bit identical rule list and
// root to the Python loop: same metablock classification, eager-1/3
// splits, alphabet reduction, landmark spans, 1-block merge and
// first-use rule-id assignment.

namespace esp_detail {

struct PairMap {
    std::vector<uint64_t> keys;
    std::vector<int32_t> vals;
    std::vector<int32_t> table;
    uint64_t mask;

    explicit PairMap(int64_t n) {
        // entries are bounded by the total rule count <= n, so a 2n
        // pow2 table keeps load <= 50% (4n cost 2 GB alone at 100 MB)
        uint64_t cap = 64;
        while (cap < uint64_t(2 * n)) cap <<= 1;
        table.assign(cap, -1);
        mask = cap - 1;
    }
    // returns existing id or assigns next_id (first-use order)
    int32_t get_or_add(uint64_t key, int32_t next_id, bool* added) {
        uint64_t h = key * 0x9E3779B97F4A7C15ull;
        uint64_t s = (h >> 32) & mask;
        while (true) {
            int32_t e = table[s];
            if (e < 0) {
                table[s] = int32_t(keys.size());
                keys.push_back(key);
                vals.push_back(next_id);
                *added = true;
                return next_id;
            }
            if (keys[size_t(e)] == key) { *added = false; return vals[size_t(e)]; }
            s = (s + 1) & mask;
        }
    }
};

inline int iter_log(int64_t n) {
    if (n < 7) return 0;
    if (n < 9) return 1;
    if (n < 17) return 2;
    if (n < 257) return 3;
    return 4;
}

inline void split13(int64_t len, std::vector<int32_t>& out) {
    int64_t rest = len;
    while (rest > 4) { out.push_back(3); rest -= 3; }
    if (rest == 4) { out.push_back(2); out.push_back(2); }
    else if (rest) out.push_back(int32_t(rest));
}

inline int64_t label(int64_t l, int64_t r) {
    uint64_t diff = uint64_t(l ^ r);
    int ctz = __builtin_ctzll(diff);
    return 2 * int64_t(ctz) + ((r >> ctz) & 1);
}

// reduced-label landmark blocks (esp.py:_landmark_blocks, tie_to_right)
inline void landmark_blocks(const int64_t* seg, int64_t m,
                            std::vector<int32_t>& out) {
    if (m == 1) { out.push_back(1); return; }
    std::vector<uint8_t> high(static_cast<size_t>(m));
    for (int64_t i = 0; i < m; i++) {
        int64_t lv = i > 0 ? seg[i - 1] : -1;
        int64_t rv = i < m - 1 ? seg[i + 1] : -1;
        high[size_t(i)] = seg[i] > lv && seg[i] > rv;
    }
    std::vector<int64_t> idx;
    for (int64_t i = 0; i < m; i++) {
        bool lm = high[size_t(i)];
        if (!lm) {
            int64_t lv = i > 0 ? seg[i - 1] : 4;
            int64_t rv = i < m - 1 ? seg[i + 1] : 4;
            bool low = seg[i] < lv && seg[i] < rv;
            bool nbr = (i > 0 && high[size_t(i - 1)]) ||
                       (i < m - 1 && high[size_t(i + 1)]);
            lm = low && !nbr;
        }
        if (lm) idx.push_back(i);
    }
    if (idx.empty()) { split13(m, out); return; }
    std::vector<std::pair<int64_t, int64_t>> spans;
    for (int64_t i : idx) {
        int64_t l = i > 0 ? i - 1 : i;
        int64_t r = i < m - 1 ? i + 1 : i;
        if (!spans.empty()) {
            if (l == spans.back().second) spans.back().second -= 1;
            l = spans.back().second + 1;
            if (l > r) continue;
        } else {
            l = 0;
        }
        spans.push_back({l, r});
    }
    spans.back().second = m - 1;
    for (auto& sp : spans) split13(sp.second - sp.first + 1, out);
}

// esp.py:_reduce_alphabet — iterated labels then 3/4/5 remap
inline void reduce_alphabet(const int32_t* seg, int64_t m, int passes,
                            std::vector<int64_t>& buf) {
    buf.resize(size_t(m));
    for (int64_t i = 0; i < m; i++) buf[size_t(i)] = seg[i];
    int64_t cur = m;
    for (int p = 0; p < passes; p++) {
        for (int64_t i = 0; i + 1 < cur; i++)
            buf[size_t(i)] = label(buf[size_t(i)], buf[size_t(i + 1)]);
        cur -= 1;
    }
    buf.resize(size_t(cur));
    for (int64_t v = 3; v <= 5; v++) {
        for (int64_t i = 0; i < cur; i++) {
            if (buf[size_t(i)] != v) continue;
            int64_t e = 0;
            int64_t n0 = i > 0 ? buf[size_t(i - 1)] : -1;
            int64_t n1 = i < cur - 1 ? buf[size_t(i + 1)] : -1;
            if (n0 == e) e++;
            if (n1 == e) e++;
            if (n0 == e) e++;
            if (n1 == e) e++;
            buf[size_t(i)] = e;
        }
    }
}

}  // namespace esp_detail

extern "C" {

// Returns number of rules (>= 0) or -1 on cap overflow. rules_out
// holds (left, right) pairs, ids >= 256 are rule ids + 256.
int64_t tdc_esp_rounds(const uint8_t* text, int64_t n,
                       int32_t* rules_out, int64_t rules_cap,
                       int64_t* root_out) {
    using namespace esp_detail;
    if (n <= 0) { *root_out = 0; return 0; }
    std::vector<int32_t> s(static_cast<size_t>(n));
    std::vector<int32_t> s2;
    for (int64_t i = 0; i < n; i++) s[size_t(i)] = text[i];
    PairMap map(n);
    int64_t num_rules = 0;
    int64_t alphabet = 256;
    std::vector<int32_t> blocks, merged;
    std::vector<int64_t> reduced;

    auto rule_id = [&](int32_t a, int32_t b) -> int64_t {
        uint64_t key = (uint64_t(uint32_t(a)) << 32) | uint32_t(b);
        bool added = false;
        int32_t rid = map.get_or_add(key, int32_t(256 + num_rules), &added);
        if (added) {
            if (num_rules >= rules_cap) return -1;
            rules_out[2 * num_rules] = a;
            rules_out[2 * num_rules + 1] = b;
            num_rules++;
        }
        return rid;
    };

    while (int64_t(s.size()) > 1) {
        int64_t sz = int64_t(s.size());
        blocks.clear();
        int64_t i = 0;
        while (i < sz) {
            int64_t j = i;
            while (j + 1 < sz && s[size_t(j + 1)] == s[size_t(i)]) j++;
            if (j > i) {  // type 1: repeating run
                split13(j - i + 1, blocks);
                i = j + 1;
            } else {  // group consecutive singleton runs: type 2 segment
                int64_t e = i;
                while (e + 1 < sz && s[size_t(e + 1)] != s[size_t(e)] &&
                       (e + 2 >= sz || s[size_t(e + 2)] != s[size_t(e + 1)]))
                    e++;
                int64_t seglen = e - i + 1;
                int64_t p = iter_log(alphabet);
                if (p > seglen) p = seglen;
                split13(p, blocks);
                if (p < seglen) {
                    reduce_alphabet(s.data() + i, seglen, int(p), reduced);
                    landmark_blocks(reduced.data(),
                                    int64_t(reduced.size()), blocks);
                }
                i = e + 1;
            }
        }
        // merge length-1 blocks (esp.py:_merge_one_blocks)
        merged.clear();
        for (int32_t L : blocks) {
            merged.push_back(L);
            while (merged.size() >= 2 &&
                   (merged.back() == 1 || merged[merged.size() - 2] == 1)) {
                int32_t b = merged.back(); merged.pop_back();
                int32_t a = merged.back(); merged.pop_back();
                int32_t total = a + b;
                if (total == 4) { merged.push_back(2); merged.push_back(2); }
                else merged.push_back(total);
            }
        }
        // blocks -> rules
        s2.clear();
        int64_t pos = 0;
        for (int32_t L : merged) {
            int64_t rid;
            if (L == 2) {
                rid = rule_id(s[size_t(pos)], s[size_t(pos + 1)]);
            } else {
                int64_t inner = rule_id(s[size_t(pos)], s[size_t(pos + 1)]);
                if (inner < 0) return -1;
                rid = rule_id(int32_t(inner), s[size_t(pos + 2)]);
            }
            if (rid < 0) return -1;
            s2.push_back(int32_t(rid));
            pos += L;
        }
        if (pos != sz) return -2;  // internal invariant violation
        alphabet = 256 + num_rules;
        s.swap(s2);
    }
    *root_out = s[0];
    return num_rules;
}

// SLP dependency sort (esp.py:slp_dep_sort; reference SLPDepSort.hpp).
// Renumbers rules so left children are non-decreasing. Exact mirror of
// the Python heap construction incl. (key, old) tie-breaking, so the
// output permutation is identical. Returns 0, or -2 if the grammar has
// a dependency cycle.
int64_t tdc_slp_dep_sort(const int64_t* rules, int64_t n, int64_t root,
                         int64_t* out, int64_t* new_root) {
    if (n == 0) { *new_root = root; return 0; }
    std::vector<int64_t> wait_head(size_t(n), -1);
    std::vector<int64_t> wait_next(size_t(n), -1);
    std::vector<int64_t> wait_tail(size_t(n), -1);
    typedef std::pair<int64_t, int64_t> KO;
    std::priority_queue<KO, std::vector<KO>, std::greater<KO>> heap;
    for (int64_t old = 0; old < n; old++) {
        int64_t left = rules[2 * old];
        if (left < 256) {
            heap.push({left, old});
        } else {
            int64_t p = left - 256;
            if (p < 0 || p >= n) return -2;
            // append preserving old-index order
            if (wait_head[size_t(p)] < 0) wait_head[size_t(p)] = old;
            else wait_next[size_t(wait_tail[size_t(p)])] = old;
            wait_tail[size_t(p)] = old;
        }
    }
    std::vector<int64_t> newid(size_t(n), -1);
    std::vector<int64_t> order_key(static_cast<size_t>(n));
    std::vector<int64_t> order_old(static_cast<size_t>(n));
    int64_t count = 0;
    while (!heap.empty()) {
        KO top = heap.top();
        heap.pop();
        int64_t old = top.second;
        int64_t idx = count;
        newid[size_t(old)] = idx;
        order_key[size_t(idx)] = top.first;
        order_old[size_t(idx)] = old;
        count++;
        for (int64_t dep = wait_head[size_t(old)]; dep >= 0;
             dep = wait_next[size_t(dep)])
            heap.push({256 + idx, dep});
    }
    if (count != n) return -2;
    for (int64_t i = 0; i < n; i++) {
        out[2 * i] = order_key[size_t(i)];
        int64_t rt = rules[2 * order_old[size_t(i)] + 1];
        out[2 * i + 1] =
            rt < 256 ? rt : 256 + newid[size_t(rt - 256)];
    }
    *new_root = root < 256 ? root : 256 + newid[size_t(root - 256)];
    return 0;
}

// ---- SLP derivation ---------------------------------------------------
// Expands a binary SLP (terminals < 256; rule i: pairs[2i], pairs[2i+1])
// from `root` iteratively. Returns output length or -1 on overflow.

int64_t tdc_slp_derive(const int64_t* pairs, int64_t nrules,
                       int64_t root, uint8_t* out, int64_t out_cap) {
    std::vector<int64_t> stack;
    stack.push_back(root);
    int64_t o = 0;
    while (!stack.empty()) {
        int64_t x = stack.back();
        stack.pop_back();
        if (x < 256) {
            if (o >= out_cap) return -1;
            out[o++] = uint8_t(x);
        } else {
            int64_t r = x - 256;
            if (r >= nrules) return -2;
            stack.push_back(pairs[2 * r + 1]);
            stack.push_back(pairs[2 * r]);
        }
    }
    return o;
}

// ---- monotone subsequence decomposition ------------------------------
// Re-derivation of esp/MonotoneSubsequences.hpp create_dpi_and_b_...:
// repeatedly extract the longest monotone (increasing vs decreasing,
// tie -> increasing) subsequence of the remaining sorted-index sequence
// via patience piles with parent links. Dpi[rank] = subsequence id;
// b[id] = 0 increasing / 1 decreasing. Returns subsequence count.

static int64_t patience_lis(const int64_t* vals, int64_t m, int sign,
                            std::vector<int64_t>& tails,
                            std::vector<int64_t>& tails_idx,
                            std::vector<int64_t>& parent,
                            std::vector<int64_t>& out_idx) {
    tails.clear(); tails_idx.clear();
    parent.assign(size_t(m), -1);
    for (int64_t k = 0; k < m; k++) {
        int64_t v = sign * vals[k];
        // first pile with tail >= v (strictly increasing subsequence)
        size_t lo = 0, hi = tails.size();
        while (lo < hi) {
            size_t mid = (lo + hi) / 2;
            if (tails[mid] >= v) hi = mid; else lo = mid + 1;
        }
        if (lo > 0) parent[size_t(k)] = tails_idx[lo - 1];
        if (lo == tails.size()) {
            tails.push_back(v); tails_idx.push_back(k);
        } else {
            tails[lo] = v; tails_idx[lo] = k;
        }
    }
    out_idx.clear();
    int64_t cur = tails_idx.empty() ? -1 : tails_idx.back();
    while (cur != -1) { out_idx.push_back(cur); cur = parent[size_t(cur)]; }
    std::reverse(out_idx.begin(), out_idx.end());
    return int64_t(tails.size());
}

int64_t tdc_monotone_decompose(const int64_t* sis, int64_t n,
                               int64_t* Dpi, uint8_t* b, int64_t b_cap) {
    std::vector<int64_t> active((size_t)n);
    std::vector<int64_t> vals((size_t)n);
    for (int64_t i = 0; i < n; i++) active[size_t(i)] = i;
    std::vector<int64_t> tails, tails_idx, parent, inc, dec;
    int64_t rounds = 0;
    int64_t m = n;
    while (m > 0) {
        for (int64_t k = 0; k < m; k++)
            vals[size_t(k)] = sis[active[size_t(k)]];
        int64_t li = patience_lis(vals.data(), m, +1, tails, tails_idx,
                                  parent, inc);
        int64_t ld = patience_lis(vals.data(), m, -1, tails, tails_idx,
                                  parent, dec);
        const std::vector<int64_t>& take = (li >= ld) ? inc : dec;
        if (rounds >= b_cap) return -1;
        b[rounds] = (li >= ld) ? 0 : 1;
        // mark and compact
        int64_t t = 0;
        int64_t w = 0;
        for (int64_t k = 0; k < m; k++) {
            if (t < int64_t(take.size()) && take[size_t(t)] == k) {
                Dpi[active[size_t(k)]] = rounds;
                t++;
            } else {
                active[size_t(w++)] = active[size_t(k)];
            }
        }
        m = w;
        rounds++;
    }
    return rounds;
}

}  // extern "C"
