// Host suffix tree and LFS of the torch port: the lcp-interval suffix
// tree, the single- and two-layer longest-first parses, the SimST and
// BST rule computations, and the LFS and LFS2 stream decoders.
//
// Copies of the JAX package's native runtime (native/tdc_native.cpp:
// suffix_tree_impl with tdc_suffix_tree/32 :875-935, Lfs2Node with
// lfs2_parse_impl, tdc_lfs2_parse and tdc_lfs_parse :946-1058,
// tdc_lfs_start_decode :3213-3266, tdc_lfs2_decode :3279-3342,
// tdc_lfs_simst :3415-3525, tdc_lfs_bst :3537-3655, over bitrw.hpp's
// BitRd), so that the port's suffix tree, lfs_comp, lfs2 and lfs2bst
// need nothing of that package. Built with the host compiler by
// _build.py into csrc/build/ and bound with ctypes by native.py.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#include "bitrw.hpp"

// ---- suffix tree from SA+LCP (lcp-interval stack) --------------------
// Mirrors ds/suffix_tree.py exactly. Output arrays sized >= 2n+2.
// Returns the node count.

template <typename I>
static int64_t suffix_tree_impl(const I* sa, const I* lcp, int64_t n,
                                I* parent, I* sdepth,
                                uint8_t* is_leaf, I* suffix,
                                I* leaf_of_rank) {
    int64_t m = 0;  // node count
    parent[0] = -1; sdepth[0] = 0; is_leaf[0] = 0; suffix[0] = -1; m = 1;
    std::vector<I> stack;
    stack.push_back(0);
    auto add = [&](int64_t d, bool leaf, int64_t suf) -> int64_t {
        parent[m] = I(-1); sdepth[m] = I(d);
        is_leaf[m] = leaf ? 1 : 0; suffix[m] = I(suf);
        return m++;
    };
    for (int64_t i = 0; i < n; i++) {
        int64_t l = i ? lcp[i] : 0;
        int64_t last = -1;
        while (sdepth[stack.back()] > l) {
            int64_t v = stack.back(); stack.pop_back();
            if (last != -1) parent[last] = I(v);
            last = v;
        }
        if (last != -1) {
            if (sdepth[stack.back()] == l) {
                parent[last] = stack.back();
            } else {
                int64_t u = add(l, false, -1);
                parent[last] = I(u);
                stack.push_back(I(u));
            }
        }
        int64_t leaf = add(n - sa[i], true, sa[i]);
        leaf_of_rank[i] = I(leaf);
        stack.push_back(I(leaf));
    }
    int64_t last = -1;
    while (!stack.empty()) {
        int64_t v = stack.back(); stack.pop_back();
        if (last != -1) parent[last] = I(v);
        last = v;
    }
    return m;
}

extern "C" {

int64_t tdc_suffix_tree(const int64_t* sa, const int64_t* lcp, int64_t n,
                        int64_t* parent, int64_t* sdepth,
                        uint8_t* is_leaf, int64_t* suffix,
                        int64_t* leaf_of_rank) {
    return suffix_tree_impl<int64_t>(
        sa, lcp, n, parent, sdepth, is_leaf, suffix, leaf_of_rank);
}

int64_t tdc_suffix_tree32(const int32_t* sa, const int32_t* lcp,
                          int64_t n, int32_t* parent, int32_t* sdepth,
                          uint8_t* is_leaf, int32_t* suffix,
                          int32_t* leaf_of_rank) {
    return suffix_tree_impl<int32_t>(
        sa, lcp, n, parent, sdepth, is_leaf, suffix, leaf_of_rank);
}

// ---- LFS2 two-layer longest-first substitution -------------------------
// Re-derivation of lfs/LFS2Compressor.hpp:36-330: enumerate lcp-interval
// tree nodes (stack algorithm over SA+LCP instead of sdsl cst_sct3),
// process them by string depth descending; per node, greedily pick
// non-overlapping occurrences that are either first-layer viable (both
// endpoints unsubstituted) or second-layer viable (inside an earlier
// NT's definition window); substitute when >=1 first-layer and >=2
// total. Outputs the reference's four position maps + the NT list.

struct Lfs2Node { int64_t depth, lb, rb; };

static int64_t lfs2_parse_impl(const int64_t* sa, const int64_t* lcp,
                       int64_t m, int64_t n, int64_t min_lrf,
                       uint32_t* fl_nts, uint32_t* fl_off,
                       uint32_t* sl_nts, uint8_t* sl_dead,
                       int64_t* nts_start, int64_t* nts_len,
                       int64_t nts_cap, int two_layer) {
    // lcp-interval nodes via the classic stack sweep (m = SA entries
    // incl. sentinel suffix, n = text length without sentinel)
    std::vector<Lfs2Node> nodes;
    {
        std::vector<Lfs2Node> stack;
        stack.push_back({0, 0, -1});
        for (int64_t i = 1; i <= m; i++) {
            int64_t l = (i < m) ? lcp[i] : 0;
            int64_t lb = i - 1;
            while (!stack.empty() && l < stack.back().depth) {
                Lfs2Node top = stack.back(); stack.pop_back();
                top.rb = i - 1;
                lb = top.lb;
                if (top.depth >= min_lrf && top.rb > top.lb)
                    nodes.push_back(top);
            }
            if (stack.empty() || l > stack.back().depth)
                stack.push_back({l, lb, -1});
        }
    }
    // depth-descending stable order
    std::stable_sort(nodes.begin(), nodes.end(),
                     [](const Lfs2Node& a, const Lfs2Node& b) {
                         return a.depth > b.depth;
                     });
    memset(fl_nts, 0, sizeof(uint32_t) * size_t(n));
    memset(fl_off, 0, sizeof(uint32_t) * size_t(n));
    memset(sl_nts, 0, sizeof(uint32_t) * size_t(n));
    memset(sl_dead, 0, size_t(n));
    int64_t count = 0;
    std::vector<int64_t> occs, fl_viable, sl_viable;
    for (const Lfs2Node& node : nodes) {
        int64_t i = node.depth;
        occs.assign(sa + node.lb, sa + node.rb + 1);
        std::sort(occs.begin(), occs.end());
        if (occs.back() - occs.front() < i) continue;  // all overlap
        fl_viable.clear();
        sl_viable.clear();
        int64_t last = -i;
        for (int64_t occ : occs) {
            if (last + i > occ) continue;
            if (occ >= n || occ + i > n) continue;
            if (fl_off[occ] == 0) {
                if (fl_off[occ + i - 1] == 0) {
                    fl_viable.push_back(occ);
                    last = occ;
                }
            } else if (two_layer) {
                uint32_t parent = fl_nts[occ - (fl_off[occ] - 1)];
                if (parent && nts_len[parent - 1] >= int64_t(fl_off[occ]) - 1 + i)
                    sl_viable.push_back(occ);
            }
        }
        if ((two_layer
                 ? (fl_viable.size() >= 1 &&
                    fl_viable.size() + sl_viable.size() >= 2)
                 : fl_viable.size() >= 2)) {
            if (count >= nts_cap) return -1;
            nts_start[count] = fl_viable.front();
            nts_len[count] = i;
            uint32_t id = uint32_t(++count);
            for (int64_t occ : fl_viable) {
                fl_nts[occ] = id;
                for (int64_t k = 0; k < i; k++)
                    fl_off[occ + k] = uint32_t(k + 1);
            }
            for (int64_t occ : sl_viable) {
                uint32_t parent = fl_nts[occ - (fl_off[occ] - 1)];
                int64_t pstart = nts_start[parent - 1];
                int64_t sl_start = pstart + fl_off[occ] - 1;
                int64_t sl_end = sl_start + i - 1;
                if (!sl_dead[sl_start] && !sl_dead[sl_end]) {
                    sl_nts[sl_start] = id;
                    for (int64_t d = sl_start; d <= sl_end; d++)
                        sl_dead[d] = 1;
                }
            }
        }
    }
    return count;
}

int64_t tdc_lfs2_parse(const int64_t* sa, const int64_t* lcp, int64_t m,
                       int64_t n, int64_t min_lrf,
                       uint32_t* fl_nts, uint32_t* fl_off,
                       uint32_t* sl_nts, uint8_t* sl_dead,
                       int64_t* nts_start, int64_t* nts_len,
                       int64_t nts_cap) {
    return lfs2_parse_impl(sa, lcp, m, n, min_lrf, fl_nts, fl_off,
                           sl_nts, sl_dead, nts_start, nts_len,
                           nts_cap, 1);
}

// Single-layer variant for the LFS st/esa strategies: no second-layer
// substitution, rules need >= 2 first-layer occurrences.
int64_t tdc_lfs_parse(const int64_t* sa, const int64_t* lcp, int64_t m,
                      int64_t n, int64_t min_lrf,
                      uint32_t* fl_nts, uint32_t* fl_off,
                      uint32_t* sl_nts, uint8_t* sl_dead,
                      int64_t* nts_start, int64_t* nts_len,
                      int64_t nts_cap) {
    return lfs2_parse_impl(sa, lcp, m, n, min_lrf, fl_nts, fl_off,
                           sl_nts, sl_dead, nts_start, nts_len,
                           nts_cap, 0);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// LFS start-string decode (compressors/lfs.py EncodeStrategy.decode):
// interleaved (flag, literal | rule-id) events; literals via the
// canonical-Huffman LUT (k > 0) or plain 8-bit (k == 0), rule ids in
// fixed width w_id; each id expands to its dictionary string.
// ---------------------------------------------------------------------------

extern "C" {

int64_t tdc_lfs_start_decode(const uint8_t* p, int64_t nbits,
                             int64_t pos0, const uint8_t* lut_sym,
                             const uint8_t* lut_len, int k, int w_id,
                             const int64_t* dict_lens, int64_t ndict,
                             uint8_t* out, int64_t cap) {
    BitRd rd{p, nbits, pos0};
    auto read_lit = [&](int* ok) -> int {
        *ok = 1;
        if (k > 0) {
            int64_t save = rd.pos;
            int64_t w = rd.read(k);
            int len = lut_len[w];
            if (len == 0) { *ok = 0; return 0; }
            rd.pos = save + len;
            return lut_sym[w];
        }
        if (rd.pos + 8 > nbits) { *ok = 0; return 0; }
        return int(rd.read(8));
    };
    // phase 1: the rule strings, as one run of literals
    std::vector<uint8_t> blob;
    std::vector<int64_t> off(size_t(ndict) + 1, 0);
    for (int64_t d = 0; d < ndict; d++) {
        for (int64_t j = 0; j < dict_lens[d]; j++) {
            int ok;
            int c = read_lit(&ok);
            if (!ok) return -2;
            blob.push_back((uint8_t)c);
        }
        off[size_t(d) + 1] = (int64_t)blob.size();
    }
    // phase 2: the start string
    int64_t cursor = 0;
    while (rd.pos < nbits) {
        int64_t flag = rd.read(1);
        if (flag) {
            if (rd.pos + w_id > nbits) return -2;
            int64_t id = rd.read(w_id);
            if (id < 0 || id >= ndict) return -2;
            int64_t len = off[size_t(id) + 1] - off[size_t(id)];
            if (cursor + len > cap) return -1;
            memcpy(out + cursor, blob.data() + off[size_t(id)],
                   size_t(len));
            cursor += len;
        } else {
            int ok;
            int c = read_lit(&ok);
            if (!ok) return -2;
            if (cursor >= cap) return -1;
            out[cursor++] = (uint8_t)c;
        }
    }
    return cursor;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// LFS2 decode (compressors/lfs.py LFS2Compressor.decompress): rules are
// decoded backward and may reference higher-id rules; then the start
// stream expands (flag, literal | rule-id) events. Exact mirror incl.
// the size-countdown loop per rule.
// ---------------------------------------------------------------------------

extern "C" {

int64_t tdc_lfs2_decode(const uint8_t* p, int64_t nbits, int64_t pos0,
                        const uint8_t* lut_sym, const uint8_t* lut_len,
                        int k, int w_id, const int64_t* dict_lens,
                        int64_t ndict, uint8_t* out, int64_t cap) {
    BitRd rd{p, nbits, pos0};
    auto read_lit = [&](int* ok) -> int {
        *ok = 1;
        if (k > 0) {
            int64_t save = rd.pos;
            int64_t w = rd.read(k);
            int len = lut_len[w];
            if (len == 0) { *ok = 0; return 0; }
            rd.pos = save + len;
            return lut_sym[w];
        }
        if (rd.pos + 8 > nbits) { *ok = 0; return 0; }
        return int(rd.read(8));
    };
    std::vector<std::vector<uint8_t>> rules;
    rules.resize(size_t(ndict));
    for (int64_t r = ndict - 1; r >= 0; r--) {
        int64_t size_cur = dict_lens[r];
        std::vector<uint8_t>& body = rules[size_t(r)];
        while (size_cur > 0) {
            if (rd.pos >= nbits) return -2;
            int64_t flag = rd.read(1);
            if (flag) {
                if (rd.pos + w_id > nbits) return -2;
                int64_t ref = rd.read(w_id) - 1;
                if (ref < 0 || ref >= ndict) return -2;
                if (ref <= r) return -2;  // refs point to higher ids
                body.insert(body.end(), rules[size_t(ref)].begin(),
                            rules[size_t(ref)].end());
                size_cur -= dict_lens[ref];
            } else {
                int ok;
                int c = read_lit(&ok);
                if (!ok) return -2;
                body.push_back((uint8_t)c);
                size_cur -= 1;
            }
        }
    }
    int64_t cursor = 0;
    while (rd.pos < nbits) {
        int64_t flag = rd.read(1);
        if (flag) {
            if (rd.pos + w_id > nbits) return -2;
            int64_t ref = rd.read(w_id) - 1;
            if (ref < 0 || ref >= ndict) return -2;
            const std::vector<uint8_t>& body = rules[size_t(ref)];
            if (cursor + (int64_t)body.size() > cap) return -1;
            memcpy(out + cursor, body.data(), body.size());
            cursor += (int64_t)body.size();
        } else {
            int ok;
            int c = read_lit(&ok);
            if (!ok) return -2;
            if (cursor >= cap) return -1;
            out[cursor++] = (uint8_t)c;
        }
    }
    return cursor;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// LFS SimST strategy (compressors/lfs.py SimSTStrategy.compute_rules,
// reference lfs/SimSTStrategy.hpp): depth-binned greedy LRF selection
// with on-demand child-merged begin lists, dead-position pruning and
// the reference's shared monotone min_shorter re-binning accumulator.
// Exact mirror of the Python walk.
// ---------------------------------------------------------------------------

extern "C" {

int64_t tdc_lfs_simst(const int64_t* parent, const int64_t* sdepth,
                      const uint8_t* is_leaf, const int64_t* suffix,
                      int64_t nn, int64_t n, int64_t min_lrf,
                      int64_t* d_start, int64_t* d_len, int64_t d_cap,
                      int64_t* o_pos, int64_t* o_rule, int64_t* o_len,
                      int64_t o_cap, int64_t* nd_out) {
    std::vector<std::vector<int32_t>> children;
    children.resize(size_t(nn));
    for (int64_t v = 1; v < nn; v++)
        children[size_t(parent[v])].push_back(int32_t(v));
    int64_t max_depth = 0;
    for (int64_t v = 0; v < nn; v++)
        if (!is_leaf[v] && v != 0 && sdepth[v] > max_depth)
            max_depth = sdepth[v];
    std::vector<std::vector<int64_t>> bins;
    bins.resize(size_t(max_depth) + 1);
    for (int64_t v = 0; v < nn; v++)
        if (!is_leaf[v] && v != 0)
            bins[size_t(sdepth[v])].push_back(v);
    std::vector<uint8_t> dead(size_t(n), 0);
    std::vector<std::vector<int64_t>> node_begins;
    node_begins.resize(size_t(nn));
    std::vector<uint8_t> has_begins(size_t(nn), 0);

    auto begins = [&](int64_t v) -> std::vector<int64_t>& {
        if (has_begins[size_t(v)]) return node_begins[size_t(v)];
        std::vector<int64_t> stack{v}, order;
        while (!stack.empty()) {
            int64_t u = stack.back();
            stack.pop_back();
            order.push_back(u);
            for (int32_t c : children[size_t(u)])
                if (!is_leaf[c] && !has_begins[size_t(c)])
                    stack.push_back(c);
        }
        for (auto it = order.rbegin(); it != order.rend(); ++it) {
            int64_t u = *it;
            if (has_begins[size_t(u)]) continue;
            std::vector<int64_t> merged;
            for (int32_t c : children[size_t(u)]) {
                if (is_leaf[c]) {
                    int64_t p = suffix[c];
                    if (!dead[size_t(p)]) merged.push_back(p);
                } else {
                    merged.insert(merged.end(),
                                  node_begins[size_t(c)].begin(),
                                  node_begins[size_t(c)].end());
                    node_begins[size_t(c)].clear();
                    node_begins[size_t(c)].shrink_to_fit();
                }
            }
            std::sort(merged.begin(), merged.end());
            node_begins[size_t(u)] = std::move(merged);
            has_begins[size_t(u)] = 1;
        }
        return node_begins[size_t(v)];
    };

    int64_t nd = 0, no = 0;
    // iterate lengths max_depth .. min_lrf (bins may gain entries at
    // smaller lengths mid-flight, exactly like the Python dict)
    for (int64_t length = max_depth; length >= min_lrf; length--) {
        // the Python loop iterates the bin list by reference; re-binned
        // nodes land in other (smaller) bins, never the current one
        for (size_t qi = 0; qi < bins[size_t(length)].size(); qi++) {
            int64_t v = bins[size_t(length)][qi];
            std::vector<int64_t>& poss = begins(v);
            std::vector<int64_t> selected, not_selected;
            int64_t last = -length - 1;
            int64_t min_shorter = 1;
            for (int64_t p : poss) {
                if (last + length <= p && !dead[size_t(p)] &&
                    !dead[size_t(p + length - 1)]) {
                    selected.push_back(p);
                    last = p;
                } else {
                    not_selected.push_back(p);
                }
                if (!dead[size_t(p)] && dead[size_t(p + length - 1)]) {
                    while (p + min_shorter < n &&
                           !dead[size_t(p + min_shorter)])
                        min_shorter++;
                }
            }
            if (min_shorter > 1 && min_shorter < length &&
                min_shorter >= min_lrf) {
                int64_t parent_depth = sdepth[parent[v]];
                if (parent_depth < min_shorter)
                    bins[size_t(min_shorter)].push_back(v);
            }
            if ((int64_t)selected.size() >= 2) {
                node_begins[size_t(v)] = std::move(not_selected);
                if (nd >= d_cap) return -1;
                d_start[nd] = selected[0];
                d_len[nd] = length;
                for (int64_t p : selected) {
                    for (int64_t j = p; j < p + length; j++)
                        dead[size_t(j)] = 1;
                    if (no >= o_cap) return -1;
                    o_pos[no] = p;
                    o_rule[no] = nd;
                    o_len[no] = length;
                    no++;
                }
                nd++;
            }
        }
    }
    *nd_out = nd;
    return no;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// LFS BST strategy (compressors/lfs.py BSTStrategy.compute_rules,
// reference lfs/BSTStrategy.hpp over the binary suffix tree): exact
// mirror incl. the chain-DFS bin order and dead-head filtering.
// ---------------------------------------------------------------------------

extern "C" {

int64_t tdc_lfs_bst(const int64_t* parent, const int64_t* sdepth,
                    const int64_t* suffix,
                    int64_t nn, int64_t n, int64_t min_lrf,
                    int64_t* d_start, int64_t* d_len, int64_t d_cap,
                    int64_t* o_pos, int64_t* o_rule, int64_t* o_len,
                    int64_t o_cap, int64_t* nd_out) {
    std::vector<int64_t> first_child(size_t(nn), 0);
    std::vector<int64_t> next_sibling(size_t(nn), 0);
    for (int64_t v = nn - 1; v >= 1; v--) {  // prepend keeps child order
        int64_t p = parent[v];
        next_sibling[size_t(v)] = first_child[size_t(p)];
        first_child[size_t(p)] = v;
    }
    int64_t max_depth = 0;
    {
        std::vector<int64_t> stack{0};
        while (!stack.empty()) {
            int64_t v = stack.back();
            stack.pop_back();
            if (first_child[size_t(v)] != 0 && sdepth[v] > max_depth)
                max_depth = sdepth[v];
            for (int64_t c = first_child[size_t(v)]; c != 0;
                 c = next_sibling[size_t(c)])
                stack.push_back(c);
        }
    }
    std::vector<std::vector<int64_t>> bins;
    bins.resize(size_t(max_depth) + 1);
    {
        std::vector<int64_t> stack{0};
        while (!stack.empty()) {
            int64_t v = stack.back();
            stack.pop_back();
            if (first_child[size_t(v)] != 0) {
                int64_t d = sdepth[v];
                if (d > 0) bins[size_t(d)].push_back(v);
                for (int64_t c = first_child[size_t(v)]; c != 0;
                     c = next_sibling[size_t(c)])
                    stack.push_back(c);
            }
        }
    }
    std::vector<uint8_t> dead(size_t(n), 0);
    std::vector<std::vector<int64_t>> begins;
    begins.resize(size_t(nn));
    std::vector<uint8_t> has(size_t(nn), 0);

    auto positions = [&](int64_t v) -> std::vector<int64_t>& {
        if (has[size_t(v)]) return begins[size_t(v)];
        std::vector<int64_t> stack{v}, order;
        while (!stack.empty()) {
            int64_t u = stack.back();
            stack.pop_back();
            order.push_back(u);
            for (int64_t c = first_child[size_t(u)]; c != 0;
                 c = next_sibling[size_t(c)])
                if (first_child[size_t(c)] != 0 && !has[size_t(c)])
                    stack.push_back(c);
        }
        for (auto it = order.rbegin(); it != order.rend(); ++it) {
            int64_t u = *it;
            if (has[size_t(u)]) continue;
            std::vector<int64_t> merged;
            for (int64_t c = first_child[size_t(u)]; c != 0;
                 c = next_sibling[size_t(c)]) {
                if (first_child[size_t(c)] == 0) {  // leaf
                    int64_t p = suffix[c];
                    if (!dead[size_t(p)]) merged.push_back(p);
                } else {
                    merged.insert(merged.end(), begins[size_t(c)].begin(),
                                  begins[size_t(c)].end());
                    begins[size_t(c)].clear();
                    begins[size_t(c)].shrink_to_fit();
                }
            }
            std::sort(merged.begin(), merged.end());
            begins[size_t(u)] = std::move(merged);
            has[size_t(u)] = 1;
        }
        return begins[size_t(v)];
    };

    int64_t nd = 0, no = 0;
    for (int64_t length = max_depth; length >= min_lrf; length--) {
        for (size_t qi = 0; qi < bins[size_t(length)].size(); qi++) {
            int64_t v = bins[size_t(length)][qi];
            std::vector<int64_t>& poss = positions(v);
            std::vector<int64_t> selected, not_selected;
            int64_t last = -length - 1;
            for (int64_t p : poss) {
                if (last + length <= p && !dead[size_t(p)] &&
                    !dead[size_t(p + length - 1)]) {
                    selected.push_back(p);
                    last = p;
                } else if (!dead[size_t(p)]) {  // drop dead heads
                    not_selected.push_back(p);
                }
            }
            if ((int64_t)selected.size() >= 2) {
                begins[size_t(v)] = std::move(not_selected);
                if (nd >= d_cap) return -1;
                d_start[nd] = selected[0];
                d_len[nd] = length;
                for (int64_t p : selected) {
                    for (int64_t j = p; j < p + length; j++)
                        dead[size_t(j)] = 1;
                    if (no >= o_cap) return -1;
                    o_pos[no] = p;
                    o_rule[no] = nd;
                    o_len[no] = length;
                    no++;
                }
                nd++;
            }
        }
    }
    *nd_out = nd;
    return no;
}

}  // extern "C"
