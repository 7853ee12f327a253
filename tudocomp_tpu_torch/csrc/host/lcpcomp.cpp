// Host lcpcomp of the torch port: the arrays and heap factorizers over
// SA/ISA/LCP, the bulldozer interval sweep, and the compact decoder.
//
// Copies of the JAX package's native runtime (native/tdc_native.cpp:
// lcpcomp_arrays_impl with tdc_lcpcomp_arrays/32, lcpcomp_heap_impl with
// tdc_lcpcomp_heap/32, tdc_lcpcomp_compact, tdc_lcpcomp_bulldozer), so
// that the port's lcpcomp needs nothing of that package. Built with the
// host compiler by _build.py into csrc/build/ and bound with ctypes by
// native.py. Every entry point returns int64, as the host library's
// others do.

#include <algorithm>
#include <cstdint>
#include <queue>
#include <vector>

// ---- lcpcomp "arrays" factorization ----------------------------------
// Bucket array per LCP value with lazy decrease-key (reference
// lcpcomp/compress/ArraysComp.hpp; mirrors compressors/lcpcomp.py's
// _emit_factor rules). Mutates lcp. Returns the factor count or -1.

template <typename I>
static int64_t lcpcomp_arrays_impl(const I* sa, const I* isa,
                                   I* lcp, int64_t n, int64_t threshold,
                                   I* out_pos, I* out_src,
                                   I* out_len, int64_t cap) {
    int64_t maxlcp = 0;
    for (int64_t i = 0; i < n; i++)
        maxlcp = std::max<int64_t>(maxlcp, lcp[i]);
    if (maxlcp < threshold) return 0;
    // candidate buckets at index width I: english-class inputs push
    // ~0.6 entries/char here, the kernel's biggest allocation
    std::vector<std::vector<I>> cand(size_t(maxlcp + 1 - threshold));
    for (int64_t i = 0; i < n; i++) {
        if (lcp[i] >= threshold)
            cand[size_t(lcp[i] - threshold)].push_back(I(i));
    }
    int64_t count = 0;
    for (int64_t cur = maxlcp; cur >= threshold; cur--) {
        auto& col = cand[size_t(cur - threshold)];
        for (size_t ci = 0; ci < col.size(); ci++) {
            int64_t index = col[ci];
            int64_t lv = lcp[index];
            if (lv < cur) {
                if (lv >= threshold)
                    cand[size_t(lv - threshold)].push_back(I(index));
                continue;
            }
            int64_t pos = sa[index];
            int64_t src = sa[index - 1];
            int64_t len = lv;
            if (count >= cap) return -1;
            out_pos[count] = I(pos); out_src[count] = I(src);
            out_len[count] = I(len);
            count++;
            for (int64_t k = 0; k < len; k++) lcp[isa[pos + k]] = 0;
            int64_t max_affect = std::min(len, pos);
            for (int64_t k = 1; k <= max_affect; k++) {
                int64_t ind = isa[pos - k];
                if (k < lcp[ind]) lcp[ind] = I(k);
            }
        }
        col.clear();
        col.shrink_to_fit();
    }
    return count;
}

// ---- lcpcomp "heap" factorization ------------------------------------
// Max-heap with lazy invalidation (the order of compressors/lcpcomp.py
// MaxHeapStrategy: ties on LCP pop the smaller SA index first). Mutates
// lcp. Returns the factor count or -1.

template <typename I>
static int64_t lcpcomp_heap_impl(const I* sa, const I* isa,
                                 I* lcp, int64_t n, int64_t threshold,
                                 I* out_pos, I* out_src,
                                 I* out_len, int64_t cap) {
    // packed entry: lcp in the high 32 bits, bit-inverted index low —
    // a max-heap on the u64 pops the largest LCP and, on ties, the
    // smallest index (same order as the pair-based formulation).
    auto pack = [](int64_t lv, int64_t i) -> uint64_t {
        return (uint64_t(lv) << 32) | uint64_t(~uint32_t(i));
    };
    std::vector<uint64_t> init;
    init.reserve(size_t(n) / 4);
    for (int64_t i = 0; i < n; i++)
        if (lcp[i] >= threshold) init.push_back(pack(lcp[i], i));
    std::priority_queue<uint64_t> heap(
        std::less<uint64_t>(), std::move(init));  // O(n) make_heap
    int64_t count = 0;
    while (!heap.empty()) {
        uint64_t key = heap.top();
        heap.pop();
        int64_t index = int64_t(~uint32_t(key & 0xFFFFFFFFu));
        int64_t lv = lcp[index];
        if (lv != int64_t(key >> 32)) {
            if (lv >= threshold) heap.push(pack(lv, index));
            continue;
        }
        int64_t pos = sa[index], src = sa[index - 1], len = lv;
        if (count >= cap) return -1;
        out_pos[count] = I(pos); out_src[count] = I(src);
        out_len[count] = I(len);
        count++;
        for (int64_t k = 0; k < len; k++) lcp[isa[pos + k]] = 0;
        int64_t max_affect = std::min(len, pos);
        for (int64_t k = 1; k <= max_affect; k++) {
            int64_t ind = isa[pos - k];
            if (k < lcp[ind]) lcp[ind] = I(k);
        }
    }
    return count;
}

extern "C" {

int64_t tdc_lcpcomp_arrays(const int64_t* sa, const int64_t* isa,
                           int64_t* lcp, int64_t n, int64_t threshold,
                           int64_t* out_pos, int64_t* out_src,
                           int64_t* out_len, int64_t cap) {
    return lcpcomp_arrays_impl<int64_t>(
        sa, isa, lcp, n, threshold, out_pos, out_src, out_len, cap);
}

int64_t tdc_lcpcomp_arrays32(const int32_t* sa, const int32_t* isa,
                             int32_t* lcp, int64_t n, int64_t threshold,
                             int32_t* out_pos, int32_t* out_src,
                             int32_t* out_len, int64_t cap) {
    return lcpcomp_arrays_impl<int32_t>(
        sa, isa, lcp, n, threshold, out_pos, out_src, out_len, cap);
}

int64_t tdc_lcpcomp_heap(const int64_t* sa, const int64_t* isa,
                         int64_t* lcp, int64_t n, int64_t threshold,
                         int64_t* out_pos, int64_t* out_src,
                         int64_t* out_len, int64_t cap) {
    return lcpcomp_heap_impl<int64_t>(
        sa, isa, lcp, n, threshold, out_pos, out_src, out_len, cap);
}

int64_t tdc_lcpcomp_heap32(const int32_t* sa, const int32_t* isa,
                           int32_t* lcp, int64_t n, int64_t threshold,
                           int32_t* out_pos, int32_t* out_src,
                           int32_t* out_len, int64_t cap) {
    return lcpcomp_heap_impl<int32_t>(
        sa, isa, lcp, n, threshold, out_pos, out_src, out_len, cap);
}

// Forward-bucket resolution (reference decompress/CompactDec.hpp:18-40):
// every position copied from source s registers a waiter on s; once a
// byte becomes known it propagates to its waiters (iterative stack
// instead of the reference's recursion). O(n + total factor length).

int64_t tdc_lcpcomp_compact(int64_t n, const uint8_t* lit_bytes,
                            const int64_t* lit_pos, int64_t nlit,
                            const int64_t* fpos, const int64_t* fsrc,
                            const int64_t* flen, int64_t nfac,
                            uint8_t* out) {
    // counting-sort waiters by source position
    std::vector<int64_t> cnt((size_t)n + 1, 0);
    int64_t total_w = 0;
    for (int64_t f = 0; f < nfac; f++) {
        if (fpos[f] < 0 || fsrc[f] < 0 || flen[f] < 0) return -2;
        if (fpos[f] + flen[f] > n || fsrc[f] + flen[f] > n) return -2;
        for (int64_t k = 0; k < flen[f]; k++) cnt[(size_t)(fsrc[f] + k)]++;
        total_w += flen[f];
    }
    std::vector<int64_t> start((size_t)n + 1, 0);
    for (int64_t i = 0; i < n; i++) start[(size_t)(i + 1)] = start[(size_t)i] + cnt[(size_t)i];
    std::vector<int64_t> waiters((size_t)total_w);
    std::vector<int64_t> fill(start.begin(), start.end() - 1);
    for (int64_t f = 0; f < nfac; f++)
        for (int64_t k = 0; k < flen[f]; k++)
            waiters[(size_t)fill[(size_t)(fsrc[f] + k)]++] = fpos[f] + k;
    std::vector<uint8_t> known((size_t)n, 0);
    std::vector<int64_t> stack;
    stack.reserve(1024);
    for (int64_t i = 0; i < nlit; i++) {
        int64_t p = lit_pos[i];
        if (p < 0 || p >= n) return -2;
        out[p] = lit_bytes[i];
        known[(size_t)p] = 1;
        stack.push_back(p);
        while (!stack.empty()) {
            int64_t q = stack.back(); stack.pop_back();
            for (int64_t w = start[(size_t)q]; w < start[(size_t)q + 1]; w++) {
                int64_t t = waiters[(size_t)w];
                if (!known[(size_t)t]) {
                    out[t] = out[q];
                    known[(size_t)t] = 1;
                    stack.push_back(t);
                }
            }
        }
    }
    for (int64_t i = 0; i < n; i++)
        if (!known[(size_t)i]) return -3;  // unresolved (cyclic/missing)
    return 0;
}

// ---- lcpcomp bulldozer strategy ----------------------------------------
// compressors/lcpcomp.py BulldozerStrategy (reference
// compress/BulldozerStrategy.hpp, intended behavior): the interval sweep.

int64_t tdc_lcpcomp_bulldozer(const int64_t* sa, const int64_t* lcp,
                              int64_t n, int64_t threshold,
                              int64_t* fpos, int64_t* fsrc,
                              int64_t* flen, int64_t fcap) {
    struct Iv { int64_t p, q, l; };
    std::vector<Iv> iv;
    for (int64_t i = 1; i < n; i++) {
        if (lcp[i] >= threshold) {
            iv.push_back({sa[i], sa[i - 1], lcp[i]});
            iv.push_back({sa[i - 1], sa[i], lcp[i]});
        }
    }
    // stable: ties on (p, l) keep candidate order like Python's sort
    std::stable_sort(iv.begin(), iv.end(), [](const Iv& a, const Iv& b) {
        if (a.p != b.p) return a.p < b.p;
        return a.l > b.l;
    });
    std::vector<uint8_t> marked(size_t(n), 0);
    int64_t nf = 0;
    size_t x = 0;
    while (x < iv.size()) {
        int64_t p = iv[x].p, q = iv[x].q, max_l = iv[x].l;
        if (!marked[size_t(q)]) {
            int64_t length = 1;
            while (length < max_l && q + length < n &&
                   !marked[size_t(q + length)])
                length++;
            if (length >= threshold) {
                bool free_run = true;
                for (int64_t j = p; j < p + length; j++) {
                    if (marked[size_t(j)]) { free_run = false; break; }
                }
                if (free_run) {
                    if (nf >= fcap) return -1;
                    fpos[nf] = p; fsrc[nf] = q; flen[nf] = length;
                    nf++;
                    for (int64_t j = p; j < p + length; j++)
                        marked[size_t(j)] = 1;
                    x++;
                    while (x < iv.size() && iv[x].p < p + length) x++;
                    continue;
                }
            }
        }
        x++;
    }
    return nf;
}

}  // extern "C"
