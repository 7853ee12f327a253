// Host suffix array (SA-IS) and BWT decode of the torch port.
//
// Copies of the JAX package's native runtime (native/tdc_native.cpp:
// the tdc_sais namespace with tdc_suffix_array_sais/_sais32, and
// tdc_bwt_decode), so that the port's bwt compressor needs nothing of
// that package. Built with the host compiler by _build.py into
// csrc/build/ and bound with ctypes by native.py. Every entry point
// returns int64 (0 on success), as the host library's others do.

#include <cstddef>
#include <cstdint>
#include <vector>

// ---- SA-IS linear-time suffix array ---------------------------------------
// Induced sorting (Nong, Zhang & Chan, "Two Efficient Algorithms for
// Linear Time Suffix Array Construction", 2009).

namespace tdc_sais {

static inline bool is_lms(const uint8_t* t, int64_t i) {
    return i > 0 && t[i] && !t[i - 1];
}

// s: values in [0, K); s[n-1] is the unique smallest symbol (sentinel).
// Templated on the index width I: the int32 instantiation (n < 2^31)
// halves both the output and the recursion workspace.
template <typename I>
static void sais(const I* s, I* sa, I n, I K, std::vector<I>& work) {
    std::vector<uint8_t> t(static_cast<size_t>(n), uint8_t(0));
    t[size_t(n - 1)] = 1;
    for (I i = n - 2; i >= 0; i--)
        t[size_t(i)] = s[i] < s[i + 1]
            || (s[i] == s[i + 1] && t[size_t(i + 1)]);
    std::vector<I> bkt(size_t(K) + 1);
    auto buckets = [&](bool ends) {
        std::fill(bkt.begin(), bkt.end(), I(0));
        for (I i = 0; i < n; i++) bkt[size_t(s[i]) + 1]++;
        for (size_t i = 1; i < bkt.size(); i++) bkt[i] += bkt[i - 1];
        if (!ends) return;           // bkt[c] = start of bucket c
        // ends: bkt[c] = one past end of bucket c (shift left by one)
        for (size_t i = 0; i + 1 < bkt.size(); i++) bkt[i] = bkt[i + 1];
    };
    auto induce = [&]() {
        // L-type left-to-right from bucket starts
        buckets(false);
        std::vector<I> head(bkt.begin(), bkt.end());
        for (I i = 0; i < n; i++) {
            I j = sa[i] - 1;
            if (sa[i] > 0 && !t[size_t(j)])
                sa[head[size_t(s[j])]++] = j;
        }
        // S-type right-to-left from bucket ends
        buckets(true);
        std::vector<I> tail(bkt.begin(), bkt.end());
        for (I i = n - 1; i >= 0; i--) {
            I j = sa[i] - 1;
            if (sa[i] > 0 && t[size_t(j)])
                sa[--tail[size_t(s[j])]] = j;
        }
    };
    // 1) place LMS suffixes at bucket ends (arbitrary order), induce
    std::fill(sa, sa + n, I(-1));
    buckets(true);
    {
        std::vector<I> tail(bkt.begin(), bkt.end());
        for (I i = 1; i < n; i++)
            if (is_lms(t.data(), i)) sa[--tail[size_t(s[i])]] = i;
    }
    induce();
    // 2) extract sorted LMS substrings, assign names
    I n1 = 0;
    for (I i = 0; i < n; i++)
        if (is_lms(t.data(), sa[i])) sa[n1++] = sa[i];
    std::fill(sa + n1, sa + n, I(-1));
    I name = 0, prev = -1;
    for (I i = 0; i < n1; i++) {
        I pos = sa[i];
        bool diff = false;
        if (prev < 0) {
            diff = true;
        } else {
            for (I d = 0;; d++) {
                if (pos + d >= n || prev + d >= n
                    || s[pos + d] != s[prev + d]
                    || t[size_t(pos + d)] != t[size_t(prev + d)]) {
                    diff = true;
                    break;
                }
                if (d > 0 && (is_lms(t.data(), pos + d)
                              || is_lms(t.data(), prev + d))) {
                    diff = !(is_lms(t.data(), pos + d)
                             && is_lms(t.data(), prev + d));
                    break;
                }
            }
        }
        if (diff) { name++; prev = pos; }
        sa[n1 + pos / 2] = name - 1;
    }
    // compact names into s1 (order of appearance in the text)
    I* s1 = sa + n - n1;
    for (I i = n - 1, j = n - 1; i >= n1; i--)
        if (sa[i] >= 0) sa[j--] = sa[i];
    // 3) sort the LMS order: recurse if names repeat
    if (name < n1) {
        sais<I>(s1, sa, n1, name, work);
    } else {
        for (I i = 0; i < n1; i++) sa[s1[i]] = i;
    }
    // map s1 indices back to text positions
    {
        std::vector<I>& lms = work;
        lms.clear();
        lms.reserve(size_t(n1));
        for (I i = 1; i < n; i++)
            if (is_lms(t.data(), i)) lms.push_back(i);
        for (I i = 0; i < n1; i++) sa[i] = lms[size_t(sa[i])];
    }
    // 4) final induce from the sorted LMS suffixes
    std::fill(sa + n1, sa + n, I(-1));
    buckets(true);
    {
        std::vector<I> tail(bkt.begin(), bkt.end());
        for (I i = n1 - 1; i >= 0; i--) {
            I j = sa[i];
            sa[i] = -1;
            sa[--tail[size_t(s[j])]] = j;
        }
    }
    induce();
}

}  // namespace tdc_sais

// ---- BWT decode (LF walk) --------------------------------------------
// bwt: n bytes of the BWT of a 0-sentineled text (sentinel included).
// out receives n-1 bytes (text without sentinel).

template <typename I>
static void bwt_decode_impl(const uint8_t* bwt, uint8_t* out, int64_t n) {
    std::vector<I> counts(257, 0);
    for (int64_t i = 0; i < n; i++) counts[bwt[i] + 1]++;
    for (int i = 0; i < 256; i++) counts[i + 1] += counts[i];
    std::vector<I> lf(static_cast<size_t>(n));
    for (int64_t i = 0; i < n; i++) lf[size_t(i)] = counts[bwt[i]]++;
    I p = 0;
    for (int64_t j = 1; j < n; j++) {
        out[n - 1 - j] = bwt[p];
        p = lf[size_t(p)];
    }
}

extern "C" {

int64_t tdc_suffix_array_sais(const uint8_t* text, int64_t n, int64_t* sa) {
    if (n <= 0) return 0;
    if (n == 1) { sa[0] = 0; return 0; }
    // sentinel formulation: s = text+1 with a trailing unique 0
    std::vector<int64_t> s(size_t(n) + 1);
    for (int64_t i = 0; i < n; i++) s[size_t(i)] = int64_t(text[i]) + 1;
    s[size_t(n)] = 0;
    std::vector<int64_t> sa1(size_t(n) + 1);
    std::vector<int64_t> work;
    tdc_sais::sais<int64_t>(s.data(), sa1.data(), n + 1, 257, work);
    // drop the sentinel suffix (always first)
    for (int64_t i = 0; i < n; i++) sa[i] = sa1[size_t(i) + 1];
    return 0;
}

int64_t tdc_suffix_array_sais32(const uint8_t* text, int64_t n,
                                int32_t* sa) {
    if (n <= 0) return 0;
    if (n == 1) { sa[0] = 0; return 0; }
    std::vector<int32_t> s(size_t(n) + 1);
    for (int64_t i = 0; i < n; i++) s[size_t(i)] = int32_t(text[i]) + 1;
    s[size_t(n)] = 0;
    std::vector<int32_t> sa1(size_t(n) + 1);
    std::vector<int32_t> work;
    tdc_sais::sais<int32_t>(s.data(), sa1.data(), int32_t(n + 1), 257,
                            work);
    for (int64_t i = 0; i < n; i++) sa[i] = sa1[size_t(i) + 1];
    return 0;
}

int64_t tdc_bwt_decode(const uint8_t* bwt, uint8_t* out, int64_t n) {
    if (n <= 1) return 0;
    // int32 LF halves the decode working set for any real input
    if (n < (int64_t(1) << 31)) bwt_decode_impl<int32_t>(bwt, out, n);
    else bwt_decode_impl<int64_t>(bwt, out, n);
    return 0;
}

}  // extern "C"
