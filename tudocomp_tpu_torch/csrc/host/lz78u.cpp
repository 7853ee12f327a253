// Host LZ78U of the torch port: the suffix-tree factorization's event
// stream and the stream decoder.
//
// Copies of the JAX package's native runtime (native/tdc_native.cpp:
// lz78u_parse_impl with tdc_lz78u_parse/32 :2053-2171,
// tdc_lz78u_decode :2179-2282, over bitrw.hpp's BitRd), so that the
// port's lz78u needs nothing of that package. Built with the host
// compiler by _build.py into csrc/build/ and bound with ctypes by
// native.py.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#include "bitrw.hpp"

// ---- LZ78U parse + decode ------------------------------------------------
// Suffix-tree LZ78U factorization (compressors/lz78u.py compress walk,
// reference compressors/LZ78UCompressor.hpp): one factor per freshly
// visited suffix-tree node, labels >= threshold sub-factorized against
// already-assigned node factors with 0-escaped cut records. Emits the
// coder-agnostic event stream:
//   kind 0 = ref      (value = r,   aux = factor_count | -1 for len_r)
//   kind 1 = sep bit  (value = 0/1)
//   kind 2 = char     (value = byte)

template <typename I>
static int64_t lz78u_parse_impl(const I* parent, const I* sdepth,
                                const uint8_t* is_leaf,
                                const I* leaf_of_rank, const I* isa,
                                const uint8_t* text, int64_t n,
                                int64_t m, int64_t threshold,
                                uint8_t* kind, I* value, I* aux,
                                int64_t cap) {
    std::vector<I> R(size_t(m), 0);
    std::vector<int64_t> path;
    int64_t ne = 0;       // event count
    int64_t fc = 0;       // factor count
    auto emit = [&](uint8_t k, int64_t v, int64_t a) -> bool {
        if (ne >= cap) return false;
        kind[ne] = k; value[ne] = I(v); aux[ne] = I(a); ne++;
        return true;
    };
    auto build_path = [&](int64_t leaf) {
        path.clear();
        for (int64_t v = leaf; v != -1; v = parent[v]) path.push_back(v);
        std::reverse(path.begin(), path.end());
    };
    // output(begin, end, ref): one factor record
    auto output = [&](int64_t begin, int64_t end, int64_t ref) -> bool {
        while (end > begin && text[end - 1] == 0) end--;
        if (!emit(0, ref, fc)) return false;
        if (end - begin >= threshold) {
            if (!emit(1, 0, 0)) return false;
            int64_t pos = begin;
            while (pos < end) {
                build_path(leaf_of_rank[isa[pos]]);
                size_t d = 1;
                int64_t par2 = 0;
                int64_t node = path[d];
                while (!is_leaf[node] && R[size_t(node)] != 0) {
                    par2 = node;
                    d++;
                    node = path[d];
                }
                int64_t depth = sdepth[par2];
                if (depth < threshold) {
                    if (!emit(1, 0, 0)) return false;
                    if (!emit(2, text[pos], 0)) return false;
                    pos += 1;
                } else {
                    if (!emit(1, 1, 0)) return false;
                    if (!emit(0, R[size_t(par2)], fc)) return false;
                    pos += depth;
                    if (pos > end) {
                        if (!emit(1, 1, 0)) return false;
                        if (!emit(0, 0, fc)) return false;
                        if (!emit(0, pos - end, -1)) return false;
                    }
                }
            }
            if (!emit(1, 0, 0)) return false;
            if (!emit(2, 0, 0)) return false;
        } else {
            if (!emit(1, 1, 0)) return false;
            for (int64_t i = begin; i < end; i++)
                if (!emit(2, text[i], 0)) return false;
            if (!emit(2, 0, 0)) return false;
        }
        fc++;
        return true;
    };
    int64_t pos = 0;
    while (pos < n - 1) {
        build_path(leaf_of_rank[isa[pos]]);
        int64_t par = path[path.size() - 2];
        if (par == 0 || R[size_t(par)] != 0) {
            int64_t psd = sdepth[par];
            if (!output(pos + psd, pos + psd + 1, R[size_t(par)]))
                return -1;
            pos += psd + 1;
            continue;
        }
        size_t d = 1;
        int64_t par2 = 0;
        int64_t node = path[d];
        while (R[size_t(node)] != 0) {
            par2 = node;
            d++;
            node = path[d];
        }
        int64_t begin = pos + sdepth[par2];
        int64_t end = pos + sdepth[node];
        if (!output(begin, end, R[size_t(par2)])) return -1;
        R[size_t(node)] = I(fc);  // output() already incremented
        pos = end;
    }
    return ne;
}

extern "C" {

int64_t tdc_lz78u_parse(const int64_t* parent, const int64_t* sdepth,
                        const uint8_t* is_leaf,
                        const int64_t* leaf_of_rank, const int64_t* isa,
                        const uint8_t* text, int64_t n, int64_t m,
                        int64_t threshold,
                        uint8_t* kind, int64_t* value, int64_t* aux,
                        int64_t cap) {
    return lz78u_parse_impl<int64_t>(
        parent, sdepth, is_leaf, leaf_of_rank, isa, text, n, m,
        threshold, kind, value, aux, cap);
}

int64_t tdc_lz78u_parse32(const int32_t* parent, const int32_t* sdepth,
                          const uint8_t* is_leaf,
                          const int32_t* leaf_of_rank,
                          const int32_t* isa, const uint8_t* text,
                          int64_t n, int64_t m, int64_t threshold,
                          uint8_t* kind, int32_t* value, int32_t* aux,
                          int64_t cap) {
    return lz78u_parse_impl<int32_t>(
        parent, sdepth, is_leaf, leaf_of_rank, isa, text, n, m,
        threshold, kind, value, aux, cap);
}

// LZ78U stream decode (compressors/lz78u.py decompress): binary refs of
// width bits_for(factor_count), raw separator bits, chars via the
// canonical-huffman LUT when k > 0 else plain 8-bit. Each factor's full
// expansion is a contiguous segment of `out`, so expand() is a segment
// copy. Returns output length (incl. restored sentinel), -1 on overflow,
// -2 on malformed input.
int64_t tdc_lz78u_decode(const uint8_t* payload, int64_t nbits,
                         int64_t start_bit, const uint8_t* lut_sym,
                         const uint8_t* lut_len, int k,
                         int ref_kind, int str_kind,
                         uint8_t* out, int64_t out_cap) {
    BitRd rd{payload, nbits, start_bit};
    auto bits_for = [](int64_t v) -> int {
        int b = 1;
        while ((uint64_t(v) >> b) != 0) b++;
        return b;
    };
    auto read_ref = [&](int64_t fc, int w) -> int64_t {
        // ref coder fields: Range(fc) fixed width for kind 0,
        // the coder's VLC otherwise (values stored verbatim)
        if (ref_kind == 0) return rd.read(w);
        return rd.read_code(ref_kind, w);
    };
    auto read_literal = [&]() -> int {
        if (str_kind == 1 || str_kind == 2 || str_kind == 3) {
            int64_t v = rd.read_code(str_kind, 8);
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
    std::vector<int64_t> exp_off, exp_len;
    std::vector<uint8_t> rebuilt;
    int64_t fc = 0;
    int64_t o = 0;
    while (rd.pos < nbits) {
        int64_t ref = read_ref(fc, bits_for(fc));
        if (rd.pos >= nbits) break;
        if (ref < 0 || ref > fc) return -2;
        int64_t not_factorized = rd.read(1);
        rebuilt.clear();
        if (not_factorized) {
            while (true) {
                int c = read_literal();
                if (c < 0) return -2;
                if (c == 0) break;
                rebuilt.push_back(uint8_t(c));
                if (int64_t(rebuilt.size()) > out_cap) return -1;
                if (rd.pos >= nbits) return -2;
            }
        } else {
            while (true) {
                int64_t is_sub_char = !rd.read(1);
                if (is_sub_char) {
                    int c = read_literal();
                    if (c < 0) return -2;
                    rebuilt.push_back(uint8_t(c));
                } else {
                    int64_t sub = read_ref(fc, bits_for(fc));
                    if (sub < 0 || sub > fc) return -2;
                    if (sub == 0) {
                        int64_t cut = read_ref(fc, 32);
                        if (cut < 0 || cut > int64_t(rebuilt.size()))
                            return -2;
                        rebuilt.resize(rebuilt.size() - size_t(cut));
                    } else {
                        int64_t so = exp_off[size_t(sub - 1)];
                        int64_t sl = exp_len[size_t(sub - 1)];
                        rebuilt.insert(rebuilt.end(), out + so,
                                       out + so + sl);
                    }
                }
                if (int64_t(rebuilt.size()) > out_cap) return -1;
                if (!rebuilt.empty() && rebuilt.back() == 0) {
                    rebuilt.pop_back();
                    break;
                }
                // truncated stream: past-EOF reads return zeros which
                // can decode to a nonzero symbol forever; -1 here
                // would make the caller's grow-and-retry loop spin
                if (rd.pos >= nbits) return -2;
            }
        }
        int64_t start = o;
        if (ref != 0) {
            int64_t ro = exp_off[size_t(ref - 1)];
            int64_t rl = exp_len[size_t(ref - 1)];
            if (o + rl > out_cap) return -1;
            memcpy(out + o, out + ro, size_t(rl));
            o += rl;
        }
        if (o + int64_t(rebuilt.size()) > out_cap) return -1;
        memcpy(out + o, rebuilt.data(), rebuilt.size());
        o += int64_t(rebuilt.size());
        exp_off.push_back(start);
        exp_len.push_back(o - start);
        fc++;
    }
    if (o >= out_cap) return -1;
    out[o++] = 0;  // restore the sentinel
    return o;
}

}  // extern "C"
