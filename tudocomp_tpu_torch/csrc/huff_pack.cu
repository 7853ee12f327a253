// K2: per-segment canonical Huffman pack, the codec's huff_raw escape
// select, and the stage probes.
//
// Replaces tudocomp_tpu/ops/segpack_pallas.py:_huffman_kernel_w4 (entry
// huffman_pack_segments_w4) and its byte twin _huffman_kernel: for each
// segment, the first counts[c] bytes of its big-endian stream words map
// to their codes (<= 16 bits), packed MSB-first into u32 words, plus the
// total bit count. The select entry also takes the codec's escape
// (tudocomp_tpu/models/blockcodec.py huff_stage, where XLA fused it
// beside the TPU kernel): where the codes would not shrink the stream
// (bits >= 8 * count), the input words and 8 * count bits.
//
// On the TPU the table lookup and the placement are one-hot matmuls. A
// first Hopper design ran one 256-thread block per segment, refilled the
// table and zeroed a word buffer in every block, and OR-ed every code
// into shared memory with atomicOr: with codes of 3-10 bits many codes
// share a word, so the atomics of a warp serialised, and they took 57%
// of its time (NVIDIA H100 80GB HBM3, 700 W; PERF.md). Here one warp
// owns one segment, eight segments a block, and only the table fill
// waits on the block. Each lane loads its 16 bytes of each 512-byte
// slice of the segment (16-byte loads, none past the stream), then,
// slice by slice: looks up its 16 codes in the shared table, takes its
// bit offset from a warp sum-scan by shuffles, appends its codes two at
// a time to a 64-bit register and stages each word its bits complete
// with a plain (predicated) shared store. A word that
// several lanes share gets the bits of the lanes before it from a
// segmented OR-scan by shuffles of the lanes' left-over bits (lanes
// whose bits end in the same word, in order; skipped when every lane's
// bits fill a word, so that no two lanes end in one), and its first
// owner ORs them in. No atomics. Then the warp stores the first 512
// words with 16-byte stores, zero past the stream: a segment with more
// bits (> 16384 >= 8 * count) takes the huff_raw escape, which discards
// them. The escape is known once the last slice's scan is done, the
// same for the whole warp, and then the warp stores its input words in
// place of the staged ones (a first design decided it before any
// placement, from a separate pass over the code lengths: that cost the
// segments that do not escape more than it saved the others). It reads
// 2 KiB and writes 2 KiB a segment, but what bounds it is the
// instruction rate of the lookups and the appends, not device memory (on
// the NVIDIA H100 80GB HBM3 at 700 W, 1.4x its memory bound at 256 MiB;
// PERF.md).
//
// The kernel is a template over the stage it stops after, so that the
// stage probes (counterparts of etc/probe_ablate.py, the byte form, and
// etc/probe_ablate_w4.py, the word form) time cuts through this very
// body: s0 load, s1 + table fill and code lookup, s2 + warp scans, s3 +
// placement (the appends, the staged words and the OR-scans in shared
// memory and registers), s4 + store (K2 itself). Stages s0-s3 write one
// wrapping u32 checksum per segment to bits_out, so that no stage is
// dead code; each of them pays one warp reduction that s4 does not.
// tdc_huff_pack launches <FULL, false, false>, tdc_huff_select
// <FULL, false, true>.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;                            // segments per block
constexpr int THREADS = 32 * WARPS;
constexpr int SLICES = 4;                           // 512-byte slices
constexpr int PER = tdc::SEG / (32 * SLICES);       // 16 symbols a lane
constexpr int SLICE_WORDS = tdc::SEG_WORDS / SLICES;
constexpr int KEEP = tdc::SEG_WORDS;                // packed words kept
// staged words a warp: every word of a stream of 16-bit codes
constexpr int BUF = 2 * KEEP;
constexpr unsigned FULL_MASK = 0xffffffffu;
static_assert(THREADS == 256, "one table entry per thread");

enum Stage { LOAD = 0, LOOKUP = 1, SCAN = 2, PLACE = 3, FULL = 4 };

// symbol j (0..15) of a lane's 16 bytes of one slice: big-endian stream
// words, or (BYTES) the segment's bytes read as little-endian words
template <bool BYTES>
__device__ __forceinline__ uint32_t symbol(const uint32_t (&w)[4], int j) {
  const int sh = BYTES ? 8 * (j & 3) : 24 - 8 * (j & 3);
  return (w[j >> 2] >> sh) & 0xFFu;
}

// the lane's 16 bytes of slice r
__device__ __forceinline__ void load(uint32_t (&v)[4], const uint32_t* src,
                                     int lane, int r, bool vec) {
  if (vec) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(src) + lane + 32 * r);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {  // 4-byte aligned
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[q] = __ldg(src + SLICE_WORDS * r + 4 * lane + q);
  }
}

// the table entries (code << 8 | length) of the lane's 16 symbols of
// one slice; with MASK, 0 past its first `live`
template <bool BYTES, bool MASK>
__device__ __forceinline__ void lookup(const uint32_t (&v)[4], int live,
                                       const uint32_t* table,
                                       uint32_t (&e)[PER]) {
#pragma unroll
  for (int j = 0; j < PER; ++j)
    e[j] = !MASK || j < live ? table[symbol<BYTES>(v, j)] : 0u;
}

// lane 0 writes the warp's wrapping u32 sum of v
__device__ __forceinline__ void warp_checksum(uint32_t v, int lane,
                                              int32_t* out) {
  v = __reduce_add_sync(FULL_MASK, v);
  if (lane == 0) *out = (int32_t)v;
}

// BYTES: words_in holds the segment's bytes in order (u8[NC, 2048] read
// as little-endian u32); otherwise big-endian stream words (K2's input).
// SELECT (word form only): the huff_raw escape, flags to raw_out. Four
// blocks an SM (at most 64 registers a thread).
template <int STAGE, bool BYTES, bool SELECT>
__global__ void __launch_bounds__(THREADS, 4)
huff_pack_kernel(const uint32_t* __restrict__ words_in,
                 const int32_t* __restrict__ counts,
                 const int32_t* __restrict__ sym_code,
                 const int32_t* __restrict__ sym_len,
                 uint32_t* __restrict__ words_out,
                 int32_t* __restrict__ bits_out,
                 uint8_t* __restrict__ raw_out, int nc) {
  static_assert(!(SELECT && (BYTES || STAGE != FULL)), "select: K2 only");
  __shared__ uint32_t table[256];  // code << 8 | length
  __shared__ __align__(16) uint32_t staged[WARPS][BUF];
  const int t = threadIdx.x;
  if constexpr (STAGE >= LOOKUP) {
    const int l = min(max(sym_len[t], 0), 16);
    table[t] = (((uint32_t)sym_code[t] & ((1u << l) - 1u)) << 8) | l;
    __syncthreads();
  }
  const int lane = t & 31;
  const int warp = t >> 5;
  const int seg = blockIdx.x * WARPS + warp;
  if (seg >= nc) return;  // whole warps leave; nothing below syncs the block
  const int count_raw = counts[seg];
  const int count = min(max(count_raw, 0), tdc::SEG);

  // load: the lane's 16 bytes of each slice (words 4 * lane .. + 3 of
  // it) that hold live symbols, 16 bytes at a time where the rows allow
  const uint32_t* src = words_in + (size_t)seg * tdc::SEG_WORDS;
  const bool vec = (reinterpret_cast<uintptr_t>(words_in) & 15) == 0;
  uint32_t w[SLICES][4];
  int live[SLICES];  // live symbols of the lane's 16 in each slice
#pragma unroll
  for (int r = 0; r < SLICES; ++r) {
    live[r] = min(max(count - (tdc::SEG / SLICES) * r - PER * lane, 0), PER);
    w[r][0] = w[r][1] = w[r][2] = w[r][3] = 0u;
    if (live[r]) load(w[r], src, lane, r, vec);
  }

  if constexpr (STAGE == LOAD) {
    uint32_t s = 0;
#pragma unroll
    for (int r = 0; r < SLICES; ++r)
#pragma unroll
      for (int j = 0; j < PER; ++j)
        if (j < live[r]) s += symbol<BYTES>(w[r], j);
    warp_checksum(s, lane, &bits_out[seg]);
    return;
  }

  // slice by slice: look up the codes, scan their lengths, place them
  uint32_t ck = 0;     // the probes' checksum
  int base = 0;        // bits of the slices before
  uint32_t* buf = staged[warp];
  const uint32_t buf_s =
      tdc::pinned((uint32_t)__cvta_generic_to_shared(buf));
  uint32_t carry = 0;  // OR of the left-over bits ending in word carry_at
  int carry_at = 0;
#pragma unroll
  for (int r = 0; r < SLICES; ++r) {
    // slices past the stream hold no symbol (the same for the warp)
    if ((tdc::SEG / SLICES) * r >= count) break;
    uint32_t e[PER];
    if (live[r] == PER)
      lookup<BYTES, false>(w[r], PER, table, e);
    else
      lookup<BYTES, true>(w[r], live[r], table, e);
    int sum = 0;
    uint32_t later = 0;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int l = e[j] & 0xFF;
      sum += l;
      if constexpr (STAGE == LOOKUP) ck += (e[j] >> 8) + l;
      // the bits of symbol j lie before each live symbol after it
      if constexpr (STAGE == SCAN) later += l * (live[r] - 1 - j);
    }
    if constexpr (STAGE == LOOKUP) continue;

    // the lane's bit offset: a warp sum-scan
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, incl, d);
      if (lane >= d) incl += y;
    }
    const int off = base + incl - sum;
    base += __shfl_sync(FULL_MASK, incl, 31);
    if constexpr (STAGE == SCAN) {
      ck += live[r] * off + later;
      continue;
    }

    // placement: the lane appends its codes two at a time (<= 32 bits)
    // to acc (nb bits pending, starting at its offset within its first
    // word) and stages each word once its 32 bits are known; the first
    // of them lacks the bits of the lanes before it, which arrive with
    // the OR-scan below
    const int first = off >> 5;
    int at = first, nb = off & 31;
    uint64_t acc = 0;
#pragma unroll
    for (int j = 0; j < PER; j += 2) {
      const int l1 = e[j + 1] & 0xFF;
      const int l = (e[j] & 0xFF) + l1;
      acc = (acc << l) | (((e[j] >> 8) << l1) | (e[j + 1] >> 8));
      nb += l;
      const bool full = nb >= 32;
      nb -= full ? 32 : 0;
      tdc::stage(buf_s, buf, at, (uint32_t)(acc >> nb), full);
      at += full;
    }
    // left-over bits at the top of word `at`, OR-ed over the lanes (of
    // this slice and, through carry, the slices before) that end in it
    uint32_t left = nb ? (uint32_t)(acc << (32 - nb)) : 0u;
    // (every lane's bits filling a word: no two lanes end in one word)
    if (!__all_sync(FULL_MASK, sum >= 32)) {
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t y = __shfl_up_sync(FULL_MASK, left, d);
        const int ya = __shfl_up_sync(FULL_MASK, at, d);
        if (lane >= d && ya == at) left |= y;
      }
    }
    if (at == carry_at) left |= carry;
    // the lane before ends in this lane's first word
    uint32_t before = __shfl_up_sync(FULL_MASK, left, 1);
    if (lane == 0) before = carry;
    if (at > first) buf[first] |= before;
    carry = __shfl_sync(FULL_MASK, left, 31);
    carry_at = __shfl_sync(FULL_MASK, at, 31);
  }
  if constexpr (STAGE == LOOKUP || STAGE == SCAN) {
    warp_checksum(ck, lane, &bits_out[seg]);
    return;
  }
  const int total = base;
  if (lane == 0 && (total & 31))
    buf[total >> 5] = carry;  // the stream's last, partial word
  __syncwarp();

  const int nw = (total + 31) >> 5;  // words of the stream
  if constexpr (STAGE == PLACE) {
    uint32_t s = 0;
    for (int i = lane; i < min(nw, KEEP); i += 32) s += buf[i];
    warp_checksum(s, lane, &bits_out[seg]);
    return;
  }
  uint32_t* dst = words_out + (size_t)seg * tdc::SEG_WORDS;
  const int raw_bits = (int)((uint32_t)count_raw * 8u);
  // the huff_raw escape: the input words as they came, the dead ones too
  const bool escape = SELECT && total >= raw_bits;
  if (escape) {
#pragma unroll
    for (int r = 0; r < SLICES; ++r)
      if (!live[r]) load(w[r], src, lane, r, vec);
  }
  // store: the 512 staged words, zero past the stream (or, on the
  // escape, the input words), 16 bytes a lane
#pragma unroll
  for (int q = 0; q < SLICES; ++q) {
    const int i = 4 * lane + SLICE_WORDS * q;
    const uint4 v = reinterpret_cast<const uint4*>(buf)[lane + 32 * q];
    const uint32_t o[4] = {v.x, v.y, v.z, v.w};
    uint32_t out[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      out[k] = escape ? w[q][k] : i + k < nw ? o[k] : 0u;
    reinterpret_cast<uint4*>(dst)[lane + 32 * q] =
        make_uint4(out[0], out[1], out[2], out[3]);
  }
  if (lane == 0) {
    bits_out[seg] = escape ? raw_bits : total;
    if constexpr (SELECT) raw_out[seg] = escape;
  }
}

template <int STAGE, bool BYTES, bool SELECT = false>
int launch(const void* words_in, const void* counts, const void* sym_code,
           const void* sym_len, void* words_out, void* bits_out,
           void* raw_out, int nc, cudaStream_t stream) {
  const int blocks = (nc + WARPS - 1) / WARPS;
  huff_pack_kernel<STAGE, BYTES, SELECT><<<blocks, THREADS, 0, stream>>>(
      (const uint32_t*)words_in, (const int32_t*)counts,
      (const int32_t*)sym_code, (const int32_t*)sym_len,
      (uint32_t*)words_out, (int32_t*)bits_out, (uint8_t*)raw_out, nc);
  return (int)cudaGetLastError();
}

template <bool BYTES>
int launch_stage(int stage, const void* words_in, const void* counts,
                 const void* sym_code, const void* sym_len, void* words_out,
                 void* bits_out, int nc, cudaStream_t s) {
  switch (stage) {
    case LOAD:
      return launch<LOAD, BYTES>(words_in, counts, sym_code, sym_len,
                                 words_out, bits_out, nullptr, nc, s);
    case LOOKUP:
      return launch<LOOKUP, BYTES>(words_in, counts, sym_code, sym_len,
                                   words_out, bits_out, nullptr, nc, s);
    case SCAN:
      return launch<SCAN, BYTES>(words_in, counts, sym_code, sym_len,
                                 words_out, bits_out, nullptr, nc, s);
    case PLACE:
      return launch<PLACE, BYTES>(words_in, counts, sym_code, sym_len,
                                  words_out, bits_out, nullptr, nc, s);
    case FULL:
      return launch<FULL, BYTES>(words_in, counts, sym_code, sym_len,
                                 words_out, bits_out, nullptr, nc, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K2: the first 512 packed words and the full bit count
extern "C" int tdc_huff_pack(const void* words_in, const void* counts,
                             const void* sym_code, const void* sym_len,
                             void* words_out, void* bits_out, int nc,
                             void* stream) {
  return launch<FULL, false>(words_in, counts, sym_code, sym_len, words_out,
                             bits_out, nullptr, nc, (cudaStream_t)stream);
}

// K2 + the huff_raw escape: huff_stage's (words, bits, huff_raw)
extern "C" int tdc_huff_select(const void* words_in, const void* counts,
                               const void* sym_code, const void* sym_len,
                               void* words_out, void* bits_out,
                               void* raw_out, int nc, void* stream) {
  return launch<FULL, false, true>(words_in, counts, sym_code, sym_len,
                                   words_out, bits_out, raw_out, nc,
                                   (cudaStream_t)stream);
}

// The stage probes: stage 0..4 as above; bytes_input selects the byte
// form (u8[NC, 2048]) over K2's big-endian words. words_out is written
// at stage 4 only and may be null below it.
extern "C" int tdc_huff_pack_stage(const void* data, const void* counts,
                                   const void* sym_code, const void* sym_len,
                                   void* words_out, void* bits_out, int nc,
                                   int stage, int bytes_input, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return bytes_input
      ? launch_stage<true>(stage, data, counts, sym_code, sym_len, words_out,
                           bits_out, nc, s)
      : launch_stage<false>(stage, data, counts, sym_code, sym_len,
                            words_out, bits_out, nc, s);
}
