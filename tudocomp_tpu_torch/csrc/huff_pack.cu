// K2: per-segment canonical Huffman pack, and its stage probes.
//
// Replaces tudocomp_tpu/ops/segpack_pallas.py:_huffman_kernel_w4 (entry
// huffman_pack_segments_w4) and its byte twin _huffman_kernel: for each
// segment, the first counts[c] bytes of its big-endian stream words map
// to their codes (<= 16 bits), packed MSB-first into u32 words, plus the
// total bit count.
//
// On the TPU the table lookup and the placement are one-hot matmuls.
// Here the 256-entry code/length table sits in shared memory, a block
// sum-scan of code lengths gives each code its bit offset, and each code
// (spanning at most two words) is OR-ed into a shared-memory word
// buffer with atomicOr. One block per segment; the kernel reads 2 KiB
// and writes 2 KiB per segment, so it is bound by device memory traffic
// and the shared-memory atomics. Only the first 512 words are kept: a
// segment with more bits (> 16384 >= 8 * count) takes the huff_raw
// escape, which discards the packed words.
//
// The kernel is a template over the stage it stops after, so that the
// stage probes (counterparts of etc/probe_ablate.py, the byte form, and
// etc/probe_ablate_w4.py, the word form) time cuts through this very
// body: s0 load, s1 + table and lookup, s2 + block scan, s3 + placement
// into shared memory, s4 + store (K2 itself). Stages s0-s3 write one
// wrapping u32 checksum per segment to bits_out, so that no stage is
// dead code; each of them pays one block reduction that s4 does not.
// tdc_huff_pack launches <FULL, false> only.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PER = tdc::SEG / THREADS;  // 8 symbols per thread

enum Stage { LOAD = 0, LOOKUP = 1, SCAN = 2, PLACE = 3, FULL = 4 };

__device__ __forceinline__ void put(uint32_t* acc, int off, uint32_t code,
                                    int len) {
  const int w = off >> 5;
  const int sh = 32 - (off & 31) - len;
  if (w >= tdc::SEG_WORDS) return;
  if (sh >= 0) {
    atomicOr(&acc[w], code << sh);
  } else {
    atomicOr(&acc[w], code >> -sh);
    if (w + 1 < tdc::SEG_WORDS) atomicOr(&acc[w + 1], code << (32 + sh));
  }
}

// Wrapping u32 sum of one value per thread over the block; thread 0
// writes it to *out.
__device__ __forceinline__ void block_checksum(uint32_t v, int32_t* out) {
  __shared__ uint32_t part[THREADS / 32];
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t s = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) s += part[w];
    *out = (int32_t)s;
  }
}

// BYTES: words_in holds the segment's bytes in order (u8[NC, 2048] read
// as little-endian u32); otherwise big-endian stream words (K2's input).
template <int STAGE, bool BYTES>
__global__ void __launch_bounds__(THREADS)
huff_pack_kernel(const uint32_t* __restrict__ words_in,
                 const int32_t* __restrict__ counts,
                 const int32_t* __restrict__ sym_code,
                 const int32_t* __restrict__ sym_len,
                 uint32_t* __restrict__ words_out,
                 int32_t* __restrict__ bits_out) {
  __shared__ uint32_t code_of[256];
  __shared__ int len_of[256];
  __shared__ uint32_t acc[tdc::SEG_WORDS];
  const int seg = blockIdx.x;
  const int t = threadIdx.x;
  const int count = min(max(counts[seg], 0), tdc::SEG);

  if constexpr (STAGE >= LOOKUP) {
    const int l = min(max(sym_len[t], 0), 16);
    len_of[t] = l;
    code_of[t] = (uint32_t)sym_code[t] & ((1u << l) - 1u);
  }
  if constexpr (STAGE >= PLACE) {
    for (int w = t; w < tdc::SEG_WORDS; w += THREADS) acc[w] = 0u;
  }
  const uint32_t* src = words_in + (size_t)seg * tdc::SEG_WORDS;
  const uint32_t pair[2] = {src[2 * t], src[2 * t + 1]};
  auto symbol = [&](int j) -> int {
    const int sh = BYTES ? 8 * (j & 3) : 24 - 8 * (j & 3);
    return (pair[j >> 2] >> sh) & 0xFF;
  };

  if constexpr (STAGE == LOAD) {
    uint32_t s = 0;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      if (t * PER + j < count) s += symbol(j);
    }
    block_checksum(s, &bits_out[seg]);
    return;
  }
  __syncthreads();

  int len[PER];
  uint32_t code[PER];
  int sum = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int sym = symbol(j);
    const bool live = t * PER + j < count;
    len[j] = live ? len_of[sym] : 0;
    code[j] = live ? code_of[sym] : 0u;
    sum += len[j];
  }
  if constexpr (STAGE == LOOKUP) {
    uint32_t s = 0;
#pragma unroll
    for (int j = 0; j < PER; ++j) s += code[j] + (uint32_t)len[j];
    block_checksum(s, &bits_out[seg]);
    return;
  }
  int total;
  int off = tdc::block_exclusive_scan(sum, 0, tdc::Sum(), &total);
  if constexpr (STAGE == SCAN) {
    uint32_t s = 0;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      if (t * PER + j < count) s += (uint32_t)off;
      off += len[j];
    }
    block_checksum(s, &bits_out[seg]);
  } else {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      if (len[j]) put(acc, off, code[j], len[j]);
      off += len[j];
    }
    __syncthreads();
    if constexpr (STAGE == PLACE) {
      uint32_t s = 0;
      for (int w = t; w < tdc::SEG_WORDS; w += THREADS) s += acc[w];
      block_checksum(s, &bits_out[seg]);
    } else {
      uint32_t* dst = words_out + (size_t)seg * tdc::SEG_WORDS;
      for (int w = t; w < tdc::SEG_WORDS; w += THREADS) dst[w] = acc[w];
      if (t == 0) bits_out[seg] = total;
    }
  }
}

template <int STAGE, bool BYTES>
void launch(const void* words_in, const void* counts, const void* sym_code,
            const void* sym_len, void* words_out, void* bits_out, int nc,
            cudaStream_t stream) {
  huff_pack_kernel<STAGE, BYTES><<<nc, THREADS, 0, stream>>>(
      (const uint32_t*)words_in, (const int32_t*)counts,
      (const int32_t*)sym_code, (const int32_t*)sym_len,
      (uint32_t*)words_out, (int32_t*)bits_out);
}

template <bool BYTES>
int launch_stage(int stage, const void* words_in, const void* counts,
                 const void* sym_code, const void* sym_len, void* words_out,
                 void* bits_out, int nc, cudaStream_t stream) {
  switch (stage) {
    case LOAD:
      launch<LOAD, BYTES>(words_in, counts, sym_code, sym_len, words_out,
                          bits_out, nc, stream);
      break;
    case LOOKUP:
      launch<LOOKUP, BYTES>(words_in, counts, sym_code, sym_len, words_out,
                            bits_out, nc, stream);
      break;
    case SCAN:
      launch<SCAN, BYTES>(words_in, counts, sym_code, sym_len, words_out,
                          bits_out, nc, stream);
      break;
    case PLACE:
      launch<PLACE, BYTES>(words_in, counts, sym_code, sym_len, words_out,
                           bits_out, nc, stream);
      break;
    case FULL:
      launch<FULL, BYTES>(words_in, counts, sym_code, sym_len, words_out,
                          bits_out, nc, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tdc_huff_pack(const void* words_in, const void* counts,
                             const void* sym_code, const void* sym_len,
                             void* words_out, void* bits_out, int nc,
                             void* stream) {
  launch<FULL, false>(words_in, counts, sym_code, sym_len, words_out,
                      bits_out, nc, (cudaStream_t)stream);
  return (int)cudaGetLastError();
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
