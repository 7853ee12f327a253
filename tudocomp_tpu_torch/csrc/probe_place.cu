// P4: K2's placement step alone, under three strategies.
//
// Counterpart of etc/probe_int8.py, which timed the TPU's placement loop
// (one-hot dots into a VMEM accumulator) in three MXU dtypes. Hopper
// places a token by OR-ing it into at most two words, so what there is
// to choose is where the OR happens:
//   SMEM_ATOMIC    atomicOr into a shared-memory row, then one store (K2);
//   GLOBAL_ATOMIC  atomicOr straight into the output row, which the
//                  block zeroes first;
//   WARP_COMBINE   the tokens of a warp that hit one word are OR-ed in
//                  registers (a segmented OR-scan over the lanes, by
//                  shuffles) and the word is stored once; only the words
//                  two warps share (each warp's first and last) go
//                  through shared atomics.
// Every strategy shares the token layout, the loads and the scan, so the
// differences between them are placement alone.
//
// Tokens (P4's): from byte b at position p, value (b << 8) | b masked to
// len = 8 + (b & 7) bits; at STRIDE 2 odd positions get len 0. Offsets
// are the per-segment exclusive scan of len, so the output is a real
// MSB-first stream: 960 words (2048 tokens x 15 bits) and the bit count.
// Layout: one block of 256 threads per segment; warp w owns positions
// [256w, 256w + 256), and in round r its lane l holds position
// 256w + 32r + l, so each round of a warp is 32 consecutive tokens.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROUNDS = tdc::SEG / THREADS;  // tokens per lane
constexpr int OUT_WORDS = tdc::SEG * 15 / 32;
constexpr unsigned FULL_MASK = 0xffffffffu;

enum Strategy { SMEM_ATOMIC = 0, GLOBAL_ATOMIC = 1, WARP_COMBINE = 2 };

// The (at most two) word parts of a token of len > 0 at bit off.
struct Parts {
  int w0;
  uint32_t first, spill;
};

__device__ __forceinline__ Parts parts(int off, uint32_t val, int len) {
  const int sh = 32 - (off & 31) - len;
  if (len == 0) return {off >> 5, 0u, 0u};
  if (sh >= 0) return {off >> 5, val << sh, 0u};
  return {off >> 5, val >> -sh, val << (32 + sh)};
}

template <int STRATEGY, int STRIDE>
__global__ void __launch_bounds__(THREADS)
place_kernel(const uint8_t* __restrict__ rows, uint32_t* __restrict__ words,
             int32_t* __restrict__ bits) {
  __shared__ uint32_t acc[STRATEGY == SMEM_ATOMIC ? OUT_WORDS : 1];
  __shared__ uint32_t edge[WARPS + 1];  // WARP_COMBINE: shared words
  __shared__ int warp_bits[WARPS];
  const int seg = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  uint32_t* dst = words + (size_t)seg * OUT_WORDS;

  const uint8_t* src = rows + (size_t)seg * tdc::SEG + warp * 256 + lane;
  int len[ROUNDS], off[ROUNDS];
  uint32_t val[ROUNDS];
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const uint32_t b = src[32 * r];
    len[r] = (STRIDE == 2 && (lane & 1)) ? 0 : 8 + (int)(b & 7);
    val[r] = (b << 8 | b) & ((1u << len[r]) - 1u);
  }
  // exclusive scan: per round across the warp, rounds in order
  int carry = 0;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    int x = len[r];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, x, d);
      if (lane >= d) x += y;
    }
    off[r] = carry + x - len[r];
    carry += __shfl_sync(FULL_MASK, x, 31);
  }
  if (lane == 0) warp_bits[warp] = carry;
  if constexpr (STRATEGY == SMEM_ATOMIC) {
    for (int w = t; w < OUT_WORDS; w += THREADS) acc[w] = 0u;
  } else if constexpr (STRATEGY == GLOBAL_ATOMIC) {
    for (int w = t; w < OUT_WORDS; w += THREADS) dst[w] = 0u;
  } else {
    if (t <= WARPS) edge[t] = 0u;
  }
  __syncthreads();
  int base = 0, total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    base += w < warp ? warp_bits[w] : 0;
    total += warp_bits[w];
  }
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) off[r] += base;

  if constexpr (STRATEGY == SMEM_ATOMIC || STRATEGY == GLOBAL_ATOMIC) {
    uint32_t* row = STRATEGY == SMEM_ATOMIC ? acc : dst;
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const Parts p = parts(off[r], val[r], len[r]);
      if (len[r]) atomicOr(&row[p.w0], p.first);
      if (p.spill) atomicOr(&row[p.w0 + 1], p.spill);
    }
    if constexpr (STRATEGY == SMEM_ATOMIC) {
      __syncthreads();
      for (int w = t; w < OUT_WORDS; w += THREADS) dst[w] = acc[w];
    }
  } else {
    // Each warp's words lie in [lo, hi]; lo and hi may be shared with
    // the neighbouring warps and collect in edge[warp], edge[warp + 1].
    const int lo = base >> 5;
    const int hi = (base + carry) >> 5;
    auto emit = [&](int w, uint32_t v) {
      if (w == lo) {
        atomicOr(&edge[warp], v);
      } else if (w == hi) {
        atomicOr(&edge[warp + 1], v);
      } else {
        dst[w] = v;
      }
    };
    // The round's last word may continue into the next round: it is
    // carried (open_w, open_v), as is lane 31's spill, which lands in
    // the word where the next round's first token starts.
    int open_w = -1;
    uint32_t open_v = 0u, spill_in = 0u;
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      Parts p = parts(off[r], val[r], len[r]);
      // a token's spill lands in the next token's first word
      uint32_t from_prev = __shfl_up_sync(FULL_MASK, p.spill, 1);
      if (lane == 0) from_prev = spill_in;
      p.first |= from_prev;
      spill_in = __shfl_sync(FULL_MASK, p.spill, 31);
      const int first_w = __shfl_sync(FULL_MASK, p.w0, 0);
      if (open_w >= 0 && open_w != first_w) {
        if (lane == 0) emit(open_w, open_v);  // complete: nothing follows
      } else if (open_w >= 0 && lane == 0) {
        p.first |= open_v;
      }
      // words rise with the lane: OR-scan each run of equal words, and
      // the run's last lane holds the word
      const int prev_w = __shfl_up_sync(FULL_MASK, p.w0, 1);
      const unsigned heads =
          __ballot_sync(FULL_MASK, lane == 0 || p.w0 != prev_w);
      const int start = 31 - __clz(heads & (FULL_MASK >> (31 - lane)));
      uint32_t v = p.first;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t y = __shfl_up_sync(FULL_MASK, v, d);
        if (lane - d >= start) v |= y;
      }
      const bool last = lane == 31 || (heads >> (lane + 1) & 1u);
      const int last_w = __shfl_sync(FULL_MASK, p.w0, 31);
      if (last && p.w0 != last_w) emit(p.w0, v);
      open_w = last_w;
      open_v = __shfl_sync(FULL_MASK, v, 31);
    }
    if (lane == 0) {
      emit(open_w, open_v);
      if (spill_in) emit(open_w + 1, spill_in);
    }
    // the words past the stream; word total >> 5 is the last edge
    for (int w = (total >> 5) + 1 + t; w < OUT_WORDS; w += THREADS)
      dst[w] = 0u;
    __syncthreads();
    if (t == 0) {
      // edges in order; an empty warp makes two edges one word
      int w_prev = -1;
      uint32_t v_prev = 0u;
      int b = 0;
      for (int k = 0; k <= WARPS; ++k) {
        const int w = b >> 5;
        if (w != w_prev) {
          if (w_prev >= 0 && w_prev < OUT_WORDS) dst[w_prev] = v_prev;
          w_prev = w;
          v_prev = 0u;
        }
        v_prev |= edge[k];
        if (k < WARPS) b += warp_bits[k];
      }
      if (w_prev < OUT_WORDS) dst[w_prev] = v_prev;
    }
  }
  if (t == 0) bits[seg] = total;
}

template <int STRATEGY, int STRIDE>
void launch(const void* rows, void* words, void* bits, int nc,
            cudaStream_t stream) {
  place_kernel<STRATEGY, STRIDE><<<nc, THREADS, 0, stream>>>(
      (const uint8_t*)rows, (uint32_t*)words, (int32_t*)bits);
}

template <int STRATEGY>
int launch_stride(int stride, const void* rows, void* words, void* bits,
                  int nc, cudaStream_t stream) {
  if (stride == 1) {
    launch<STRATEGY, 1>(rows, words, bits, nc, stream);
  } else if (stride == 2) {
    launch<STRATEGY, 2>(rows, words, bits, nc, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// rows u8[nc, 2048]; words i32[nc, 960]; bits i32[nc]. strategy: 0
// smem_atomic, 1 global_atomic, 2 warp_combine; stride 1 or 2.
extern "C" int tdc_probe_place(const void* rows, void* words, void* bits,
                               int nc, int strategy, int stride,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (strategy) {
    case SMEM_ATOMIC:
      return launch_stride<SMEM_ATOMIC>(stride, rows, words, bits, nc, s);
    case GLOBAL_ATOMIC:
      return launch_stride<GLOBAL_ATOMIC>(stride, rows, words, bits, nc, s);
    case WARP_COMBINE:
      return launch_stride<WARP_COMBINE>(stride, rows, words, bits, nc, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
