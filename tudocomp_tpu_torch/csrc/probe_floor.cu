// P3: the data-movement floor of the segment packers.
//
// Counterpart of etc/probe_floor.py, whose trivial Pallas kernels read
// the segment rows and wrote K2-shaped outputs (zero words plus a
// per-row sum). Here two functions move a segment's 2 KiB and do
// nothing else: `read` writes the per-segment byte sum, `copy` also
// writes the segment as big-endian u32 words (K1's and K2's output
// layout and write volume). Each is bound by device memory traffic by
// construction; the variants show what the load form costs: one byte
// per thread (VEC16 false) or 16-byte vector loads (true), with G = 1
// or 4 segments per block (the TPU's 8 or 32 per grid step).
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int VEC = 16;                    // bytes per vector load
static_assert(tdc::SEG == THREADS * VEC, "one vector load per thread");
constexpr unsigned FULL_MASK = 0xffffffffu;

template <bool COPY, bool VEC16, int G>
__global__ void __launch_bounds__(THREADS)
floor_kernel(const uint8_t* __restrict__ rows, uint32_t* __restrict__ words,
             int32_t* __restrict__ sums, int nc) {
  __shared__ uint32_t part[G][THREADS / 32];
  const int t = threadIdx.x;
  const int seg0 = blockIdx.x * G;
  uint32_t sum[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    sum[g] = 0u;
    const int seg = seg0 + g;
    if (seg >= nc) continue;  // uniform over the block
    const uint8_t* src = rows + (size_t)seg * tdc::SEG;
    uint32_t* dst = words + (size_t)seg * tdc::SEG_WORDS;
    if constexpr (VEC16) {
      const uint4 v = reinterpret_cast<const uint4*>(src)[t];
      sum[g] = __dp4a(v.x, 0x01010101u,
                      __dp4a(v.y, 0x01010101u,
                             __dp4a(v.z, 0x01010101u,
                                    __dp4a(v.w, 0x01010101u, 0u))));
      if constexpr (COPY) {
        reinterpret_cast<uint4*>(dst)[t] = make_uint4(
            __byte_perm(v.x, 0, 0x0123), __byte_perm(v.y, 0, 0x0123),
            __byte_perm(v.z, 0, 0x0123), __byte_perm(v.w, 0, 0x0123));
      }
    } else {
#pragma unroll
      for (int k = 0; k < tdc::SEG / THREADS; ++k) {
        const int i = k * THREADS + t;
        const uint32_t b = src[i];
        sum[g] += b;
        if constexpr (COPY) {
          // lanes 4m..4m+3 hold the bytes of one word
          const uint32_t b1 = __shfl_down_sync(FULL_MASK, b, 1);
          const uint32_t b2 = __shfl_down_sync(FULL_MASK, b, 2);
          const uint32_t b3 = __shfl_down_sync(FULL_MASK, b, 3);
          if ((t & 3) == 0) dst[i >> 2] = b << 24 | b1 << 16 | b2 << 8 | b3;
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const uint32_t v = __reduce_add_sync(FULL_MASK, sum[g]);
    if ((t & 31) == 0) part[g][t >> 5] = v;
  }
  __syncthreads();
  if (t < G && seg0 + t < nc) {
    uint32_t s = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) s += part[t][w];
    sums[seg0 + t] = (int32_t)s;
  }
}

template <bool COPY, bool VEC16, int G>
void launch(const void* rows, void* words, void* sums, int nc,
            cudaStream_t stream) {
  floor_kernel<COPY, VEC16, G><<<(nc + G - 1) / G, THREADS, 0, stream>>>(
      (const uint8_t*)rows, (uint32_t*)words, (int32_t*)sums, nc);
}

template <bool COPY, bool VEC16>
int launch_group(int group, const void* rows, void* words, void* sums,
                 int nc, cudaStream_t stream) {
  if (group == 1) {
    launch<COPY, VEC16, 1>(rows, words, sums, nc, stream);
  } else if (group == 4) {
    launch<COPY, VEC16, 4>(rows, words, sums, nc, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// rows u8[nc, 2048] (16-byte aligned); words i32[nc, 512] (copy only,
// may be null for read); sums i32[nc]. group: segments per block, 1 or 4.
extern "C" int tdc_probe_floor(const void* rows, void* words, void* sums,
                               int nc, int copy, int vec16, int group,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (copy) {
    return vec16 ? launch_group<true, true>(group, rows, words, sums, nc, s)
                 : launch_group<true, false>(group, rows, words, sums, nc, s);
  }
  return vec16 ? launch_group<false, true>(group, rows, words, sums, nc, s)
               : launch_group<false, false>(group, rows, words, sums, nc, s);
}
