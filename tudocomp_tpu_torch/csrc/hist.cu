// K3: masked 256-bin histogram of stream bytes.
//
// Replaces tudocomp_tpu/ops/hist_pallas.py:_hist_kernel (entry
// histogram_chunks): the sum over rows of bincount(row[:lengths[c]]).
// The TPU version sums one-hot matmuls in f32 accumulators. Here each
// warp counts whole rows (2 KiB of big-endian stream words, read with
// 16-byte loads) into its own 256-bin histogram in shared memory with
// integer atomicAdd, eight warps a block; then the block adds its
// non-zero bins to the global histogram, one global atomic each. Integer
// atomics make the result exact and independent of order. The rows are
// read where they lie: row i is row i * stride of the batch, so the
// codec's 1-in-8 sample needs no gathered copy, and the rows entry adds
// into the caller's int64 histogram, which sums every batch. At the
// codec's 1024 sampled rows (2 MiB) the launch and the shared atomics
// (one per byte; repeated bytes contend on a bin), not the bytes, bound
// it.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int SLICES = 4;  // a lane's 16 bytes of each 512-byte slice

__device__ __forceinline__ void add(unsigned int* p, unsigned int v) {
  atomicAdd(p, v);
}
__device__ __forceinline__ void add(unsigned long long* p, unsigned int v) {
  atomicAdd(p, (unsigned long long)v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
hist_kernel(const uint32_t* __restrict__ words,
            const int32_t* __restrict__ lengths, T* __restrict__ hist,
            int rows, int stride) {
  __shared__ uint32_t h[WARPS][256];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) h[i][t] = 0u;
  __syncthreads();
  const bool vec = (reinterpret_cast<uintptr_t>(words) & 15) == 0;
  for (int row = blockIdx.x * WARPS + warp; row < rows;
       row += gridDim.x * WARPS) {
    const size_t r = (size_t)row * stride;
    const int len = min(max(lengths[r], 0), tdc::SEG);
    const uint32_t* src = words + r * tdc::SEG_WORDS;
    // all loads first, then the atomics
    uint32_t w[SLICES][4];
#pragma unroll
    for (int s = 0; s < SLICES; ++s) {
      w[s][0] = w[s][1] = w[s][2] = w[s][3] = 0u;
      if ((tdc::SEG / SLICES) * s + 16 * lane >= len) continue;
      if (vec) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(src) + lane +
                              32 * s);
        w[s][0] = v.x, w[s][1] = v.y, w[s][2] = v.z, w[s][3] = v.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          w[s][q] =
              __ldg(src + (tdc::SEG_WORDS / SLICES) * s + 4 * lane + q);
      }
    }
#pragma unroll
    for (int s = 0; s < SLICES; ++s) {
      const int base = (tdc::SEG / SLICES) * s + 16 * lane;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (base + j < len)
          atomicAdd(&h[warp][(w[s][j >> 2] >> (24 - 8 * (j & 3))) & 0xFF],
                    1u);
    }
  }
  __syncthreads();
  uint32_t sum = 0;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) sum += h[i][t];
  if (sum) add(hist + t, sum);
}

template <typename T>
int launch(const void* words, const void* lengths, void* hist, int rows,
           int stride, void* stream) {
  const int blocks = (rows + WARPS - 1) / WARPS;  // one row a warp
  hist_kernel<T><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int32_t*)lengths, (T*)hist, rows,
      stride);
  return (int)cudaGetLastError();
}

}  // namespace

// every row of words[rows, 512], added into the u32 hist[256]
extern "C" int tdc_hist(const void* words, const void* lengths, void* hist,
                        int rows, void* stream) {
  return launch<unsigned int>(words, lengths, hist, rows, 1, stream);
}

// rows 0, stride, 2 * stride, ... (rows of them) of words[.., 512] and
// lengths[..], added into the u64 hist[256]
extern "C" int tdc_hist_rows(const void* words, const void* lengths,
                             void* hist, int rows, int stride,
                             void* stream) {
  return launch<unsigned long long>(words, lengths, hist, rows, stride,
                                    stream);
}
