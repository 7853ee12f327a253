// Shared helpers of the port's kernels: the segment geometry, a
// block-wide exclusive scan built from warp shuffles, and the per-chunk
// scan of tile values that the chunked packers run between passes.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tdc {

constexpr int SEG = 2048;          // bytes per segment
constexpr int SEG_WORDS = SEG / 4; // big-endian u32 stream words per segment

struct Sum {
  __device__ int operator()(int a, int b) const { return a + b; }
};
struct Max {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};

// Exclusive scan of one int per thread over the whole block (blockDim.x
// a multiple of 32, at most 1024). Every thread of the block must call
// it. Writes the block total to *total when total is not null.
template <typename Op>
__device__ int block_exclusive_scan(int v, int identity, Op op, int* total) {
  __shared__ int warp_incl[32];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_up_sync(full, incl, d);
    if (lane >= d) incl = op(incl, y);
  }
  if (lane == 31) warp_incl[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? warp_incl[lane] : identity;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int y = __shfl_up_sync(full, w, d);
      if (lane >= d) w = op(w, y);
    }
    warp_incl[lane] = w;  // inclusive scan of the warp totals
  }
  __syncthreads();
  int excl = __shfl_up_sync(full, incl, 1);
  if (lane == 0) excl = identity;
  if (warp > 0) excl = op(warp_incl[warp - 1], excl);
  if (total) *total = warp_incl[nwarps - 1];
  __syncthreads();  // warp_incl is reused by the next call
  return excl;
}

namespace {

// The chunked kernels' middle pass: one block per chunk replaces that
// chunk's T per-tile values (vals[c * T .. c * T + T)) by their
// exclusive scan under op, and writes the chunk's total to totals[c]
// when totals is not null. Launch with 1024 threads.
template <typename Op>
__global__ void __launch_bounds__(1024)
scan_tiles_kernel(int32_t* vals, int32_t* totals, int T, int identity,
                  Op op) {
  int32_t* v = vals + (size_t)blockIdx.x * T;
  int carry = identity;
  for (int base = 0; base < T; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int x = i < T ? v[i] : identity;
    int round_total;
    const int excl = block_exclusive_scan(x, identity, op, &round_total);
    if (i < T) v[i] = op(carry, excl);
    carry = op(carry, round_total);
  }
  if (totals && threadIdx.x == 0) totals[blockIdx.x] = carry;
}

}  // namespace

}  // namespace tdc
