// Shared helpers of the port's kernels: the segment geometry, block-wide
// exclusive scans built from warp shuffles (of ints, and of the Tails
// that the chunked packers carry from tile to tile), the per-chunk scan
// of tile values that K5 runs between its passes, the zero tail of
// a chunked packer's output row, and K2's word-staging helpers.
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

// A piece of a stream as the chunked packers carry it from tile to
// tile: its length n in units (bits or bytes) and its last min(n, KEEP)
// units in the low bits of t, the rest of t zero.
struct Tail {
  int n;
  uint32_t t;
};

// Stream a followed by stream b, on Tails of UNIT-bit units: associative,
// with identity {0, 0}, but not commutative (a comes first).
template <int UNIT, int KEEP>
struct Append {
  static constexpr uint32_t MASK = (uint32_t)((1ull << (UNIT * KEEP)) - 1);
  __device__ Tail operator()(Tail a, Tail b) const {
    const uint32_t t =
        b.n >= KEEP ? b.t : ((a.t << (UNIT * b.n)) | b.t) & MASK;
    return {a.n + b.n, t};
  }
};

__device__ __forceinline__ Tail shfl_up(Tail v, int d) {
  return {__shfl_up_sync(0xffffffffu, v.n, d),
          __shfl_up_sync(0xffffffffu, v.t, d)};
}

// Inclusive scan of one Tail per lane, lanes in order; every lane of the
// warp must call it.
template <typename Op>
__device__ Tail warp_inclusive_scan(Tail v, Op op) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Tail y = shfl_up(v, d);
    if (lane >= d) v = op(y, v);
  }
  return v;
}

// Exclusive scan of one Tail per thread over the whole block, threads in
// order (the same contract as block_exclusive_scan below).
template <typename Op>
__device__ Tail block_exclusive_scan_tail(Tail v, Op op, Tail* total) {
  __shared__ Tail warp_incl[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const Tail incl = warp_inclusive_scan(v, op);
  if (lane == 31) warp_incl[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const Tail w = lane < nwarps ? warp_incl[lane] : Tail{0, 0u};
    warp_incl[lane] = warp_inclusive_scan(w, op);
  }
  __syncthreads();
  Tail excl = shfl_up(incl, 1);
  if (lane == 0) excl = Tail{0, 0u};
  if (warp > 0) excl = op(warp_incl[warp - 1], excl);
  if (total) *total = warp_incl[nwarps - 1];
  __syncthreads();  // warp_incl is reused by the next call
  return excl;
}

// Zeroes words [z0, cap) of one output row: the part `part` of `parts`
// that share it, written by the calling warp (whole 16-byte stores; the
// row is 16-byte aligned and cap % 4 == 0). Every lane calls it.
__device__ __forceinline__ void zero_tail(uint32_t* row, int z0, int cap,
                                          int part, int parts) {
  const int lane = threadIdx.x & 31;
  const int a4 = min((z0 + 3) & ~3, cap);
  if (part == 0)
    for (int w = z0 + lane; w < a4; w += 32) row[w] = 0u;
  const int groups = (cap - a4) >> 2;
  const int per = (groups + parts - 1) / parts;
  const int g1 = min(groups, (part + 1) * per);
  uint4* v = reinterpret_cast<uint4*>(row + a4);
  for (int g = part * per + lane; g < g1; g += 32)
    v[g] = make_uint4(0u, 0u, 0u, 0u);
}

// keeps v in a register: the compiler may not recompute it in the loop
__device__ __forceinline__ uint32_t pinned(uint32_t v) {
#ifdef __CUDA_ARCH__
  asm volatile("" : "+r"(v));
#endif
  return v;
}

// stages word `word` of the stream at word `at` of a staging buffer
// (shared address buf_s, generic pointer buf) where `full`: a predicated
// store, not a branch, which every lane of the warp would take in turn
// (padding the buffer against bank conflicts cost more than it saved)
__device__ __forceinline__ void stage(uint32_t buf_s, uint32_t* buf, int at,
                                      uint32_t word, bool full) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %2, 0;\n\t"
      "@p st.shared.u32 [%0], %1;\n\t}"
      :
      : "r"(buf_s + 4u * (uint32_t)at), "r"(word), "r"((int)full)
      : "memory");
#else
  if (full) buf[at] = word;
#endif
}

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
