// K6: chunked canonical-Huffman lookup + pack.
//
// Replaces tudocomp_tpu/ops/bitpack_pallas.py:_pack_huffman_kernel
// (entry pack_bytes_huffman_chunks). Per chunk c, the codes (<= 16 bits,
// from a 256-entry table) of data[c, :lengths[c]] packed MSB-first into
// big-endian u32 words, zero past the stream up to the row's cap, and
// bits[c], their total.
//
// On the TPU the grid walks a chunk's tiles in order, carrying the bit
// offset from tile to tile, and places codes with one-hot matmuls. A
// first Hopper port shared K5's body: it zeroed a stage in every block,
// OR-ed each code into it with a shared atomicOr (the placement that
// took 57% of K2's time before K2 dropped it), put the tile's edge words
// out with global atomics, and needed the whole [C, cap] output zeroed
// first, which was most of its bound (NVIDIA H100 80GB HBM3, 700 W: 1.01
// ms at 64 x 4 MiB against a 0.24 ms bound; PERF.md). Here a warp owns a
// tile of 2048 positions, as K2's warp owns a segment, and no block
// barrier follows the table fill:
//
// (1) count_kernel: each warp writes its tile's bits and last <= 31 bits
//     (a Tail), slice by slice through a warp scan;
// (2) scan_kernel: one block per chunk scans the tiles' Tails in order
//     (tdc::Append, associative): each tile gets its start bit and the
//     last <= 31 stream bits before it; the chunk's total is bits[c];
// (3) place_kernel: each warp places its codes as K2 does (16-byte
//     loads, a warp scan of the lengths, two codes an append into a
//     64-bit register, completed words staged by plain stores, a
//     segmented OR-scan for the words lanes share), from its start bit,
//     with the carried bits standing in for a slice before it. A word
//     belongs to the tile that holds its last bit (the chunk's last word
//     to the tile that holds the stream's last bit), which stores it
//     whole: one writer per word, no atomics, nothing zeroed first. The
//     tiles of a chunk also store the zero words past its stream, with
//     16-byte stores.
//
// It reads the input twice and writes the row once: its bound on the
// H100 is those bytes, most of them the zero tail (cap is about N/2
// words, the stream often less); what holds it back is the
// instructions a warp spends per code, as in K2 (PERF.md).
#include "common.cuh"

namespace {

constexpr int WARPS = 8;                  // tiles a block
constexpr int THREADS = 32 * WARPS;
constexpr int PER = 16;                   // positions a lane, per slice
constexpr int SLICE = 32 * PER;           // positions a warp, per slice
constexpr int SLICES = 4;
constexpr int TILE = SLICES * SLICE;      // positions a warp (a tile)
constexpr int MAX_LEN = 16;               // the wrapper's code-length cap
// a tile's words, from the 16-byte group its first bit lies in: up to
// 127 bits before it, then at most 16 bits a position
constexpr int STAGE_WORDS = ((127 + MAX_LEN * TILE) / 32 + 4) & ~3;
constexpr unsigned FULL_MASK = 0xffffffffu;
using Bits = tdc::Append<1, 31>;
static_assert(THREADS == 256, "one table entry per thread");

struct Args {
  const uint8_t* data;      // u8[C, n]
  const int32_t* lengths;   // i32[C]
  const int32_t* sym_code;  // i32[256]
  const int32_t* sym_len;   // i32[256]
  uint32_t* words;          // u32[C, cap]
  int32_t* bits;            // i32[C]
  int32_t* start;           // i32[C, T]: tile bits -> tile start bit
  uint32_t* tail;           // u32[C, T]: tile tail -> bits before it
  int n, cap, T;
  bool vec;                 // data 16-byte aligned
};

// code << 8 | length of each byte value; lengths clamped to 0..16 (the
// wrapper rejects others), codes masked to their length
__device__ __forceinline__ void fill_table(const Args& a, uint32_t* table) {
  const int t = threadIdx.x;
  const int l = min(max(a.sym_len[t], 0), MAX_LEN);
  table[t] = (((uint32_t)a.sym_code[t] & ((1u << l) - 1u)) << 8) | l;
}

struct Lane {
  int c, x, length;  // chunk, tile (-1: past the chunk's tiles)
  size_t row;        // offset of the chunk's row in data
  int p0;            // the lane's first position in slice 0
};

__device__ __forceinline__ Lane lane_of(const Args& a) {
  Lane l;
  l.c = blockIdx.y;
  l.x = blockIdx.x * WARPS + (threadIdx.x >> 5);
  l.length = min(max(a.lengths[l.c], 0), a.n);
  l.row = (size_t)l.c * a.n;
  l.p0 = l.x * TILE + (threadIdx.x & 31) * PER;
  if (l.x >= a.T) l.x = -1;
  return l;
}

// live positions of the lane's 16 in slice r (n % 16 == 0, so they lie
// all inside or all past the row)
__device__ __forceinline__ int live_in(const Lane& l, int r) {
  return min(max(l.length - (l.p0 + SLICE * r), 0), PER);
}

__device__ __forceinline__ void load(const Args& a, const Lane& l, int r,
                                     uint32_t (&v)[4]) {
  const uint8_t* src = a.data + l.row + l.p0 + SLICE * r;
  if (a.vec) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(src));
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {  // 8-byte aligned
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(src));
    const uint2 y = __ldg(reinterpret_cast<const uint2*>(src) + 1);
    v[0] = x.x, v[1] = x.y, v[2] = y.x, v[3] = y.y;
  }
}

__device__ __forceinline__ uint32_t byte_of(const uint32_t (&v)[4], int j) {
  return (v[j >> 2] >> (8 * (j & 3))) & 0xFFu;
}

__device__ __forceinline__ uint32_t entry(const uint32_t* table,
                                          const uint32_t (&v)[4], int j) {
  return table[byte_of(v, j)];
}

// The last <= 31 bits of the codes of a lane's live positions in one
// slice (the first `live` of its 16), in the low bits.
__device__ __forceinline__ uint32_t lane_tail(const uint32_t* table,
                                              const uint32_t (&v)[4],
                                              int live) {
  uint32_t t = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const uint32_t e = j < live ? entry(table, v, j) : 0u;
    t = ((t << (e & 0xFF)) | (e >> 8)) & 0x7FFFFFFFu;
  }
  return t;
}

// Pass 1: each tile's bits and last <= 31 bits.
__global__ void __launch_bounds__(THREADS) count_kernel(Args a) {
  __shared__ uint32_t table[256];
  __shared__ uint8_t lens[256];  // the lengths alone: one load, no mask
  fill_table(a, table);
  lens[threadIdx.x] = table[threadIdx.x] & 0xFF;
  __syncthreads();
  const Lane l = lane_of(a);
  if (l.x < 0) return;  // whole warps; nothing below syncs the block
  const int lane = threadIdx.x & 31;
  // the lane's 16 bytes of each slice that holds live positions, all
  // loads in flight before the first lookup
  uint32_t w[SLICES][4];
  int live[SLICES];
#pragma unroll
  for (int r = 0; r < SLICES; ++r) {
    live[r] = live_in(l, r);
    w[r][0] = w[r][1] = w[r][2] = w[r][3] = 0u;
    if (live[r]) load(a, l, r, w[r]);
  }
  // the bits: a sum of the code lengths (the lane's, summed over the
  // warp at the end)
  int nbits[SLICES], bits = 0;
#pragma unroll
  for (int r = 0; r < SLICES; ++r) {
    nbits[r] = 0;
    if (live[r] == PER) {  // all but the lane the stream ends in
#pragma unroll
      for (int j = 0; j < PER; ++j) nbits[r] += lens[byte_of(w[r], j)];
    } else {
#pragma unroll
      for (int j = 0; j < PER; ++j)
        nbits[r] += j < live[r] ? lens[byte_of(w[r], j)] : 0;
    }
    bits += nbits[r];
  }
  // the last <= 31 bits: from the last lanes that have any, latest first
  // (usually the last lane alone)
  tdc::Tail acc{0, 0u};
#pragma unroll
  for (int r = SLICES - 1; r >= 0; --r) {
    for (uint32_t m = __ballot_sync(FULL_MASK, nbits[r] > 0);
         m && acc.n < 31;) {
      const int src = 31 - __clz(m);
      m ^= 1u << src;
      const uint32_t t = lane == src ? lane_tail(table, w[r], live[r]) : 0u;
      acc = Bits()({__shfl_sync(FULL_MASK, nbits[r], src),
                    __shfl_sync(FULL_MASK, t, src)},
                   acc);
    }
  }
  acc.n = __reduce_add_sync(FULL_MASK, bits);
  if (lane == 0) {
    const size_t id = (size_t)l.c * a.T + l.x;
    a.start[id] = acc.n;
    a.tail[id] = acc.t;
  }
}

// Pass 2: one block per chunk; each tile's Tail -> the stream before it.
__global__ void __launch_bounds__(1024) scan_kernel(Args a) {
  const size_t row = (size_t)blockIdx.x * a.T;
  tdc::Tail carry{0, 0u};
  for (int base = 0; base < a.T; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const tdc::Tail x = i < a.T ? tdc::Tail{a.start[row + i], a.tail[row + i]}
                                : tdc::Tail{0, 0u};
    tdc::Tail round;
    const tdc::Tail before =
        Bits()(carry, tdc::block_exclusive_scan_tail(x, Bits(), &round));
    if (i < a.T) {
      a.start[row + i] = before.n;
      a.tail[row + i] = before.t;
    }
    carry = Bits()(carry, round);
  }
  if (threadIdx.x == 0) a.bits[blockIdx.x] = carry.n;
}

// Pass 3: place each tile's codes from its start bit and store the words
// it owns; then its share of the chunk's zero tail. Four blocks an SM.
__global__ void __launch_bounds__(THREADS, 4) place_kernel(Args a) {
  __shared__ uint32_t table[256];
  __shared__ __align__(16) uint32_t staged[WARPS][STAGE_WORDS];
  fill_table(a, table);
  __syncthreads();
  const Lane l = lane_of(a);
  if (l.x < 0) return;  // whole warps; nothing below syncs the block
  const int lane = threadIdx.x & 31;
  const size_t id = (size_t)l.c * a.T + l.x;
  const int s = a.start[id];
  const int total = a.bits[l.c];
  // staged word 0 is stream word sbase (16-byte aligned), so the tile's
  // first bit is bit rel0 of the staged words
  const int sbase = (s >> 5) & ~3;
  const int rel0 = s - 32 * sbase;
  const int k0 = s & 31;  // bits of the tile's first word before it

  // placement, slice by slice, as in K2 (csrc/huff_pack.cu); the bits
  // carried from the tiles before stand in for a slice before this one
  uint32_t* buf = staged[threadIdx.x >> 5];
  const uint32_t buf_s =
      tdc::pinned((uint32_t)__cvta_generic_to_shared(buf));
  uint32_t w[SLICES][4];
  int live[SLICES];
#pragma unroll
  for (int r = 0; r < SLICES; ++r) {
    live[r] = live_in(l, r);
    w[r][0] = w[r][1] = w[r][2] = w[r][3] = 0u;
    if (live[r]) load(a, l, r, w[r]);
  }
  int base = rel0;
  uint32_t carry = k0 ? a.tail[id] << (32 - k0) : 0u;
  int carry_at = rel0 >> 5;
#pragma unroll
  for (int r = 0; r < SLICES; ++r) {
    if (l.p0 - lane * PER + SLICE * r >= l.length) break;
    uint32_t e[PER];
    if (live[r] == PER) {  // all but the lane the stream ends in
#pragma unroll
      for (int j = 0; j < PER; ++j) e[j] = entry(table, w[r], j);
    } else {
#pragma unroll
      for (int j = 0; j < PER; ++j)
        e[j] = j < live[r] ? entry(table, w[r], j) : 0u;
    }
    int n = 0;
#pragma unroll
    for (int j = 0; j < PER; ++j) n += e[j] & 0xFF;
    int incl = n;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, incl, d);
      if (lane >= d) incl += y;
    }
    const int off = base + incl - n;
    base += __shfl_sync(FULL_MASK, incl, 31);
    const int first = off >> 5;
    int at = first, nb = off & 31;
    uint64_t acc = 0;
#pragma unroll
    for (int j = 0; j < PER; j += 2) {
      const int l1 = e[j + 1] & 0xFF;
      const int len = (e[j] & 0xFF) + l1;
      acc = (acc << len) | (((e[j] >> 8) << l1) | (e[j + 1] >> 8));
      nb += len;
      const bool full = nb >= 32;
      nb -= full ? 32 : 0;
      tdc::stage(buf_s, buf, at, (uint32_t)(acc >> nb), full);
      at += full;
    }
    uint32_t left = nb ? (uint32_t)(acc << (32 - nb)) : 0u;
    if (!__all_sync(FULL_MASK, n >= 32)) {
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t y = __shfl_up_sync(FULL_MASK, left, d);
        const int ya = __shfl_up_sync(FULL_MASK, at, d);
        if (lane >= d && ya == at) left |= y;
      }
    }
    if (at == carry_at) left |= carry;
    uint32_t before = __shfl_up_sync(FULL_MASK, left, 1);
    if (lane == 0) before = carry;
    if (at > first) buf[first] |= before;
    carry = __shfl_sync(FULL_MASK, left, 31);
    carry_at = __shfl_sync(FULL_MASK, at, 31);
  }
  const int e = base;  // the tile's end in the staged words
  const bool last_tile = e > rel0 && s + (e - rel0) == total;
  if (lane == 0 && last_tile && (e & 31))
    buf[e >> 5] = carry;  // the stream's last, partial word
  __syncwarp();

  // store the words the tile owns, [fw, lw] of the staged words, whole
  // 16-byte groups with one store
  uint32_t* out = a.words + (size_t)l.c * a.cap;
  if (e > rel0) {
    const int fw = rel0 >> 5;
    const int lw = (e & 31) == 0 || last_tile ? (e - 1) >> 5 : (e >> 5) - 1;
    uint32_t* dst = out + sbase;
    for (int g = (fw >> 2) + lane; g <= lw >> 2; g += 32) {
      const int w0 = 4 * g;
      if (w0 >= fw && w0 + 3 <= lw) {
        reinterpret_cast<uint4*>(dst)[g] =
            reinterpret_cast<const uint4*>(buf)[g];
      } else {
        for (int k = 0; k < 4; ++k)
          if (w0 + k >= fw && w0 + k <= lw) dst[w0 + k] = buf[w0 + k];
      }
    }
  }
  tdc::zero_tail(out, (total + 31) >> 5, a.cap, l.x, a.T);
}

}  // namespace

extern "C" int tdc_pack_huffman_chunks(const void* data, const void* lengths,
                                       const void* sym_code,
                                       const void* sym_len, void* words,
                                       void* bits, void* scratch, int chunks,
                                       int n, int cap, void* stream) {
  Args a{};
  a.data = (const uint8_t*)data;
  a.lengths = (const int32_t*)lengths;
  a.sym_code = (const int32_t*)sym_code;
  a.sym_len = (const int32_t*)sym_len;
  a.words = (uint32_t*)words;
  a.bits = (int32_t*)bits;
  a.n = n;
  a.cap = cap;
  a.T = (n + TILE - 1) / TILE;
  a.start = (int32_t*)scratch;
  a.tail = (uint32_t*)(a.start + (size_t)chunks * a.T);
  a.vec = ((uintptr_t)data & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((a.T + WARPS - 1) / WARPS, chunks);
  count_kernel<<<grid, THREADS, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_kernel<<<chunks, 1024, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  place_kernel<<<grid, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}
