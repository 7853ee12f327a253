// K5: chunked token pack.
//
// Replaces tudocomp_tpu/ops/bitpack_pallas.py:_pack_kernel (entry
// pack_tokens_chunks). Per chunk c, the tokens (values, lens) of
// positions 0..n-1, lens <= 32, are packed MSB-first into big-endian u32
// words, and bits[c] is their total.
//
// On the TPU the grid walks a chunk's tiles in order and carries the bit
// offset from tile to tile; the in-tile offsets and the word placement
// are matmuls. Blocks on Hopper run in no order, so the carry becomes a
// scan over tiles, in three launches: (1) each block of 2048 positions
// sums its token lengths; (2) one block per chunk scans the tile sums
// into each tile's starting bit; (3) each block scans its lengths again,
// ORs its tokens (at most two words each) into shared memory with
// atomicOr, and writes its words out: plain stores for the words only it
// touches, atomicOr for its first and last word, which it may share with
// a neighbouring tile (bit ranges are disjoint, so OR is exact). The
// output must be zero on entry. K5 is bound by device memory: it reads
// its 8 bytes per token twice and writes the stream.
//
// The HUFF branches are K6's first body (a 256-entry shared table in
// front of the same placement). K6 now has its own kernels
// (csrc/huff_chunk_pack.cu) and nothing instantiates them; they stay so
// that K5, the control K6 and K7 are held against, keeps its code.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PER = 8;                   // positions per thread
constexpr int TILE = THREADS * PER;      // positions per block
constexpr int STAGE_WORDS = TILE + 2;    // 2048 tokens of <= 32 bits

struct Args {
  const uint32_t* values;   // K5: u32[C, n]
  const int32_t* lens;      // K5: i32[C, n]
  const uint8_t* data;      // K6: u8[C, n]
  const int32_t* lengths;   // K6: i32[C]
  const int32_t* sym_code;  // K6: i32[256]
  const int32_t* sym_len;   // K6: i32[256]
  uint32_t* words;          // u32[C, cap], zero on entry
  int32_t* scratch;         // i32[C, T]: tile bits -> tile start bit
  int n, cap, T;
};

struct Table {
  uint32_t code[256];
  int len[256];
};

__device__ __forceinline__ uint32_t mask_to(uint32_t v, int len) {
  return len >= 32 ? v : v & ((1u << len) - 1u);
}

// K6's table: codes are at most 16 bits (the value is the code's low 16
// bits, as on the TPU). The wrapper rejects lengths outside 0..16; the
// clamp keeps every row inside its cap = N/2 + wt + 128 words regardless.
__device__ void load_table(const Args& a, Table& t) {
  const int s = threadIdx.x;  // THREADS == 256
  t.len[s] = min((uint32_t)a.sym_len[s], 16u);
  t.code[s] = (uint32_t)a.sym_code[s] & 0xFFFFu;
}

// The thread's PER tokens at positions i0 .. i0 + PER - 1 of chunk c.
// n % PER == 0, so they lie all inside or all past the chunk.
template <bool HUFF>
__device__ void load_tokens(const Args& a, const Table& t, int c, int i0,
                            uint32_t* v, int* len) {
  if (i0 >= a.n) {
#pragma unroll
    for (int j = 0; j < PER; ++j) { v[j] = 0u; len[j] = 0; }
    return;
  }
  const size_t off = (size_t)c * a.n + i0;
  if (HUFF) {
    const int length = min(max(a.lengths[c], 0), a.n);
    const uint2 d = *reinterpret_cast<const uint2*>(a.data + off);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int sym = ((j < 4 ? d.x : d.y) >> (8 * (j & 3))) & 0xFF;
      const bool live = i0 + j < length;
      len[j] = live ? t.len[sym] : 0;
      v[j] = live ? t.code[sym] : 0u;
    }
  } else {
    const uint4* pv = reinterpret_cast<const uint4*>(a.values + off);
    const uint4* pl = reinterpret_cast<const uint4*>(a.lens + off);
    const uint4 v0 = pv[0], v1 = pv[1], l0 = pl[0], l1 = pl[1];
    const uint32_t vs[PER] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
    const uint32_t ls[PER] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      len[j] = (int)min(ls[j], 32u);
      v[j] = vs[j];
    }
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) v[j] = mask_to(v[j], len[j]);
}

// Pass 1: the bits of each tile.
template <bool HUFF>
__global__ void __launch_bounds__(THREADS) tile_bits_kernel(Args a) {
  __shared__ Table table;
  if (HUFF) load_table(a, table);
  __syncthreads();
  const int c = blockIdx.y;
  uint32_t v[PER];
  int len[PER];
  load_tokens<HUFF>(a, table, c, blockIdx.x * TILE + threadIdx.x * PER, v,
                    len);
  int sum = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) sum += len[j];
  int total;
  tdc::block_exclusive_scan(sum, 0, tdc::Sum(), &total);
  if (threadIdx.x == 0) a.scratch[(size_t)c * a.T + blockIdx.x] = total;
}

// Pass 3: place each tile's tokens, starting at its scanned bit offset.
template <bool HUFF>
__global__ void __launch_bounds__(THREADS) place_kernel(Args a) {
  __shared__ Table table;
  __shared__ uint32_t stage[STAGE_WORDS];
  if (HUFF) load_table(a, table);
  for (int w = threadIdx.x; w < STAGE_WORDS; w += THREADS) stage[w] = 0u;
  __syncthreads();
  const int c = blockIdx.y;
  uint32_t v[PER];
  int len[PER];
  load_tokens<HUFF>(a, table, c, blockIdx.x * TILE + threadIdx.x * PER, v,
                    len);
  int sum = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) sum += len[j];
  int tile_bits;
  int off = tdc::block_exclusive_scan(sum, 0, tdc::Sum(), &tile_bits);
  const int tile_start = a.scratch[(size_t)c * a.T + blockIdx.x];
  off += tile_start & 31;  // bit offset relative to word tile_start >> 5
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    if (len[j]) {
      const int w = off >> 5;
      const int sh = 32 - (off & 31) - len[j];
      if (sh >= 0) {
        atomicOr(&stage[w], v[j] << sh);
      } else {
        atomicOr(&stage[w], v[j] >> -sh);
        atomicOr(&stage[w + 1], v[j] << (32 + sh));
      }
    }
    off += len[j];
  }
  __syncthreads();
  if (tile_bits == 0) return;
  const int wb = tile_start >> 5;
  const int we = (tile_start + tile_bits - 1) >> 5;
  uint32_t* out = a.words + (size_t)c * a.cap;
  for (int w = wb + threadIdx.x; w <= we; w += THREADS) {
    const uint32_t x = stage[w - wb];
    if (w == wb || w == we) {
      if (x) atomicOr(&out[w], x);
    } else {
      out[w] = x;
    }
  }
}

template <bool HUFF>
int pack_chunks(const Args& a, int chunks, int32_t* bits,
                cudaStream_t stream) {
  const dim3 grid(a.T, chunks);
  tile_bits_kernel<HUFF><<<grid, THREADS, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tdc::scan_tiles_kernel<<<chunks, 1024, 0, stream>>>(a.scratch, bits, a.T,
                                                      0, tdc::Sum());
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  place_kernel<HUFF><<<grid, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tdc_pack_tokens_chunks(const void* values, const void* lens,
                                      void* words, void* bits, void* scratch,
                                      int chunks, int n, int cap,
                                      void* stream) {
  Args a{};
  a.values = (const uint32_t*)values;
  a.lens = (const int32_t*)lens;
  a.words = (uint32_t*)words;
  a.scratch = (int32_t*)scratch;
  a.n = n;
  a.cap = cap;
  a.T = (n + TILE - 1) / TILE;
  return pack_chunks<false>(a, chunks, (int32_t*)bits, (cudaStream_t)stream);
}
