// K7: chunked RLE (runs cut into RUN_CAP pieces) fused with the pack.
//
// Replaces tudocomp_tpu/ops/bitpack_pallas.py:_rle_pack_kernel (entry
// rle_pack_chunks). Per chunk c, the RLE byte stream of data[c,
// :lengths[c]] (ops/rle_jax.py: a run of n >= 2 -> char, char,
// vbyte(n - 2 + offset); runs cut into pieces of at most 8192, each
// continuation piece -> char, vbyte(L - 1 + offset); single bytes
// verbatim) as big-endian u32 words, and its byte count.
//
// On the TPU the grid walks a chunk's tiles in order, carrying the last
// byte, the start of the current run and the bit count, and places the
// tokens with matmuls. Every token is whole bytes (1, 3 or 4 for a first
// piece, 2 or 3 for a continuation), so here K7 is a byte compaction
// like K1, made chunk-wide by scans over tiles of 2048 positions:
// (1) each tile's last run start; (2) an exclusive max-scan of those per
// chunk gives each tile the start of the run entering it; (3) each tile
// counts its token bytes; (4) an exclusive sum-scan gives each tile its
// first output byte; (5) each tile emits its tokens. Every stream byte is
// stored once, straight to its place in the big-endian words (byte b of
// the stream is byte (b & ~3) | (3 - (b & 3)) of the little-endian
// buffer), so no atomics are needed; the output must be zero on entry.
// The kernel is bound by device memory: it reads the input three times
// and writes the stream once.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PER = 8;               // positions per thread
constexpr int TILE = THREADS * PER;  // positions per block
constexpr int RUN_CAP = 8192;        // max piece length (ops/rle_jax.py)

struct Args {
  const uint8_t* data;     // u8[C, n]
  const int32_t* lengths;  // i32[C]
  uint32_t* words;         // u32[C, cap], zero on entry
  int32_t* last;           // i32[C, T]: tile's last run start -> max-scan
  int32_t* tbytes;         // i32[C, T]: tile's token bytes -> sum-scan
  int n, cap, T, offset;
};

// The thread's PER positions i0.. of chunk c: bytes and run starts.
// n % PER == 0, so the positions lie all inside or all past the chunk.
struct Window {
  int b[PER];    // bytes (0 past the chunk)
  int next;      // byte at i0 + PER (-1 past the chunk)
  int sor[PER];  // last run start at or before each position, within
                 // the thread's window (-1: none)
  int last;      // last run start of the window (-1: none)
};

__device__ void load_window(const Args& a, int c, int i0, int length,
                            Window& w) {
  const uint8_t* row = a.data + (size_t)c * a.n;
  int prev = -1;
  if (i0 < a.n) {
    const uint2 d = *reinterpret_cast<const uint2*>(row + i0);
#pragma unroll
    for (int j = 0; j < PER; ++j)
      w.b[j] = ((j < 4 ? d.x : d.y) >> (8 * (j & 3))) & 0xFF;
    if (i0 > 0) prev = row[i0 - 1];
  } else {
#pragma unroll
    for (int j = 0; j < PER; ++j) w.b[j] = 0;
  }
  w.next = i0 + PER < a.n ? row[i0 + PER] : -1;
  int m = -1;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = i0 + j;
    const int p = j ? w.b[j - 1] : prev;
    if (i == 0 || i >= length || w.b[j] != p) m = i;
    w.sor[j] = m;
  }
  w.last = m;
}

// Pass 1: the last run start of each tile.
__global__ void __launch_bounds__(THREADS) tile_last_kernel(Args a) {
  const int c = blockIdx.y;
  const int length = min(max(a.lengths[c], 0), a.n);
  Window w;
  load_window(a, c, blockIdx.x * TILE + threadIdx.x * PER, length, w);
  int last;
  tdc::block_exclusive_scan(w.last, -1, tdc::Max(), &last);
  if (threadIdx.x == 0) a.last[(size_t)c * a.T + blockIdx.x] = last;
}

// Passes 3 (EMIT false: count each tile's token bytes) and 5 (EMIT
// true: write them).
template <bool EMIT>
__global__ void __launch_bounds__(THREADS) tile_tokens_kernel(Args a) {
  const int c = blockIdx.y;
  const size_t tile_id = (size_t)c * a.T + blockIdx.x;
  const int length = min(max(a.lengths[c], 0), a.n);
  const int i0 = blockIdx.x * TILE + threadIdx.x * PER;
  Window w;
  load_window(a, c, i0, length, w);
  const int before = tdc::block_exclusive_scan(w.last, -1, tdc::Max(),
                                               nullptr);
  const int entering = max(a.last[tile_id], before);
  int nb[PER], vb[PER];
  bool cont[PER];
  int count = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = i0 + j;
    nb[j] = 0;
    vb[j] = 0;
    cont[j] = false;
    if (i >= length) continue;
    const int nxt = j + 1 < PER ? w.b[j + 1] : w.next;
    const int since = i - max(entering, w.sor[j]);
    const int piece = since % RUN_CAP + 1;
    if (!(i + 1 >= length || nxt != w.b[j] || piece == RUN_CAP)) continue;
    cont[j] = since >= RUN_CAP;
    if (!cont[j] && piece < 2) {
      nb[j] = 1;
    } else {
      vb[j] = max((cont[j] ? piece - 1 : piece - 2) + a.offset, 0);
      nb[j] = (cont[j] ? 1 : 2) + (vb[j] >= 128 ? 2 : 1);
    }
    count += nb[j];
  }
  int tile_bytes;
  int pos = tdc::block_exclusive_scan(count, 0, tdc::Sum(), &tile_bytes);
  if (!EMIT) {
    if (threadIdx.x == 0) a.tbytes[tile_id] = tile_bytes;
    return;
  }
  pos += a.tbytes[tile_id];
  uint8_t* out = reinterpret_cast<uint8_t*>(a.words + (size_t)c * a.cap);
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    if (!nb[j]) continue;
    const int v = vb[j];
    const int two = v >= 128;
    const uint8_t tok[4] = {
        (uint8_t)w.b[j], (uint8_t)w.b[j],
        (uint8_t)(two ? (v & 0x7F) | 0x80 : v), (uint8_t)(v >> 7)};
    // a single byte is tok[0]; a continuation piece skips the second
    // char; a first piece writes both chars
    const int skip = cont[j] ? 1 : 0;
    for (int k = 0; k < nb[j]; ++k) {
      const int src = k == 0 ? 0 : k + skip;
      out[(pos & ~3) | (3 - (pos & 3))] = tok[src];
      ++pos;
    }
  }
}

}  // namespace

extern "C" int tdc_rle_pack_chunks(const void* data, const void* lengths,
                                   void* words, void* nbytes, void* scratch,
                                   int chunks, int n, int cap, int offset,
                                   void* stream) {
  Args a{};
  a.data = (const uint8_t*)data;
  a.lengths = (const int32_t*)lengths;
  a.words = (uint32_t*)words;
  a.n = n;
  a.cap = cap;
  a.T = (n + TILE - 1) / TILE;
  a.last = (int32_t*)scratch;
  a.tbytes = a.last + (size_t)chunks * a.T;
  a.offset = offset;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(a.T, chunks);
  tile_last_kernel<<<grid, THREADS, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tdc::scan_tiles_kernel<<<chunks, 1024, 0, s>>>(a.last, nullptr, a.T, -1,
                                                 tdc::Max());
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tile_tokens_kernel<false><<<grid, THREADS, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tdc::scan_tiles_kernel<<<chunks, 1024, 0, s>>>(
      a.tbytes, (int32_t*)nbytes, a.T, 0, tdc::Sum());
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tile_tokens_kernel<true><<<grid, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}
