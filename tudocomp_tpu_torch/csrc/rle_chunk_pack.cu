// K7: chunked RLE (runs cut into RUN_CAP pieces) fused with the pack.
//
// Replaces tudocomp_tpu/ops/bitpack_pallas.py:_rle_pack_kernel (entry
// rle_pack_chunks). Per chunk c, the RLE byte stream of data[c,
// :lengths[c]] (ops/rle_jax.py: a run of n >= 2 -> char, char,
// vbyte(n - 2 + offset); runs cut into pieces of at most 8192, each
// continuation piece -> char, vbyte(L - 1 + offset); single bytes
// verbatim) as big-endian u32 words, zero past the stream up to the
// row's cap, and its byte count.
//
// On the TPU the grid walks a chunk's tiles in order, carrying the last
// byte, the start of the current run and the bit count, and places the
// tokens with matmuls. Every token is whole bytes, so on Hopper K7 is a
// byte compaction. A first port (one thread per 8 positions, a block
// per 2048) ran five launches that read the input three times, worked
// byte by byte between block-wide scans, stored every stream byte alone
// to a scattered address, and needed the whole [C, cap] output zeroed
// first (NVIDIA H100 80GB HBM3, 700 W: 2.27 ms at 64 x 4 MiB against a
// 0.40 ms bound; PERF.md), and spent most of it on instructions, not
// bytes. Here a warp owns a tile of 2048 positions, 16 a lane in each
// of four 512-position slices, and no block barrier is needed:
//
// (1) count_kernel: each lane turns its 16 bytes into a mask of run
//     starts (four bytes at a time: a byte-wise not-equal by xor and a
//     carry trick) and a mask of run ends; single bytes are counted by
//     popcount, longer runs one by one from their start (the last start
//     before them in the mask, or from the lanes before by a warp
//     max-scan). The tile writes a summary that does not depend on what
//     enters it: its last and first run start, whether the run before
//     its first start ends in it, its first byte, and the bytes (a Tail:
//     count and last <= 3 bytes) of the runs that start in it;
// (2) scan_kernel: one block per chunk scans the tiles in order: a
//     max-scan of the last run starts gives each tile the start of the
//     run entering it, from which the tokens of its head (the pieces of
//     that run that end before its first start: at most one full piece
//     and the run's end, as tiles are shorter than RUN_CAP, and no run
//     that starts in a tile reaches RUN_CAP inside it) follow in closed
//     form; a scan of the tiles' Tails (tdc::Append) gives each tile its
//     first output byte and the last <= 3 stream bytes before it;
// (3) emit_kernel: each warp stages its tile's bytes in shared memory,
//     already in big-endian word order: the carried bytes, the head's
//     tokens, then each lane's tokens at its offset from a warp scan;
//     it stores the words it owns whole: a word belongs to the tile
//     that holds its last byte (the chunk's last word to the tile that
//     holds the stream's last byte), so each word has one writer, no
//     atomics, and nothing is zeroed first. The tiles of a chunk also
//     store the zero words past its stream, with 16-byte stores.
//
// It reads the input twice and writes the row once: its bound on the
// H100 is those bytes, most of them the zero tail (cap is about N words,
// four times the input); what holds it back is the per-token work of
// the emit pass (PERF.md).
#include <climits>

#include "common.cuh"

namespace {

constexpr int WARPS = 8;                   // tiles a block
constexpr int THREADS = 32 * WARPS;
constexpr int PER = 16;                    // positions a lane, per slice
constexpr int SLICE = 32 * PER;            // positions a warp, per slice
constexpr int SLICES = 4;
constexpr int TILE = SLICES * SLICE;       // positions a warp (a tile)
constexpr int RUN_CAP = 8192;              // max piece length
// a tile's bytes: at most 2 a position from the runs that start in it,
// plus the head's two tokens (<= 7 bytes), after up to 15 carried bytes
constexpr int STAGE_BYTES = 16 + 2 * TILE + 16;
constexpr int HEAD_ENDS = 1 << 16;         // flags in the head word
constexpr int HEAD_CHAR = 24;              // the tile's first byte
constexpr unsigned FULL_MASK = 0xffffffffu;
using Bytes = tdc::Append<8, 3>;
static_assert(TILE <= RUN_CAP, "a head holds at most one full piece end");
static_assert(STAGE_BYTES % 16 == 0, "16-byte groups");

struct Args {
  const uint8_t* data;     // u8[C, n]
  const int32_t* lengths;  // i32[C]
  uint32_t* words;         // u32[C, cap]
  int32_t* nbytes;         // i32[C]
  // i32[C, T] planes of scratch, count -> scan:
  int32_t* last;           // last run start (-1: none) -> entering start
  int32_t* head;           // first run start - t0 | HEAD_ENDS | char << 24
  int32_t* own_n;          // bytes of the runs that start in the tile ->
                           // the tile's first output byte
  uint32_t* own_t;         // their last <= 3 bytes -> the 3 bytes before
  int n, cap, T, offset;
  bool vec;                // data 16-byte aligned
};

// A lane's view of its 16 positions p .. p + 15 in one slice.
struct Piece {
  uint32_t v[4];  // the bytes, little-endian words
  uint32_t s;     // bit j: a run starts at p + j (at or past the
                  // chunk's length every position does)
  uint32_t e;     // bit j: a run ends at p + j (live positions only)
};

// byte j of the 16 (j may vary by lane: selects, not a local array)
__device__ __forceinline__ int byte_at(const uint32_t (&v)[4], int j) {
  const uint32_t w = j < 8 ? (j < 4 ? v[0] : v[1]) : (j < 12 ? v[2] : v[3]);
  return (w >> (8 * (j & 3))) & 0xFF;
}

// bit k (k < 4) set where byte k of x is non-zero
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  const uint32_t t = (((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u;
  return ((t >> 7) * 0x10204080u) >> 28;
}

// Loads the lane's 16 bytes of each slice of tile `x` of chunk c and
// builds its start and end masks.
__device__ void load_tile(const Args& a, int c, int length, int x,
                          Piece (&pc)[SLICES]) {
  const int lane = threadIdx.x & 31;
  const uint8_t* row = a.data + (size_t)c * a.n;
  const int t0 = x * TILE;
#pragma unroll
  for (int r = 0; r < SLICES; ++r) {
    const int p = t0 + SLICE * r + PER * lane;
    uint32_t(&v)[4] = pc[r].v;
    v[0] = v[1] = v[2] = v[3] = 0u;
    if (p < a.n) {  // n % 16 == 0: all 16 inside or all past
      const uint8_t* src = row + p;
      if (a.vec) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(src));
        v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
      } else {  // 8-byte aligned
        const uint2 q = __ldg(reinterpret_cast<const uint2*>(src));
        const uint2 u = __ldg(reinterpret_cast<const uint2*>(src) + 1);
        v[0] = q.x, v[1] = q.y, v[2] = u.x, v[3] = u.y;
      }
    }
  }
  // the byte before each lane's first: the lane before, the slice
  // before, or (first lane of the tile) the byte before the tile
  uint32_t before = t0 > 0 && lane == 0 ? row[t0 - 1] : 0u;
#pragma unroll
  for (int r = 0; r < SLICES; ++r) {
    const int p = t0 + SLICE * r + PER * lane;
    uint32_t(&v)[4] = pc[r].v;
    uint32_t prev = __shfl_up_sync(FULL_MASK, v[3], 1);
    const uint32_t wrap = __shfl_sync(FULL_MASK, v[3], 31);
    if (lane == 0) prev = before << 24;
    before = wrap >> 24;
    uint32_t s = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t shifted = __funnelshift_l(q ? v[q - 1] : prev, v[q], 8);
      s |= nonzero_bytes(v[q] ^ shifted) << (4 * q);
    }
    if (p == 0) s |= 1u;
    const int live = length - p;  // live positions of the 16
    if (live < PER) s |= (0xFFFFu << max(live, 0)) & 0xFFFFu;
    pc[r].s = s;
  }
  // a run ends where the next position starts one; the last position of
  // the tile looks at the byte after it
  const int t1 = t0 + TILE;
  const bool after = t1 >= length ||
                     (lane == 31 && row[t1] != (pc[SLICES - 1].v[3] >> 24));
#pragma unroll
  for (int r = 0; r < SLICES; ++r) {
    const int p = t0 + SLICE * r + PER * lane;
    uint32_t next = __shfl_down_sync(FULL_MASK, pc[r].s, 1) & 1u;
    if (r + 1 < SLICES) {
      const uint32_t wrap = __shfl_sync(FULL_MASK, pc[r + 1].s, 0) & 1u;
      if (lane == 31) next = wrap;
    } else if (lane == 31) {
      next = after;
    }
    const int live = min(max(length - p, 0), PER);
    pc[r].e = ((pc[r].s >> 1) | (next << 15)) & ((1u << live) - 1u);
  }
}

// vbyte(v), v < 2**14: its bytes big-endian, their number in nb
__device__ __forceinline__ uint32_t vbyte(int v, int& nb) {
  nb = v >= 128 ? 2 : 1;
  return v >= 128 ? (uint32_t)((v & 0x7F) | 0x80) << 8 | (uint32_t)(v >> 7)
                  : (uint32_t)v;
}

// The token of a first piece of L >= 2 positions: char, char,
// vbyte(L - 2 + offset); of a continuation piece: char, vbyte(L - 1 +
// offset). Its bytes big-endian in the low bytes, their number in nb.
__device__ __forceinline__ uint32_t run_token(int ch, int L, int offset,
                                              int& nb) {
  const uint32_t vb = vbyte(L - 2 + offset, nb);
  nb += 2;
  return ((uint32_t)ch * 0x101u) << (8 * (nb - 2)) | vb;
}

__device__ __forceinline__ uint32_t cont_token(int ch, int L, int offset,
                                               int& nb) {
  const uint32_t vb = vbyte(L - 1 + offset, nb);
  nb += 1;
  return (uint32_t)ch << (8 * (nb - 1)) | vb;
}

// The start of the run that ends at bit j of a lane's piece: the last
// start at or before it in the mask, else `entering` (the last start of
// the lanes before in the tile, -1 if none: the tile's head run).
__device__ __forceinline__ int run_start(uint32_t s, int j, int p,
                                         int entering) {
  const uint32_t at_or_before = s & ((2u << j) - 1u);
  return at_or_before ? p + 31 - __clz(at_or_before) : entering;
}

// The token that ends at bit j (a run end whose run starts in the tile):
// its bytes, big-endian in the low bytes, and their number.
__device__ __forceinline__ uint32_t token(const Piece& pc, int j, int p,
                                          int entering, int offset,
                                          int& nb) {
  const int ch = byte_at(pc.v, j);
  if (pc.s >> j & 1u) {
    nb = 1;
    return ch;
  }
  return run_token(ch, p + j - run_start(pc.s, j, p, entering) + 1, offset,
                   nb);
}

// The run ends of a lane's piece whose runs start in the tile: all of
// them if a run started in the lanes before (entering >= 0), else those
// from the lane's first start on (the ends before it are the head run's).
__device__ __forceinline__ uint32_t own_ends(const Piece& pc, int entering) {
  const uint32_t from = entering >= 0 ? ~0u
                        : pc.s        ? ~((1u << (__ffs(pc.s) - 1)) - 1u)
                                      : 0u;
  return pc.e & from;
}

// The bytes of the lane's own tokens in one slice.
__device__ __forceinline__ int own_bytes(const Piece& pc, int p,
                                         int entering, int offset) {
  const uint32_t own = own_ends(pc, entering);
  int bytes = __popc(own & pc.s);  // single bytes
  for (uint32_t m = own & ~pc.s; m; m &= m - 1) {
    const int j = __ffs(m) - 1;
    bytes += p + j - run_start(pc.s, j, p, entering) - 1 + offset >= 128
                 ? 4 : 3;
  }
  return bytes;
}

// The last <= 3 bytes of the lane's own tokens in one slice.
__device__ __forceinline__ uint32_t own_tail(const Piece& pc, int p,
                                             int entering, int offset) {
  uint32_t t = 0;
  int n = 0;
  for (uint32_t m = own_ends(pc, entering); m && n < 3;) {
    const int j = 31 - __clz(m);
    m ^= 1u << j;
    int nb;
    t = (t | token(pc, j, p, entering, offset, nb) << (8 * n)) & 0xFFFFFFu;
    n += nb;
  }
  return t;
}

// The last run start of the lanes before this one in the slice, or of
// the slices before (`last`); -1 if none. Sets *all to that of the
// whole slice and the ones before.
__device__ __forceinline__ int entering_start(const Piece& pc, int p,
                                              int last, int* all) {
  const int lane = threadIdx.x & 31;
  int incl = pc.s ? p + 31 - __clz(pc.s) : -1;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL_MASK, incl, d);
    if (lane >= d) incl = max(incl, y);
  }
  int excl = __shfl_up_sync(FULL_MASK, incl, 1);
  if (lane == 0) excl = -1;
  *all = max(last, __shfl_sync(FULL_MASK, incl, 31));
  return max(last, excl);
}

// Pass 1: each tile's summary.
__global__ void __launch_bounds__(THREADS) count_kernel(Args a) {
  const int c = blockIdx.y;
  const int x = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (x >= a.T) return;  // whole warps; nothing below syncs the block
  const int lane = threadIdx.x & 31;
  const int length = min(max(a.lengths[c], 0), a.n);
  Piece pc[SLICES];
  load_tile(a, c, length, x, pc);
  const int t0 = x * TILE;
  int last = -1, first = INT_MAX, bytes = 0;
  int ent[SLICES], nb[SLICES];
#pragma unroll
  for (int r = 0; r < SLICES; ++r) {
    const int p = t0 + SLICE * r + PER * lane;
    int all;
    ent[r] = entering_start(pc[r], p, last, &all);
    last = all;
    nb[r] = own_bytes(pc[r], p, ent[r], a.offset);
    bytes += __reduce_add_sync(FULL_MASK, nb[r]);
    first = min(first, __reduce_min_sync(
                           FULL_MASK, pc[r].s ? p + __ffs(pc[r].s) - 1
                                              : INT_MAX));
  }
  // the last <= 3 of those bytes: from the last lanes that have any,
  // latest first (usually the last lane alone)
  tdc::Tail tail{0, 0u};
#pragma unroll
  for (int r = SLICES - 1; r >= 0; --r) {
    const int p = t0 + SLICE * r + PER * lane;
    for (uint32_t m = __ballot_sync(FULL_MASK, nb[r] > 0); m && tail.n < 3;) {
      const int src = 31 - __clz(m);
      m ^= 1u << src;
      const uint32_t t =
          lane == src ? own_tail(pc[r], p, ent[r], a.offset) : 0u;
      tail = Bytes()({__shfl_sync(FULL_MASK, nb[r], src),
                      __shfl_sync(FULL_MASK, t, src)},
                     tail);
    }
  }
  // the run before the first start ends in the tile if a run starts in
  // it, or right after it (the last position's end bit)
  const int t1 = t0 + TILE;
  const uint32_t end_bit =
      __shfl_sync(FULL_MASK, pc[SLICES - 1].e >> 15, 31) & 1u;
  const int ch = __shfl_sync(FULL_MASK, pc[0].v[0] & 0xFFu, 0);
  if (lane == 0) {
    const size_t id = (size_t)c * a.T + x;
    a.last[id] = last;
    a.head[id] = (min(first, t1) - t0) |
                 (first < t1 || end_bit ? HEAD_ENDS : 0) | ch << HEAD_CHAR;
    a.own_n[id] = bytes;
    a.own_t[id] = tail.t;
  }
}

// The tokens of a tile's head: positions [t0, f) of the run of ch that
// started at `entering` < t0, i.e. the pieces of RUN_CAP that end there,
// then the run's last piece if it ends at f - 1. At most two tokens
// (TILE <= RUN_CAP), so at most 7 bytes: their number in n, the bytes
// big-endian in the low bytes of v.
struct Head {
  int n;
  uint64_t v;
};

__device__ __forceinline__ void append(Head& h, uint32_t tv, int nb) {
  h.v = h.v << (8 * nb) | tv;
  h.n += nb;
}

__device__ Head head_tokens(int entering, int t0, int f, bool ends, int ch,
                            int offset) {
  Head h{0, 0ull};
  if (f <= t0) return h;
  int nb;
  for (int k = (t0 - entering + RUN_CAP) / RUN_CAP;
       entering + k * RUN_CAP <= f; ++k) {
    const uint32_t tv = k > 1 ? cont_token(ch, RUN_CAP, offset, nb)
                              : run_token(ch, RUN_CAP, offset, nb);
    append(h, tv, nb);
  }
  if (ends && (f - entering) % RUN_CAP) {
    const int since = f - 1 - entering;
    const int piece = since % RUN_CAP + 1;
    const uint32_t tv = since >= RUN_CAP ? cont_token(ch, piece, offset, nb)
                                         : run_token(ch, piece, offset, nb);
    append(h, tv, nb);
  }
  return h;
}

// Pass 2: one block per chunk; the tiles in order.
__global__ void __launch_bounds__(1024) scan_kernel(Args a) {
  const int c = blockIdx.x;
  const size_t row = (size_t)c * a.T;
  int run = -1;  // last run start of the rounds before
  tdc::Tail carry{0, 0u};
  for (int base = 0; base < a.T; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const bool in = i < a.T;
    int round_last;
    const int entering = max(
        run, tdc::block_exclusive_scan(in ? a.last[row + i] : -1, -1,
                                       tdc::Max(), &round_last));
    run = max(run, round_last);
    tdc::Tail tile{0, 0u};
    if (in) {
      const int t0 = i * TILE;
      const int h = a.head[row + i];
      const Head hd = head_tokens(entering, t0, t0 + (h & 0xFFFF),
                                  h & HEAD_ENDS, (uint32_t)h >> HEAD_CHAR,
                                  a.offset);
      tile = Bytes()({hd.n, (uint32_t)hd.v & 0xFFFFFFu},
                     {a.own_n[row + i], a.own_t[row + i]});
    }
    tdc::Tail round;
    const tdc::Tail before =
        Bytes()(carry, tdc::block_exclusive_scan_tail(tile, Bytes(), &round));
    if (in) {
      a.last[row + i] = entering;
      a.own_n[row + i] = before.n;
      a.own_t[row + i] = before.t;
    }
    carry = Bytes()(carry, round);
  }
  if (threadIdx.x == 0) a.nbytes[c] = carry.n;
}

// stream byte r of a tile's staged words, in big-endian word order
__device__ __forceinline__ void put(uint8_t* sb, int r, uint32_t v) {
  sb[r ^ 3] = (uint8_t)v;
}

// Pass 3: each tile's bytes, staged, and the words it owns; then its
// share of the chunk's zero tail.
__global__ void __launch_bounds__(THREADS) emit_kernel(Args a) {
  __shared__ __align__(16) uint32_t staged[WARPS][STAGE_BYTES / 4];
  const int c = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int x = blockIdx.x * WARPS + warp;
  if (x >= a.T) return;  // whole warps; nothing below syncs the block
  const int lane = threadIdx.x & 31;
  const int length = min(max(a.lengths[c], 0), a.n);
  const size_t id = (size_t)c * a.T + x;
  const int o = a.own_n[id];  // the tile's first output byte
  const int total = a.nbytes[c];
  const int base = o & ~15;   // stream byte of staged byte 0
  uint8_t* sb = reinterpret_cast<uint8_t*>(staged[warp]);
  const int t0 = x * TILE;
  const int h = a.head[id];
  const Head hd = head_tokens(a.last[id], t0, t0 + (h & 0xFFFF),
                              h & HEAD_ENDS, (uint32_t)h >> HEAD_CHAR,
                              a.offset);
  if (lane == 0) {
    // the stream bytes before the tile in its first word, then the head
    const int k0 = o & 3;
    const uint32_t before = a.own_t[id];
    for (int q = 0; q < k0; ++q)
      put(sb, o - base - k0 + q, before >> (8 * (k0 - 1 - q)));
    for (int k = 0; k < hd.n; ++k)
      put(sb, o - base + k, (uint32_t)(hd.v >> (8 * (hd.n - 1 - k))));
  }
  Piece pc[SLICES];
  load_tile(a, c, length, x, pc);
  int at = o - base + hd.n;  // staged byte of the slice's first token
  int last = -1;
#pragma unroll
  for (int r = 0; r < SLICES; ++r) {
    const int p = t0 + SLICE * r + PER * lane;
    int all;
    const int ent = entering_start(pc[r], p, last, &all);
    last = all;
    const int nb = own_bytes(pc[r], p, ent, a.offset);
    int incl = nb;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, incl, d);
      if (lane >= d) incl += y;
    }
    int w = at + incl - nb;
    at += __shfl_sync(FULL_MASK, incl, 31);
    for (uint32_t m = own_ends(pc[r], ent); m; m &= m - 1) {
      // single bytes, the common case, apart (the general token path
      // for every end was slower on the card)
      const int j = __ffs(m) - 1;
      const int ch = byte_at(pc[r].v, j);
      if (pc[r].s >> j & 1u) {
        put(sb, w++, ch);
        continue;
      }
      int tnb;
      const uint32_t tv = run_token(
          ch, p + j - run_start(pc[r].s, j, p, ent) + 1, a.offset, tnb);
      for (int k = tnb - 1; k >= 0; --k) put(sb, w++, tv >> (8 * k));
    }
  }
  const int e = base + at;  // the tile's end in the stream
  const bool last_tile = e > o && e == total;
  if (lane == 0 && last_tile)  // zeros after the stream in its last word
    for (int q = e & 3; q && q < 4; ++q) put(sb, at - (e & 3) + q, 0);
  __syncwarp();
  uint32_t* out = a.words + (size_t)c * a.cap;
  if (e > o) {
    // the words the tile owns, [fw, lw] of the staged words, whole
    // 16-byte groups with one store
    const int fw = (o - base) >> 2;
    const int lw = (e & 3) == 0 || last_tile ? (at - 1) >> 2
                                             : (at >> 2) - 1;
    uint32_t* dst = out + (base >> 2);
    const uint32_t* src = staged[warp];
    for (int g = (fw >> 2) + lane; g <= lw >> 2; g += 32) {
      const int w0 = 4 * g;
      if (w0 >= fw && w0 + 3 <= lw) {
        reinterpret_cast<uint4*>(dst)[g] =
            reinterpret_cast<const uint4*>(src)[g];
      } else {
        for (int k = 0; k < 4; ++k)
          if (w0 + k >= fw && w0 + k <= lw) dst[w0 + k] = src[w0 + k];
      }
    }
  }
  tdc::zero_tail(out, (total + 3) >> 2, a.cap, x, a.T);
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
  a.nbytes = (int32_t*)nbytes;
  a.n = n;
  a.cap = cap;
  a.T = (n + TILE - 1) / TILE;
  const size_t plane = (size_t)chunks * a.T;
  a.last = (int32_t*)scratch;
  a.head = a.last + plane;
  a.own_n = a.head + plane;
  a.own_t = (uint32_t*)(a.own_n + plane);
  a.offset = offset;
  a.vec = ((uintptr_t)data & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((a.T + WARPS - 1) / WARPS, chunks);
  count_kernel<<<grid, THREADS, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_kernel<<<chunks, 1024, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  emit_kernel<<<grid, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}
