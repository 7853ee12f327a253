// K1: per-segment RLE pack, and the codec's rle_raw escape select.
//
// Replaces tudocomp_tpu/ops/segpack_pallas.py:_rle_kernel_w4 (entry
// rle_pack_segments_w4) and its byte twin _rle_kernel: for each
// 2048-byte segment, the RLE byte stream of data[:len] (run of n >= 2 ->
// char, char, vbyte(n - 2 + offset); single bytes verbatim) as
// big-endian u32 words, plus the stream's full byte count. The select
// entry also takes the codec's escape (tudocomp_tpu/models/blockcodec.py
// rle_stage, where XLA fused it beside the TPU kernel): where the stream
// is longer than len, the segment's own bytes, zero past len.
//
// On the TPU the stream is placed through one-hot matmuls, because the
// TPU has no fast scatter. Here RLE tokens are whole bytes (1, 3 or 4),
// so the stream is a byte compaction. It reads 2 KiB and writes 2 KiB
// per segment, so device memory bounds it; a first design (one 256-thread
// block per segment, two block scans, eight barriers for 2 KiB of work)
// spent its time in barriers and short blocks instead, and a loop over
// the tokens in placement. Here one warp owns one segment, eight
// segments per block, and nothing waits on the block: each lane loads 64
// positions with 16-byte loads and turns them into 64-bit masks of run
// boundaries and run ends; a warp max-scan carries the last boundary
// across lanes and a warp sum-scan gives each lane its output offset
// (shuffles only). Literals cost one popcount in the sum; only runs of
// two or more need their length. Each lane places its tokens' bytes in
// the warp's 2 KiB of shared memory: the literals in one unrolled pass
// over its 64 positions, straight from the registers, and the run
// tokens at offsets counted by popcounts. Then the warp stores the
// stream (or, on the escape, its staged input) as big-endian words with
// 16-byte stores, zero past the stream. The select entry's escape skips
// the placement: the stream length is known after the sum-scan, the
// same for the whole warp. Positions >= len are masked here, so the
// output never depends on the row's padding.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;              // segments per block
constexpr int THREADS = 32 * WARPS;
constexpr int PER = tdc::SEG / 32;    // 64 positions per lane
constexpr unsigned FULL = 0xffffffffu;

// bits k of the result: byte k of x differs from byte k of y
__device__ __forceinline__ uint32_t byte_ne_bits(uint32_t x, uint32_t y) {
  return ((__vcmpne4(x, y) & 0x08040201u) * 0x01010101u) >> 24;
}

// big-endian word of 4 stream bytes (byte 0 in the top byte), bytes at
// or past n (counted from this word's first byte o) zero
__device__ __forceinline__ uint32_t be_word(uint32_t x, int o, int n) {
  const uint32_t w = __byte_perm(x, 0, 0x0123);
  const int keep = n - o;
  return keep >= 4 ? w : keep <= 0 ? 0u : w & (~0u << (8 * (4 - keep)));
}

template <bool SELECT>
__global__ void __launch_bounds__(THREADS)
rle_pack_kernel(const uint8_t* __restrict__ rows,
                const int32_t* __restrict__ lens_g,
                uint32_t* __restrict__ words, int32_t* __restrict__ lens_out,
                uint8_t* __restrict__ raw_out, int nc, int offset) {
  __shared__ __align__(16) uint8_t in_buf[WARPS][tdc::SEG];
  __shared__ __align__(16) uint8_t out_buf[WARPS][tdc::SEG];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int seg = blockIdx.x * WARPS + warp;
  if (seg >= nc) return;  // whole warps leave; nothing below syncs the block
  uint8_t* in = in_buf[warp];
  uint8_t* out = out_buf[warp];
  const int len_raw = lens_g[seg];
  const int len = min(max(len_raw, 0), tdc::SEG);
  const int base = lane * PER;

  // load: 64 bytes per lane, 16 bytes at a time where the rows allow
  uint32_t w[PER / 4];
  const uint8_t* src = rows + (size_t)seg * tdc::SEG + base;
  if ((reinterpret_cast<uintptr_t>(rows) & 15) == 0) {
#pragma unroll
    for (int r = 0; r < PER / 16; ++r) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(src) + r);
      w[4 * r] = v.x, w[4 * r + 1] = v.y, w[4 * r + 2] = v.z,
      w[4 * r + 3] = v.w;
    }
  } else {  // the wrapper guarantees 8-byte alignment
#pragma unroll
    for (int r = 0; r < PER / 8; ++r) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(src) + r);
      w[2 * r] = v.x, w[2 * r + 1] = v.y;
    }
  }
#pragma unroll
  for (int r = 0; r < PER / 16; ++r)
    reinterpret_cast<uint4*>(in + base)[r] =
        make_uint4(w[4 * r], w[4 * r + 1], w[4 * r + 2], w[4 * r + 3]);

  // boundary mask: bit j set where position base + j starts a run
  // (position 0, a byte unlike the one before it, or a position >= len)
  const uint32_t before = __shfl_up_sync(FULL, w[PER / 4 - 1] >> 24, 1);
  uint64_t bmask = 0;
#pragma unroll
  for (int i = 0; i < PER / 4; ++i) {
    const uint32_t prev = i ? w[i - 1] >> 24 : before;
    const uint32_t shifted = (w[i] << 8) | prev;
    bmask |= (uint64_t)byte_ne_bits(w[i], shifted) << (4 * i);
  }
  const int live_n = len - base;
  const uint64_t live = live_n >= PER ? ~0ull
                        : live_n <= 0  ? 0ull
                                       : (1ull << live_n) - 1;
  bmask |= ~live;
  if (lane == 0) bmask |= 1;
  // a run ends at a live position whose successor starts a run
  const uint64_t next_b = __shfl_down_sync(FULL, bmask & 1, 1);
  const uint64_t ends = live & ((bmask >> 1) | ((lane == 31 ? 1 : next_b)
                                                << 63));
  const uint64_t run_ends = ends & ~bmask;  // ends of runs of 2 or more

  // last run start before this lane: exclusive warp max-scan
  int carry = 63 - __clzll(bmask);  // -1 when the lane starts no run
  carry = carry >= 0 ? base + carry : -1;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, carry, d);
    if (lane >= d) carry = max(carry, y);
  }
  int sor_in = __shfl_up_sync(FULL, carry, 1);  // lane 0 starts a run at 0

  // stream bytes of this lane: one per token, two more per run token,
  // one more where its vbyte takes two bytes (bits of vb2)
  int sum = __popcll(ends);
  uint64_t vb2 = 0;
  for (uint64_t m = run_ends; m; m &= m - 1) {
    const int j = __ffsll(m) - 1;
    const uint64_t below = bmask & (~0ull >> (63 - j));
    const int sor = below ? base + 63 - __clzll(below) : sor_in;
    const bool two = base + j - sor + 1 - 2 + offset >= 128;
    sum += 2 + two;
    vb2 |= (uint64_t)two << j;
  }
  int q = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, q, d);
    if (lane >= d) q += y;
  }
  const int total = __shfl_sync(FULL, q, 31);
  q -= sum;  // exclusive: this lane's first output byte

  const bool escape = SELECT && total > len_raw;
  if (!escape) {
    // literals (runs of one), straight from the registers in position
    // order; a run token only moves the output position here
    const uint64_t lit = ends & bmask;
    if (lit) {
      int p = q;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int h = j >> 5, b = j & 31;  // masks by 32-bit halves
        const uint32_t litm = (uint32_t)(lit >> (32 * h));
        const uint32_t runm = (uint32_t)(run_ends >> (32 * h));
        const uint32_t vb2m = (uint32_t)(vb2 >> (32 * h));
        if ((litm >> b) & 1) {
          if (p < tdc::SEG) out[p] = (uint8_t)(w[j >> 2] >> (8 * (j & 3)));
          ++p;
        } else if ((runm >> b) & 1) {
          p += 3 + ((vb2m >> b) & 1);
        }
      }
    }
    // run tokens: char, char, vbyte(run - 2 + offset), each at the
    // stream bytes of the tokens before it
    for (uint64_t m = run_ends; m; m &= m - 1) {
      const int j = __ffsll(m) - 1;
      const uint64_t before = (1ull << j) - 1;
      const int at = q + __popcll(ends & before) +
                     2 * __popcll(run_ends & before) + __popcll(vb2 & before);
      const uint64_t below = bmask & (~0ull >> (63 - j));
      const int sor = below ? base + 63 - __clzll(below) : sor_in;
      const int v = base + j - sor + 1 - 2 + offset;
      const uint8_t c = in[base + j];
      const uint8_t tok[4] = {c, c,
                              (uint8_t)(v < 128 ? v : ((v & 0x7F) | 0x80)),
                              (uint8_t)(v >> 7)};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k < 3 + (v >= 128) && at + k < tdc::SEG) out[at + k] = tok[k];
    }
  }
  __syncwarp();

  // store: 512 big-endian words, zero past the stream, 16 bytes a lane
  const uint8_t* stream = escape ? in : out;
  const int n = escape ? len : min(total, tdc::SEG);
  uint4* dst = reinterpret_cast<uint4*>(words + (size_t)seg * tdc::SEG_WORDS);
#pragma unroll
  for (int r = 0; r < tdc::SEG / 512; ++r) {
    const int o = 16 * lane + 512 * r;
    const uint4 v = *reinterpret_cast<const uint4*>(stream + o);
    dst[lane + 32 * r] = make_uint4(be_word(v.x, o, n), be_word(v.y, o + 4, n),
                                    be_word(v.z, o + 8, n),
                                    be_word(v.w, o + 12, n));
  }
  if (lane == 0) {
    lens_out[seg] = escape ? len_raw : total;
    if (SELECT) raw_out[seg] = escape;
  }
}

template <bool SELECT>
int launch(const void* rows, const void* lens, void* words, void* lens_out,
           void* raw_out, int nc, int offset, void* stream) {
  const int blocks = (nc + WARPS - 1) / WARPS;
  rle_pack_kernel<SELECT><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)rows, (const int32_t*)lens, (uint32_t*)words,
      (int32_t*)lens_out, (uint8_t*)raw_out, nc, offset);
  return (int)cudaGetLastError();
}

}  // namespace

// K1: the RLE stream's first 2048 bytes as words, and its full length
extern "C" int tdc_rle_pack(const void* rows, const void* lens, void* words,
                            void* rle_lens, int nc, int offset,
                            void* stream) {
  return launch<false>(rows, lens, words, rle_lens, nullptr, nc, offset,
                       stream);
}

// K1 + the rle_raw escape: rle_stage's (sel, counts, rle_raw)
extern "C" int tdc_rle_select(const void* rows, const void* lens, void* sel,
                              void* counts, void* rle_raw, int nc,
                              int offset, void* stream) {
  return launch<true>(rows, lens, sel, counts, rle_raw, nc, offset, stream);
}
