// K8: frame pack, the body of a TBC2 container built on the card.
//
// Replaces no TPU kernel: the JAX package assembles the frames on the
// host (tudocomp_tpu/models/blockcodec.py, numpy); the port's CPU
// tensors take this kernel's plain version (ops/frames.py:
// pack_frames_plain). Frame c is vbyte(meta1[c]), vbyte(pbytes[c]) and
// the first pbytes[c] bytes of row c of the big-endian stream words that
// K2 leaves (words u32[nc, 512]), written at byte offs[c] of out; the
// caller has scanned the frame sizes, so frames abut. The batch's rows are read
// where they lie.
//
// A pure data-movement kernel: its floor is the payload bytes read once
// and the frame bytes written once, at the card's memory bandwidth. One
// warp a frame, eight a block. The lanes walk the 16-byte-aligned pieces
// of out that the frame touches: a piece wholly inside the payload is
// made from five stream words in registers (byte swap to stream order,
// then funnel shifts by the payload's offset mod 4) and written with one
// 16-byte store; the other pieces (the one that holds the frame's
// header, and those it shares with a neighbouring frame) are written a
// byte at a time. Every byte of out within [offs[0], offs[nc-1] + size)
// is written once, by one lane, so out needs no fill.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;

// a big-endian stream word with stream byte k in bits 8k..8k+7
__device__ __forceinline__ uint32_t stream_order(uint32_t w) {
  return __byte_perm(w, 0u, 0x0123);
}

__device__ __forceinline__ int vbyte_len(uint32_t v) {
  int n = 1;
  while (v >>= 7) ++n;
  return n;
}

// byte k of vbyte(v), which is n bytes long: 7-bit groups, low group
// first, the top bit set where another byte follows
__device__ __forceinline__ uint8_t vbyte_at(uint32_t v, int k, int n) {
  const uint32_t g = (v >> (7 * k)) & 0x7Fu;
  return (uint8_t)(k + 1 < n ? g | 0x80u : g);
}

__global__ void __launch_bounds__(THREADS)
frame_pack_kernel(const uint32_t* __restrict__ words,
                  const int32_t* __restrict__ meta1,
                  const int32_t* __restrict__ pbytes,
                  const int64_t* __restrict__ offs,
                  uint8_t* __restrict__ out, int nc) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (c >= nc) return;
  const uint32_t m1 = (uint32_t)meta1[c];
  const uint32_t pb = (uint32_t)pbytes[c];
  const int l1 = vbyte_len(m1);
  const int hl = l1 + vbyte_len(pb);
  const int64_t off = offs[c];
  const int64_t p0 = off + hl;  // the payload's first byte
  const int64_t end = p0 + pb;
  const uint32_t* row = words + (size_t)c * tdc::SEG_WORDS;
  const int64_t a0 = off & ~(int64_t)15;
  const int pieces = (int)((end - a0 + 15) >> 4);
  for (int i = lane; i < pieces; i += 32) {
    const int64_t q = a0 + 16 * (int64_t)i;
    if (q >= p0 && q + 16 <= end) {
      const int s = (int)(q - p0);  // the stream byte of out[q]
      const int w = s >> 2;
      const uint32_t sh = 8u * (uint32_t)(s & 3);
      uint32_t x[5];
#pragma unroll
      for (int k = 0; k < 4; ++k) x[k] = stream_order(__ldg(row + w + k));
      // a fifth word only where the piece is not word-aligned (it then
      // lies within the payload, below word 512)
      x[4] = sh ? stream_order(__ldg(row + w + 4)) : 0u;
      uint4 v;
      v.x = __funnelshift_r(x[0], x[1], sh);
      v.y = __funnelshift_r(x[1], x[2], sh);
      v.z = __funnelshift_r(x[2], x[3], sh);
      v.w = __funnelshift_r(x[3], x[4], sh);
      *reinterpret_cast<uint4*>(out + q) = v;
    } else {
      const int64_t lo = q > off ? q : off;
      const int64_t hi = q + 16 < end ? q + 16 : end;
      for (int64_t p = lo; p < hi; ++p) {
        const int k = (int)(p - off);
        uint8_t b;
        if (k < l1) {
          b = vbyte_at(m1, k, l1);
        } else if (k < hl) {
          b = vbyte_at(pb, k - l1, hl - l1);
        } else {
          const int j = k - hl;
          b = (uint8_t)(__ldg(row + (j >> 2)) >> (24 - 8 * (j & 3)));
        }
        out[p] = b;
      }
    }
  }
}

}  // namespace

// words u32[nc, 512], meta1 i32[nc], pbytes i32[nc] (each at most
// 2048), offs i64[nc]; out u8, 16-byte aligned, at least offs[nc-1] +
// the last frame's size bytes long
extern "C" int tdc_frame_pack(const void* words, const void* meta1,
                              const void* pbytes, const void* offs,
                              void* out, int nc, void* stream) {
  const int blocks = (nc + WARPS - 1) / WARPS;  // one frame a warp
  frame_pack_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int32_t*)meta1,
      (const int32_t*)pbytes, (const int64_t*)offs, (uint8_t*)out, nc);
  return (int)cudaGetLastError();
}
