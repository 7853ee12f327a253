// K4: TBC2 segment decode, canonical Huffman fused with the RLE parse.
//
// Replaces tudocomp_tpu/ops/hufdec_pallas.py:_decode_kernel (entry
// decode_segments_pallas; its XLA twin is hufdec_jax.decode_segments).
// The TPU decoder runs 1024 segments in lockstep per tile over a
// transposed word feed, with a bit-sliced symbol map (no gathers) and
// (char, end) records expanded on the host. Here one thread owns one
// segment: it reads its payload straight from the container bytes at
// poff/pbytes (zero past the payload, like the TPU feed), decodes each
// symbol, runs the reference RLE record machine (hufdec_pallas.py:
// 146-177) and writes the output bytes in place.
//
// What bounds it: one symbol depends on the last inside a thread, so a
// segment is a serial chain of ~2048 steps. At a 16 MiB batch (8192
// segments) the card runs out of segments before it runs out of warp
// schedulers, and the chain's latency is the time; at 256 MiB (131,072
// segments, ~31 warps an SM) the SMs' issue and load/store pipes are:
// every warp memory access touches 32 lines, 2 KiB apart, and the
// table loads of 32 lanes collide in the banks. A first design spent
// most of its time beside the chain: a byte load per 8 payload bits, a
// 16-way threshold compare per symbol, a byte loop per output run, a
// zero-fill of the whole output before the launch and 128-thread blocks
// that left half the SMs idle at 16 MiB. This design keeps one thread
// per segment and cuts the work around the chain:
// - the payload is read as aligned 4-byte words on the read-only path
//   into a 96-bit bit buffer, topped up before every second symbol by
//   straight-line code (lanes in a warp need words at different times,
//   so a branch would run for all of them anyway); only the payload's
//   partial first and last words are read by bytes;
// - a 1024-entry table in shared memory (built on the host,
//   ops/hufdec.py:fast_decode_table) resolves every code of at most 10
//   bits with one load; longer codes take the threshold compare;
// - the RLE machine runs on selects, not branches, and a warp whose
//   segments are all rle_raw (one byte a symbol) skips it: 16 symbols
//   fill four registers at fixed places and leave as one 16-byte store;
// - otherwise output collects in a 16-byte shift register (four funnel
//   shifts a byte); a run shifts in up to 16 bytes of its
//   byte-replicated word at once and stores whole chunks of it;
// - the kernel writes every byte of [0, out_len) of its segment, zeros
//   past a short decode included, so the output needs no zero-fill;
// - 64-thread blocks, and fewer segments a warp when a batch has too
//   few segments to give each of the card's warp schedulers a warp.
#include "common.cuh"

namespace {

constexpr int THREADS = 64;
constexpr int MIN_LANES = 8;  // segments a warp, at the least
constexpr int FAST_BITS = 10;
constexpr int FAST_SIZE = 1 << FAST_BITS;

// Keeps v in a register: the compiler may not recompute it in the loop
// from the kernel's arguments (it did, at ~20 instructions a symbol).
__device__ __forceinline__ int pinned(int v) {
#ifdef __CUDA_ARCH__
  asm volatile("" : "+r"(v));
#endif
  return v;
}

template <typename T>
__device__ __forceinline__ T* pinned(T* p) {
  uintptr_t v = reinterpret_cast<uintptr_t>(p);
#ifdef __CUDA_ARCH__
  asm volatile("" : "+l"(v));
#endif
  return reinterpret_cast<T*>(v);
}

// The payload as a bit stream, MSB first: a 96-bit buffer (w2:w1:w0)
// whose top `nbits` bits are the next bits, zeros below. Word i of the
// stream is the word at wp + i; bytes outside [p, p + nb) read as zero.
// The first word and the payload's partial last word (`tail`) are read
// by bytes once; every other word by one 4-byte load, issued one top-up
// ahead. No load leaves the payload, which lies inside the container.
// The caller tops the buffer up before every second symbol, the same for
// every lane of a warp, so the top-up is straight-line code: it adds a
// word wherever at most 64 bits are left, which leaves at least 32,
// enough for two codes of up to 16 bits.
struct Bits {
  const uint32_t* wp;
  int k, full;        // next word to merge; words wholly inside the payload
  uint32_t pending;   // the raw load of word k (when k < full)
  uint32_t tail;      // word `full` (the partial last word), or 0
  uint32_t w2, w1, w0;
  int nbits;

  __device__ __forceinline__ void init(const uint8_t* p, long long nb) {
    const int skip = (int)(reinterpret_cast<uintptr_t>(p) & 3);
    const uint8_t* a0 = p - skip;
    const long long end_off = nb + skip;
    wp = pinned(reinterpret_cast<const uint32_t*>(a0));
    full = (int)min(end_off >> 2, 1LL << 30);
    uint32_t first = 0;  // no byte before p is loaded
    for (int b = skip; b < 4 && b < end_off; ++b)
      first |= (uint32_t)a0[b] << (24 - 8 * b);
    tail = 0;
    if (full >= 1)
      for (int b = 0; 4LL * full + b < end_off; ++b)
        tail |= (uint32_t)a0[4LL * full + b] << (24 - 8 * b);
    pending = full > 1 ? __ldg(wp + 1) : 0u;
    w2 = first << (8 * skip);
    w1 = w0 = 0;
    nbits = 32 - 8 * skip;
    k = 1;
  }

  // merge word k where at most 64 bits are left, and load word k + 1
  __device__ __forceinline__ void top_up() {
    const bool need = nbits <= 64;
    const uint32_t w = k < full    ? __byte_perm(pending, 0, 0x0123)
                       : k == full ? tail
                                   : 0u;
    if (need && k + 1 < full) pending = __ldg(wp + k + 1);
    // the word's top bit lands nbits below the buffer's top
    const int s = nbits & 31;
    const uint32_t a = w >> s, b = __funnelshift_r(0u, w, s);
    const bool top = nbits < 32, low = nbits >= 64;
    if (need) {
      w2 |= top ? a : 0u;
      w1 |= top ? b : (low ? 0u : a);
      w0 |= top ? 0u : (low ? a : b);
      nbits += 32;
      ++k;
    }
  }

  __device__ __forceinline__ uint32_t window16() const { return w2 >> 16; }

  __device__ __forceinline__ void consume(int n) {  // n <= 16
    w2 = __funnelshift_l(w1, w2, n);
    w1 = __funnelshift_l(w0, w1, n);
    w0 <<= n;
    nbits -= n;
  }
};

// The segment's output as 16-byte chunks. The current chunk is a
// 128-bit shift register (w0..w3, byte 0 in the low byte of w0): bytes
// enter at the top, so after k of them the chunk's first byte sits at
// register byte 16 - k. Bytes [0, cb) are stored; cb + k bytes written.
struct Out {
  uint8_t* dst;
  int cb, k;
  uint32_t w0, w1, w2, w3;

  // shift t bytes (1..16) of the byte-replicated word rep in at the top
  __device__ __forceinline__ void shift_in(uint32_t rep, int t) {
    if (t >= 16) {
      w0 = w1 = w2 = w3 = rep;
      return;
    }
    if (t & 8) w0 = w2, w1 = w3, w2 = rep, w3 = rep;
    if (t & 4) w0 = w1, w1 = w2, w2 = w3, w3 = rep;
    const int r = 8 * (t & 3);
    w0 = __funnelshift_r(w0, w1, r);
    w1 = __funnelshift_r(w1, w2, r);
    w2 = __funnelshift_r(w2, w3, r);
    w3 = __funnelshift_r(w3, rep, r);
  }

  __device__ __forceinline__ void store(uint32_t a, uint32_t b, uint32_t c,
                                        uint32_t d) {
    __stcg(reinterpret_cast<uint4*>(dst + cb), make_uint4(a, b, c, d));
    cb += 16;
  }

  __device__ __forceinline__ void put(uint32_t ch) {  // one byte
    w0 = __funnelshift_r(w0, w1, 8);
    w1 = __funnelshift_r(w1, w2, 8);
    w2 = __funnelshift_r(w2, w3, 8);
    w3 = __funnelshift_r(w3, ch, 8);
    if (++k == 16) {
      store(w0, w1, w2, w3);
      k = 0;
    }
  }

  __device__ __forceinline__ void fill(uint32_t ch, int m) {  // m bytes
    const uint32_t rep = ch * 0x01010101u;
    const int t = min(m, 16 - k);
    shift_in(rep, t);
    k += t;
    if (k < 16) return;
    store(w0, w1, w2, w3);
    for (m -= t; m >= 16; m -= 16) store(rep, rep, rep, rep);
    k = m;
    if (m) shift_in(rep, m);
  }

  // the held bytes and zeros up to n (the segment's length)
  __device__ __forceinline__ void finish(int n) {
    if (cb >= n) return;
    shift_in(0u, 16 - k);
    store(w0, w1, w2, w3);
    while (cb < n) store(0u, 0u, 0u, 0u);
  }
};

// entry `i` of the one-lookup table at shared address `base`
__device__ __forceinline__ uint32_t fast_entry(uint32_t base, uint32_t i,
                                               const uint16_t* table) {
#ifdef __CUDA_ARCH__
  uint32_t e;
  asm("ld.shared.u16 %0, [%1];" : "=r"(e) : "r"(base + 2 * i));
  return e;
#else
  return table[i];
#endif
}

// (byte | length << 8) of a code longer than FAST_BITS bits, from the
// thresholds (out of line: it is rare, and the decode loops unroll)
__device__ __noinline__ uint32_t long_code(uint32_t win, const int* thresh,
                                           const int* offs,
                                           const uint8_t* symbols) {
  int ln = 1;
#pragma unroll
  for (int l = 0; l < 16; ++l) ln += (int)win < thresh[l];
  ln = min(ln, 16);
  const int idx = min(max((int)(win >> (16 - ln)) + offs[ln - 1], 0), 255);
  return symbols[idx] | (ln << 8);
}

__global__ void __launch_bounds__(THREADS)
hufdec_kernel(const uint8_t* __restrict__ flat,
              const int64_t* __restrict__ poff,
              const int64_t* __restrict__ pbytes,
              const int32_t* __restrict__ counts,
              const uint8_t* __restrict__ flags,
              const int32_t* __restrict__ thresh_g,
              const int32_t* __restrict__ offs_g,
              const uint8_t* __restrict__ symbols_g,
              const uint16_t* __restrict__ fast_g,
              uint8_t* __restrict__ out, int nseg, long long flat_len,
              long long orig_len, int offset, int lanes) {
  __shared__ int thresh[16];
  __shared__ int offs[16];
  __shared__ uint8_t symbols[256];
  __shared__ __align__(16) uint16_t fast[FAST_SIZE];
  const int t = threadIdx.x;
  if (t < 16) {
    thresh[t] = thresh_g[t];
    offs[t] = offs_g[t];
  }
  for (int i = t; i < 256; i += THREADS) symbols[i] = symbols_g[i];
  for (int i = t; i < FAST_SIZE / 2; i += THREADS)
    reinterpret_cast<uint32_t*>(fast)[i] =
        reinterpret_cast<const uint32_t*>(fast_g)[i];
  __syncthreads();

  // `lanes` segments a warp (32, or fewer so that a small batch still
  // gives every warp scheduler of the card a warp)
  const int lane = t & 31;
  const int seg = ((blockIdx.x * THREADS + t) >> 5) * lanes + lane;
  const int out_len =
      lane < lanes && seg < nseg
          ? pinned((int)max(0LL, min((long long)tdc::SEG,
                                     orig_len - (long long)seg * tdc::SEG)))
          : 0;
  const int flag = out_len ? flags[seg] : 2;
  // a warp of rle_raw segments (one byte a symbol) skips the RLE machine
  const bool all_rle_raw = __all_sync(0xffffffffu, flag & 2);
  if (out_len == 0) return;
  const uint32_t fast_s =
      (uint32_t)pinned((int)__cvta_generic_to_shared(fast));
  const long long start = min(max((long long)poff[seg], 0LL), flat_len);
  const long long nb = max(0LL, min((long long)pbytes[seg], flat_len - start));
  const int count = min(max(counts[seg], 0), tdc::SEG);
  const bool raw = flag & 1;
  const bool rle_raw = flag & 2;

  Bits in;
  in.init(flat + start, nb);
  Out o{pinned(out + (size_t)seg * tdc::SEG), 0, 0, 0u, 0u, 0u, 0u};

  // one symbol: its byte, and the bits consumed. Codes of at most
  // FAST_BITS bits come from the table, longer ones from the thresholds;
  // huff_raw reads 8 bits
  auto next_symbol = [&]() -> int {
    const uint32_t win = in.window16();
    uint32_t e = fast_entry(fast_s, win >> (16 - FAST_BITS), fast);
    if (raw) e = 0x800u | (win >> 8);
    if (e == 0) e = long_code(win, thresh, offs, symbols);
    in.consume(e >> 8);
    return e & 0xFF;
  };

  if (all_rle_raw) {
    // every symbol is one output byte: 16 symbols fill 16 bytes in four
    // registers at fixed places, then one 16-byte store
    const int n = min(count, out_len);
    int i = 0;
    for (; i + 16 <= n; i += 16) {
      uint32_t q[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (!(j & 1)) in.top_up();
        q[j >> 2] = __funnelshift_r(q[j >> 2], next_symbol(), 8);
      }
      o.store(q[0], q[1], q[2], q[3]);
    }
    for (; i < n; ++i) {
      if (!(i & 1)) in.top_up();
      o.put(next_symbol());
    }
    o.finish(out_len);
    return;
  }
  // the reference RLE record machine, by selects (the lanes of a warp
  // are in different states): `armed` is the last char, which a vbyte
  // of at most 3 bytes after a repeat extends; every symbol before the
  // segment's end lands at the output position (no record is clipped
  // before the break below)
  int armed = -1, vb = 0, vb_acc = 0;
  for (int i = 0; i < count; ++i) {
    if (!(i & 1)) in.top_up();
    const int byte = next_symbol();
    const bool in_vb = vb != 0;
    const bool more = in_vb && (byte & 0x80);  // the vbyte goes on
    const int acc = vb_acc | ((byte & 0x7F) << (7 * max(vb - 1, 0)));
    const bool trig = !in_vb && byte == armed && !rle_raw;
    const int ch = in_vb ? armed : byte;
    const int delta = in_vb ? (more ? 0 : acc - offset + 1) : !trig;
    vb = (int)trig + (more ? min(vb + 1, 3) : 0);
    vb_acc = more ? acc : 0;
    armed = ch;
    const int m = min(max(delta, 0), out_len - (o.cb + o.k));
    if (m == 1) {
      o.put(ch);
    } else if (m > 1) {
      o.fill(ch, m);
    }
    if (o.cb + o.k == out_len) break;  // later symbols land past the end
  }
  o.finish(out_len);
}

}  // namespace

extern "C" int tdc_hufdec(const void* flat, const void* poff,
                          const void* pbytes, const void* counts,
                          const void* flags, const void* thresh,
                          const void* offs, const void* symbols,
                          const void* fast, void* out, int nseg,
                          long long flat_len, long long orig_len, int offset,
                          void* stream) {
  // halve the segments a warp while that leaves a warp scheduler (four
  // an SM) without a warp; at least 8 lanes a warp
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int lanes = 32;
  while (lanes > MIN_LANES && (long long)(nseg + lanes - 1) / lanes < 4LL * sms)
    lanes /= 2;
  const long long warps = (nseg + lanes - 1) / lanes;
  const int blocks = (int)((warps * 32 + THREADS - 1) / THREADS);
  hufdec_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)flat, (const int64_t*)poff, (const int64_t*)pbytes,
      (const int32_t*)counts, (const uint8_t*)flags, (const int32_t*)thresh,
      (const int32_t*)offs, (const uint8_t*)symbols, (const uint16_t*)fast,
      (uint8_t*)out, nseg, flat_len, orig_len, offset, lanes);
  return (int)cudaGetLastError();
}
