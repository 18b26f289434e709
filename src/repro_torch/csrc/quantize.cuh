// The b-bit stochastic quantizer, shared by the plane kernel (K1,
// quantize_plane.cu) and the per-message kernel (K4, quantize_leaf.cu):
// the per-element arithmetic and the fused row kernel that computes each
// row's scale and its levels in one launch.  Only the source of kappa
// differs between K1 and K4 (a Kappa policy: PlaneKappa, LeafKappa, and
// ShardKappa for K4's shard form, a rank's shard of a leaf cut over the
// "model" axis, quantize_leaf.cu quantize_leaf_shard).
//
// Arithmetic.  q = sign(x) * floor(levels * |x| / scale + kappa), in the
// reference's operation order (src/repro/kernels/quantize/kernel.py:43),
// every step rounded to nearest and none contracted, the division
// correctly rounded: the int8 payload bits depend on it.  The reference's
// f32 arithmetic runs under XLA, whose CPU backend and the TPU keep no
// f32 subnormal: a subnormal operand counts as a zero of its sign, and a
// subnormal result becomes one (XLA rounds with an unbounded exponent,
// then flushes a result below tiny, as the GPU's .ftz forms do).  So each
// step here is the .ftz form of its PTX instruction (mul/div/fma.rn.ftz),
// in these functions only: the rest of the port keeps IEEE subnormals.
// signed_y says how the level is formed (one copysign and one conversion
// besides); the division is div.rn.ftz.f32 itself.
//
// The fused row kernel (quantize_rows).  The reference computes the scale,
// max(max |x|, tiny) per row, in a separate jnp pass, because a Pallas
// grid on the TPU cannot reduce across blocks (kernel.py:9-11).  Here one
// launch does both, in tiles of kQTile elements of a row, handed out by
// tickets:
//   * each block takes a ticket from a global counter (atomicAdd) and
//     loops until the tickets run out (a persistent, 1-D grid sized from
//     the SM count and the occupancy);
//   * the tickets' order fixes the work: first the max tiles of rows
//     0..L-1, then for r = 0, 1, ... the quantise tiles of row r
//     alternating with the max tiles of row r + L;
//   * a max tile reduces max |x| over its part of the row as uint32 bits
//     (for a non-negative f32, the bits order as the value; any NaN's
//     bits exceed +inf's, so a NaN propagates as amax does),
//     atomicMax-es them into the row's word, then, after a
//     __threadfence (release), adds one to the row's arrival counter;
//   * a quantise tile waits (acquire loads) until all P max tiles of its
//     row have arrived, reads the row's word, takes max(word, bits of
//     tiny), which is exactly max(amax |x|, tiny), re-reads its x tile
//     (which the max tile brought into L2 a few rows before: L rows of x
//     stay well inside the 50 MB L2, so HBM reads x once), draws kappa,
//     quantises and stores; the row's first quantise tile writes
//     scale[m].
// It cannot deadlock: a quantise tile of row r receives its ticket only
// after every max tile of row r received one, max tiles never wait, and a
// block holding a ticket is running.  So every max tile a quantise tile
// waits on is already resident and finishes; no cooperative launch and no
// assumption on how many blocks are co-resident is needed (the argument
// of CUB's single-pass scan).  Max tiles are memory work and quantise
// tiles integer work, so the two overlap on the SMs.  A row that fits one
// tile (P == 1) is done by one block, reduced, synced and quantised, with
// no ticket and no counter.  The scratch (ticket, counters, row words) is
// zeroed by one cudaMemsetAsync before the launch.
//
// Element body.  A row whose x and q are aligned the same way is read in
// 16-byte loads and written one 4-byte store per four int8 levels (per
// eight b=4 levels, two offset-8 nibbles a byte); the elements before the
// first such group (fewer than 8) and after the last go one at a time,
// and so does a whole row that cannot be aligned (a misaligned x, or a
// b=4 row of odd n whose bytes and floats never line up).
#pragma once
#include <cuda_runtime.h>

#include <cstdint>

#include "threefry.cuh"

namespace repro {

__device__ __forceinline__ float mul_ftz(float a, float b) {
  float r;
  asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float div_ftz(float a, float b) {
  float r;
  asm("div.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float mul_sat_ftz(float a, float b) {
  float r;
  asm("mul.rn.ftz.sat.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float fma_ftz(float a, float b, float c) {
  float r;
  asm("fma.rn.ftz.f32 %0, %1, %2, %3;" : "=f"(r) : "f"(a), "f"(b), "f"(c));
  return r;
}

// The level before its conversion to an integer: copysign(y, x) with
// a = levels * |x| and y = RN(RN(a / scale) + kappa), every step .ftz (a
// subnormal x gives a = 0); kbits is f32(kappa's bits) = 2^32 kappa.  The
// reference's level is sign(x) * floor(y) converted as XLA converts
// (saturating, NaN to 0); y >= 0 (or NaN), so that is the truncation of
// copysign(y, x), which the float -> int conversion does, saturation and
// NaN included.  A zero or subnormal x must give 0 whatever kappa:
// c = sat(a * 2^126) is 1 for every a > 0 (a >= 7 tiny) and 0 for a = 0
// or NaN, and y = fma(kappa, c, a / scale) adds kappa exactly when c = 1.
__device__ __forceinline__ float signed_y(float x, float levels,
                                          float scale, float kbits) {
  const float a = mul_ftz(levels, fabsf(x));
  const float c = mul_sat_ftz(a, 0x1p126f);
  const float y = fma_ftz(mul_ftz(kbits, 0x1p-32f), c, div_ftz(a, scale));
  return copysignf(y, x);
}

// int8 level (b=8): truncated, saturated to [-128, 127], NaN to 0; the
// byte is the low byte of the result
__device__ __forceinline__ uint32_t level8(float qs) {
  unsigned short r;
  asm("cvt.rzi.s8.f32 %0, %1;" : "=h"(r) : "f"(qs));
  return r;
}

// offset-8 nibble of a b=4 level in [-8, 8] (NaN counts as level 0).
// Level 8 gives 16, which the caller packs in int32 and truncates to a
// byte, exactly as the reference does (kernel.py:58-61).
__device__ __forceinline__ int nibble4(float qs) {
  return __float2int_rz(qs) + 8;
}

// ---------------------------------------------------------------------------
// kappa sources: state(m) once per row and tile, bits(state, j) per element
// ---------------------------------------------------------------------------

// K1: random_bits(fold(seed, sid[m], rid[m]), j)
struct PlaneKappa {
  uint32_t s0, s1;
  const uint32_t* sids;
  const uint32_t* rids;
  __device__ __forceinline__ Pair state(int m) const {
    return message_seed(s0, s1, id_or(sids, m, 0u),
                        id_or(rids, m, kBroadcast));
  }
  __device__ __forceinline__ uint32_t bits(Pair st, uint32_t j) const {
    return random_bits(st, j);
  }
};

// K4: jax.random.bits(key[m], (n_pad,))[j], the keys in device memory
struct LeafKappa {
  const uint32_t* keys;
  __device__ __forceinline__ Pair state(int m) const {
    return Pair{keys[2 * m], keys[2 * m + 1]};
  }
  __device__ __forceinline__ uint32_t bits(Pair st, uint32_t j) const {
    return jax_bits(st.x0, st.x1, j);
  }
};

// K4's shard form: the rank's element j of a leaf's shard draws
// jax.random.bits(key[m], (n_pad,))[g], g its flat index in the whole
// leaf.  The shard is the whole leaf but along one dim (the cut dim), where
// it holds at most kMaxPieces pieces, each (local start, global start,
// length): local element j = (outer * ldim + l) * inner + i lies at
// g = (outer * gdim + l - ls[p] + gs[p]) * inner + i, p the piece holding l.
// Two 32-bit divisions an element; the whole leaf has fewer than 2^32
// elements (the C entry checks).
constexpr int kMaxPieces = 4;

struct ShardKappa {
  const uint32_t* keys;
  uint32_t inner, gdim, ldim;
  int pieces;
  uint32_t ls[kMaxPieces], gs[kMaxPieces], len[kMaxPieces];
  __device__ __forceinline__ Pair state(int m) const {
    return Pair{keys[2 * m], keys[2 * m + 1]};
  }
  __device__ __forceinline__ uint32_t global(uint32_t j) const {
    const uint32_t block = ldim * inner;
    const uint32_t outer = j / block;
    const uint32_t rem = j - outer * block;
    const uint32_t l = rem / inner;
    const uint32_t i = rem - l * inner;
    uint32_t g = l;
#pragma unroll
    for (int p = 0; p < kMaxPieces; ++p) {
      if (p < pieces && l - ls[p] < len[p]) g = l - ls[p] + gs[p];
    }
    return (outer * gdim + g) * inner + i;
  }
  __device__ __forceinline__ uint32_t bits(Pair st, uint32_t j) const {
    return jax_bits(st.x0, st.x1, global(j));
  }
};

// ---------------------------------------------------------------------------
// the fused row kernel
// ---------------------------------------------------------------------------

constexpr int kQThreads = 256;
constexpr int kQTile = 8192;  // elements of a row per ticket
constexpr unsigned kTinyBits = 0x00800000u;  // FLT_MIN, the scale's floor

// one element's signed level before conversion (kappa drawn here)
template <int kBits, class Kappa>
__device__ __forceinline__ float level_at(const Kappa& src, Pair st, float x,
                                          float scale, uint32_t j) {
  return signed_y(x, kBits == 8 ? 127.f : 7.f, scale,
                  __uint2float_rn(src.bits(st, j)));
}

// the byte of a b=4 pair: ((hi + 8) << 4) | (lo + 8) in int32, low byte
__device__ __forceinline__ uint32_t pair_byte(int hi, int lo) {
  return static_cast<uint32_t>((hi << 4) | lo) & 0xFFu;
}

// Four int8 levels (x at element j..j+3) or eight b=4 levels (j..j+7) as
// one little-endian word, the bytes as the reference stores them.
template <int kBits, class Kappa>
__device__ __forceinline__ uint32_t quantize_group(const Kappa& src, Pair st,
                                                   const float4* v,
                                                   float scale, uint32_t j) {
  if (kBits == 8) {
    const float4 a = v[0];
    const uint32_t l0 = level8(level_at<kBits>(src, st, a.x, scale, j));
    const uint32_t l1 = level8(level_at<kBits>(src, st, a.y, scale, j + 1));
    const uint32_t l2 = level8(level_at<kBits>(src, st, a.z, scale, j + 2));
    const uint32_t l3 = level8(level_at<kBits>(src, st, a.w, scale, j + 3));
    return __byte_perm(__byte_perm(l0, l1, 0x0040),
                       __byte_perm(l2, l3, 0x0040), 0x5410);
  }
  const float4 a = v[0], b = v[1];
  const float e[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t p[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    p[i] = pair_byte(
        nibble4(level_at<kBits>(src, st, e[2 * i], scale, j + 2 * i)),
        nibble4(level_at<kBits>(src, st, e[2 * i + 1], scale, j + 2 * i + 1)));
  }
  return __byte_perm(__byte_perm(p[0], p[1], 0x0040),
                     __byte_perm(p[2], p[3], 0x0040), 0x5410);
}

// The first element j0 (< 8) of row m from which x (16 bytes) and q (4
// bytes) are aligned together, or -1 if they never are.
template <int kBits>
__device__ __forceinline__ int aligned_start(const float* x, const void* q,
                                             long long m, int n, int wire) {
  if ((reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(q) & 3)) {
    return -1;
  }
  const long long e = m * n;  // the row's first element in x
  if (kBits == 8) return static_cast<int>((4 - (e & 3)) & 3);
  const long long byte = m * wire;  // its first byte in q
  for (int j0 = 0; j0 < 8; j0 += 2) {
    if (((e + j0) & 3) == 0 && ((byte + j0 / 2) & 3) == 0) return j0;
  }
  return -1;
}

// the elements [lo, hi) of tile t of a row and where its groups begin
struct TileSpan {
  int lo, a, b, hi;  // scalar [lo, a), groups [a, b), scalar [b, hi)
};

template <int kBits>
__device__ __forceinline__ TileSpan tile_span(int t, int n, int j0) {
  constexpr int g = kBits == 8 ? 4 : 8;
  const int base = j0 < 0 ? 0 : j0;
  TileSpan s;
  s.lo = t == 0 ? 0 : base + t * kQTile;
  s.hi = min(n, base + (t + 1) * kQTile);
  if (s.lo > s.hi) s.lo = s.hi;
  if (j0 < 0) {
    s.a = s.b = s.hi;
  } else {
    s.a = max(s.lo, min(j0, s.hi));
    s.b = s.a + (s.hi - s.a) / g * g;
  }
  return s;
}

// max |x| over the tile as uint32 bits, reduced over the block (every
// thread gets it)
template <int kBits>
__device__ __forceinline__ unsigned tile_max(const float* __restrict__ xr,
                                             TileSpan s, unsigned* red) {
  unsigned mx = 0;
  const int ng4 = (s.b - s.a) / 4;  // groups are whole float4s
  const float4* v = reinterpret_cast<const float4*>(xr + s.a);
#pragma unroll
  for (int k = 0; k < kQTile / 4 / kQThreads; ++k) {
    const int i = threadIdx.x + k * kQThreads;
    if (i < ng4) {
      const float4 f = __ldg(v + i);
      mx = max(mx, max(max(__float_as_uint(f.x) & 0x7FFFFFFFu,
                           __float_as_uint(f.y) & 0x7FFFFFFFu),
                       max(__float_as_uint(f.z) & 0x7FFFFFFFu,
                           __float_as_uint(f.w) & 0x7FFFFFFFu)));
    }
  }
  for (int j = s.lo + threadIdx.x; j < s.a; j += kQThreads) {
    mx = max(mx, __float_as_uint(__ldg(xr + j)) & 0x7FFFFFFFu);
  }
  for (int j = s.b + threadIdx.x; j < s.hi; j += kQThreads) {
    mx = max(mx, __float_as_uint(__ldg(xr + j)) & 0x7FFFFFFFu);
  }
  mx = __reduce_max_sync(0xFFFFFFFFu, mx);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int w = 1; w < kQThreads / 32; ++w) mx = max(mx, red[w]);
  return mx;
}

// the scalar elements [from, to) of a tile (b=4: whole pairs; an element
// past n is x = 0, whose nibble is 8 for any kappa)
template <int kBits, class Kappa>
__device__ __forceinline__ void quantize_scalar(
    const Kappa& src, Pair st, const float* __restrict__ xr, int n,
    float scale, uint8_t* __restrict__ qr, int from, int to) {
  if (kBits == 8) {
    for (int j = from + threadIdx.x; j < to; j += kQThreads) {
      qr[j] = static_cast<uint8_t>(level8(level_at<kBits>(
          src, st, __ldg(xr + j), scale, static_cast<uint32_t>(j))));
    }
  } else {
    for (int p = from / 2 + threadIdx.x; 2 * p < to; p += kQThreads) {
      const int j = 2 * p;
      const int hi = nibble4(level_at<kBits>(src, st, __ldg(xr + j), scale,
                                             static_cast<uint32_t>(j)));
      const int lo =
          j + 1 < n ? nibble4(level_at<kBits>(src, st, __ldg(xr + j + 1),
                                              scale,
                                              static_cast<uint32_t>(j + 1)))
                    : 8;
      qr[p] = static_cast<uint8_t>(pair_byte(hi, lo));
    }
  }
}

// a tile at the row's scale
template <int kBits, class Kappa>
__device__ __forceinline__ void quantize_tile(
    const Kappa& src, Pair st, const float* __restrict__ xr, int n,
    float scale, uint8_t* __restrict__ qr, TileSpan s) {
  constexpr int g = kBits == 8 ? 4 : 8;
  const int ng = (s.b - s.a) / g;
  const float4* v = reinterpret_cast<const float4*>(xr + s.a);
  uint32_t* w = reinterpret_cast<uint32_t*>(qr + (kBits == 8 ? s.a : s.a / 2));
#pragma unroll 4
  for (int k = 0; k < kQTile / g / kQThreads; ++k) {
    const int i = threadIdx.x + k * kQThreads;
    if (i < ng) {
      float4 f[g / 4];
#pragma unroll
      for (int h = 0; h < g / 4; ++h) f[h] = __ldg(v + (g / 4) * i + h);
      w[i] = quantize_group<kBits>(src, st, f, scale,
                                   static_cast<uint32_t>(s.a + g * i));
    }
  }
  quantize_scalar<kBits>(src, st, xr, n, scale, qr, s.lo, s.a);
  quantize_scalar<kBits>(src, st, xr, n, scale, qr, s.b, s.hi);
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Quantise rows [M, n] of x into q [M, wire] and scale [M]; see the header
// comment.  scratch: ticket, arrived[M], word[M] (zeroed), unused if P == 1.
template <int kBits, class Kappa>
__global__ void __launch_bounds__(kQThreads)
quantize_rows(const float* __restrict__ x, int M, int n, int wire, int P,
              int L, Kappa src, float* __restrict__ scale,
              uint8_t* __restrict__ q, unsigned* __restrict__ scratch) {
  __shared__ unsigned red[kQThreads / 32];
  __shared__ unsigned item;
  __shared__ float row_scale;
  __shared__ Pair row_state;
  if (P == 1) {
    for (int m = blockIdx.x; m < M; m += gridDim.x) {
      const float* xr = x + static_cast<long long>(m) * n;
      uint8_t* qr = q + static_cast<long long>(m) * wire;
      const TileSpan s = tile_span<kBits>(
          0, n, aligned_start<kBits>(x, q, m, n, wire));
      if (threadIdx.x == 0) row_state = src.state(m);
      // tile_max syncs the block, which publishes row_state
      const float sc =
          __uint_as_float(max(tile_max<kBits>(xr, s, red), kTinyBits));
      if (threadIdx.x == 0) scale[m] = sc;
      quantize_tile<kBits>(src, row_state, xr, n, sc, qr, s);
      __syncthreads();  // red and row_state are reused by the next row
    }
    return;
  }
  unsigned* ticket = scratch;
  unsigned* arrived = scratch + 1;
  unsigned* word = scratch + 1 + M;
  const int lead = min(L, M);
  const unsigned head = static_cast<unsigned>(lead) * P;
  const unsigned paired = static_cast<unsigned>(M - lead) * 2u * P;
  const unsigned total = 2u * static_cast<unsigned>(M) * P;
  for (;;) {
    if (threadIdx.x == 0) item = atomicAdd(ticket, 1u);
    __syncthreads();
    const unsigned t = item;
    if (t >= total) return;
    bool is_max;
    int m, tile;
    if (t < head) {
      is_max = true, m = t / P, tile = t % P;
    } else if (t - head < paired) {
      const unsigned u = t - head, r = u / (2u * P), w = u % (2u * P);
      is_max = w & 1u, tile = w >> 1;
      m = is_max ? r + lead : r;
    } else {
      const unsigned u = t - head - paired;
      is_max = false, m = M - lead + u / P, tile = u % P;
    }
    const float* xr = x + static_cast<long long>(m) * n;
    const TileSpan s =
        tile_span<kBits>(tile, n, aligned_start<kBits>(x, q, m, n, wire));
    if (is_max) {
      const unsigned mx = tile_max<kBits>(xr, s, red);
      if (threadIdx.x == 0) {
        atomicMax(word + m, mx);
        __threadfence();
        atomicAdd(arrived + m, 1u);
      }
    } else {
      if (threadIdx.x == 0) {
        row_state = src.state(m);
        const unsigned long long t0 = global_ns();
        while (ld_acquire(arrived + m) < static_cast<unsigned>(P)) {
          __nanosleep(64);
          // a lost max tile fails the launch instead of holding the card
          if (global_ns() - t0 > 10000000000ull) __trap();
        }
        const float sc =
            __uint_as_float(max(ld_acquire(word + m), kTinyBits));
        row_scale = sc;
        if (tile == 0) scale[m] = sc;
      }
      __syncthreads();
      quantize_tile<kBits>(src, row_state, xr, n, row_scale,
                           q + static_cast<long long>(m) * wire, s);
    }
    __syncthreads();  // every thread is done with red, row_* and item
  }
}

// Launch quantize_rows on [M, n] rows: checks the shape, zeroes the
// scratch (1 + 2M words) when a row spans more than one tile, sizes the
// persistent grid from the SM count and the occupancy.  Returns the CUDA
// error code.
template <int kBits, class Kappa>
int launch_quantize_rows(const float* x, int M, int n, int wire, Kappa src,
                         float* scale, uint8_t* q, unsigned* scratch,
                         cudaStream_t st) {
  const long long tiles = (static_cast<long long>(n) + kQTile - 1) / kQTile;
  if (2LL * M * tiles >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int P = static_cast<int>(tiles);
  // L rows of x (~16 MB) stay in L2 between their max and quantise tiles
  const long long row_bytes = 4LL * n;
  const int L = static_cast<int>(
      max(2LL, min(static_cast<long long>(M), (16LL << 20) / row_bytes)));
  // the current device's, read at every launch
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, quantize_rows<kBits, Kappa>, kQThreads, 0);
  per_sm = max(per_sm, 1);
  const long long items = P == 1 ? M : 2LL * M * P;
  const int grid = static_cast<int>(min(items, 1LL * sms * per_sm));
  if (P > 1) {
    const cudaError_t e = cudaMemsetAsync(
        scratch, 0, sizeof(unsigned) * (1 + 2 * static_cast<size_t>(M)), st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  quantize_rows<kBits, Kappa><<<grid, kQThreads, 0, st>>>(
      x, M, n, wire, P, L, src, scale, q, scratch);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the shard form's two passes: each row's max |x| bits, and the levels at a
// given scale (the row max all-reduced over the ranks in between)
// ---------------------------------------------------------------------------

// words[m] = max over row m of the bits of |x| (atomicMax; zeroed before)
__global__ void __launch_bounds__(kQThreads)
rows_absmax(const float* __restrict__ x, int M, int n, int P,
            unsigned* __restrict__ words) {
  __shared__ unsigned red[kQThreads / 32];
  const long long items = static_cast<long long>(M) * P;
  for (long long b = blockIdx.x; b < items; b += gridDim.x) {
    const int m = static_cast<int>(b / P), t = static_cast<int>(b % P);
    const TileSpan s =
        tile_span<8>(t, n, aligned_start<8>(x, x, m, n, n));
    const unsigned mx =
        tile_max<8>(x + static_cast<long long>(m) * n, s, red);
    if (threadIdx.x == 0) atomicMax(words + m, mx);
    __syncthreads();  // red is reused by the next item
  }
}

// q, scale of rows [M, n] at scale max(words[m], tiny): one tile an item
template <int kBits, class Kappa>
__global__ void __launch_bounds__(kQThreads)
quantize_rows_at(const float* __restrict__ x, int M, int n, int wire, int P,
                 Kappa src, const unsigned* __restrict__ words,
                 float* __restrict__ scale, uint8_t* __restrict__ q) {
  const long long items = static_cast<long long>(M) * P;
  for (long long b = blockIdx.x; b < items; b += gridDim.x) {
    const int m = static_cast<int>(b / P), t = static_cast<int>(b % P);
    const TileSpan s =
        tile_span<kBits>(t, n, aligned_start<kBits>(x, q, m, n, wire));
    const float sc = __uint_as_float(max(__ldg(words + m), kTinyBits));
    if (t == 0 && threadIdx.x == 0) scale[m] = sc;
    quantize_tile<kBits>(src, src.state(m),
                         x + static_cast<long long>(m) * n, n, sc,
                         q + static_cast<long long>(m) * wire, s);
  }
}

// a persistent 1-D grid over `items` tiles of `kernel`
template <class K>
int item_grid(K kernel, long long items) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kQThreads,
                                                0);
  return static_cast<int>(
      max(1LL, min(items, 1LL * sms * max(per_sm, 1))));
}

}  // namespace repro
