// The b-bit stochastic quantizer, shared by the plane kernel (K1,
// quantize_plane.cu) and the per-message kernel (K4, quantize_leaf.cu):
// the per-element arithmetic and the fused row kernel that computes each
// row's scale and its levels in one launch.  Only the source of kappa
// differs between K1 and K4 (a Kappa policy: PlaneKappa, LeafKappa).  K4's
// shard form (a rank's shards of a tree's leaves cut over the "model" axis,
// quantize_leaf.cu shard_tree_absmax / shard_tree_quantize) reuses the
// element body with each element's place in the whole leaf (ShardMap).
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

#include <atomic>
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
// one little-endian word, the bytes as the reference stores them; element
// k of the group draws its kappa's bits as bits(k).
template <int kBits, class Bits>
__device__ __forceinline__ uint32_t pack_group(const float4* v, float scale,
                                               Bits bits) {
  constexpr float levels = kBits == 8 ? 127.f : 7.f;
  if (kBits == 8) {
    const float4 a = v[0];
    const uint32_t l0 =
        level8(signed_y(a.x, levels, scale, __uint2float_rn(bits(0))));
    const uint32_t l1 =
        level8(signed_y(a.y, levels, scale, __uint2float_rn(bits(1))));
    const uint32_t l2 =
        level8(signed_y(a.z, levels, scale, __uint2float_rn(bits(2))));
    const uint32_t l3 =
        level8(signed_y(a.w, levels, scale, __uint2float_rn(bits(3))));
    return __byte_perm(__byte_perm(l0, l1, 0x0040),
                       __byte_perm(l2, l3, 0x0040), 0x5410);
  }
  const float4 a = v[0], b = v[1];
  const float e[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t p[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    p[i] = pair_byte(
        nibble4(signed_y(e[2 * i], levels, scale,
                         __uint2float_rn(bits(2 * i)))),
        nibble4(signed_y(e[2 * i + 1], levels, scale,
                         __uint2float_rn(bits(2 * i + 1)))));
  }
  return __byte_perm(__byte_perm(p[0], p[1], 0x0040),
                     __byte_perm(p[2], p[3], 0x0040), 0x5410);
}

// the group at element j of a row, kappa from the source's bits(st, j + k)
template <int kBits, class Kappa>
__device__ __forceinline__ uint32_t quantize_group(const Kappa& src, Pair st,
                                                   const float4* v,
                                                   float scale, uint32_t j) {
  return pack_group<kBits>(v, scale,
                           [&](int k) { return src.bits(st, j + k); });
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
// K4's shard form, grouped: the leaves of one message tree whose rank's
// shards tensor parallelism cut over the "model" axis (and FSDP over
// "data"), one launch a pass
// ---------------------------------------------------------------------------
//
// The scale of a cut leaf is the whole leaf's, so the rank's row max is a
// pass of its own (shard_tree_absmax), the caller all-reduces the cut
// leaves' words with MAX over the agent's ranks, and the quantise pass
// (shard_tree_quantize) takes them.  Each pass walks the tiles (kQTile
// elements of a row) of every leaf of the tree, a leaf's M rows one after
// another, on one persistent grid; a block finds its tile's leaf by a
// binary search over the leaves' first tiles, per tile.  A leaf is an
// entry of a device table of kShardWords words (ShardWord), built by the
// host once per (layouts, rows) and cached (kernels/quantize/ops.py
// shard_plan); the x pointers travel in the launch's parameter block
// (ShardTreeArgs), kMaxLeaves leaves a launch; the keys lie in device
// memory.  A leaf's rows own consecutive word (and scale) slots, the cut
// leaves' first, so that the all-reduce covers one prefix of the words.
// A leaf held whole takes the identity layout and keeps its own rank's
// scale (every rank holds the same leaf): its levels are K4's.
//
// Absmax pass: a tile reduces max |x| of its part of the row as uint32
// bits (tile_max).  A row of one tile writes its word; a row of P > 1
// tiles writes the tile's partial, then, after a __threadfence (release),
// adds one to the row's arrival counter, and the block that arrives last
// reduces the row's P partials (read past L1), writes the word and puts
// the counter back to 0.  The counters are zero when the plan allocates
// them and after every launch, so no call zeroes anything.
//
// Quantise pass: scale = max(word, tiny) (the all-reduced word for a cut
// leaf); element j of a shard row draws jax.random.bits(key, (n_pad,))[g],
// g its flat index in the whole leaf.  The host classifies each layout:
//   class 0: the shard is one run of the whole leaf (cut on its first
//            dim, or every dim before the cut is 1), or a leaf held whole:
//            g = j + base;
//   class 1: one piece along the cut dim: a run of block = ldim * inner
//            elements an outer index, g = j + outer * delta + base;
//   class 2: up to kMaxPieces pieces (local start, global start, length)
//            along the cut dim: j = (outer * ldim + l) * inner + i lies at
//            g = (outer * gdim + l - ls[p] + gs[p]) * inner + i;
//   class 3: two cut dims (FSDP's "data" dim, one piece, and the "model"
//            dim's pieces, either first): class 2 on the inner cut dim,
//            whose outer index is itself cut: outer = (o * ldim2 + a) *
//            mid + c lies at (o * gdim2 + along2(a)) * mid + c, mid the
//            elements between the two cut dims, along2 the outer cut
//            dim's pieces.
// The quantise loop is instantiated per class.  A group of 4 (b=8) or 8
// (b=4) elements works out its first element's place once, by a
// multiply-high by constants the host computed (fast_div), and steps to
// the others; the elements outside the groups map one at a time by the
// same multiply-highs.  No element divides.  The host checks that the
// whole leaf has fewer than 2^32 elements, at most kMaxPieces pieces that
// cover the local dim, and each leaf's x against its entry.

constexpr int kMaxPieces = 4;
constexpr int kMaxLeaves = 128;  // a launch's leaves (ShardTreeArgs)

// a table entry's words (kernels/quantize/ops.py mirrors them)
enum ShardWord {
  kSwN = 0,   // the shard's elements a row
  kSwTiles,   // tiles a row
  kSwFirst,   // the leaf's first tile in the launch
  kSwSlot,    // its first row's word and scale slot
  kSwKey,     // its index in the tree: row m's key is m * leaves + this
  kSwQ8,      // its q's byte offset at b=8
  kSwQ4,      // ... and at b=4
  kSwClass,   // 0, 1, 2 (see above)
  kSwBase,    // class 0 and 1: g of local element 0
  kSwDelta,   // class 1: (gdim - ldim) * inner
  kSwBlock,   // ldim * inner
  kSwBlockM,  // its fast_div constants
  kSwBlockS,
  kSwInner,   // the elements past the cut dim
  kSwInnerM,  // its fast_div constants
  kSwInnerS,
  kSwGdim,    // the whole leaf's cut dim
  kSwLdim,    // the shard's
  kSwPieces,
  kSwLs,                     // pieces' local starts
  kSwGs = kSwLs + kMaxPieces,  // global starts
  kSwLen = kSwGs + kMaxPieces,  // lengths
  kSwMid = kSwLen + kMaxPieces,  // class 3: the elements between the cuts
  kSwMidM,                    // its fast_div constants
  kSwMidS,
  kSwLdim2,                   // the outer cut dim's local length
  kSwLdim2M,                  // its fast_div constants
  kSwLdim2S,
  kSwGdim2,                   // its whole length
  kSwPieces2,
  kSwLs2,                       // its pieces' local starts
  kSwGs2 = kSwLs2 + kMaxPieces,  // global starts
  kSwLen2 = kSwGs2 + kMaxPieces,  // lengths
  kShardWords = 64
};
static_assert(kSwLen2 + kMaxPieces <= kShardWords, "table entry");

// n / d for every 32-bit n by a multiply-high, with the host's constants
// m and s = s1 | s2 << 8 of d (Granlund and Montgomery 1994, fig. 4.1: l =
// ceil(log2 d), m = floor(2^32 (2^l - d) / d) + 1, s1 = min(l, 1), s2 =
// max(l - 1, 0))
__device__ __forceinline__ uint32_t fast_div(uint32_t n, uint32_t m,
                                             uint32_t s) {
  const uint32_t t = __umulhi(n, m);
  return (t + ((n - t) >> (s & 0xFFu))) >> (s >> 8);
}

// where a shard's local element j lies in the whole leaf, for class kClass
template <int kClass>
struct ShardMap {
  uint32_t base, delta, block, bm, bs, inner, im, is, gdim, ldim;
  int pieces;
  uint32_t ls[kMaxPieces], gs[kMaxPieces], len[kMaxPieces];
  // class 3: the outer cut dim
  uint32_t mid, mm, ms, ldim2, l2m, l2s, gdim2;
  int pieces2;
  uint32_t ls2[kMaxPieces], gs2[kMaxPieces], len2[kMaxPieces];

  __device__ __forceinline__ explicit ShardMap(const uint32_t* e) {
    base = __ldg(e + kSwBase);
    delta = __ldg(e + kSwDelta);
    block = __ldg(e + kSwBlock);
    bm = __ldg(e + kSwBlockM);
    bs = __ldg(e + kSwBlockS);
    inner = __ldg(e + kSwInner);
    im = __ldg(e + kSwInnerM);
    is = __ldg(e + kSwInnerS);
    gdim = __ldg(e + kSwGdim);
    ldim = __ldg(e + kSwLdim);
    pieces = static_cast<int>(__ldg(e + kSwPieces));
#pragma unroll
    for (int p = 0; p < kMaxPieces; ++p) {
      ls[p] = __ldg(e + kSwLs + p);
      gs[p] = __ldg(e + kSwGs + p);
      len[p] = __ldg(e + kSwLen + p);
    }
    if (kClass == 3) {
      mid = __ldg(e + kSwMid);
      mm = __ldg(e + kSwMidM);
      ms = __ldg(e + kSwMidS);
      ldim2 = __ldg(e + kSwLdim2);
      l2m = __ldg(e + kSwLdim2M);
      l2s = __ldg(e + kSwLdim2S);
      gdim2 = __ldg(e + kSwGdim2);
      pieces2 = static_cast<int>(__ldg(e + kSwPieces2));
#pragma unroll
      for (int p = 0; p < kMaxPieces; ++p) {
        ls2[p] = __ldg(e + kSwLs2 + p);
        gs2[p] = __ldg(e + kSwGs2 + p);
        len2[p] = __ldg(e + kSwLen2 + p);
      }
    }
  }

  // the whole leaf's index along the cut dim of local index l (class 2)
  __device__ __forceinline__ uint32_t along(uint32_t l) const {
    uint32_t g = l;
#pragma unroll
    for (int p = 0; p < kMaxPieces; ++p) {
      if (p < pieces && l - ls[p] < len[p]) g = l - ls[p] + gs[p];
    }
    return g;
  }

  // ... and along the outer cut dim (class 3)
  __device__ __forceinline__ uint32_t along2(uint32_t a) const {
    uint32_t g = a;
#pragma unroll
    for (int p = 0; p < kMaxPieces; ++p) {
      if (p < pieces2 && a - ls2[p] < len2[p]) g = a - ls2[p] + gs2[p];
    }
    return g;
  }

  // class 3: the local outer index (o, a, c) -> the whole leaf's
  __device__ __forceinline__ uint32_t outer_at(uint32_t o, uint32_t a,
                                               uint32_t c) const {
    return (o * gdim2 + along2(a)) * mid + c;
  }

  // g of one element
  __device__ __forceinline__ uint32_t one(uint32_t j) const {
    if (kClass == 0) return j + base;
    const uint32_t outer = fast_div(j, bm, bs);
    if (kClass == 1) return j + outer * delta + base;
    const uint32_t rem = j - outer * block;
    const uint32_t l = fast_div(rem, im, is);
    uint32_t go = outer;
    if (kClass == 3) {
      const uint32_t t = fast_div(outer, mm, ms);
      const uint32_t o = fast_div(t, l2m, l2s);
      go = outer_at(o, t - o * ldim2, outer - t * mid);
    }
    return (go * gdim + along(l)) * inner + (rem - l * inner);
  }

  // g of elements j .. j + G - 1: the first's place once, then steps
  template <int G>
  __device__ __forceinline__ void run(uint32_t j, uint32_t (&g)[G]) const {
    if (kClass == 0) {
#pragma unroll
      for (int k = 0; k < G; ++k) g[k] = j + base + k;
      return;
    }
    uint32_t outer = fast_div(j, bm, bs);
    uint32_t r = j - outer * block;  // the place in the run
    if (kClass == 1) {
      uint32_t v = j + outer * delta + base;
#pragma unroll
      for (int k = 0; k < G; ++k) {
        g[k] = v;
        ++v;
        if (++r == block) {
          r = 0;
          v += delta;
        }
      }
      return;
    }
    uint32_t l = fast_div(r, im, is);
    uint32_t i = r - l * inner;
    if (kClass == 2) {
#pragma unroll
      for (int k = 0; k < G; ++k) {
        g[k] = (outer * gdim + along(l)) * inner + i;
        if (++i == inner) {
          i = 0;
          if (++l == ldim) {
            l = 0;
            ++outer;
          }
        }
      }
      return;
    }
    // class 3: the outer index as (o, a, c), stepped with the rest
    const uint32_t t = fast_div(outer, mm, ms);
    uint32_t o = fast_div(t, l2m, l2s);
    uint32_t a = t - o * ldim2, c = outer - t * mid;
#pragma unroll
    for (int k = 0; k < G; ++k) {
      g[k] = (outer_at(o, a, c) * gdim + along(l)) * inner + i;
      if (++i == inner) {
        i = 0;
        if (++l == ldim) {
          l = 0;
          if (++c == mid) {
            c = 0;
            if (++a == ldim2) {
              a = 0;
              ++o;
            }
          }
        }
      }
    }
  }
};

// the elements outside the groups draw through a Kappa of their own
template <int kClass>
struct MapKappa {
  ShardMap<kClass> map;
  __device__ __forceinline__ uint32_t bits(Pair st, uint32_t j) const {
    return jax_bits(st.x0, st.x1, map.one(j));
  }
};

// a tile of a shard row at the row's scale (quantize_tile's walk)
template <int kBits, int kClass>
__device__ __forceinline__ void shard_tile(const uint32_t* entry, Pair st,
                                           const float* __restrict__ xr,
                                           int n, float scale,
                                           uint8_t* __restrict__ qr,
                                           TileSpan s) {
  const ShardMap<kClass> map(entry);
  constexpr int g = kBits == 8 ? 4 : 8;
  const int ng = (s.b - s.a) / g;
  const float4* v = reinterpret_cast<const float4*>(xr + s.a);
  uint32_t* w = reinterpret_cast<uint32_t*>(qr + (kBits == 8 ? s.a : s.a / 2));
#pragma unroll(4)
  for (int k = 0; k < kQTile / g / kQThreads; ++k) {
    const int i = threadIdx.x + k * kQThreads;
    if (i < ng) {
      float4 f[g / 4];
#pragma unroll
      for (int h = 0; h < g / 4; ++h) f[h] = __ldg(v + (g / 4) * i + h);
      uint32_t at[g];
      map.run(static_cast<uint32_t>(s.a + g * i), at);
      w[i] = pack_group<kBits>(
          f, scale, [&](int e) { return jax_bits(st.x0, st.x1, at[e]); });
    }
  }
  const MapKappa<kClass> src{map};
  quantize_scalar<kBits>(src, st, xr, n, scale, qr, s.lo, s.a);
  quantize_scalar<kBits>(src, st, xr, n, scale, qr, s.b, s.hi);
}

// one launch of a pass over the leaves of a tree (at most kMaxLeaves)
struct ShardTreeArgs {
  const uint32_t* table;   // kShardWords a leaf
  int leaves;              // this launch's
  unsigned tiles;          // this launch's
  int key_stride;          // the tree's leaves
  const uint32_t* keys;    // (k0, k1) by row m and leaf: m * leaves + key
  const unsigned* reduced;  // the all-reduced words of slots < cut
  unsigned cut;
  unsigned* words;         // absmax: written; quantise: slots >= cut
  unsigned* counters;      // absmax: an arrival counter a slot (zero)
  unsigned* partials;      // absmax: a partial a tile of the launch
  float* scale;            // quantise: by slot
  uint8_t* q;              // quantise: the leaves' q at their offsets
  const float* x[kMaxLeaves];
};

// the leaf of tile b: the last entry whose first tile is at most b
__device__ __forceinline__ int tile_leaf(const ShardTreeArgs& a, unsigned b) {
  int lo = 0, hi = a.leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(a.table + mid * kShardWords + kSwFirst) <= b) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

__global__ __launch_bounds__(kQThreads) void shard_tree_absmax(
    const ShardTreeArgs a) {
  __shared__ unsigned red[kQThreads / 32];
  __shared__ bool last;
  for (unsigned b = blockIdx.x; b < a.tiles; b += gridDim.x) {
    const int e = tile_leaf(a, b);
    const uint32_t* en = a.table + e * kShardWords;
    const int n = static_cast<int>(__ldg(en + kSwN));
    const int P = static_cast<int>(__ldg(en + kSwTiles));
    const unsigned u = b - __ldg(en + kSwFirst);
    const int m = static_cast<int>(u / P), t = static_cast<int>(u % P);
    const unsigned slot = __ldg(en + kSwSlot) + m;
    const float* x = a.x[e];
    const TileSpan s = tile_span<8>(t, n, aligned_start<8>(x, x, m, n, n));
    const unsigned mx =
        tile_max<8>(x + static_cast<long long>(m) * n, s, red);
    if (P == 1) {
      if (threadIdx.x == 0) a.words[slot] = mx;
    } else {
      if (threadIdx.x == 0) {
        a.partials[b] = mx;
        __threadfence();
        last = atomicAdd(a.counters + slot, 1u) ==
               static_cast<unsigned>(P - 1);
      }
      __syncthreads();
      if (last) {  // the row's other tiles have written their partials
        __threadfence();
        const unsigned* row = a.partials + (b - t);
        unsigned v = 0;
        for (int k = threadIdx.x; k < P; k += kQThreads) {
          v = max(v, __ldcg(row + k));
        }
        v = __reduce_max_sync(0xFFFFFFFFu, v);
        if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
        __syncthreads();
        if (threadIdx.x == 0) {
#pragma unroll
          for (int w = 0; w < kQThreads / 32; ++w) v = max(v, red[w]);
          a.words[slot] = v;
          a.counters[slot] = 0u;
        }
      }
    }
    __syncthreads();  // red and last are reused by the next tile
  }
}

template <int kBits>
__global__ __launch_bounds__(kQThreads) void shard_tree_quantize(
    const ShardTreeArgs a) {
  for (unsigned b = blockIdx.x; b < a.tiles; b += gridDim.x) {
    const int e = tile_leaf(a, b);
    const uint32_t* en = a.table + e * kShardWords;
    const int n = static_cast<int>(__ldg(en + kSwN));
    const int wire = kBits == 8 ? n : (n + 1) / 2;
    const int P = static_cast<int>(__ldg(en + kSwTiles));
    const unsigned u = b - __ldg(en + kSwFirst);
    const int m = static_cast<int>(u / P), t = static_cast<int>(u % P);
    const unsigned slot = __ldg(en + kSwSlot) + m;
    const unsigned word =
        slot < a.cut ? __ldg(a.reduced + slot) : __ldg(a.words + slot);
    const float sc = __uint_as_float(max(word, kTinyBits));
    if (t == 0 && threadIdx.x == 0) a.scale[slot] = sc;
    const unsigned key =
        static_cast<unsigned>(m) * a.key_stride + __ldg(en + kSwKey);
    const Pair st{__ldg(a.keys + 2 * key), __ldg(a.keys + 2 * key + 1)};
    const float* x = a.x[e];
    uint8_t* q = a.q + __ldg(en + (kBits == 8 ? kSwQ8 : kSwQ4));
    const TileSpan s =
        tile_span<kBits>(t, n, aligned_start<kBits>(x, q, m, n, wire));
    const float* xr = x + static_cast<long long>(m) * n;
    uint8_t* qr = q + static_cast<long long>(m) * wire;
    switch (__ldg(en + kSwClass)) {
      case 0:
        shard_tile<kBits, 0>(en, st, xr, n, sc, qr, s);
        break;
      case 1:
        shard_tile<kBits, 1>(en, st, xr, n, sc, qr, s);
        break;
      case 2:
        shard_tile<kBits, 2>(en, st, xr, n, sc, qr, s);
        break;
      default:
        shard_tile<kBits, 3>(en, st, xr, n, sc, qr, s);
    }
  }
}

// Blocks of a persistent grid over `items` tiles of `kernel` (slot `id`
// of the cache): the SM count times the kernel's occupancy, asked of the
// driver once per kernel and device.
constexpr int kGridKernels = 4, kGridDevices = 16;

template <class K>
int persistent_grid(K kernel, int id, long long items) {
  static std::atomic<int> cache[kGridKernels][kGridDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  int full = dev < kGridDevices ? cache[id][dev].load() : 0;
  if (full == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kQThreads,
                                                  0);
    full = max(1, sms * max(per_sm, 1));
    if (dev < kGridDevices) cache[id][dev].store(full);
  }
  return static_cast<int>(max(1LL, min(items, static_cast<long long>(full))));
}

}  // namespace repro
