#!/usr/bin/env python3
"""Time the fused quantisers K1 (``quantize_plane``) and K4
(``quantize_tensor``) at the main path's shapes beside their first
designs and beside builds of the fused kernel with other sizes; and the
dequantiser K5 (both forms) and K0's test entry beside theirs.

    python3 tools/quantize_probe.py [--tree PATH ...]

The first designs (K1 of slice 1, K4 of slice 2) took each row's scale
from a separate PyTorch pass (``torch.amax(x.abs(), -1).clamp_min(tiny)``)
and launched one block per 8,192 elements of a row on a 2-D grid
(``grid.y`` = the row, so at most 65,535 rows), one element a thread a
step: a 4-byte load, a Threefry block, the division, a 1-byte store (b=4:
one byte a pair).  They live here, built from ``SOURCE``, as the
yardstick: ``chip_smoke.py`` builds this file's base library in its build
phase, holds the first designs bit for bit against the plain versions and
times them beside the package in turns.  Their arithmetic is theirs, with
the .ftz steps (``csrc/quantize.cuh`` ``mul_ftz``, ``div_ftz``, and an
``add_ftz`` here) that the reference's subnormal flush asks for, so that
on the same scale they give the same bits.

``build`` compiles ``SOURCE`` once as the package has ``quantize.cuh``
and ``threefry.cuh`` ("base") and once for each entry of ``VARIANTS``:
copies of the two headers with a size or a step changed (the tile a
ticket covers; the ~16 MB of rows whose x stays in L2 between their max
and quantise tiles; the quantise loop's unrolling; a floor of 6 blocks an
SM on the register budget; Threefry's rotations, all of them or two of
them, on the FMA pipe), and once with the headers of each ``--tree``
(another checkout, e.g. a parent commit
unpacked with ``git archive``, so that two versions of the fused kernel
are timed in turns in one process), one ``nvcc`` each, all started
together.  The fused kernel of each build is reached through the C
entries ``probe_plane`` / ``probe_leaf`` (the package's
``quantize_plane`` / ``quantize_leaf``).  It also compiles the package's
``quantize_leaf.cu`` and ``threefry_bits.cu`` once for each entry of
``PACKAGE_VARIANTS`` (K5 with other quads a thread, write-back stores,
streaming loads; K0's entry with more counters a thread or more threads
a block), each its own library.

The first design of K4's shard form (PR 30; C entries
``leaf_absmax_first`` and ``quantize_leaf_shard_first``, ``first_shard``)
took one leaf a call in two launches: a memset and an atomicMax pass for
the row max, then the levels, each element mapping its local index to
the whole leaf's by two 32-bit divisions (``ShardKappa``), the grid sized
by an occupancy query every launch.  ``chip_smoke.py``'s tp timing holds
it bit for bit and times it in turns beside the grouped form.

The first K5 (C entry ``dequantize_leaf_first``) gave each thread one
element a step, a 1-byte load and a 4-byte store, on a 2-D grid
(``grid.y`` = the row); the first K0 entry (``threefry_bits_first``)
folded the message seed in every thread, with 64-bit indices.  Built
with a ``--tree``'s headers, ``threefry_bits_first`` is that tree's K0
entry with its cipher.

``main`` times, at K1's [20, 2^20] (b = 8 and 4) and [150, 2^20]
(drop0.3's x/z-plane) and K4's [10, 2^20] and [20, 2^20 - 4096] (the ring
tree's big leaf): the package's wrapper and bare entry, the first
design's wrapper (scale pass + kernel) and bare kernel, the scale pass
alone, and each variant's bare entry, every candidate checked bit for bit
(q and scale) against the plain version first, each timed twice in turns
(forward, then backward); K5 at [10, 2^20] b=8 (multiply form) and
[150, 2^20] b=8, [20, 2^20] b=8 and 4 (division form; also the
multiply form at [150, 2^20]), the package beside its first design and
its variant builds, and K0 at 8 seeds x 2^20 counters beside the first
design of every build and the entry's variant builds, the same way; the
cipher's issue rate by the SM's own clock (``clock64``), Threefry blocks
a clock per SM as K1 and as K4 draw them, 1, 2 and 4 independent chains
a thread, one block of 1,024 threads an SM, each build's cipher; then
nvidia-smi's SM clock and power draw, sampled while the fused K1 runs
at [150, 2^20] for ~2 s.  Needs a CUDA
card and nvcc; prints one JSON object as its last line.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

# builds of the package's headers with other sizes or steps: name ->
# [(header, the package's line, its line in the copy)]
_TILE = "constexpr int kQTile = 8192;"
_L2 = "(16LL << 20) / row_bytes"
_ROT = "  return (x << r) | (x >> (32 - r));"
_UNROLL = "#pragma unroll 4\n  for (int k = 0; k < kQTile"
_BOUNDS = "__global__ void __launch_bounds__(kQThreads)"
_ROT1 = ("#define REPRO_TF_ROT1 REPRO_TF_MIX(17) REPRO_TF_MIX(29) "
         "REPRO_TF_MIX(16) REPRO_TF_MIX(24)")
VARIANTS = {
    "base": [],
    "tile4096": [("quantize.cuh", _TILE, _TILE.replace("8192", "4096"))],
    "l2_32mb": [("quantize.cuh", _L2, _L2.replace("16LL", "32LL"))],
    "unroll2": [("quantize.cuh", _UNROLL, _UNROLL.replace("4", "2"))],
    "blocks6": [("quantize.cuh", _BOUNDS,
                 _BOUNDS.replace("(kQThreads)", "(kQThreads, 6)"))],
    # Threefry's rotations as a 32 x 32 -> 64 multiply by 2^r (the FMA
    # pipe) whose halves the following xor joins, instead of a funnel
    # shift (the ALU pipe)
    "rot_imad": [("threefry.cuh", _ROT, """  unsigned long long w;
  asm("mul.wide.u32 %0, %1, %2;" : "=l"(w) : "r"(x), "r"(1u << r));
  return static_cast<uint32_t>(w) | static_cast<uint32_t>(w >> 32);""")],
    # the first rotation of rounds 5 and 13 (ROT1's first mix) on the FMA
    # pipe, as x * 2^r + hi(x * 2^r) (IMAD and IMAD.HI by a multiplier
    # ptxas cannot fold), to balance the block's ALU and FMA pipes
    "rot_split": [("threefry.cuh", _ROT1, r"""
__device__ __forceinline__ uint32_t rotl_fma(uint32_t x, int r) {
  const uint32_t p = kFmaOne << r;
  uint32_t hi, lo;
  asm("mul.hi.u32 %0, %1, %2;" : "=r"(hi) : "r"(x), "r"(p));
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(lo) : "r"(x), "r"(p), "r"(hi));
  return lo;
}
#define REPRO_TF_MIXM(r) x0 = add_fma(x0, x1); x1 = rotl_fma(x1, r) ^ x0;
#define REPRO_TF_ROT1 \
  REPRO_TF_MIXM(17) REPRO_TF_MIX(29) REPRO_TF_MIX(16) REPRO_TF_MIX(24)""")],
}

# builds of the package's K5 (csrc/quantize_leaf.cu, C entry
# dequantize_leaf) and of K0's test entry (csrc/threefry_bits.cu, C entry
# threefry_bits) with other sizes or steps: name -> (source, [(its line,
# the copy's)])
_QUADS = "constexpr int kDqQuads = 2;"
_STORE = "  __stcs(p, v);"
_LOAD = "lo[h] = __ldg(qw + word);"
_K0_PER = "constexpr int kPerThread = 8;"
_K0_THREADS = "constexpr int kThreads = 256;"
PACKAGE_VARIANTS = {
    "k5 quads1": ("quantize_leaf.cu", [(_QUADS, _QUADS.replace("2", "1"))]),
    "k5 quads4": ("quantize_leaf.cu", [(_QUADS, _QUADS.replace("2", "4"))]),
    "k5 quads8": ("quantize_leaf.cu", [(_QUADS, _QUADS.replace("2", "8"))]),
    # write-back stores of out instead of streaming ones
    "k5 store_wb": ("quantize_leaf.cu", [(_STORE, "  *p = v;")]),
    # streaming loads of q too
    "k5 ldcs": ("quantize_leaf.cu",
                [(_LOAD, _LOAD.replace("__ldg", "__ldcs"))]),
    # K0's entry with 32 counters a thread, or 1,024 threads a block
    "k0 per32": ("threefry_bits.cu",
                 [(_K0_PER, _K0_PER.replace("8", "32"))]),
    "k0 threads1024": ("threefry_bits.cu",
                       [(_K0_THREADS, _K0_THREADS.replace("256", "1024"))]),
}
PACKAGE_ENTRIES = {"quantize_leaf.cu": "dequantize_leaf",
                   "threefry_bits.cu": "threefry_bits"}

SOURCE = r"""
#include <cuda_runtime.h>

#include "quantize.cuh"

namespace {

__device__ __forceinline__ float add_ftz(float a, float b) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// the first designs' per-element arithmetic, with the .ftz steps of the
// reference's XLA arithmetic: q = sign(x) * floor(levels |x| / scale +
// kappa), converted as XLA converts
__device__ __forceinline__ float quantize_one(float x, float levels,
                                              float scale, float kappa) {
  const float xf = repro::mul_ftz(x, 1.f);
  const float y = add_ftz(
      repro::div_ftz(repro::mul_ftz(levels, fabsf(xf)), scale), kappa);
  const float s = xf > 0.f ? 1.f : (xf < 0.f ? -1.f : xf);
  return repro::mul_ftz(s, floorf(y));
}

__device__ __forceinline__ int to_int_sat(float q, float lo, float hi) {
  if (q != q) return 0;
  return static_cast<int>(fminf(fmaxf(q, lo), hi));
}

__device__ __forceinline__ int nibble(float q) {
  return (q != q ? 0 : static_cast<int>(q)) + 8;
}

constexpr int kThreads = 256;
constexpr int kPerThread = 32;
constexpr int kTile = kThreads * kPerThread;

// K1, first design: one element a thread a step, the scale given
__global__ void quantize8_kernel(const float* __restrict__ x, int n,
                                 uint32_t s0, uint32_t s1,
                                 const uint32_t* __restrict__ sids,
                                 const uint32_t* __restrict__ rids,
                                 const float* __restrict__ scale,
                                 int8_t* __restrict__ q) {
  const int m = blockIdx.y;
  const repro::Pair es = repro::message_seed(
      s0, s1, repro::id_or(sids, m, 0u),
      repro::id_or(rids, m, repro::kBroadcast));
  const float sc = scale[m];
  const float* xr = x + static_cast<long long>(m) * n;
  int8_t* qr = q + static_cast<long long>(m) * n;
  const int base = blockIdx.x * kTile + threadIdx.x;
#pragma unroll 4
  for (int i = 0; i < kPerThread; ++i) {
    const int j = base + i * kThreads;
    if (j < n) {
      const float kappa = repro::uniform01(
          repro::random_bits(es, static_cast<uint32_t>(j)));
      const float v = quantize_one(xr[j], 127.f, sc, kappa);
      qr[j] = static_cast<int8_t>(to_int_sat(v, -128.f, 127.f));
    }
  }
}

__global__ void quantize4_kernel(const float* __restrict__ x, int n, int wire,
                                 uint32_t s0, uint32_t s1,
                                 const uint32_t* __restrict__ sids,
                                 const uint32_t* __restrict__ rids,
                                 const float* __restrict__ scale,
                                 uint8_t* __restrict__ q) {
  const int m = blockIdx.y;
  const repro::Pair es = repro::message_seed(
      s0, s1, repro::id_or(sids, m, 0u),
      repro::id_or(rids, m, repro::kBroadcast));
  const float sc = scale[m];
  const float* xr = x + static_cast<long long>(m) * n;
  uint8_t* qr = q + static_cast<long long>(m) * wire;
  const int base = blockIdx.x * kTile + threadIdx.x;
#pragma unroll 4
  for (int i = 0; i < kPerThread; ++i) {
    const int p = base + i * kThreads;
    if (p < wire) {
      int nib[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 2 * p + h;
        float v = 0.f;
        if (j < n) {
          const float kappa = repro::uniform01(
              repro::random_bits(es, static_cast<uint32_t>(j)));
          v = quantize_one(xr[j], 7.f, sc, kappa);
        }
        nib[h] = nibble(v);
      }
      qr[p] = static_cast<uint8_t>((nib[0] << 4) | nib[1]);
    }
  }
}

// K4, first design
__device__ __forceinline__ float kappa_at(uint32_t k0, uint32_t k1, int j) {
  return repro::uniform01(repro::jax_bits(k0, k1, static_cast<uint32_t>(j)));
}

__global__ void quantize8_leaf(const float* __restrict__ x, int n,
                               const uint32_t* __restrict__ keys,
                               const float* __restrict__ scale,
                               int8_t* __restrict__ q) {
  const int m = blockIdx.y;
  const uint32_t k0 = keys[2 * m], k1 = keys[2 * m + 1];
  const float sc = scale[m];
  const float* xr = x + static_cast<long long>(m) * n;
  int8_t* qr = q + static_cast<long long>(m) * n;
  const int base = blockIdx.x * kTile + threadIdx.x;
#pragma unroll 4
  for (int i = 0; i < kPerThread; ++i) {
    const int j = base + i * kThreads;
    if (j < n) {
      const float v = quantize_one(xr[j], 127.f, sc, kappa_at(k0, k1, j));
      qr[j] = static_cast<int8_t>(to_int_sat(v, -128.f, 127.f));
    }
  }
}

__global__ void quantize4_leaf(const float* __restrict__ x, int n, int wire,
                               const uint32_t* __restrict__ keys,
                               const float* __restrict__ scale,
                               uint8_t* __restrict__ q) {
  const int m = blockIdx.y;
  const uint32_t k0 = keys[2 * m], k1 = keys[2 * m + 1];
  const float sc = scale[m];
  const float* xr = x + static_cast<long long>(m) * n;
  uint8_t* qr = q + static_cast<long long>(m) * wire;
  const int base = blockIdx.x * kTile + threadIdx.x;
#pragma unroll 4
  for (int i = 0; i < kPerThread; ++i) {
    const int p = base + i * kThreads;
    if (p < wire) {
      int nib[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 2 * p + h;
        const float v =
            j < n ? quantize_one(xr[j], 7.f, sc, kappa_at(k0, k1, j)) : 0.f;
        nib[h] = nibble(v);
      }
      qr[p] = static_cast<uint8_t>((nib[0] << 4) | nib[1]);
    }
  }
}

bool bad_shape(int M, int n, int bits, int wire) {
  return M <= 0 || M > 65535 || n <= 0 ||
         !((bits == 8 && wire == n) || (bits == 4 && wire == (n + 1) / 2));
}

// K5, first design: one element a thread a step (a 1-byte load, a 4-byte
// store), a 2-D grid (grid.y = the row); plane = 1 divides by levels
constexpr float kInv127 = 0x1.020408p-7f;
constexpr float kInv7 = 0x1.24924ap-3f;

template <bool kDiv>
__device__ __forceinline__ float dequantize_one(float sc, float v,
                                                float levels, float inv) {
  const float p = repro::mul_ftz(sc, v);
  return kDiv ? repro::div_ftz(p, levels) : repro::mul_ftz(p, inv);
}

template <bool kDiv>
__global__ void dequantize8_leaf(const int8_t* __restrict__ q, int n,
                                 const float* __restrict__ scale,
                                 float* __restrict__ out) {
  const int m = blockIdx.y;
  const float sc = scale[m];
  const int8_t* qr = q + static_cast<long long>(m) * n;
  float* orow = out + static_cast<long long>(m) * n;
  const int base = blockIdx.x * kTile + threadIdx.x;
#pragma unroll 4
  for (int i = 0; i < kPerThread; ++i) {
    const int j = base + i * kThreads;
    if (j < n) {
      orow[j] = dequantize_one<kDiv>(sc, static_cast<float>(qr[j]), 127.f,
                                     kInv127);
    }
  }
}

template <bool kDiv>
__global__ void dequantize4_leaf(const uint8_t* __restrict__ q, int n,
                                 int wire, const float* __restrict__ scale,
                                 float* __restrict__ out) {
  const int m = blockIdx.y;
  const float sc = scale[m];
  const uint8_t* qr = q + static_cast<long long>(m) * wire;
  float* orow = out + static_cast<long long>(m) * n;
  const int base = blockIdx.x * kTile + threadIdx.x;
#pragma unroll 4
  for (int i = 0; i < kPerThread; ++i) {
    const int j = base + i * kThreads;
    if (j < n) {
      const int byte = qr[j >> 1];
      const int level = ((j & 1) ? (byte & 0xF) : (byte >> 4)) - 8;
      orow[j] = dequantize_one<kDiv>(sc, static_cast<float>(level), 7.f,
                                     kInv7);
    }
  }
}

// K0's test entry, first design: every thread folds its message's seed
// (two Threefry blocks) before its 8 counters, 64-bit indices
constexpr int kBitsPerThread = 8;

__global__ void threefry_bits_first_kernel(
    uint32_t s0, uint32_t s1, const uint32_t* __restrict__ sids,
    const uint32_t* __restrict__ rids, const uint32_t* __restrict__ ctr,
    int C, int n, int n_strides, uint32_t* __restrict__ bits,
    int32_t* __restrict__ off, int32_t* __restrict__ slot) {
  const int b = blockIdx.y;
  const repro::Pair es = repro::message_seed(s0, s1, sids[b], rids[b]);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const repro::Pair ob = repro::offset_block(es);
    off[b] = static_cast<int32_t>(ob.x0 % static_cast<uint32_t>(n));
    slot[b] = static_cast<int32_t>(ob.x1 % static_cast<uint32_t>(n_strides));
  }
  const long long base =
      static_cast<long long>(blockIdx.x) * kThreads * kBitsPerThread +
      threadIdx.x;
#pragma unroll
  for (int i = 0; i < kBitsPerThread; ++i) {
    const long long c = base + static_cast<long long>(i) * kThreads;
    if (c < C) {
      bits[static_cast<long long>(b) * C + c] = repro::random_bits(es, ctr[c]);
    }
  }
}

// The cipher's issue rate, by the SM's own clock: kChains independent
// chains of Threefry blocks a thread (each block's output the next one's
// counter), as K1 draws a block (random_bits: seed fixed, counter word 1
// zero, word 0 kept) or as K4 does (jax_bits); one block of 1024 threads
// an SM (32 warps).
template <int kChains, bool kLeaf>
__global__ void __launch_bounds__(1024, 1)
cipher_rate_kernel(uint32_t s0, uint32_t s1, int iters, uint32_t* out,
                   long long* cycles) {
  const repro::Pair es{s0, s1};
  uint32_t c[kChains];
#pragma unroll
  for (int i = 0; i < kChains; ++i) {
    c[i] = (blockIdx.x * 1024u + threadIdx.x) * kChains + i;
  }
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < kChains; ++i) {
      c[i] = kLeaf ? repro::jax_bits(s0, s1, c[i])
                   : repro::random_bits(es, c[i]);
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  uint32_t x = 0;
#pragma unroll
  for (int i = 0; i < kChains; ++i) x ^= c[i];
  out[blockIdx.x * 1024 + threadIdx.x] = x;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

// K4's shard form, first design (PR 30): two launches a leaf.  Each
// element maps its local index to the whole leaf's by two 32-bit
// divisions (ShardKappa: the shard is the whole leaf but along the cut
// dim, where it holds at most kShardPieces pieces, each (local start,
// global start, length)); the max pass atomicMax-es into words that a
// memset zeroed; the grid asks the driver for the occupancy every launch.
constexpr int kShardPieces = 4;

struct ShardKappa {
  const uint32_t* keys;
  uint32_t inner, gdim, ldim;
  int pieces;
  uint32_t ls[kShardPieces], gs[kShardPieces], len[kShardPieces];
  __device__ __forceinline__ repro::Pair state(int m) const {
    return repro::Pair{keys[2 * m], keys[2 * m + 1]};
  }
  __device__ __forceinline__ uint32_t global(uint32_t j) const {
    const uint32_t block = ldim * inner;
    const uint32_t outer = j / block;
    const uint32_t rem = j - outer * block;
    const uint32_t l = rem / inner;
    const uint32_t i = rem - l * inner;
    uint32_t g = l;
#pragma unroll
    for (int p = 0; p < kShardPieces; ++p) {
      if (p < pieces && l - ls[p] < len[p]) g = l - ls[p] + gs[p];
    }
    return (outer * gdim + g) * inner + i;
  }
  __device__ __forceinline__ uint32_t bits(repro::Pair st, uint32_t j) const {
    return repro::jax_bits(st.x0, st.x1, global(j));
  }
};

// words[m] = max over row m of the bits of |x| (atomicMax; zeroed before)
__global__ void __launch_bounds__(repro::kQThreads)
rows_absmax_first(const float* __restrict__ x, int M, int n, int P,
                  unsigned* __restrict__ words) {
  __shared__ unsigned red[repro::kQThreads / 32];
  const long long items = static_cast<long long>(M) * P;
  for (long long b = blockIdx.x; b < items; b += gridDim.x) {
    const int m = static_cast<int>(b / P), t = static_cast<int>(b % P);
    const repro::TileSpan s = repro::tile_span<8>(
        t, n, repro::aligned_start<8>(x, x, m, n, n));
    const unsigned mx =
        repro::tile_max<8>(x + static_cast<long long>(m) * n, s, red);
    if (threadIdx.x == 0) atomicMax(words + m, mx);
    __syncthreads();  // red is reused by the next item
  }
}

// q, scale of rows [M, n] at scale max(words[m], tiny): one tile an item
template <int kBits>
__global__ void __launch_bounds__(repro::kQThreads)
quantize_rows_at_first(const float* __restrict__ x, int M, int n, int wire,
                       int P, ShardKappa src,
                       const unsigned* __restrict__ words,
                       float* __restrict__ scale, uint8_t* __restrict__ q) {
  const long long items = static_cast<long long>(M) * P;
  for (long long b = blockIdx.x; b < items; b += gridDim.x) {
    const int m = static_cast<int>(b / P), t = static_cast<int>(b % P);
    const repro::TileSpan s = repro::tile_span<kBits>(
        t, n, repro::aligned_start<kBits>(x, q, m, n, wire));
    const float sc =
        __uint_as_float(max(__ldg(words + m), repro::kTinyBits));
    if (t == 0 && threadIdx.x == 0) scale[m] = sc;
    repro::quantize_tile<kBits>(src, src.state(m),
                                x + static_cast<long long>(m) * n, n, sc,
                                q + static_cast<long long>(m) * wire, s);
  }
}

template <class K>
int item_grid_first(K kernel, long long items) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                repro::kQThreads, 0);
  return static_cast<int>(
      max(1LL, min(items, 1LL * sms * max(per_sm, 1))));
}

}  // namespace

extern "C" int probe_cipher_rate(int leaf, int chains, int blocks, int iters,
                                 void* out, void* cycles, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<uint32_t*>(out);
  auto* c = static_cast<long long*>(cycles);
  const uint32_t s0 = 0x9E3779B9u, s1 = 0x7F4A7C15u;
#define REPRO_RATE(k)                                                        \
  if (chains == k) {                                                         \
    if (leaf) {                                                              \
      cipher_rate_kernel<k, true><<<blocks, 1024, 0, st>>>(s0, s1, iters, o, \
                                                           c);               \
    } else {                                                                 \
      cipher_rate_kernel<k, false><<<blocks, 1024, 0, st>>>(s0, s1, iters,   \
                                                            o, c);           \
    }                                                                        \
    return static_cast<int>(cudaGetLastError());                             \
  }
  REPRO_RATE(1)
  REPRO_RATE(2)
  REPRO_RATE(4)
#undef REPRO_RATE
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int dequantize_leaf_first(const void* q, int M, int n, int bits,
                                     const void* scale, void* out, int wire,
                                     int plane, void* stream) {
  if (bad_shape(M, n, bits, wire)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* sc = static_cast<const float*>(scale);
  auto* o = static_cast<float*>(out);
  const dim3 grid((n + kTile - 1) / kTile, M);
  const auto* q8 = static_cast<const int8_t*>(q);
  const auto* q4 = static_cast<const uint8_t*>(q);
  if (bits == 8 && plane) {
    dequantize8_leaf<true><<<grid, kThreads, 0, st>>>(q8, n, sc, o);
  } else if (bits == 8) {
    dequantize8_leaf<false><<<grid, kThreads, 0, st>>>(q8, n, sc, o);
  } else if (plane) {
    dequantize4_leaf<true><<<grid, kThreads, 0, st>>>(q4, n, wire, sc, o);
  } else {
    dequantize4_leaf<false><<<grid, kThreads, 0, st>>>(q4, n, wire, sc, o);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int threefry_bits_first(uint32_t s0, uint32_t s1, const void* sids,
                                   const void* rids, const void* ctr, int B,
                                   int C, int n, int n_strides, void* bits,
                                   void* off, void* slot, void* stream) {
  if (B <= 0 || B > 65535 || C <= 0 || n <= 0 || n_strides <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(
      (C + kThreads * kBitsPerThread - 1) / (kThreads * kBitsPerThread), B);
  threefry_bits_first_kernel<<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      s0, s1, static_cast<const uint32_t*>(sids),
      static_cast<const uint32_t*>(rids), static_cast<const uint32_t*>(ctr),
      C, n, n_strides, static_cast<uint32_t*>(bits),
      static_cast<int32_t*>(off), static_cast<int32_t*>(slot));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int quantize_plane_first(const void* x, int M, int n, int bits,
                                    uint32_t s0, uint32_t s1,
                                    const void* sids, const void* rids,
                                    const void* scale, void* q, int wire,
                                    void* stream) {
  if (bad_shape(M, n, bits, wire)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xs = static_cast<const float*>(x);
  const auto* si = static_cast<const uint32_t*>(sids);
  const auto* ri = static_cast<const uint32_t*>(rids);
  const auto* sc = static_cast<const float*>(scale);
  const dim3 grid((wire + kTile - 1) / kTile, M);
  if (bits == 8) {
    quantize8_kernel<<<grid, kThreads, 0, st>>>(xs, n, s0, s1, si, ri, sc,
                                                static_cast<int8_t*>(q));
  } else {
    quantize4_kernel<<<grid, kThreads, 0, st>>>(xs, n, wire, s0, s1, si, ri,
                                                sc, static_cast<uint8_t*>(q));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int quantize_leaf_first(const void* x, int M, int n, int bits,
                                   const void* keys, const void* scale,
                                   void* q, int wire, void* stream) {
  if (bad_shape(M, n, bits, wire)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xs = static_cast<const float*>(x);
  const auto* ks = static_cast<const uint32_t*>(keys);
  const auto* sc = static_cast<const float*>(scale);
  const dim3 grid((wire + kTile - 1) / kTile, M);
  if (bits == 8) {
    quantize8_leaf<<<grid, kThreads, 0, st>>>(xs, n, ks, sc,
                                              static_cast<int8_t*>(q));
  } else {
    quantize4_leaf<<<grid, kThreads, 0, st>>>(xs, n, wire, ks, sc,
                                              static_cast<uint8_t*>(q));
  }
  return static_cast<int>(cudaGetLastError());
}

// K4's shard form, first design: words[m] = the bits of max_j |x[m, j]|
extern "C" int leaf_absmax_first(const void* x, int M, int n, void* words,
                                 void* stream) {
  if (M <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int P = (n + repro::kQTile - 1) / repro::kQTile;
  const cudaError_t e =
      cudaMemsetAsync(words, 0, sizeof(unsigned) * static_cast<size_t>(M), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long items = 1LL * M * P;
  rows_absmax_first<<<item_grid_first(rows_absmax_first, items),
                      repro::kQThreads, 0, st>>>(
      static_cast<const float*>(x), M, n, P, static_cast<unsigned*>(words));
  return static_cast<int>(cudaGetLastError());
}

// ... and its second pass: rows [M, n] of a shard at the scales
// max(words[m], tiny).  desc (host memory): inner, gdim, ldim, pieces,
// then (local start, global start, length) for kShardPieces pieces.
extern "C" int quantize_leaf_shard_first(const void* x, int M, int n,
                                         int bits, const void* keys,
                                         const void* words, const void* desc,
                                         void* scale, void* q, int wire,
                                         void* stream) {
  if (bad_shape(M, n, bits, wire)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* d = static_cast<const int*>(desc);
  ShardKappa src{};
  src.keys = static_cast<const uint32_t*>(keys);
  src.inner = static_cast<uint32_t>(d[0]);
  src.gdim = static_cast<uint32_t>(d[1]);
  src.ldim = static_cast<uint32_t>(d[2]);
  src.pieces = d[3];
  long long local = 0;
  for (int p = 0; p < kShardPieces; ++p) {
    src.ls[p] = static_cast<uint32_t>(d[4 + 3 * p]);
    src.gs[p] = static_cast<uint32_t>(d[5 + 3 * p]);
    src.len[p] = static_cast<uint32_t>(d[6 + 3 * p]);
    if (p < src.pieces) local += d[6 + 3 * p];
  }
  const long long outer =
      d[0] > 0 && d[2] > 0 ? n / (1LL * d[0] * d[2]) : 0;
  if (src.pieces < 1 || src.pieces > kShardPieces || local != d[2] ||
      outer * d[0] * d[2] != n || outer * d[0] * d[1] >= (1LL << 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const int P = (n + repro::kQTile - 1) / repro::kQTile;
  const long long items = 1LL * M * P;
  const auto* xs = static_cast<const float*>(x);
  const auto* w = static_cast<const unsigned*>(words);
  auto* sc = static_cast<float*>(scale);
  auto* qs = static_cast<uint8_t*>(q);
  if (bits == 8) {
    auto k = quantize_rows_at_first<8>;
    k<<<item_grid_first(k, items), repro::kQThreads, 0, st>>>(
        xs, M, n, wire, P, src, w, sc, qs);
  } else {
    auto k = quantize_rows_at_first<4>;
    k<<<item_grid_first(k, items), repro::kQThreads, 0, st>>>(
        xs, M, n, wire, P, src, w, sc, qs);
  }
  return static_cast<int>(cudaGetLastError());
}

// the fused kernel of this build's quantize.cuh (the package's entries)
extern "C" int probe_plane(const void* x, int M, int n, int bits,
                           uint32_t s0, uint32_t s1, const void* sids,
                           const void* rids, void* scale, void* q, int wire,
                           void* scratch, void* stream) {
  const repro::PlaneKappa src{s0, s1, static_cast<const uint32_t*>(sids),
                              static_cast<const uint32_t*>(rids)};
  const auto st = static_cast<cudaStream_t>(stream);
  return bits == 8
             ? repro::launch_quantize_rows<8>(
                   static_cast<const float*>(x), M, n, wire, src,
                   static_cast<float*>(scale), static_cast<uint8_t*>(q),
                   static_cast<unsigned*>(scratch), st)
             : repro::launch_quantize_rows<4>(
                   static_cast<const float*>(x), M, n, wire, src,
                   static_cast<float*>(scale), static_cast<uint8_t*>(q),
                   static_cast<unsigned*>(scratch), st);
}

extern "C" int probe_leaf(const void* x, int M, int n, int bits,
                          const void* keys, void* scale, void* q, int wire,
                          void* scratch, void* stream) {
  const repro::LeafKappa src{static_cast<const uint32_t*>(keys)};
  const auto st = static_cast<cudaStream_t>(stream);
  return bits == 8
             ? repro::launch_quantize_rows<8>(
                   static_cast<const float*>(x), M, n, wire, src,
                   static_cast<float*>(scale), static_cast<uint8_t*>(q),
                   static_cast<unsigned*>(scratch), st)
             : repro::launch_quantize_rows<4>(
                   static_cast<const float*>(x), M, n, wire, src,
                   static_cast<float*>(scale), static_cast<uint8_t*>(q),
                   static_cast<unsigned*>(scratch), st);
}
"""


def build(out_dir, variants=tuple(VARIANTS), trees=(), package=()):
    """Compile ``SOURCE`` once per entry of ``variants`` (names of
    ``VARIANTS``) and once with the headers of each tree of ``trees``
    (roots of other checkouts, named "tree <path>"), and the package's
    source once per entry of ``package`` (names of ``PACKAGE_VARIANTS``),
    one ``nvcc`` each, all started together, into ``out_dir/<name>/``.  Returns ``{name:
    ctypes library}``; raises with nvcc's log if a build fails or a line
    to change is not in the package's header."""
    from pathlib import Path

    from repro_torch.kernels import _build

    jobs = [(name, _build._CSRC, VARIANTS[name]) for name in variants]
    jobs += [(f"tree {t}", Path(t) / "src" / "repro_torch" / "csrc", [])
             for t in trees]
    procs = {}
    for i, (name, csrc, changes) in enumerate(jobs):
        vdir = os.path.join(out_dir, name if i < len(variants) else f"t{i}")
        os.makedirs(vdir, exist_ok=True)
        for header in ("quantize.cuh", "threefry.cuh"):
            text = (csrc / header).read_text()
            for hdr, line, repl in changes:
                if hdr != header:
                    continue
                if text.count(line) != 1:
                    raise RuntimeError(f"{header} has no single {line!r}")
                text = text.replace(line, repl)
            with open(os.path.join(vdir, header), "w") as f:
                f.write(text)
        src = os.path.join(vdir, "quantize_probe.cu")
        lib = os.path.join(vdir, "quantize_probe.so")
        with open(src, "w") as f:
            f.write(SOURCE)
        procs[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", vdir, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    # the package's sources with each PACKAGE_VARIANTS change, a library
    # each
    for name in package:
        source, changes = PACKAGE_VARIANTS[name]
        vdir = os.path.join(out_dir, name.replace(" ", "_"))
        os.makedirs(vdir, exist_ok=True)
        for f in _build._CSRC.glob("*.cuh"):
            with open(os.path.join(vdir, f.name), "w") as out:
                out.write(f.read_text())
        text = (_build._CSRC / source).read_text()
        for line, repl in changes:
            if text.count(line) != 1:
                raise RuntimeError(f"{source} has no single {line!r}")
            text = text.replace(line, repl)
        src = os.path.join(vdir, source)
        lib = os.path.join(vdir, source.replace(".cu", ".so"))
        with open(src, "w") as f:
            f.write(text)
        procs[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    sigs = {
        "quantize_plane_first": [P, I, I, I, U, U, P, P, P, P, I, P],
        "quantize_leaf_first": [P, I, I, I, P, P, P, I, P],
        "probe_plane": [P, I, I, I, U, U, P, P, P, P, I, P, P],
        "probe_leaf": [P, I, I, I, P, P, P, I, P, P],
        "dequantize_leaf_first": [P, I, I, I, P, P, I, I, P],
        "threefry_bits_first": [U, U, P, P, P, I, I, I, I, P, P, P, P],
        "probe_cipher_rate": [I, I, I, I, P, P, P],
        "leaf_absmax_first": [P, I, I, P, P],
        "quantize_leaf_shard_first": [P, I, I, I, P, P, P, P, P, I, P],
    }
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the probe ({name}):\n{log}")
        fn_name = "?"
        for line in log.splitlines():
            if "Compiling entry function" in line:
                fn_name = line.split("'")[1]
            elif "Used" in line and "quantize_rows" in fn_name:
                print(f"[ptxas] {name} {fn_name[:60]}: {line.strip()}",
                      flush=True)
        dll = ctypes.CDLL(lib)
        if name in PACKAGE_VARIANTS:
            entry = PACKAGE_ENTRIES[PACKAGE_VARIANTS[name][0]]
            mine = {entry: list(_build.ENTRIES[entry][1]) + [P]}
        for fn_name, argtypes in (
                mine if name in PACKAGE_VARIANTS else sigs).items():
            fn = getattr(dll, fn_name)
            fn.argtypes = argtypes
            fn.restype = I
        libs[name] = dll
    return libs


def caller(dll):
    """``call(entry, *args)``: a function that launches C entry ``entry``
    of ``dll`` on PyTorch's current stream and raises on a CUDA error."""
    import torch

    def call(name, *args):
        def run():
            rc = getattr(dll, name)(*args,
                                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"{name}: CUDA error {rc}")
        return run
    return call


def first_plane(call, seed, sid, rid, x, bits):
    """The first K1 design's wrapper: the scale pass, then its kernel;
    returns ``(q, scale)``."""
    import torch

    from repro_torch.kernels.quantize import ops, ref

    m, n = x.shape
    wire = ops.wire_len(n, bits)
    scale = ref.row_scale(x)
    q = torch.empty((m, wire), device=x.device,
                    dtype=torch.int8 if bits == 8 else torch.uint8)
    call("quantize_plane_first", x.data_ptr(), m, n, bits, seed[0], seed[1],
         sid.data_ptr(), None if rid is None else rid.data_ptr(),
         scale.data_ptr(), q.data_ptr(), wire)()
    return q, scale


def first_leaf(call, kd, x, bits):
    """The first K4 design's wrapper (``kd``: int32 [M, 2] key words);
    returns ``(q, scale)``."""
    import torch

    from repro_torch.kernels.quantize import ops, ref

    m, n = x.shape
    wire = ops.wire_len(n, bits)
    scale = ref.row_scale(x)
    q = torch.empty((m, wire), device=x.device,
                    dtype=torch.int8 if bits == 8 else torch.uint8)
    call("quantize_leaf_first", x.data_ptr(), m, n, bits, kd.data_ptr(),
         scale.data_ptr(), q.data_ptr(), wire)()
    return q, scale


def shard_desc(layout):
    """The first shard-form design's description of a cut (a host int32
    array, copied by its C entry into the kernel's argument):
    ``layout.words()``."""
    words = layout.words()
    if max(words) >= 2 ** 31:
        raise ValueError(f"a shard description past int32: {words}")
    return (ctypes.c_int32 * len(words))(*words)


def first_shard(call, kd, x, words, desc, bits):
    """The first shard-form design's two launches on ``x [M, n]`` (the
    first fills ``words``; the caller all-reduces them in between where
    ranks share a leaf), ``kd`` int32 [M, 2] key words; returns ``(q,
    scale)``."""
    import torch

    from repro_torch.kernels.quantize import ops

    m, n = x.shape
    wire = ops.wire_len(n, bits)
    scale = torch.empty((m,), dtype=torch.float32, device=x.device)
    q = torch.empty((m, wire), device=x.device,
                    dtype=torch.int8 if bits == 8 else torch.uint8)
    call("leaf_absmax_first", x.data_ptr(), m, n, words.data_ptr())()
    call("quantize_leaf_shard_first", x.data_ptr(), m, n, bits,
         kd.data_ptr(), words.data_ptr(), desc, scale.data_ptr(),
         q.data_ptr(), wire)()
    return q, scale


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="root of another checkout whose fused kernel is "
                    "timed beside this one's (repeatable)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.core import jaxrand
    from repro_torch.kernels import _build
    from repro_torch.kernels.quantize import ops, ref

    if not torch.cuda.is_available():
        print("quantize_probe: CUDA is not available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _build.build()
    libs = build(os.path.join(ROOT, "build", "quantize_probe"),
                 trees=args.tree, package=tuple(PACKAGE_VARIANTS))
    call = caller(libs["base"])
    dev = torch.device("cuda")
    seed = jaxrand.key_seed(jaxrand.fold_in(jaxrand.key(7), 13))

    def ms(fn, iters=30, warmup=5):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / iters

    def same(got, want):
        q, sc = got
        qw, scw = want
        return (torch.equal(q, qw) and torch.equal(torch.isnan(sc),
                                                   torch.isnan(scw))
                and torch.equal(sc.nan_to_num(), scw.nan_to_num()))

    n = 2 ** 20
    g = torch.Generator(device=dev).manual_seed(0)
    results = {}
    shapes = (("K1", 20, n, 8), ("K1", 20, n, 4), ("K1", 150, n, 8),
              ("K4", 10, n, 8), ("K4", 20, n - 4096, 8))
    k5_libs = {k: v for k, v in libs.items() if k.startswith("k5 ")}
    k0_libs = {k: v for k, v in libs.items() if k.startswith("k0 ")}
    libs = {k: v for k, v in libs.items() if k not in PACKAGE_VARIANTS}
    for kid, m, nn, bits in shapes:
        label = f"{kid} [{m}, {nn}] b={bits}"
        x = torch.randn((m, nn), generator=g, device=dev)
        wire = ops.wire_len(nn, bits)
        q = torch.empty((m, wire), device=dev,
                        dtype=torch.int8 if bits == 8 else torch.uint8)
        sc = torch.empty((m,), device=dev)
        scr = ops.scratch(m, dev)
        if kid == "K1":
            sid = (torch.arange(m, device=dev) // 2).to(torch.int32)
            rid = (torch.arange(m, device=dev) % 15).to(torch.int32)
            want = ref.quantize_plane_ref(seed, sid, rid, x, bits=bits)
            wrapper = lambda: ops.quantize_plane(seed, sid, rid, x,  # noqa
                                                 bits=bits)
            first = lambda: first_plane(call, seed, sid, rid, x, bits)  # noqa
            fscale = ref.row_scale(x)

            def entry(lib, name="probe_plane"):
                return caller(lib)(name, x.data_ptr(), m, nn, bits, seed[0],
                                   seed[1], sid.data_ptr(), rid.data_ptr(),
                                   sc.data_ptr(), q.data_ptr(), wire,
                                   scr.data_ptr())
            first_bare = call("quantize_plane_first", x.data_ptr(), m, nn,
                              bits, seed[0], seed[1], sid.data_ptr(),
                              rid.data_ptr(), fscale.data_ptr(),
                              q.data_ptr(), wire)
            package = lambda: _build.launch(  # noqa
                "quantize_plane", x.data_ptr(), m, nn, bits, seed[0],
                seed[1], sid.data_ptr(), rid.data_ptr(), sc.data_ptr(),
                q.data_ptr(), wire, scr.data_ptr())
        else:
            keys = jaxrand.split(jaxrand.key(5), m)
            kd = ops._key_words(keys, (m,), dev)
            want = ref.quantize_tensor_ref(keys, x, bits=bits)
            wrapper = lambda: ops.quantize_tensor(keys, x, bits=bits)  # noqa
            first = lambda: first_leaf(call, kd, x, bits)  # noqa
            fscale = ref.row_scale(x)

            def entry(lib, name="probe_leaf"):
                return caller(lib)(name, x.data_ptr(), m, nn, bits,
                                   kd.data_ptr(), sc.data_ptr(),
                                   q.data_ptr(), wire, scr.data_ptr())
            first_bare = call("quantize_leaf_first", x.data_ptr(), m, nn,
                              bits, kd.data_ptr(), fscale.data_ptr(),
                              q.data_ptr(), wire)
            package = lambda: _build.launch(  # noqa
                "quantize_leaf", x.data_ptr(), m, nn, bits, kd.data_ptr(),
                sc.data_ptr(), q.data_ptr(), wire, scr.data_ptr())
        cands = {"wrapper (package)": wrapper, "bare (package)": package,
                 "first wrapper (scale pass + kernel)": first,
                 "first bare (scale given)": first_bare,
                 "scale pass alone": lambda: ref.row_scale(x)}
        for name, lib in libs.items():
            cands[f"fused {name} bare"] = entry(lib)
        for name, fn in cands.items():
            if name == "scale pass alone":
                continue
            q.zero_()
            sc.fill_(-1.0)
            got = fn()
            torch.cuda.synchronize()
            if not isinstance(got, tuple):
                got = (q, fscale if name.startswith("first bare") else sc)
            if not same(got, want):
                raise AssertionError(f"{label}: {name} differs from the "
                                     "plain version")
        times = {}
        for name in list(cands) + list(reversed(cands)):
            times.setdefault(name, []).append(ms(cands[name]))
        for name, t in times.items():
            print(f"[probe] {label}: {name}: {min(t):.4f} ms (turns "
                  f"{', '.join(f'{u:.4f}' for u in t)}) [{card}]", flush=True)
        results[label] = {nm: min(t) for nm, t in times.items()}
        del x, q
        torch.cuda.empty_cache()
    # K5 in both forms beside its first design, at the main path's shapes
    # (LEAD's [10, 2^20] messages; the drop0.3 and ring planes' rows)
    for m, nn, bits, plane in ((10, n, 8, 0), (150, n, 8, 1), (150, n, 8, 0),
                               (20, n, 8, 1), (20, n, 4, 1)):
        form = "dequantize_plane" if plane else "dequantize_tensor"
        label = f"K5 {form} [{m}, {nn}] b={bits}"
        x = torch.randn((m, nn), generator=g, device=dev)
        sid = (torch.arange(m, device=dev) // 15).to(torch.int32)
        rid = (torch.arange(m, device=dev) % 15).to(torch.int32)
        q, sc = ops.quantize_plane(seed, sid, rid, x, bits=bits)
        del x
        wire = q.shape[-1]
        out = torch.empty((m, nn), device=dev)
        fn = ops.dequantize_plane if plane else ops.dequantize_tensor
        plain = ref.dequantize_plane_ref if plane else \
            ref.dequantize_tensor_ref
        want = plain(q, sc, n=nn, bits=bits)
        args = (q.data_ptr(), m, nn, bits, sc.data_ptr(), out.data_ptr(),
                wire, plane)
        cands = {"wrapper (package)": lambda: fn(q, sc, n=nn, bits=bits),
                 "bare (package)": lambda: _build.launch(  # noqa
                     "dequantize_leaf", *args)}
        cands["first design, bare"] = call("dequantize_leaf_first", *args)
        for name, lib in k5_libs.items():
            cands[f"{name} bare"] = caller(lib)("dequantize_leaf", *args)
        for name, fn_ in cands.items():
            out.fill_(float("nan"))
            got = fn_()
            torch.cuda.synchronize()
            got = out if got is None else got
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"{label}: {name} differs from the "
                                     "plain version")
        times = {}
        for name in list(cands) + list(reversed(cands)):
            times.setdefault(name, []).append(ms(cands[name]))
        for name, t in times.items():
            print(f"[probe] {label}: {name}: {min(t):.4f} ms (turns "
                  f"{', '.join(f'{u:.4f}' for u in t)}) [{card}]", flush=True)
        results[label] = {nm: min(t) for nm, t in times.items()}
        del q, out
        torch.cuda.empty_cache()
    # K0's test entry (8 seeds x 2^20 counters) beside its first design
    # (every thread folds its seed, 64-bit indices), with this build's
    # cipher and each --tree's
    from repro_torch.kernels import prng

    label = "K0 threefry_bits [8, 2^20]"
    sids = prng.u32([0, 1, 9, 2 ** 31, 2 ** 31 + 7, 2 ** 32 - 1, 12345,
                     3_000_000_000], dev).to(torch.int32)
    rids = prng.u32([1, 0, prng.BROADCAST, 5, 2 ** 31 + 1, 3, 2 ** 32 - 2,
                     4_000_000_000], dev).to(torch.int32)
    ctr = ((torch.arange(n, device=dev, dtype=torch.int64) * 4099
            + 2 ** 31 - 100) & prng.MASK).to(torch.int32)
    want = prng._threefry_bits_ref(seed, sids, rids, ctr, 1_000_003, 64)
    outs = [torch.empty(sh, dtype=torch.int32, device=dev)
            for sh in ((8, n), (8,), (8,))]
    args = (seed[0], seed[1], sids.data_ptr(), rids.data_ptr(),
            ctr.data_ptr(), 8, n, 1_000_003, 64,
            *(t.data_ptr() for t in outs))
    cands = {"wrapper (package)": lambda: prng.threefry_bits(
                 seed, sids, rids, ctr, n=1_000_003, n_strides=64),
             "bare (package)": lambda: _build.launch("threefry_bits",
                                                     *args)}
    for name, lib in libs.items():
        cands[f"first design, {name} build, bare"] = caller(lib)(
            "threefry_bits_first", *args)
    for name, lib in k0_libs.items():
        cands[f"{name} bare"] = caller(lib)("threefry_bits", *args)
    for name, fn_ in cands.items():
        for t in outs:
            t.fill_(-1)
        got = fn_()
        torch.cuda.synchronize()
        got = tuple(prng.u32(t) for t in outs) if got is None else got
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{label}: {name} differs from the plain "
                                 "version")
    times = {}
    for name in list(cands) + list(reversed(cands)):
        times.setdefault(name, []).append(ms(cands[name]))
    for name, t in times.items():
        print(f"[probe] {label}: {name}: {min(t):.4f} ms (turns "
              f"{', '.join(f'{u:.4f}' for u in t)}) [{card}]", flush=True)
    results[label] = {nm: min(t) for nm, t in times.items()}
    # the cipher's issue rate by the SM clock: Threefry blocks a clock per
    # SM, as K1 and as K4 draw them, 1, 2 and 4 independent chains a
    # thread, 32 warps an SM (a block of 1024 on each), each build's cipher
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 2048
    sink = torch.empty((sms * 1024,), dtype=torch.int32, device=dev)
    cycles = torch.empty((sms,), dtype=torch.int64, device=dev)
    rates = {}
    for name, lib in libs.items():
        for leaf in (0, 1):
            for chains in (1, 2, 4):
                run = caller(lib)("probe_cipher_rate", leaf, chains, sms,
                                  iters, sink.data_ptr(), cycles.data_ptr())
                run()
                run()
                torch.cuda.synchronize()
                med = float(cycles.double().median())
                per_clock = 1024 * chains * iters / med
                key = (f"{name} {'K4 jax_bits' if leaf else 'K1 random_bits'}"
                       f" x{chains}")
                rates[key] = 1 / per_clock
                print(f"[rate] {key}: {1 / per_clock:.4f} clocks a block "
                      f"per SM ({per_clock:.3f} blocks a clock, median "
                      f"{med:.0f} cycles of {sms} blocks) [{card}]",
                      flush=True)
    results["cipher clocks a block per SM"] = rates
    # the SM clock and the power while the fused K1 runs at [150, 2^20]
    # for ~2 s (nvidia-smi sampled from a thread meanwhile)
    import threading

    m, nn = 150, n
    x = torch.randn((m, nn), generator=g, device=dev)
    sid = (torch.arange(m, device=dev) // 15).to(torch.int32)
    rid = (torch.arange(m, device=dev) % 15).to(torch.int32)
    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            samples.append(subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader"], capture_output=True,
                text=True).stdout.strip())

    ops.quantize_plane(seed, sid, rid, x)
    torch.cuda.synchronize()
    th = threading.Thread(target=sample)
    th.start()
    for _ in range(3000):
        ops.quantize_plane(seed, sid, rid, x)
    torch.cuda.synchronize()
    stop.set()
    th.join()
    print(f"[probe] clocks.sm, power.draw while K1 [150, 2^20] runs: "
          f"{samples} [{card}]", flush=True)
    print(json.dumps({"card": card, "ms": results,
                      "clock_samples": samples}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
