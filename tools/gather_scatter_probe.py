#!/usr/bin/env python3
"""Split K6 (sparse_gather) and K7 (sparse_scatter) at the main path's
shapes between their parts, and time the design candidates beside the
first designs.

    python3 tools/gather_scatter_probe.py

``build`` compiles ``csrc/gather_scatter.cu`` together with the probe
kernels below (one translation unit, so that the probes reach the
package's kernels), once as the package has it ("base") and once for
each entry of ``VARIANTS``, a copy of the file with some of its sizes
changed (K6's loads a thread; K7's tile, fill batch and segment
length).  The base build also holds the first designs, the yardstick
that ``chip_smoke.py`` builds through ``build`` and times beside the
package: K6 on int32 rows, K7 as scattered global stores onto a zeroed
plane after an optional claim pass (atomicMax of j into an int32 plane
holding -1).

``main`` times each part and candidate with CUDA events, at two shapes:
the RandK-uniform z-plane [20, 2^20], k = 629,146 (fraction 0.6, int64
rows from ``jaxrand.permutation``), and CHOCO TopK [10, 2^20],
k = 262,144 (int64 rows from ``torch.sort``; K7 also on int32 rows, the
wire payload TopK hands it).  Parts:

  fill       the first K7 wrapper's zero fill of the [M, n] plane;
  l2row      every row's (idx, v) stored at its indices into ONE row of n
             floats, which stays in L2 (the index precomputed, int32);
  claim      the first K7's claim pass;
  stream     the coalesced streams alone: idx (int64) and v read, v
             written at j (a copy);
  convert    the first wrappers' int64 -> int32 index conversion;
  first      the first designs, bare (K7 onto a plane zeroed once);

then the candidates: K7 binned at each variant's sizes, on int32 rows,
the claim variant at S = 2^13 and 2^12, and its bin and fill launches
alone; K6 at 2 / 4 / 8 loads in flight a thread, without the streaming
hints, with 16-byte index loads and output stores, with x's next row
prefetched into L2 (one bulk prefetch a block, or a line a thread), and
on int32 rows, beside its scattered loads from one L2-resident row;
``torch.gather`` / ``torch.scatter`` on the same rows.  Each
candidate's result is checked bit for bit against the plain version
first.  Last, the integer issue rates (``int_rate``): LOP3, IADD3, SHF,
IMAD and a LOP3/IMAD mix per SM per clock, by clock64 in blocks of
1,024 threads, one a SM, and the SASS ptxas made of each (it splits a
chain of adds between IADD3 and IMAD).  Needs a CUDA card and nvcc;
prints one JSON object as its last line.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

# builds of csrc/gather_scatter.cu with other sizes: name -> {the package's
# line: its line in the copy}
_TILE, _BATCH = "constexpr int kTile = 4096;", "constexpr int kFillBatch = 4;"
_SEG, _PER = ("constexpr int kSegLogUnique = 14;",
              "constexpr int kGatherPer = 2;")
VARIANTS = {
    "base": {},
    "tile2048_per4": {_TILE: _TILE.replace("4096", "2048"),
                      _PER: _PER.replace("2", "4")},
    "tile8192_per8": {_TILE: _TILE.replace("4096", "8192"),
                      _PER: _PER.replace("2", "8")},
    "batch2": {_BATCH: _BATCH.replace("4", "2")},
    "batch8": {_BATCH: _BATCH.replace("4", "8")},
    "seg13": {_SEG: _SEG.replace("14", "13")},
    "seg15": {_SEG: _SEG.replace("14", "15")},
}

SOURCE = r"""
#include "gather_scatter.cu"

namespace {

// ---------------------------------------------------------------------------
// the first designs (the yardstick): int32 rows, scattered global stores
// ---------------------------------------------------------------------------

constexpr int kFirstThreads = 256;
constexpr int kFirstPer = 4;
constexpr int kFirstTile = kFirstThreads * kFirstPer;

__global__ void first_gather_kernel(const float* __restrict__ x, int n,
                                    const int32_t* __restrict__ idx, int k,
                                    float* __restrict__ out) {
  const int m = blockIdx.y;
  const float* xr = x + static_cast<long long>(m) * n;
  const long long row = static_cast<long long>(m) * k;
  const int base = blockIdx.x * kFirstTile + threadIdx.x;
#pragma unroll
  for (int i = 0; i < kFirstPer; ++i) {
    const int j = base + i * kFirstThreads;
    if (j < k) {
      const int s = idx[row + j];
      out[row + j] = in_range(s, n) ? xr[s] : 0.f;
    }
  }
}

// claim pass (only when indices may repeat): winner[m, idx] = max j
__global__ void first_claim_kernel(const int32_t* __restrict__ idx, int n, int k,
                                   int32_t* __restrict__ winner) {
  const int m = blockIdx.y;
  const long long row = static_cast<long long>(m) * k;
  int32_t* wrow = winner + static_cast<long long>(m) * n;
  const int base = blockIdx.x * kFirstTile + threadIdx.x;
#pragma unroll
  for (int i = 0; i < kFirstPer; ++i) {
    const int j = base + i * kFirstThreads;
    if (j < k) {
      const int s = idx[row + j];
      if (in_range(s, n)) atomicMax(wrow + s, j);
    }
  }
}

__global__ void first_scatter_kernel(const float* __restrict__ v,
                                     const int32_t* __restrict__ idx, int n, int k,
                                     float gain, const int32_t* __restrict__ winner,
                                     float* __restrict__ out) {
  const int m = blockIdx.y;
  const long long row = static_cast<long long>(m) * k;
  const long long plane = static_cast<long long>(m) * n;
  const int base = blockIdx.x * kFirstTile + threadIdx.x;
#pragma unroll
  for (int i = 0; i < kFirstPer; ++i) {
    const int j = base + i * kFirstThreads;
    if (j < k) {
      const int s = idx[row + j];
      if (in_range(s, n) && (winner == nullptr || winner[plane + s] == j)) {
        out[plane + s] = __fmul_rn(gain, v[row + j]);
      }
    }
  }
}


// K6 without the streaming hints (plain loads and stores)
template <typename I, int kPer>
__global__ void __launch_bounds__(kGatherThreads)
    gather_plain_kernel(const float* __restrict__ x, int n, const I* __restrict__ idx,
                        long long ld, int k, float* __restrict__ out) {
  const int m = blockIdx.y;
  const float* xr = x + static_cast<long long>(m) * n;
  const I* ir = idx + static_cast<long long>(m) * ld;
  float* orow = out + static_cast<long long>(m) * k;
  const int base = blockIdx.x * (kGatherThreads * kPer) + threadIdx.x;
  I s[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int j = base + i * kGatherThreads;
    s[i] = j < k ? ir[j] : static_cast<I>(-1);
  }
  float val[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) val[i] = in_range(s[i], n) ? xr[s[i]] : 0.0f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int j = base + i * kGatherThreads;
    if (j < k) orow[j] = val[i];
  }
}

// K6 on int64 rows with 16-byte index loads and 16-byte output stores:
// 4 consecutive j a thread (scalar where a row is not 16-byte aligned)
__global__ void __launch_bounds__(256)
    gather_vec_kernel(const float* __restrict__ x, int n, const long long* __restrict__ idx,
                      long long ld, int k, float* __restrict__ out) {
  const int m = blockIdx.y;
  const float* xr = x + static_cast<long long>(m) * n;
  const long long* ir = idx + static_cast<long long>(m) * ld;
  float* orow = out + static_cast<long long>(m) * k;
  const int j = (blockIdx.x * 256 + threadIdx.x) * 4;
  if (j >= k) return;
  long long s[4] = {-1, -1, -1, -1};
  const bool vec_in = j + 4 <= k && (reinterpret_cast<uintptr_t>(ir + j) & 15) == 0;
  if (vec_in) {
    const longlong2 a = __ldcs(reinterpret_cast<const longlong2*>(ir + j));
    const longlong2 b = __ldcs(reinterpret_cast<const longlong2*>(ir + j + 2));
    s[0] = a.x; s[1] = a.y; s[2] = b.x; s[3] = b.y;
  } else {
    for (int e = 0; e < 4; ++e) if (j + e < k) s[e] = __ldcs(ir + j + e);
  }
  float val[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) val[e] = in_range(s[e], n) ? __ldg(xr + s[e]) : 0.0f;
  if (j + 4 <= k && (reinterpret_cast<uintptr_t>(orow + j) & 15) == 0) {
    __stcs(reinterpret_cast<float4*>(orow + j), make_float4(val[0], val[1], val[2], val[3]));
  } else {
    for (int e = 0; e < 4; ++e) if (j + e < k) __stcs(orow + j + e, val[e]);
  }
}

// K6 with x's next row fetched into L2 ahead of its scattered reads: the
// first blocks of row m prefetch row m + 1 (and row 0's blocks row 0),
// so that HBM reads x in whole lines and the scattered loads hit L2.
// MODE 0: one bulk (TMA) prefetch of a 64 KB chunk a block, by thread 0
// of the row's first 64 blocks; MODE 1: one 128-byte line a thread of
// the row's first 128 blocks (prefetch.global.L2::evict_last); MODE 2:
// every row's loads from row 0 only (an L2-resident row: the scattered
// loads' rate without HBM)
template <int MODE>
__global__ void __launch_bounds__(kGatherThreads)
    gather_pf_kernel(const float* __restrict__ x, int n, const long long* __restrict__ idx,
                     long long ld, int k, int M, float* __restrict__ out) {
  const int m = blockIdx.y;
  const long long* ir = idx + static_cast<long long>(m) * ld;
  float* orow = out + static_cast<long long>(m) * k;
  if (MODE != 2) {
    for (int r = (m == 0 ? 0 : m + 1); r <= m + 1 && r < M; ++r) {
      const char* row = reinterpret_cast<const char*>(x + static_cast<long long>(r) * n);
      const uintptr_t lo = reinterpret_cast<uintptr_t>(row) & ~static_cast<uintptr_t>(127);
      const uintptr_t hi = reinterpret_cast<uintptr_t>(row + 4LL * n);
      if (MODE == 0 && threadIdx.x == 0 && blockIdx.x < 64) {
        const uintptr_t c0 = lo + static_cast<uintptr_t>(blockIdx.x) * 65536;
        if (c0 < hi) {
          const uintptr_t left = (hi - c0 + 15) & ~static_cast<uintptr_t>(15);
          const uint32_t bytes = static_cast<uint32_t>(left < 65536 ? left : 65536);
          asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(c0), "r"(bytes)
                       : "memory");
        }
      }
      if (MODE == 1 && blockIdx.x < 128) {
        for (uintptr_t a = lo + (static_cast<uintptr_t>(blockIdx.x) * kGatherThreads + threadIdx.x) * 128;
             a < hi; a += 128 * kGatherThreads * 128) {
          asm volatile("prefetch.global.L2::evict_last [%0];" ::"l"(a));
        }
      }
    }
  }
  const float* xr = x + (MODE == 2 ? 0LL : static_cast<long long>(m) * n);
  const int base = blockIdx.x * (kGatherThreads * kGatherPer) + threadIdx.x;
  long long s[kGatherPer];
#pragma unroll
  for (int i = 0; i < kGatherPer; ++i) {
    const int j = base + i * kGatherThreads;
    s[i] = j < k ? __ldcs(ir + j) : -1LL;
  }
  float val[kGatherPer];
#pragma unroll
  for (int i = 0; i < kGatherPer; ++i) val[i] = in_range(s[i], n) ? __ldg(xr + s[i]) : 0.0f;
#pragma unroll
  for (int i = 0; i < kGatherPer; ++i) {
    const int j = base + i * kGatherThreads;
    if (j < k) __stcs(orow + j, val[i]);
  }
}

// every row's values stored at its indices into one shared row
__global__ void l2row_kernel(const float* __restrict__ v, const int* __restrict__ idx,
                             int n, int k, float* __restrict__ row) {
  const int m = blockIdx.y;
  const long long r = static_cast<long long>(m) * k;
  const int base = blockIdx.x * 1024 + threadIdx.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = base + i * 256;
    if (j < k) {
      const int s = idx[r + j];
      if (in_range(s, n)) row[s] = v[r + j];
    }
  }
}

// idx (int64, row stride ld) and v read, v written at j
__global__ void stream_kernel(const float* __restrict__ v, const long long* __restrict__ idx,
                              long long ld, int n, int k, float* __restrict__ out) {
  const int m = blockIdx.y;
  const int base = blockIdx.x * 1024 + threadIdx.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = base + i * 256;
    if (j < k) {
      const long long s = __ldcs(idx + static_cast<long long>(m) * ld + j);
      const float x = __ldcs(v + static_cast<long long>(m) * k + j);
      __stcs(out + static_cast<long long>(m) * k + j, in_range(s, n) ? x : 1.0f);
    }
  }
}

template <int kOp>
__global__ void __launch_bounds__(1024, 1)
    int_rate_kernel(uint32_t seed, int iters, uint32_t* out, long long* cycles) {
  uint32_t a[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) a[i] = seed + threadIdx.x * 8 + i;
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int r = 0; r < 16; ++r) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (kOp == 0 || (kOp == 4 && i % 2 == 0)) {
          asm volatile("lop3.b32 %0, %0, %1, %2, 0x96;" : "+r"(a[i]) : "r"(seed), "r"(it));
        } else if (kOp == 1) {
          // another chain's value as the addend, so that ptxas cannot fold
          // two adds into one IADD3
          asm volatile("add.u32 %0, %0, %1;" : "+r"(a[i]) : "r"(a[(i + 1) & 7]));
        } else if (kOp == 2) {
          asm volatile("shf.l.wrap.b32 %0, %0, %0, 13;" : "+r"(a[i]));
        } else {
          asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(a[i]) : "r"(seed), "r"(it));
        }
      }
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  uint32_t x = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) x ^= a[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = x;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

}  // namespace

extern "C" int sparse_gather_first(const void* x, int M, int n, const void* idx, int k,
                                   void* out, void* stream) {
  if (M <= 0 || M > 65535 || n <= 0 || k <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((k + kFirstTile - 1) / kFirstTile, M);
  first_gather_kernel<<<grid, kFirstThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, static_cast<const int32_t*>(idx), k,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out must hold zeros; winner (nullable) must hold -1 everywhere
extern "C" int sparse_scatter_first(const void* v, const void* idx, int M, int n, int k,
                                    float gain, void* winner, void* out, void* stream) {
  if (M <= 0 || M > 65535 || n <= 0 || k <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* ix = static_cast<const int32_t*>(idx);
  auto* win = static_cast<int32_t*>(winner);
  const dim3 grid((k + kFirstTile - 1) / kFirstTile, M);
  if (win != nullptr) {
    first_claim_kernel<<<grid, kFirstThreads, 0, st>>>(ix, n, k, win);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  first_scatter_kernel<<<grid, kFirstThreads, 0, st>>>(static_cast<const float*>(v), ix,
                                                       n, k, gain, win,
                                                       static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// K6 without the streaming hints (mode 0) or with 16-byte index loads and
// output stores (mode 1, int64 rows only)
extern "C" int probe_gather(int mode, const void* x, int M, int n, const void* idx,
                            int idx64, long long ld, int k, void* out, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (mode == 1) {
    if (!idx64) return static_cast<int>(cudaErrorInvalidValue);
    gather_vec_kernel<<<dim3((k + 1023) / 1024, M), 256, 0, st>>>(
        static_cast<const float*>(x), n, static_cast<const long long*>(idx), ld, k,
        static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid((k + kGatherThreads * kGatherPer - 1) / (kGatherThreads * kGatherPer), M);
  if (idx64) {
    gather_plain_kernel<long long, kGatherPer><<<grid, kGatherThreads, 0, st>>>(
        static_cast<const float*>(x), n, static_cast<const long long*>(idx), ld, k,
        static_cast<float*>(out));
  } else {
    gather_plain_kernel<int, kGatherPer><<<grid, kGatherThreads, 0, st>>>(
        static_cast<const float*>(x), n, static_cast<const int*>(idx), ld, k,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// the package's bin launch alone (pass 0) or fill launch alone (pass 1):
// unique rows, int64 indices, one window (n <= kMaxSegs * S)
extern "C" int probe_pass(int pass, const void* v, const void* idx, long long ld, int M,
                          int n, int k, float gain, void* pairs, void* starts, void* out,
                          void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  constexpr int kLog = kSegLog<false>;
  const int ns = ((n - 1) >> kLog) + 1;
  const int ntiles = (k + kTile - 1) / kTile;
  if (ns > kMaxSegs) return static_cast<int>(cudaErrorInvalidValue);
  if (pass == 0) {
    static unsigned long long done = 0;
    auto kern = &bin_kernel<long long, false>;
    const cudaError_t err = allow_smem(kern, bin_smem(kMaxSegs, false), &done);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<dim3(ntiles, M), kThreads, bin_smem(ns, false), st>>>(
        static_cast<const float*>(v), static_cast<const long long*>(idx), ld, 0, n, k,
        gain, ns, ntiles, pairs, static_cast<int*>(starts));
    return static_cast<int>(cudaGetLastError());
  }
  static unsigned long long done = 0;
  auto kern = &fill_kernel<false>;
  const cudaError_t err = allow_smem(kern, fill_smem<false>(), &done);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(ns, M), kThreads, fill_smem<false>(), st>>>(
      pairs, static_cast<const int*>(starts), n, 0, n, ns, ntiles, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_gather_pf(int mode, const void* x, int M, int n, const void* idx,
                               long long ld, int k, void* out, void* stream) {
  const dim3 grid((k + kGatherThreads * kGatherPer - 1) / (kGatherThreads * kGatherPer), M);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* ix = static_cast<const long long*>(idx);
  auto* o = static_cast<float*>(out);
  if (mode == 0) gather_pf_kernel<0><<<grid, kGatherThreads, 0, st>>>(xf, n, ix, ld, k, M, o);
  if (mode == 1) gather_pf_kernel<1><<<grid, kGatherThreads, 0, st>>>(xf, n, ix, ld, k, M, o);
  if (mode == 2) gather_pf_kernel<2><<<grid, kGatherThreads, 0, st>>>(xf, n, ix, ld, k, M, o);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_l2row(const void* v, const void* idx, int M, int n, int k, void* row,
                           void* stream) {
  l2row_kernel<<<dim3((k + 1023) / 1024, M), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const int*>(idx), n, k,
      static_cast<float*>(row));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_claim(const void* idx, int M, int n, int k, void* winner, void* stream) {
  first_claim_kernel<<<dim3((k + kFirstTile - 1) / kFirstTile, M), kFirstThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), n, k, static_cast<int32_t*>(winner));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_stream(const void* v, const void* idx, long long ld, int M, int n, int k,
                            void* out, void* stream) {
  stream_kernel<<<dim3((k + 1023) / 1024, M), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const long long*>(idx), ld, n, k,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_int_rate(int op, int blocks, int iters, void* out, void* cycles,
                              void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<uint32_t*>(out);
  auto* c = static_cast<long long*>(cycles);
  switch (op) {
    case 0: int_rate_kernel<0><<<blocks, 1024, 0, st>>>(0x9E3779B9u, iters, o, c); break;
    case 1: int_rate_kernel<1><<<blocks, 1024, 0, st>>>(0x9E3779B9u, iters, o, c); break;
    case 2: int_rate_kernel<2><<<blocks, 1024, 0, st>>>(0x9E3779B9u, iters, o, c); break;
    case 3: int_rate_kernel<3><<<blocks, 1024, 0, st>>>(0x9E3779B9u, iters, o, c); break;
    case 4: int_rate_kernel<4><<<blocks, 1024, 0, st>>>(0x9E3779B9u, iters, o, c); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
"""

INT_OPS = ("LOP3", "IADD3", "SHF", "IMAD", "LOP3+IMAD")


def build(out_dir, variants=tuple(VARIANTS)):
    """Compile the probe once per entry of ``variants`` (names of
    ``VARIANTS``), one ``nvcc`` each, all started together, into
    ``out_dir/<name>/``.  Returns ``{name: ctypes library}``; raises with
    nvcc's log if a build fails or a size to change is not in the
    package's source."""
    from repro_torch.kernels import _build

    package = (_build._CSRC / "gather_scatter.cu").read_text()
    procs = {}
    for name in variants:
        text = package
        for line, repl in VARIANTS[name].items():
            if text.count(line) != 1:
                raise RuntimeError(f"gather_scatter.cu has no single {line!r}")
            text = text.replace(line, repl)
        vdir = os.path.join(out_dir, name)
        os.makedirs(vdir, exist_ok=True)
        with open(os.path.join(vdir, "gather_scatter.cu"), "w") as f:
            f.write(text)
        src = os.path.join(vdir, "gather_scatter_probe.cu")
        lib = os.path.join(vdir, "gather_scatter_probe.so")
        with open(src, "w") as f:
            f.write(SOURCE)
        procs[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", vdir, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    sigs = {
        "sparse_gather": [P, I, I, P, I, L, I, P, P],
        "sparse_scatter": [P, P, I, L, I, I, I, F, I, P, P, P, P],
        "sparse_gather_first": [P, I, I, P, I, P, P],
        "sparse_scatter_first": [P, P, I, I, I, F, P, P, P],
        "probe_gather": [I, P, I, I, P, I, L, I, P, P],
        "probe_pass": [I, P, P, L, I, I, I, F, P, P, P, P],
        "probe_gather_pf": [I, P, I, I, P, L, I, P, P],
        "probe_l2row": [P, P, I, I, I, P, P],
        "probe_claim": [P, I, I, I, P, P],
        "probe_stream": [P, P, L, I, I, I, P, P],
        "probe_int_rate": [I, I, I, P, P, P],
    }
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the probe ({name}):\n{log}")
        dll = ctypes.CDLL(lib)
        for fn_name, argtypes in sigs.items():
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


def main():
    import torch

    from repro_torch.core import jaxrand
    from repro_torch.kernels import _build
    from repro_torch.kernels.sparse_gather import ops, ref

    if not torch.cuda.is_available():
        print("gather_scatter_probe: CUDA is not available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _build.build()
    out_dir = os.path.join(ROOT, "build", "probe")
    libs = build(out_dir)
    call = caller(libs["base"])
    dev = torch.device("cuda")

    def ms(fn, iters=50, warmup=5):
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

    def same(a, b):
        return torch.equal(a.contiguous().view(torch.int32),
                           b.contiguous().view(torch.int32))

    results = {}
    n = 2 ** 20
    g = torch.Generator(device=dev).manual_seed(0)
    for label, m, frac in (("uniform", 20, 0.6), ("topk", 10, 0.25)):
        k = round(frac * n)
        x = torch.randn((m, n), generator=g, device=dev)
        if label == "uniform":
            keys = jaxrand.split(jaxrand.key(6), m).to(dev)
            idx = jaxrand.permutation(keys, n)[..., :k]
            gain = n / k
        else:
            idx = torch.sort(x.abs(), dim=-1, descending=True,
                             stable=True).indices[..., :k]
            gain = 1.0
        ld = idx.stride(0)
        idx32 = idx.to(torch.int32).contiguous()
        v = ref.sparse_gather_ref(x, idx).contiguous()
        vg = torch.tensor(gain, dtype=torch.float32, device=dev) * v
        want_v = v
        want_out = ref.sparse_scatter_ref(v, idx, n, gain)
        zeros = torch.zeros((m, n), device=dev)
        plane = torch.zeros((m, n), device=dev)
        out = torch.empty((m, n), device=dev)
        gout = torch.empty((m, k), device=dev)
        row = torch.zeros((n,), device=dev)
        winner = torch.full((m, n), -1, dtype=torch.int32, device=dev)
        # a scratch that every build's K7 fits: 8-byte pairs at the
        # largest tile's padding, run starts at the shortest segment
        # (2^12) and the smallest tile (2,048)
        pairs = torch.empty((2 * m * (-(-k // 8192)) * 8192,),
                            dtype=torch.int32, device=dev)
        starts = torch.empty((m * ((n >> 12) + 1) * (-(-k // 2048)),),
                             dtype=torch.int32, device=dev)

        def binned(build="base", claim=0, rows=idx):
            return caller(libs[build])(
                "sparse_scatter", v.data_ptr(), rows.data_ptr(),
                int(rows.dtype == torch.int64), rows.stride(0), m, n, k,
                float(gain), claim, pairs.data_ptr(), starts.data_ptr(),
                out.data_ptr())

        def one_pass(which):
            return call("probe_pass", which, v.data_ptr(), idx.data_ptr(), ld,
                        m, n, k, float(gain), pairs.data_ptr(),
                        starts.data_ptr(), out.data_ptr())

        def gather(build="base", rows=idx):
            return caller(libs[build])(
                "sparse_gather", x.data_ptr(), m, n, rows.data_ptr(),
                int(rows.dtype == torch.int64), rows.stride(0), k,
                gout.data_ptr())

        def gather_probe(mode):
            return call("probe_gather", mode, x.data_ptr(), m, n,
                        idx.data_ptr(), 1, ld, k, gout.data_ptr())

        def scatter_first(fill):
            bare = call("sparse_scatter_first", v.data_ptr(),
                        idx32.data_ptr(), m, n, k, float(gain), None,
                        plane.data_ptr())
            return (lambda: (plane.zero_(), bare())) if fill else bare

        cands = {
            "K7 part fill (torch.zero_ of the plane)": lambda: plane.zero_(),
            "K7 part l2row (scattered stores into one L2-resident row)":
                call("probe_l2row", v.data_ptr(), idx32.data_ptr(), m, n, k,
                     row.data_ptr()),
            "K7 part claim (atomicMax into an int32 plane)":
                call("probe_claim", idx32.data_ptr(), m, n, k,
                     winner.data_ptr()),
            "K6/K7 part stream (idx int64 + v read, v written)":
                call("probe_stream", v.data_ptr(), idx.data_ptr(), ld, m, n, k,
                     gout.data_ptr()),
            "K6/K7 part convert (int64 -> int32 rows)":
                lambda: idx.to(torch.int32).contiguous(),
            "K7 first (bare, onto a plane zeroed once)": scatter_first(False),
            "K7 first + fill": scatter_first(True),
            "K7 library torch.scatter": lambda: torch.scatter(zeros, 1, idx,
                                                              vg),
            "K7 binned S=2^13": binned("seg13"),
            "K7 binned S=2^14 (package)": binned(),
            "K7 binned S=2^15": binned("seg15"),
            "K7 binned S=2^14 tile 2048": binned("tile2048_per4"),
            "K7 binned S=2^14 tile 8192": binned("tile8192_per8"),
            "K7 binned S=2^14 fill batch 2": binned("batch2"),
            "K7 binned S=2^14 fill batch 8": binned("batch8"),
            "K7 binned S=2^14 int32 rows": binned(rows=idx32),
            "K7 claim S=2^13 (package)": binned(claim=1),
            "K7 claim S=2^12": binned("seg13", claim=1),
            "K7 bin launch alone": one_pass(0),
            "K7 fill launch alone": one_pass(1),
            "K7 wrapper (package)": lambda: ops.sparse_scatter(
                v, idx, n, gain, unique=True),
            "K6 first (bare, int32 rows)":
                call("sparse_gather_first", x.data_ptr(), m, n,
                     idx32.data_ptr(), k, gout.data_ptr()),
            "K6 library torch.gather": lambda: torch.gather(x, 1, idx),
            "K6 2 a thread (package)": gather(),
            "K6 4 a thread": gather("tile2048_per4"),
            "K6 8 a thread": gather("tile8192_per8"),
            "K6 2 a thread, no hints": gather_probe(0),
            "K6 16-byte index loads and output stores": gather_probe(1),
            "K6 2 a thread, int32 rows": gather(rows=idx32),
            "K6 with a bulk L2 prefetch of the next row": call(
                "probe_gather_pf", 0, x.data_ptr(), m, n, idx.data_ptr(), ld,
                k, gout.data_ptr()),
            "K6 with line prefetches of the next row": call(
                "probe_gather_pf", 1, x.data_ptr(), m, n, idx.data_ptr(), ld,
                k, gout.data_ptr()),
            "K6 part loads from one L2-resident row": call(
                "probe_gather_pf", 2, x.data_ptr(), m, n, idx.data_ptr(), ld,
                k, gout.data_ptr()),
            "K6 wrapper (package)": lambda: ops.sparse_gather(x, idx),
        }
        # every candidate's result against the plain version, once
        for name, fn in cands.items():
            if " part " in name or "library" in name or "alone" in name:
                continue
            out.fill_(float("nan"))
            gout.fill_(float("nan"))
            if "first" in name and "K7" in name:
                plane.zero_()
            got = fn()
            torch.cuda.synchronize()
            if name.startswith("K7"):
                res = got if isinstance(got, torch.Tensor) else (
                    plane if "first" in name else out)
                if not same(res, want_out):
                    raise AssertionError(f"{label}: {name} differs")
            else:
                res = got if isinstance(got, torch.Tensor) else gout
                if not same(res, want_v):
                    raise AssertionError(f"{label}: {name} differs")
        times = {}
        for name in list(cands) + list(reversed(cands)):
            if "claim (atomicMax" in name:
                winner.fill_(-1)
            times.setdefault(name, []).append(ms(cands[name]))
        for name, t in times.items():
            print(f"[probe] {label} [{m}, {n}] k={k}: {name}: {min(t):.4f} ms "
                  f"(turns {', '.join(f'{u:.4f}' for u in t)}) [{card}]",
                  flush=True)
        results[label] = {"shape": [m, n], "k": k,
                          "ms": {nm: min(t) for nm, t in times.items()}}
        del x, idx, idx32, v, vg, zeros, plane, out, gout, winner, pairs
        del starts
        torch.cuda.empty_cache()

    # integer issue rates per SM per clock
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 4096
    sink = torch.empty((sms * 1024,), dtype=torch.int32, device=dev)
    cycles = torch.empty((sms,), dtype=torch.int64, device=dev)
    rates = {}
    for op, name in enumerate(INT_OPS):
        run = call("probe_int_rate", op, sms, iters, sink.data_ptr(),
                   cycles.data_ptr())
        run()
        torch.cuda.synchronize()
        run()
        torch.cuda.synchronize()
        med = float(cycles.double().median())
        rates[name] = 1024 * iters * 16 * 8 / med
        print(f"[int_rate] {name}: {rates[name]:.2f} thread-instructions "
              f"per SM per clock (median of {sms} blocks, {med:.0f} "
              f"cycles) [{card}]", flush=True)
    # what ptxas made of each int_rate kernel: its SASS opcodes
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", os.path.join(
        out_dir, "base", "gather_scatter_probe.so")],
        capture_output=True, text=True, check=True).stdout
    ops_by_kernel, cur = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            cur = (ops_by_kernel.setdefault(name, {}) if "int_rate" in name
                   else None)
        elif cur is not None and "/*" in line and ";" in line:
            op = line.split("*/", 1)[1].strip().split()[0]
            if op.startswith("@"):
                op = line.split("*/", 1)[1].strip().split()[1]
            op = op.split(".")[0]
            cur[op] = cur.get(op, 0) + 1
    for name, ops_ in sorted(ops_by_kernel.items()):
        top = sorted(ops_.items(), key=lambda kv: -kv[1])[:6]
        print(f"[int_rate] SASS of {name}: {dict(top)}", flush=True)
    print(json.dumps({"card": card, "shapes": results,
                      "int_per_sm_per_clock": rates}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
