// K6 and K7: arbitrary-index gather and scatter over a batch of M messages
// (one index row per message), the per-message route of RandK (uniform and
// stride samplers) and TopK.
//
// Replaces: src/repro/kernels/sparse_gather/kernel.py:47 gather (body
// _gather_kernel :43, pallas_call :56) and :75 scatter (body
// _scatter_kernel :70, pallas_call :85), with their wrappers
// sparse_gather/sparse_scatter (sparse_gather/ops.py:33, :43), which the
// reference runs once per message under vmap.  The indices are computed
// outside the kernels, as in the reference (a permutation, a top-k sort or
// the affine stride set).
//
// K6: out[m, j] = x[m, idx[m, j]], 0 for an index outside [0, n).
// K7: out[m, idx[m, j]] = gain * v[m, j] (__fmul_rn), +0.0 where no index
// lands; an index outside [0, n) is skipped, never dereferenced.  Uniform
// and TopK rows are unique by construction; the stride sampler's int32
// wrap can repeat an index (n not a power of two, (k - 1) * stride >=
// 2^31), and there the reference's scatter keeps the LAST j.
//
// Both kernels read the index rows as the caller holds them: int32 (TopK's
// wire payload) or int64 (torch.sort, the permutation), with a row stride
// (`ld`, in elements), so the top-k / permutation prefix [..., :k] of an
// [..., n] tensor is read in place.  The in-range test is one unsigned
// compare of the index widened to 64 bits.
//
// Bound: bytes.  K6 reads k indices and k values and writes k values per
// row; K7 reads k indices and k values and writes the whole [M, n] plane.
//
// K6 (gather): the reads of x land at the indices, one 4-byte word per
// 32-byte sector.  A row of x (4 MB at n = 2^20) stays in the 50 MB L2
// while its blocks run (the grid is row-major and each thread takes only
// kGatherPer elements, so ~2 rows are in flight), so each x sector comes
// from HBM once and the scattered side costs one L2 sector request per
// element: that request rate, not HBM, holds K6 (at [20, 2^20],
// k = 0.6 n, 12.6 M requests).  Each thread issues its scattered loads
// before it stores; the index and output streams carry evict-first hints
// (__ldcs, __stcs).  tools/gather_scatter_probe.py found 2, 4 or 8 loads
// a thread, the hints and 16-byte index loads within a few per cent of
// each other; reading the int64 rows in place costs less than the first
// wrapper's conversion pass.
//
// K7 (scatter): scattered 4-byte stores into an [M, n] plane that L2
// cannot hold cost a 32-byte sector each (the first design's bare time
// was ~2x a scattered store into one L2-resident row, itself ~2x the
// coalesced streams).  So K7 bins in two launches, and every element of
// the plane is written once, in order, with 16-byte stores, while the
// scattered writes land in shared memory:
//   bin   (grid: tiles of kTile j x M rows, 512 threads, 8 j a thread):
//         a block reads its tile of (idx, v) coalesced, all loads in
//         flight at once, forms gain * v, counts the indices per plane
//         segment of S = 2^kSegLog elements (shared atomics), scans the
//         counts, sorts the tile by segment in shared memory and writes
//         it out coalesced, with each segment's run start in
//         starts[m, s, tile];
//   fill  (grid: segments x M rows, 512 threads): a block clears S
//         elements of shared memory, reads its segment's run in every
//         tile of its row (flattened over the block by a binary search
//         of the runs' prefix, kFillBatch loads in flight a thread),
//         stores each value at its offset, then writes the segment with
//         16-byte stores (scalar at the ends of a row that starts past a
//         16-byte boundary, e.g. n = 1,000,003).
// The unique variant keeps 6 bytes a pair (the value, a 16-bit offset)
// and S = 2^14 floats (64 KB: three fill blocks an SM).  Where indices
// may repeat (claim), a pair is 8 bytes, (offset | position << 16, value
// bits), and fill keeps a 64-bit word an element, ((j + 1) << 32 | value
// bits), taking the shared-memory atomicMax, so the last j wins and an
// untouched word (0) reads +0.0; S = 2^13 for the same shared memory.
// bin counts at most kMaxSegs segments (its counts live in shared
// memory), so a row longer than kMaxSegs * S (2^26 elements unique, 2^25
// claim) is scattered window by window: each window's bin reads the whole
// (idx, v) row again and keeps the indices that land in the window, and
// its fill writes the window.  The main path's rows (n <= 2^20) are one
// window.  The wrapper allocates the pairs and run starts with
// torch.empty: no zero fill, no full-plane claim buffer.  Traffic at
// [20, 2^20], k = 0.6 n, int64 indices, unique: bin reads 12 B and writes
// 6 B a j, fill reads 6 B a j and writes the plane, ~390 MB against the
// bound's ~235 MB.
//
// The segment length, tile and batch are the sizes the probe chose
// (tools/gather_scatter_probe.py rebuilds this file with other values to
// time them; it also holds the first designs, the yardstick).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;

template <typename I>
__device__ __forceinline__ bool in_range(I i, int n) {
  return static_cast<unsigned long long>(static_cast<long long>(i)) <
         static_cast<unsigned long long>(n);
}

// ---------------------------------------------------------------------------
// K6: gather
// ---------------------------------------------------------------------------

constexpr int kGatherThreads = 256;
constexpr int kGatherPer = 2;  // scattered loads in flight a thread

template <typename I>
__global__ void __launch_bounds__(kGatherThreads)
    gather_kernel(const float* __restrict__ x, int n, const I* __restrict__ idx,
                  long long ld, int k, float* __restrict__ out) {
  const int m = blockIdx.y;
  const float* xr = x + static_cast<long long>(m) * n;
  const I* ir = idx + static_cast<long long>(m) * ld;
  float* orow = out + static_cast<long long>(m) * k;
  const int base = blockIdx.x * (kGatherThreads * kGatherPer) + threadIdx.x;
  I s[kGatherPer];
#pragma unroll
  for (int i = 0; i < kGatherPer; ++i) {
    const int j = base + i * kGatherThreads;
    s[i] = j < k ? __ldcs(ir + j) : static_cast<I>(-1);
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

// ---------------------------------------------------------------------------
// K7: binned scatter
// ---------------------------------------------------------------------------

constexpr int kThreads = 512;  // bin and fill
constexpr int kTile = 4096;  // j a bin item; a position fits 16 bits
constexpr int kFillBatch = 4;  // pair loads in flight a fill thread
constexpr int kSegLogUnique = 14;  // S of the unique variant (floats)
constexpr int kMaxSegs = 4096;  // segments a window (bin's shared counts)
constexpr int kChunk = 1024;  // tiles whose runs fill stages at a time

// log2 S: the claim variant keeps a 64-bit word an element, so half as many
template <bool kClaim>
constexpr int kSegLog = kClaim ? kSegLogUnique - 1 : kSegLogUnique;

// an index's place in the window [base, base + nw): below nw when inside,
// one unsigned compare for any int32 or int64 index
template <typename I>
__device__ __forceinline__ unsigned long long rel(I i, int base) {
  return static_cast<unsigned long long>(static_cast<long long>(i)) -
         static_cast<unsigned long long>(base);
}

// Exclusive scan of one int a thread over the block; `scratch` holds
// kThreads / 32 + 1 ints of shared memory, its last the block's total.
// Ends with __syncthreads (the caller may reuse what it scanned).
__device__ __forceinline__ int block_scan(int x, int* scratch, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) scratch[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kThreads / 32 ? scratch[lane] : 0;
    int winc = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, winc, d);
      if (lane >= d) winc += y;
    }
    if (lane < kThreads / 32) scratch[lane] = winc - w;
    if (lane == 31) *total = winc;
  }
  __syncthreads();
  const int prefix = scratch[warp] + inc - x;
  __syncthreads();
  return prefix;
}

// A row's binned pairs, [ntiles, kTile] of them.  With kClaim an 8-byte
// word each, (offset in the segment | position in the tile << 16, value
// bits); else 6 bytes, the value and the 16-bit offset in two arrays.
template <bool kClaim>
struct Runs;

template <>
struct Runs<true> {
  uint2* pair;
};

template <>
struct Runs<false> {
  float* val;
  uint16_t* off;
};

// row m's pairs in a scratch of M rows of row_len pairs (the unique
// layout: every row's values, then every row's offsets)
template <bool kClaim>
__device__ __forceinline__ Runs<kClaim> row_runs(void* scratch, int M, int m,
                                                 long long row_len) {
  if constexpr (kClaim) {
    return Runs<true>{static_cast<uint2*>(scratch) + m * row_len};
  } else {
    float* vals = static_cast<float*>(scratch);
    return Runs<false>{vals + m * row_len,
                       reinterpret_cast<uint16_t*>(vals + M * row_len) + m * row_len};
  }
}

// bin: grid (tiles, rows).  Tile t of row m (kTile j): read (idx, v), form
// gain * v, count by segment the indices that land in the window [base,
// base + nw), sort the tile by segment in shared memory, write the runs'
// starts (the row's [nseg + 1, ntiles] of `starts`) and the pairs.
// smem: the staged pairs [kTile] (8 or 6 bytes each), counts [nseg + 1],
// scan scratch.
template <typename I, bool kClaim>
__global__ void __launch_bounds__(kThreads, 2)
    bin_kernel(const float* __restrict__ v, const I* __restrict__ idx, long long ld,
               int base, int nw, int k, float gain, int nseg, int ntiles, void* pairs,
               int* __restrict__ starts) {
  constexpr int kPer = kTile / kThreads;
  constexpr int kLog = kSegLog<kClaim>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int m = blockIdx.y, t = blockIdx.x;
  const Runs<kClaim> runs =
      row_runs<kClaim>(pairs, gridDim.y, m, static_cast<long long>(ntiles) * kTile);
  uint2* staged = reinterpret_cast<uint2*>(smem);  // kClaim
  float* staged_val = reinterpret_cast<float*>(smem);  // unique
  uint16_t* staged_off = reinterpret_cast<uint16_t*>(staged_val + kTile);
  int* cnt = reinterpret_cast<int*>(smem + kTile * (kClaim ? 8 : 6));
  int* scan = cnt + nseg + 1;
  for (int s = threadIdx.x; s <= nseg; s += kThreads) cnt[s] = 0;
  const I* ir = idx + static_cast<long long>(m) * ld;
  const float* vr = v + static_cast<long long>(m) * k;
  const int j0 = t * kTile;
  // the index and value loads of a thread all issue before any is used
  I ix[kPer];
  float val[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int j = j0 + i * kThreads + threadIdx.x;
    ix[i] = j < k ? __ldcs(ir + j) : static_cast<I>(-1);
    val[i] = j < k ? __ldcs(vr + j) : 0.0f;
  }
  __syncthreads();  // counts cleared
  int seg[kPer], rank[kPer];
  uint32_t key[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int p = i * kThreads + threadIdx.x;
    const unsigned long long u = rel(ix[i], base);
    seg[i] = -1;
    if (u < static_cast<unsigned long long>(nw)) {
      seg[i] = static_cast<int>(u >> kLog);
      key[i] = (static_cast<uint32_t>(u) & ((1u << kLog) - 1u)) |
               (kClaim ? static_cast<uint32_t>(p) << 16 : 0u);
      val[i] = __fmul_rn(gain, val[i]);
      rank[i] = atomicAdd(cnt + seg[i], 1);
    }
  }
  __syncthreads();
  // exclusive scan of the counts: each thread sums a slice, then the block
  const int per = (nseg + kThreads - 1) / kThreads;
  const int lo = threadIdx.x * per, hi = min(lo + per, nseg);
  int sum = 0;
  for (int s = lo; s < hi; ++s) sum += cnt[s];
  int run = block_scan(sum, scan, cnt + nseg);
  for (int s = lo; s < hi; ++s) {
    const int c = cnt[s];
    cnt[s] = run;
    run += c;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (seg[i] < 0) continue;
    const int q = cnt[seg[i]] + rank[i];
    if constexpr (kClaim) {
      staged[q] = make_uint2(key[i], __float_as_uint(val[i]));
    } else {
      staged_val[q] = val[i];
      staged_off[q] = static_cast<uint16_t>(key[i]);
    }
  }
  __syncthreads();
  int* col = starts + static_cast<long long>(m) * (nseg + 1) * ntiles + t;
  for (int s = threadIdx.x; s <= nseg; s += kThreads) {
    col[static_cast<long long>(s) * ntiles] = cnt[s];
  }
  const int total = cnt[nseg];
  const long long t0 = static_cast<long long>(t) * kTile;
  for (int p = threadIdx.x; p < total; p += kThreads) {
    if constexpr (kClaim) {
      runs.pair[t0 + p] = staged[p];
    } else {
      runs.val[t0 + p] = staged_val[p];
      runs.off[t0 + p] = staged_off[p];
    }
  }
}

template <bool kClaim>
__device__ __forceinline__ float seg_value(const void* seg, int i) {
  if (kClaim) {
    const unsigned long long w = static_cast<const unsigned long long*>(seg)[i];
    return w ? __uint_as_float(static_cast<uint32_t>(w)) : 0.0f;
  }
  return static_cast<const float*>(seg)[i];
}

// fill: grid (segments, rows).  Segment s of the window [base, base + nw)
// of row m (rows n apart): clear it in shared memory, store the values of
// its runs in every tile of the row (as bin wrote them), then write it out
// in order.  smem: the segment (S floats, or S 64-bit words with kClaim),
// then the staged runs of up to kChunk tiles: their starts and exclusive
// prefix of lengths, and the scan scratch.
template <bool kClaim>
__global__ void __launch_bounds__(kThreads)
    fill_kernel(void* pairs, const int* __restrict__ starts, int n, int base, int nw,
                int nseg, int ntiles, float* __restrict__ out) {
  constexpr int kLog = kSegLog<kClaim>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int m = blockIdx.y, s = blockIdx.x;
  const Runs<kClaim> runs =
      row_runs<kClaim>(pairs, gridDim.y, m, static_cast<long long>(ntiles) * kTile);
  unsigned long long* seg64 = reinterpret_cast<unsigned long long*>(smem);
  float* segf = reinterpret_cast<float*>(smem);
  const int g0 = s << kLog;
  const int len = min(1 << kLog, nw - g0);
  int* run_lo = reinterpret_cast<int*>(smem + (static_cast<size_t>(1) << kLog) *
                                                  (kClaim ? 8 : 4));
  int* run_pre = run_lo + kChunk;
  int* scan = run_pre + kChunk + 1;
  if (kClaim) {
    for (int i = threadIdx.x; i < len; i += kThreads) seg64[i] = 0ull;
  } else {
    for (int i = threadIdx.x; i < len; i += kThreads) segf[i] = 0.0f;
  }
  const int* lo_col =
      starts + (static_cast<long long>(m) * (nseg + 1) + s) * ntiles;
  const int* hi_col = lo_col + ntiles;
  for (int c0 = 0; c0 < ntiles; c0 += kChunk) {
    const int nc = min(kChunk, ntiles - c0);
    // two tiles a thread: their runs' starts and lengths, scanned
    int l0 = 0, l1 = 0;
    const int q0 = 2 * threadIdx.x, q1 = q0 + 1;
    if (q0 < nc) {
      run_lo[q0] = __ldg(lo_col + c0 + q0);
      l0 = __ldg(hi_col + c0 + q0) - run_lo[q0];
    }
    if (q1 < nc) {
      run_lo[q1] = __ldg(lo_col + c0 + q1);
      l1 = __ldg(hi_col + c0 + q1) - run_lo[q1];
    }
    const int pre = block_scan(l0 + l1, scan, scan + kThreads / 32);
    if (q0 < nc) run_pre[q0] = pre;
    if (q1 < nc) run_pre[q1] = pre + l0;
    const int total = scan[kThreads / 32];
    __syncthreads();
    for (int p0 = threadIdx.x; p0 < total; p0 += kFillBatch * kThreads) {
      uint2 e[kFillBatch];  // kClaim: the pair; else (offset, value bits)
      int tile[kFillBatch];
#pragma unroll
      for (int u = 0; u < kFillBatch; ++u) {
        const int p = p0 + u * kThreads;
        tile[u] = -1;
        if (p < total) {
          int a = 0, b = nc;  // last q with run_pre[q] <= p
          while (b - a > 1) {
            const int mid = (a + b) >> 1;
            if (run_pre[mid] <= p) a = mid; else b = mid;
          }
          tile[u] = c0 + a;
          const long long q = static_cast<long long>(c0 + a) * kTile + run_lo[a] + p -
                              run_pre[a];
          if constexpr (kClaim) {
            e[u] = __ldcs(runs.pair + q);
          } else {
            e[u] = make_uint2(__ldcs(runs.off + q), __float_as_uint(__ldcs(runs.val + q)));
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kFillBatch; ++u) {
        if (tile[u] < 0) continue;
        const uint32_t off = e[u].x & 0xffffu;
        if constexpr (kClaim) {
          const uint32_t j = static_cast<uint32_t>(tile[u]) * kTile + (e[u].x >> 16);
          atomicMax(seg64 + off, (static_cast<unsigned long long>(j + 1u) << 32) | e[u].y);
        } else {
          segf[off] = __uint_as_float(e[u].y);
        }
      }
    }
    __syncthreads();
  }
  // the segment, in order: scalar up to the row's first 16-byte boundary,
  // then 16-byte stores, then the scalar tail
  float* orow = out + static_cast<long long>(m) * n + base + g0;
  const int lead = static_cast<int>((reinterpret_cast<uintptr_t>(orow) >> 2) & 3);
  const int a0 = min((4 - lead) & 3, len);
  const int groups = (len - a0) >> 2;
  if (static_cast<int>(threadIdx.x) < a0) {
    __stcs(orow + threadIdx.x, seg_value<kClaim>(smem, threadIdx.x));
  }
  for (int g = threadIdx.x; g < groups; g += kThreads) {
    const int i = a0 + 4 * g;
    __stcs(reinterpret_cast<float4*>(orow + i),
           make_float4(seg_value<kClaim>(smem, i), seg_value<kClaim>(smem, i + 1),
                       seg_value<kClaim>(smem, i + 2), seg_value<kClaim>(smem, i + 3)));
  }
  const int tail = a0 + 4 * groups + static_cast<int>(threadIdx.x);
  if (tail < len) __stcs(orow + tail, seg_value<kClaim>(smem, tail));
}

size_t bin_smem(int nseg, bool claim) {
  return static_cast<size_t>(kTile) * (claim ? 8 : 6) +
         (static_cast<size_t>(nseg) + 1 + kThreads / 32 + 1) * sizeof(int);
}

template <bool kClaim>
constexpr size_t fill_smem() {
  return (static_cast<size_t>(1) << kSegLog<kClaim>) * (kClaim ? 8 : 4) +
         (2 * kChunk + 1 + kThreads / 32 + 1) * sizeof(int);
}

// Raises `kernel`'s dynamic shared-memory limit to `bytes` (the most any
// launch of it asks) once per device and process: `done` holds a bit per
// device, so that a launch pays no attribute call.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, unsigned long long* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (*done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) *done |= bit;
  return err;
}

// One window's bin and fill, each launch checked.
template <typename I, bool kClaim>
cudaError_t scatter_window(const float* v, const void* idx, long long ld, int M, int n,
                           int k, float gain, int base, int nw, void* pairs, int* starts,
                           float* out, cudaStream_t st) {
  static unsigned long long bin_done = 0, fill_done = 0;
  const int nseg = ((nw - 1) >> kSegLog<kClaim>) + 1;
  const int ntiles = (k + kTile - 1) / kTile;
  auto bin = &bin_kernel<I, kClaim>;
  cudaError_t err = allow_smem(bin, bin_smem(kMaxSegs, kClaim), &bin_done);
  if (err != cudaSuccess) return err;
  bin<<<dim3(ntiles, M), kThreads, bin_smem(nseg, kClaim), st>>>(
      v, static_cast<const I*>(idx), ld, base, nw, k, gain, nseg, ntiles, pairs, starts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto fill = &fill_kernel<kClaim>;
  err = allow_smem(fill, fill_smem<kClaim>(), &fill_done);
  if (err != cudaSuccess) return err;
  fill<<<dim3(nseg, M), kThreads, fill_smem<kClaim>(), st>>>(pairs, starts, n, base, nw,
                                                             nseg, ntiles, out);
  return cudaGetLastError();
}

// The binned scatter, window by window (kMaxSegs segments each).
template <typename I, bool kClaim>
cudaError_t binned_scatter(const float* v, const void* idx, long long ld, int M, int n,
                           int k, float gain, void* pairs, int* starts, float* out,
                           cudaStream_t st) {
  constexpr long long kWindow = static_cast<long long>(kMaxSegs) << kSegLog<kClaim>;
  for (long long base = 0; base < n; base += kWindow) {
    const int nw = static_cast<int>(n - base < kWindow ? n - base : kWindow);
    const cudaError_t err = scatter_window<I, kClaim>(
        v, idx, ld, M, n, k, gain, static_cast<int>(base), nw, pairs, starts, out, st);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// out[m, j] = x[m, idx[m * ld + j]]; idx int64 when idx64, else int32
extern "C" int sparse_gather(const void* x, int M, int n, const void* idx, int idx64,
                             long long ld, int k, void* out, void* stream) {
  if (M <= 0 || M > 65535 || n <= 0 || k <= 0 || ld < k) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid((k + kGatherThreads * kGatherPer - 1) / (kGatherThreads * kGatherPer), M);
  const auto* xf = static_cast<const float*>(x);
  auto* o = static_cast<float*>(out);
  if (idx64) {
    gather_kernel<long long><<<grid, kGatherThreads, 0, st>>>(
        xf, n, static_cast<const long long*>(idx), ld, k, o);
  } else {
    gather_kernel<int><<<grid, kGatherThreads, 0, st>>>(
        xf, n, static_cast<const int*>(idx), ld, k, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// Writes every element of out [M, n] (bin, then fill, for each window of
// kMaxSegs segments); claim keeps the last j of a repeat.  pairs must hold
// M * ceil(k / kTile) * kTile pairs (8 bytes each with claim, else 6) and
// starts M * (min(ceil(n / S), kMaxSegs) + 1) * ceil(k / kTile) int32
// (the wrapper's torch.empty).
extern "C" int sparse_scatter(const void* v, const void* idx, int idx64, long long ld,
                              int M, int n, int k, float gain, int claim, void* pairs,
                              void* starts, void* out, void* stream) {
  if (M <= 0 || M > 65535 || n <= 0 || k <= 0 || ld < k || pairs == nullptr ||
      starts == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* vf = static_cast<const float*>(v);
  auto* sp = static_cast<int*>(starts);
  auto* o = static_cast<float*>(out);
  cudaError_t err;
  if (idx64 && claim) {
    err = binned_scatter<long long, true>(vf, idx, ld, M, n, k, gain, pairs, sp, o, st);
  } else if (idx64) {
    err = binned_scatter<long long, false>(vf, idx, ld, M, n, k, gain, pairs, sp, o, st);
  } else if (claim) {
    err = binned_scatter<int, true>(vf, idx, ld, M, n, k, gain, pairs, sp, o, st);
  } else {
    err = binned_scatter<int, false>(vf, idx, ld, M, n, k, gain, pairs, sp, o, st);
  }
  return static_cast<int>(err);
}
