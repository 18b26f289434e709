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
// K6: out[m, j] = x[m, idx[m, j]].
// K7: out[m, idx[m, j]] = gain * v[m, j] on a zero plane (the zero fill is
// the wrapper's torch.zeros, as for K3).  Uniform and TopK indices are
// unique by construction; the stride sampler's int32 wrap can repeat an
// index (n not a power of two, (k - 1) * stride >= 2^31), and there the
// reference's scatter keeps the LAST j.  As in K3, a claim pass (atomicMax
// of j into an int32 scratch plane holding -1) runs before the write pass
// only when the wrapper cannot prove the indices unique.  An index outside
// [0, n) is never dereferenced: the gather writes 0 for it and the
// scatter skips it (the reference requires in-range indices).
//
// Bound: bytes.  K6 reads k indices and k values and writes k values per
// row; K7 reads k indices and k values and writes the whole [M, n] plane
// (zero fill included).  Neighbouring threads take neighbouring j, so the
// index and value streams are coalesced; the x reads (K6) and out writes
// (K7) land at the indices, one 4-byte word per 32-byte sector for random
// indices, so achieved bandwidth sits well below the bound.  Each thread
// takes only 4 elements (a 1,024-element tile): blocks are short-lived and
// scheduled row by row, so the rows with blocks in flight (~2 of a
// [20, 2^20] plane on 132 SMs) stay inside the 50 MB L2 that the random
// accesses hit; 32 elements per thread put ~14 rows (55 MB) in flight.
// Sorting a tile's indices first is later work.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;

__device__ __forceinline__ bool in_range(int i, int n) {
  return static_cast<unsigned>(i) < static_cast<unsigned>(n);
}

__global__ void gather_kernel(const float* __restrict__ x, int n,
                              const int32_t* __restrict__ idx, int k,
                              float* __restrict__ out) {
  const int m = blockIdx.y;
  const float* xr = x + static_cast<long long>(m) * n;
  const long long row = static_cast<long long>(m) * k;
  const int base = blockIdx.x * kTile + threadIdx.x;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int j = base + i * kThreads;
    if (j < k) {
      const int s = idx[row + j];
      out[row + j] = in_range(s, n) ? xr[s] : 0.f;
    }
  }
}

// claim pass (only when indices may repeat): winner[m, idx] = max j
__global__ void claim_kernel(const int32_t* __restrict__ idx, int n, int k,
                             int32_t* __restrict__ winner) {
  const int m = blockIdx.y;
  const long long row = static_cast<long long>(m) * k;
  int32_t* wrow = winner + static_cast<long long>(m) * n;
  const int base = blockIdx.x * kTile + threadIdx.x;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int j = base + i * kThreads;
    if (j < k) {
      const int s = idx[row + j];
      if (in_range(s, n)) atomicMax(wrow + s, j);
    }
  }
}

__global__ void scatter_kernel(const float* __restrict__ v,
                               const int32_t* __restrict__ idx, int n, int k,
                               float gain, const int32_t* __restrict__ winner,
                               float* __restrict__ out) {
  const int m = blockIdx.y;
  const long long row = static_cast<long long>(m) * k;
  const long long plane = static_cast<long long>(m) * n;
  const int base = blockIdx.x * kTile + threadIdx.x;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int j = base + i * kThreads;
    if (j < k) {
      const int s = idx[row + j];
      if (in_range(s, n) && (winner == nullptr || winner[plane + s] == j)) {
        out[plane + s] = __fmul_rn(gain, v[row + j]);
      }
    }
  }
}

}  // namespace

extern "C" int sparse_gather(const void* x, int M, int n, const void* idx,
                             int k, void* out, void* stream) {
  if (M <= 0 || M > 65535 || n <= 0 || k <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((k + kTile - 1) / kTile, M);
  gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, static_cast<const int32_t*>(idx), k,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out must hold zeros; winner (nullable) must hold -1 everywhere
extern "C" int sparse_scatter(const void* v, const void* idx, int M, int n,
                              int k, float gain, void* winner, void* out,
                              void* stream) {
  if (M <= 0 || M > 65535 || n <= 0 || k <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* ix = static_cast<const int32_t*>(idx);
  auto* win = static_cast<int32_t*>(winner);
  const dim3 grid((k + kTile - 1) / kTile, M);
  if (win != nullptr) {
    claim_kernel<<<grid, kThreads, 0, st>>>(ix, n, k, win);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  scatter_kernel<<<grid, kThreads, 0, st>>>(static_cast<const float*>(v), ix,
                                            n, k, gain, win,
                                            static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
