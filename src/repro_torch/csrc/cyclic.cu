// K8 and K9: cyclic-window gather and scatter over a batch of M messages,
// the per-message route of RandK's block sampler (one random offset per
// message, k contiguous coordinates from it, wrapping at n).
//
// Replaces: src/repro/kernels/sparse_gather/kernel.py:110 cyclic_gather
// (body _cyclic_gather_kernel :104, pallas_call :119) and :257
// cyclic_scatter (body _cyclic_scatter_kernel :251, pallas_call :266),
// with their wrappers (sparse_gather/ops.py:113, :124), which the
// reference runs once per message under vmap.  The TPU kernels work on a
// doubled buffer x2 = [x, x, 0...] (K8) and a doubled, zero-padded output
// plane folded as out2[:n] + out2[n:2n] (K9), so that every tile is one
// in-bounds dynamic slice.  Here each thread computes its own wrapped index
// instead, and neither buffer exists.
//
// K8: out[m, j] = x[m, (off[m] + j) mod n] for j < k.
// K9: out[m, p] = gain * v[m, (p - off[m]) mod n] + 0.0 where that index is
//     below k, else +0.0.  The reference's fold adds a +0.0 from the other
//     half of the doubled plane to every element, which turns a -0.0 value
//     into +0.0; __fadd_rn(., 0.0f) repeats that add (it is not folded
//     away), and __fmul_rn keeps the multiply out of an FMA.  Every output
//     element is written here, so the wrapper's plane is torch.empty: no
//     zero-fill pass.
//
// off is the int64 offset of each message as randint drew it; the kernels
// reduce it mod n themselves (the reference's jnp.mod).  Row bases m * n
// and m * k are int64 (M * n passes 2^31 at [90, 2^25]); in-row indices
// stay int32, since off + j < 2n < 2^31 for n < 2^30 (the wrapper checks).
//
// Bound: bytes.  K8 reads k words and writes k words per row; K9 reads k
// words and writes n.  Neighbouring threads take neighbouring j (or p), so
// loads and stores coalesce, with at most one wrap per row; a row's window
// starts at an arbitrary offset, so the accesses are 4-byte words and a
// warp's 128 bytes may span two extra sectors.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ int reduce_offset(long long off, int n) {
  long long o = off % n;
  return static_cast<int>(o < 0 ? o + n : o);
}

__global__ void cyclic_gather_kernel(const float* __restrict__ x,
                                     const long long* __restrict__ off, int M,
                                     int n, int k, float* __restrict__ out) {
  for (int m = blockIdx.y; m < M; m += gridDim.y) {
    const float* xr = x + static_cast<long long>(m) * n;
    float* orow = out + static_cast<long long>(m) * k;
    const int o = reduce_offset(off[m], n);
    const int base = blockIdx.x * kTile + threadIdx.x;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int j = base + i * kThreads;
      if (j < k) {
        int s = o + j;
        if (s >= n) s -= n;
        orow[j] = xr[s];
      }
    }
  }
}

__global__ void cyclic_scatter_kernel(const float* __restrict__ v,
                                      const long long* __restrict__ off,
                                      int M, int n, int k, float gain,
                                      float* __restrict__ out) {
  for (int m = blockIdx.y; m < M; m += gridDim.y) {
    const float* vr = v + static_cast<long long>(m) * k;
    float* orow = out + static_cast<long long>(m) * n;
    const int o = reduce_offset(off[m], n);
    const int base = blockIdx.x * kTile + threadIdx.x;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int p = base + i * kThreads;
      if (p < n) {
        int j = p - o;
        if (j < 0) j += n;
        orow[p] = j < k ? __fadd_rn(__fmul_rn(gain, vr[j]), 0.0f) : 0.0f;
      }
    }
  }
}

bool bad_shape(int M, int n, int k) {
  return M <= 0 || n <= 0 || n >= (1 << 30) || k <= 0 || k > n;
}

dim3 grid_of(int width, int M) {
  return dim3((width + kTile - 1) / kTile, M < kMaxGridY ? M : kMaxGridY);
}

}  // namespace

extern "C" int cyclic_gather(const void* x, const void* off, int M, int n,
                             int k, void* out, void* stream) {
  if (bad_shape(M, n, k)) return static_cast<int>(cudaErrorInvalidValue);
  cyclic_gather_kernel<<<grid_of(k, M), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const long long*>(off), M, n,
      k, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cyclic_scatter(const void* v, const void* off, int M, int n,
                              int k, float gain, void* out, void* stream) {
  if (bad_shape(M, n, k)) return static_cast<int>(cudaErrorInvalidValue);
  cyclic_scatter_kernel<<<grid_of(n, M), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const long long*>(off), M, n,
      k, gain, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
