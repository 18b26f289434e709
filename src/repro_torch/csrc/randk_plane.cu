// K2 and K3: fused RandK compress (gather) and decompress (scatter) of a
// whole message plane, with each message's index set derived in the
// kernel from (round seed, sender, receiver): no index array ever exists
// in device memory.
//
// Replaces: src/repro/kernels/sparse_gather/kernel.py:173
// randk_gather_plane (body :162, _affine_tile :145, pallas_call :189) and
// :222 randk_scatter_plane (body :206, pallas_call :233).
//
// Index set of message m: idx_j = (off + j * stride) mod n for j < k, with
// off = derive_offset(es, n), stride = strides[derive_stride_slot(es, .)]
// and es = fold(seed, sid[m], rid[m]).  The reference computes it in
// int32: the product and sum wrap at 2^31 and the result is floor-modded.
// In CUDA signed overflow is undefined and % truncates toward zero, so the
// sum is formed in uint32, reinterpreted as int32, then floor-modded.
// When n is not a power of two and (k - 1) * stride reaches 2^31, the wrap
// can repeat an index within a row; the reference's scatter then keeps
// the LAST j.  The scatter reproduces that with a claim pass (atomicMax
// of j into an int32 scratch plane) before the write pass; when the
// wrapper can prove the indices unique it passes no scratch and runs the
// write pass alone.
//
// Bound: bytes.  Gather reads k of n floats per row and writes k; scatter
// reads k floats and writes them into a zeroed [M, n] plane (the zero
// fill is the wrapper's torch.zeros).  Per element the index costs a
// multiply, an add and an integer remainder; the Threefry blocks are
// per thread (3 per 32 elements).  For the stride sampler the reads
// (gather) or writes (scatter) land one 4-byte word per 32-byte sector,
// so the achieved bandwidth sits well below the bound; fixing that
// (sorting a tile's indices, or a stride-aware tiling) is later work.
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 32;
constexpr int kTile = kThreads * kPerThread;
constexpr int kMaxStrides = 64;

struct StrideTable {
  int32_t v[kMaxStrides];
};

struct Affine {
  uint32_t off, stride;
};

__device__ __forceinline__ Affine affine_of(uint32_t s0, uint32_t s1,
                                            const uint32_t* sids,
                                            const uint32_t* rids, int m, int n,
                                            const StrideTable& table,
                                            int n_strides) {
  const repro::Pair es = repro::message_seed(
      s0, s1, repro::id_or(sids, m, 0u), repro::id_or(rids, m, repro::kBroadcast));
  const repro::Pair ob = repro::offset_block(es);
  const uint32_t slot = ob.x1 % static_cast<uint32_t>(n_strides);
  return Affine{ob.x0 % static_cast<uint32_t>(n),
                static_cast<uint32_t>(table.v[slot])};
}

__device__ __forceinline__ int affine_index(Affine a, int j, int n) {
  const int32_t v = static_cast<int32_t>(a.off + static_cast<uint32_t>(j) * a.stride);
  const int32_t r = v % n;
  return r < 0 ? r + n : r;
}

__global__ void gather_kernel(const float* __restrict__ x, int n, int k,
                              uint32_t s0, uint32_t s1,
                              const uint32_t* __restrict__ sids,
                              const uint32_t* __restrict__ rids,
                              StrideTable table, int n_strides,
                              float* __restrict__ out) {
  const int m = blockIdx.y;
  const Affine a = affine_of(s0, s1, sids, rids, m, n, table, n_strides);
  const float* xr = x + static_cast<long long>(m) * n;
  float* orow = out + static_cast<long long>(m) * k;
  const int base = blockIdx.x * kTile + threadIdx.x;
#pragma unroll 4
  for (int i = 0; i < kPerThread; ++i) {
    const int j = base + i * kThreads;
    if (j < k) orow[j] = xr[affine_index(a, j, n)];
  }
}

// claim pass (only when indices may repeat): winner[m, idx] = max j
__global__ void claim_kernel(int n, int k, uint32_t s0, uint32_t s1,
                             const uint32_t* __restrict__ sids,
                             const uint32_t* __restrict__ rids,
                             StrideTable table, int n_strides,
                             int32_t* __restrict__ winner) {
  const int m = blockIdx.y;
  const Affine a = affine_of(s0, s1, sids, rids, m, n, table, n_strides);
  int32_t* wrow = winner + static_cast<long long>(m) * n;
  const int base = blockIdx.x * kTile + threadIdx.x;
#pragma unroll 4
  for (int i = 0; i < kPerThread; ++i) {
    const int j = base + i * kThreads;
    if (j < k) atomicMax(wrow + affine_index(a, j, n), j);
  }
}

__global__ void scatter_kernel(const float* __restrict__ v, int n, int k,
                               float gain, uint32_t s0, uint32_t s1,
                               const uint32_t* __restrict__ sids,
                               const uint32_t* __restrict__ rids,
                               StrideTable table, int n_strides,
                               const int32_t* __restrict__ winner,
                               float* __restrict__ out) {
  const int m = blockIdx.y;
  const Affine a = affine_of(s0, s1, sids, rids, m, n, table, n_strides);
  const float* vrow = v + static_cast<long long>(m) * k;
  const long long row = static_cast<long long>(m) * n;
  const int base = blockIdx.x * kTile + threadIdx.x;
#pragma unroll 4
  for (int i = 0; i < kPerThread; ++i) {
    const int j = base + i * kThreads;
    if (j < k) {
      const int idx = affine_index(a, j, n);
      if (winner == nullptr || winner[row + idx] == j) {
        out[row + idx] = __fmul_rn(gain, vrow[j]);
      }
    }
  }
}

bool load_table(const int32_t* strides, int n_strides, StrideTable* t) {
  if (strides == nullptr || n_strides <= 0 || n_strides > kMaxStrides) {
    return false;
  }
  for (int i = 0; i < n_strides; ++i) t->v[i] = strides[i];
  return true;
}

}  // namespace

extern "C" int randk_gather_plane(const void* x, int M, int n, int k,
                                  uint32_t s0, uint32_t s1, const void* sids,
                                  const void* rids, const void* strides,
                                  int n_strides, void* out, void* stream) {
  StrideTable table{};
  if (M <= 0 || M > 65535 || n <= 0 || k <= 0 ||
      !load_table(static_cast<const int32_t*>(strides), n_strides, &table)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((k + kTile - 1) / kTile, M);
  gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, k, s0, s1,
      static_cast<const uint32_t*>(sids), static_cast<const uint32_t*>(rids),
      table, n_strides, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out must hold zeros; winner (nullable) must hold -1 everywhere
extern "C" int randk_scatter_plane(const void* v, int M, int n, int k,
                                   float gain, uint32_t s0, uint32_t s1,
                                   const void* sids, const void* rids,
                                   const void* strides, int n_strides,
                                   void* winner, void* out, void* stream) {
  StrideTable table{};
  if (M <= 0 || M > 65535 || n <= 0 || k <= 0 ||
      !load_table(static_cast<const int32_t*>(strides), n_strides, &table)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* si = static_cast<const uint32_t*>(sids);
  const auto* ri = static_cast<const uint32_t*>(rids);
  auto* win = static_cast<int32_t*>(winner);
  const dim3 grid((k + kTile - 1) / kTile, M);
  if (win != nullptr) {
    claim_kernel<<<grid, kThreads, 0, st>>>(n, k, s0, s1, si, ri, table,
                                            n_strides, win);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  scatter_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(v), n, k, gain, s0, s1, si, ri, table,
      n_strides, win, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
