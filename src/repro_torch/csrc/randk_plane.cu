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
//
// Two variants, chosen by the wrapper before the launch
// (sparse_gather/ops.py: variant, by indices_unique):
//
// * pull, where no row can repeat an index: k <= n, every stride coprime
//   to n, and n a power of two (n divides 2^32, so the wrap leaves the
//   residues intact) or (n - 1) + (k - 1) * |stride| < 2^31 (no wrap).
//   Then j -> idx_j is a bijection of Z_n with inverse
//   j = (i - off) * stride^-1 mod n.  Both kernels walk their OUTPUT in
//   order, 4 consecutive elements a thread, written as one 16-byte
//   streaming store (scalar at a row's unaligned ends), and read the
//   scattered side from a row that stays in L2 while the row's blocks
//   run (the grid is row-major, 1024 elements a block):
//   - gather: out[m, j] = x[m, idx_j]; a thread derives idx at its first
//     j once and steps it by stride mod n with a conditional subtract
//     (a mask for a power of two), and issues its 4 loads before it
//     stores;
//   - scatter: out[m, i] = j(i) < k ? gain * v[m, j(i)] : +0.0, every
//     element of the plane written once, so the wrapper allocates it
//     with torch.empty (no zero fill); j(i) is formed once a thread in
//     64 bits (in 32 with a mask for a power of two) and stepped by
//     stride^-1.  The host passes the inverses as a second kernel-
//     argument table, beside the strides; the launcher checks them.
//   One thread derives the message's seed, offset and stride slot (3
//   Threefry blocks) for its whole block and shares them through shared
//   memory.
// * push, where indices may repeat (n not a power of two and the int32
//   sum wraps, e.g. n = 1,000,003 at k = n / 4): the first design.  Each
//   thread takes 32 j with a stride of 256, derives the seed itself and
//   forms every index with a multiply and a runtime remainder.  The
//   scatter writes into a plane the wrapper zeroed, after a claim pass
//   (atomicMax of j into an int32 scratch plane) that keeps the LAST j
//   of a repeated index, as the reference's scatter does.
//
// Bound: bytes.  Gather reads k of n floats per row and writes k; scatter
// reads k and writes n.  The pull variant moves its output at full
// sectors; its scattered side touches one 4-byte word per 32-byte sector
// of L2, which it pays in L2 traffic, not in HBM traffic, as long as the
// row it reads stays resident (4 MB of x, or k * 4 bytes of v, at a time).
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 32;  // push: j per thread
constexpr int kTile = kThreads * kPerThread;
constexpr int kVec = 4;  // pull: consecutive outputs per thread
constexpr int kMaxStrides = 64;

struct StrideTable {
  int32_t v[kMaxStrides];
};

struct Affine {
  uint32_t off, stride, slot;
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
                static_cast<uint32_t>(table.v[slot]), slot};
}

__device__ __forceinline__ int affine_index(Affine a, int j, int n) {
  const int32_t v = static_cast<int32_t>(a.off + static_cast<uint32_t>(j) * a.stride);
  const int32_t r = v % n;
  return r < 0 ? r + n : r;
}

// ---------------------------------------------------------------------------
// push variant
// ---------------------------------------------------------------------------

__global__ void randk_gather_push_kernel(const float* __restrict__ x, int n, int k,
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
__global__ void randk_claim_kernel(int n, int k, uint32_t s0, uint32_t s1,
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

__global__ void randk_scatter_push_kernel(const float* __restrict__ v, int n, int k,
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

// ---------------------------------------------------------------------------
// pull variant
// ---------------------------------------------------------------------------

// The thread's group of kVec consecutive outputs in a row of `len` that
// starts `lead` elements past a 16-byte boundary: positions
// [p0, p0 + kVec) clipped to [0, len), with p0 = kVec * g - lead, so that
// every whole group is one aligned 16-byte store.
struct Group {
  int p0, first, last;
  __device__ __forceinline__ bool whole(int len) const {
    return p0 >= 0 && p0 + kVec <= len;
  }
};

__device__ __forceinline__ Group group_of(const float* row, int len) {
  const int lead = static_cast<int>((reinterpret_cast<uintptr_t>(row) >> 2) & 3);
  const int p0 = (blockIdx.x * kThreads + threadIdx.x) * kVec - lead;
  return Group{p0, max(p0, 0), min(p0 + kVec, len)};
}

__device__ __forceinline__ void store_group(float* row, int len, Group g,
                                            const float (&val)[kVec]) {
  if (g.whole(len)) {
    __stcs(reinterpret_cast<float4*>(row + g.p0),
           make_float4(val[0], val[1], val[2], val[3]));
    return;
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    if (g.p0 + e >= g.first && g.p0 + e < g.last) __stcs(row + g.p0 + e, val[e]);
  }
}

// t + d mod n for t, d in [0, n)
template <bool kPow2>
__device__ __forceinline__ uint32_t add_mod(uint32_t t, uint32_t d, uint32_t n) {
  if (kPow2) return (t + d) & (n - 1);
  t += d;
  return t >= n ? t - n : t;
}

template <bool kPow2>
__global__ void __launch_bounds__(kThreads)
    randk_gather_pull_kernel(const float* __restrict__ x, int n, int k, uint32_t s0,
                       uint32_t s1, const uint32_t* __restrict__ sids,
                       const uint32_t* __restrict__ rids, StrideTable table,
                       int n_strides, float* __restrict__ out) {
  __shared__ Affine shared_affine;
  const int m = blockIdx.y;
  if (threadIdx.x == 0) {
    shared_affine = affine_of(s0, s1, sids, rids, m, n, table, n_strides);
  }
  __syncthreads();
  const Affine a = shared_affine;
  float* orow = out + static_cast<long long>(m) * k;
  const Group g = group_of(orow, k);
  if (g.first >= g.last) return;
  const uint32_t un = static_cast<uint32_t>(n);
  const int32_t sr = static_cast<int32_t>(a.stride) % n;
  const uint32_t step = static_cast<uint32_t>(sr < 0 ? sr + n : sr);
  // exact under the pull rule: the mask where n divides 2^32, else the
  // int32 sum does not wrap
  uint32_t idx = kPow2 ? (a.off + static_cast<uint32_t>(g.first) * a.stride) & (un - 1)
                       : static_cast<uint32_t>(affine_index(a, g.first, n));
  const float* xr = x + static_cast<long long>(m) * n;
  float val[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    val[e] = 0.0f;
    if (g.p0 + e >= g.first && g.p0 + e < g.last) {
      val[e] = __ldg(xr + idx);
      idx = add_mod<kPow2>(idx, step, un);
    }
  }
  store_group(orow, k, g, val);
}

template <bool kPow2>
__global__ void __launch_bounds__(kThreads)
    randk_scatter_pull_kernel(const float* __restrict__ v, int n, int k, float gain,
                        uint32_t s0, uint32_t s1,
                        const uint32_t* __restrict__ sids,
                        const uint32_t* __restrict__ rids, StrideTable table,
                        StrideTable inverses, int n_strides,
                        float* __restrict__ out) {
  __shared__ uint32_t shared_map[2];  // off, stride^-1 mod n
  const int m = blockIdx.y;
  if (threadIdx.x == 0) {
    const Affine a = affine_of(s0, s1, sids, rids, m, n, table, n_strides);
    shared_map[0] = a.off;
    shared_map[1] = static_cast<uint32_t>(inverses.v[a.slot]);
  }
  __syncthreads();
  const uint32_t off = shared_map[0], inv = shared_map[1];
  float* orow = out + static_cast<long long>(m) * n;
  const Group g = group_of(orow, n);
  if (g.first >= g.last) return;
  const uint32_t un = static_cast<uint32_t>(n), uk = static_cast<uint32_t>(k);
  const uint32_t i0 = static_cast<uint32_t>(g.first);
  uint32_t j;
  if (kPow2) {
    j = ((i0 - off) * inv) & (un - 1);
  } else {
    const uint32_t r = i0 >= off ? i0 - off : i0 + un - off;
    j = static_cast<uint32_t>(static_cast<unsigned long long>(r) * inv % un);
  }
  const float* vrow = v + static_cast<long long>(m) * k;
  float val[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    val[e] = 0.0f;
    if (g.p0 + e >= g.first && g.p0 + e < g.last) {
      if (j < uk) val[e] = __fmul_rn(gain, __ldg(vrow + j));
      j = add_mod<kPow2>(j, inv, un);
    }
  }
  store_group(orow, n, g, val);
}

bool load_table(const int32_t* strides, int n_strides, StrideTable* t) {
  if (strides == nullptr || n_strides <= 0 || n_strides > kMaxStrides) {
    return false;
  }
  for (int i = 0; i < n_strides; ++i) t->v[i] = strides[i];
  return true;
}

bool pow2(int n) { return (n & (n - 1)) == 0; }

// the pull kernels' index steps are exact: n divides 2^32, or the int32
// sum off + j * stride never wraps for j < k
bool steps_exact(int n, int k, const StrideTable& t, int n_strides) {
  if (pow2(n)) return true;
  long long widest = 0;
  for (int i = 0; i < n_strides; ++i) {
    const long long s = t.v[i] < 0 ? -static_cast<long long>(t.v[i]) : t.v[i];
    widest = s > widest ? s : widest;
  }
  return (n - 1) + static_cast<long long>(k - 1) * widest < (1LL << 31);
}

unsigned grid_x(int len) {
  // groups of kVec from p0 = -3 (a row three elements past a boundary)
  const long long groups = (static_cast<long long>(len) + 3 + kVec - 1) / kVec;
  return static_cast<unsigned>((groups + kThreads - 1) / kThreads);
}

bool plane_ok(int M, int n, int k) { return M > 0 && M <= 65535 && n > 0 && k > 0; }

}  // namespace

extern "C" int randk_gather_push(const void* x, int M, int n, int k,
                                 uint32_t s0, uint32_t s1, const void* sids,
                                 const void* rids, const void* strides,
                                 int n_strides, void* out, void* stream) {
  StrideTable table{};
  if (!plane_ok(M, n, k) ||
      !load_table(static_cast<const int32_t*>(strides), n_strides, &table)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((k + kTile - 1) / kTile, M);
  randk_gather_push_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, k, s0, s1,
      static_cast<const uint32_t*>(sids), static_cast<const uint32_t*>(rids),
      table, n_strides, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out must hold zeros; winner (nullable) must hold -1 everywhere
extern "C" int randk_scatter_push(const void* v, int M, int n, int k,
                                  float gain, uint32_t s0, uint32_t s1,
                                  const void* sids, const void* rids,
                                  const void* strides, int n_strides,
                                  void* winner, void* out, void* stream) {
  StrideTable table{};
  if (!plane_ok(M, n, k) ||
      !load_table(static_cast<const int32_t*>(strides), n_strides, &table)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* si = static_cast<const uint32_t*>(sids);
  const auto* ri = static_cast<const uint32_t*>(rids);
  auto* win = static_cast<int32_t*>(winner);
  const dim3 grid((k + kTile - 1) / kTile, M);
  if (win != nullptr) {
    randk_claim_kernel<<<grid, kThreads, 0, st>>>(n, k, s0, s1, si, ri, table,
                                            n_strides, win);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  randk_scatter_push_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(v), n, k, gain, s0, s1, si, ri, table,
      n_strides, win, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// refuses a plane whose index steps could be inexact (steps_exact)
extern "C" int randk_gather_pull(const void* x, int M, int n, int k,
                                 uint32_t s0, uint32_t s1, const void* sids,
                                 const void* rids, const void* strides,
                                 int n_strides, void* out, void* stream) {
  StrideTable table{};
  if (!plane_ok(M, n, k) ||
      !load_table(static_cast<const int32_t*>(strides), n_strides, &table) ||
      !steps_exact(n, k, table, n_strides)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(grid_x(k), M);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* si = static_cast<const uint32_t*>(sids);
  const auto* ri = static_cast<const uint32_t*>(rids);
  auto* o = static_cast<float*>(out);
  if (pow2(n)) {
    randk_gather_pull_kernel<true><<<grid, kThreads, 0, st>>>(xf, n, k, s0, s1, si, ri,
                                                        table, n_strides, o);
  } else {
    randk_gather_pull_kernel<false><<<grid, kThreads, 0, st>>>(xf, n, k, s0, s1, si, ri,
                                                         table, n_strides, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// writes every element of out; inverses[i] must be strides[i]^-1 mod n,
// k <= n and the steps exact (the pull rule), else the launch is refused
extern "C" int randk_scatter_pull(const void* v, int M, int n, int k,
                                  float gain, uint32_t s0, uint32_t s1,
                                  const void* sids, const void* rids,
                                  const void* strides, const void* inverses,
                                  int n_strides, void* out, void* stream) {
  StrideTable table{}, inv{};
  if (!plane_ok(M, n, k) || k > n ||
      !load_table(static_cast<const int32_t*>(strides), n_strides, &table) ||
      !load_table(static_cast<const int32_t*>(inverses), n_strides, &inv) ||
      !steps_exact(n, k, table, n_strides)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < n_strides; ++i) {
    const long long s = (static_cast<long long>(table.v[i]) % n + n) % n;
    if (inv.v[i] < 0 || inv.v[i] >= n || s * inv.v[i] % n != 1 % n) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const dim3 grid(grid_x(n), M);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* vf = static_cast<const float*>(v);
  const auto* si = static_cast<const uint32_t*>(sids);
  const auto* ri = static_cast<const uint32_t*>(rids);
  auto* o = static_cast<float*>(out);
  if (pow2(n)) {
    randk_scatter_pull_kernel<true><<<grid, kThreads, 0, st>>>(
        vf, n, k, gain, s0, s1, si, ri, table, inv, n_strides, o);
  } else {
    randk_scatter_pull_kernel<false><<<grid, kThreads, 0, st>>>(
        vf, n, k, gain, s0, s1, si, ri, table, inv, n_strides, o);
  }
  return static_cast<int>(cudaGetLastError());
}
