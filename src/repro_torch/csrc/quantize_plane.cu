// K1: fused stochastic b-bit quantization of a whole message plane.
//
// Replaces: src/repro/kernels/quantize/kernel.py:148 quantize_plane (body
// _quantize_plane_kernel :128, pallas_call :167).
//
// q[m, j] = sign(x) * floor(levels * |x| / scale[m] + kappa), with
// kappa = uniform01(random_bits(fold(seed, sid[m], rid[m]), j)); the
// element counter j restarts for every message row.  b=8 stores int8,
// saturating to [-128, 127] as XLA's convert does (127 + kappa rounds to
// 128.0 when kappa rounds to 1.0); b=4 packs the pair (2i, 2i+1) as
// ((hi + 8) << 4) | (lo + 8) in int32 and keeps the low byte, an element
// past n counting as x = 0 (nibble 8).  The output is [M, wire] with
// wire = n (b=8) or ceil(n / 2) (b=4): no padded plane in or out.
//
// Bound: integer operations.  Each element costs one Threefry block (63
// SASS instructions) against 4 bytes read and 1 (b=8) or 0.5 (b=4)
// written, so the cipher, not memory, sets the floor (for [20, 2^20]:
// ~40 us of instruction issue at 128 per clock on 132 SMs, against ~31 us
// of bytes).  The
// design keeps everything else off that path: rows are read unpadded and
// masked at n, each thread folds its row's seed once for 32 elements, and
// loads and stores are coalesced (thread t of a block touches element
// base + t in each of its 32 steps).
//
// Arithmetic: quantize.cuh, shared with the per-message kernel K4.
#include <cuda_runtime.h>

#include "quantize.cuh"
#include "threefry.cuh"

namespace {

using repro::quantize_one;
using repro::to_int_sat;

constexpr int kThreads = 256;
constexpr int kPerThread = 32;
constexpr int kTile = kThreads * kPerThread;

__global__ void quantize8_kernel(const float* __restrict__ x, int n,
                                 uint32_t s0, uint32_t s1,
                                 const uint32_t* __restrict__ sids,
                                 const uint32_t* __restrict__ rids,
                                 const float* __restrict__ scale,
                                 int8_t* __restrict__ q) {
  const int m = blockIdx.y;
  const repro::Pair es = repro::message_seed(
      s0, s1, repro::id_or(sids, m, 0u), repro::id_or(rids, m, repro::kBroadcast));
  const float sc = scale[m];
  const float* xr = x + static_cast<long long>(m) * n;
  int8_t* qr = q + static_cast<long long>(m) * n;
  const int base = blockIdx.x * kTile + threadIdx.x;
#pragma unroll 4
  for (int i = 0; i < kPerThread; ++i) {
    const int j = base + i * kThreads;
    if (j < n) {
      const float kappa = repro::uniform01(repro::random_bits(es, static_cast<uint32_t>(j)));
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
      s0, s1, repro::id_or(sids, m, 0u), repro::id_or(rids, m, repro::kBroadcast));
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
        // the pad element past n is x = 0, whose q is 0 for any kappa
        float v = 0.f;
        if (j < n) {
          const float kappa = repro::uniform01(repro::random_bits(es, static_cast<uint32_t>(j)));
          v = quantize_one(xr[j], 7.f, sc, kappa);
        }
        nib[h] = repro::nibble(v);  // |v| <= 8
      }
      qr[p] = static_cast<uint8_t>((nib[0] << 4) | nib[1]);
    }
  }
}

}  // namespace

extern "C" int quantize_plane(const void* x, int M, int n, int bits,
                              uint32_t s0, uint32_t s1, const void* sids,
                              const void* rids, const void* scale, void* q,
                              int wire, void* stream) {
  if (M <= 0 || M > 65535 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xs = static_cast<const float*>(x);
  const auto* si = static_cast<const uint32_t*>(sids);
  const auto* ri = static_cast<const uint32_t*>(rids);
  const auto* sc = static_cast<const float*>(scale);
  if (bits == 8 && wire == n) {
    const dim3 grid((n + kTile - 1) / kTile, M);
    quantize8_kernel<<<grid, kThreads, 0, st>>>(xs, n, s0, s1, si, ri, sc,
                                                static_cast<int8_t*>(q));
  } else if (bits == 4 && wire == (n + 1) / 2) {
    const dim3 grid((wire + kTile - 1) / kTile, M);
    quantize4_kernel<<<grid, kThreads, 0, st>>>(xs, n, wire, s0, s1, si, ri,
                                                sc, static_cast<uint8_t*>(q));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
