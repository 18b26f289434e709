// K4 and K5: per-message stochastic b-bit quantize and dequantize, one
// launch for all M messages of a call (one scale and one key per row).
//
// Replaces: src/repro/kernels/quantize/kernel.py:73 quantize (bodies
// _quantize8_kernel :38 and _quantize4_kernel :53, pallas_call :86/:99)
// and :188 dequantize (bodies :48 and :64, pallas_call :195/:208), with
// their wrappers quantize_tensor/dequantize_tensor (quantize/ops.py:86,
// :104), which the reference runs once per message under vmap.
//
// K4: q[m, j] = sign(x) * floor(levels * |x| / scale[m] + kappa) with
// kappa = f32(bits) * 2^-32 (round-to-nearest, so kappa can be 1.0) and
// bits = jax.random.bits(key[m], (n_pad,))[j].  The reference reads that
// uint32 stream from device memory only so that interpret mode on a CPU
// can reproduce it (kernel.py:13-16); here each element draws its word in
// the kernel (threefry.cuh jax_bits), which gives the same bits and keeps
// an [M, n_pad] uint32 tensor out of memory.  b=8 stores int8 saturating
// as XLA's convert does; b=4 packs the pair (2i, 2i+1) as
// ((hi + 8) << 4) | (lo + 8) in int32 and keeps the low byte, an element
// past n counting as x = 0 (nibble 8), as the reference's zero padding to
// BLOCK = 1024 does.  The output is [M, wire] (wire = n or ceil(n / 2)):
// the reference slices its padded output to exactly that.
//
// K5: out[m, j] = (scale[m] * q[m, j]) * (1 / levels), two rounded
// multiplies, no FMA; b=4 unpacks the nibbles.  The reference writes
// (scale * q) / levels, but XLA strength-reduces a division by a constant
// into a multiply by the constant's f32 reciprocal, so that is what its
// kernel computes (a true division differs from it in the last bit for
// some levels and scales).  The reference's pad bytes (0 at b=8, 0x88 at b=4)
// only feed elements past n, which it slices away, so the kernel stops at
// n.
//
// Bound: K4 by integer operations (one full Threefry block per element,
// both words kept, against 4 bytes read and 1 or 0.5 written; chip_smoke.py
// counts the block's SASS instructions); K5 by bytes (1 or 0.5 read, 4
// written per element).  Design: as K1 (quantize_plane.cu): rows read
// unpadded and masked at n, each thread loads its row's key and scale once
// for 32 elements, coalesced loads and stores (thread t touches element
// base + t in each step).
#include <cuda_runtime.h>

#include "quantize.cuh"
#include "threefry.cuh"

namespace {

using repro::quantize_one;

constexpr int kThreads = 256;
constexpr int kPerThread = 32;
constexpr int kTile = kThreads * kPerThread;
// f32(1 / 127) and f32(1 / 7), correctly rounded, as XLA folds them
constexpr float kInv127 = 0x1.020408p-7f;
constexpr float kInv7 = 0x1.24924ap-3f;

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
      qr[j] = static_cast<int8_t>(repro::to_int_sat(v, -128.f, 127.f));
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
        // the pad element past n is x = 0, whose q is 0 for any kappa
        const float v =
            j < n ? quantize_one(xr[j], 7.f, sc, kappa_at(k0, k1, j)) : 0.f;
        nib[h] = repro::nibble(v);
      }
      qr[p] = static_cast<uint8_t>((nib[0] << 4) | nib[1]);
    }
  }
}

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
      orow[j] = __fmul_rn(__fmul_rn(sc, static_cast<float>(qr[j])), kInv127);
    }
  }
}

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
      orow[j] = __fmul_rn(__fmul_rn(sc, static_cast<float>(level)), kInv7);
    }
  }
}

bool bad_shape(int M, int n, int bits, int wire) {
  return M <= 0 || M > 65535 || n <= 0 ||
         !((bits == 8 && wire == n) || (bits == 4 && wire == (n + 1) / 2));
}

}  // namespace

extern "C" int quantize_leaf(const void* x, int M, int n, int bits,
                             const void* keys, const void* scale, void* q,
                             int wire, void* stream) {
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

extern "C" int dequantize_leaf(const void* q, int M, int n, int bits,
                               const void* scale, void* out, int wire,
                               void* stream) {
  if (bad_shape(M, n, bits, wire)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* sc = static_cast<const float*>(scale);
  auto* o = static_cast<float*>(out);
  const dim3 grid((n + kTile - 1) / kTile, M);
  if (bits == 8) {
    dequantize8_leaf<<<grid, kThreads, 0, st>>>(
        static_cast<const int8_t*>(q), n, sc, o);
  } else {
    dequantize4_leaf<<<grid, kThreads, 0, st>>>(
        static_cast<const uint8_t*>(q), n, wire, sc, o);
  }
  return static_cast<int>(cudaGetLastError());
}
