// K4 and K5: per-message stochastic b-bit quantize and dequantize, one
// launch for all M messages of a call (one scale and one key per row).
//
// Replaces: src/repro/kernels/quantize/kernel.py:73 quantize (bodies
// _quantize8_kernel :38 and _quantize4_kernel :53, pallas_call :86/:99)
// and :188 dequantize (bodies :48 and :64, pallas_call :195/:208), with
// their wrappers quantize_tensor/dequantize_tensor (quantize/ops.py:86,
// :104), which the reference runs once per message under vmap; K4 also
// replaces the wrapper's scale pass (jnp.max |x|, ops.py:95).
//
// K4: scale[m] = max(max_j |x[m, j]|, tiny) and q[m, j] = sign(x) *
// floor(levels * |x| / scale[m] + kappa) with kappa = f32(bits) * 2^-32
// (round-to-nearest, so kappa can be 1.0) and bits =
// jax.random.bits(key[m], (n_pad,))[j].  The reference reads that uint32
// stream from device memory only so that interpret mode on a CPU can
// reproduce it (kernel.py:13-16); here each element draws its word in the
// kernel (threefry.cuh jax_bits), which gives the same bits and keeps an
// [M, n_pad] uint32 tensor out of memory.  b=8 stores int8 saturating as
// XLA's convert does; b=4 packs the pair (2i, 2i+1) as
// ((hi + 8) << 4) | (lo + 8) in int32 and keeps the low byte, an element
// past n counting as x = 0 (nibble 8), as the reference's zero padding to
// BLOCK = 1024 does.  The output is [M, wire] (wire = n or ceil(n / 2)):
// the reference slices its padded output to exactly that.  Design: K1's
// (quantize.cuh quantize_rows, ticketed max and quantise tiles in one
// launch after one memset, .ftz arithmetic), with the LeafKappa source
// (the keys in device memory).
//
// K5: out[m, j] = (scale[m] * q[m, j]) * (1 / levels), two rounded .ftz
// multiplies (a product below tiny becomes a zero of its sign, as XLA
// gives), no FMA; b=4 unpacks the nibbles.  The reference writes
// (scale * q) / levels, but XLA strength-reduces a division by a constant
// into a multiply by the constant's f32 reciprocal, so that is what its
// kernel computes (a true division differs from it in the last bit for
// some levels and scales).  The reference's pad bytes (0 at b=8, 0x88 at
// b=4) only feed elements past n, which it slices away, so the kernel
// stops at n.  The same kernels serve the plane route's dequantize_plane
// (plane = 1), whose reference is the jnp expression (scale * q) / levels
// (src/repro/kernels/quantize/ops.py:71), a true division there: its
// second step is an .ftz division, one pass where the flush in PyTorch
// would take four.
//
// Bound: K4 by integer operations (one full Threefry block per element,
// both words kept: 64 SASS, 39 only on the ALU pipe; chip_smoke.py's
// phase_sass counts them), against 4 bytes read and 1 or 0.5 written; K5
// by bytes (1 or 0.5 read, 4 written per element).  K5's design: rows read
// unpadded and masked at n, each thread loads its row's scale once for 32
// elements, coalesced loads and stores (thread t touches element base + t
// in each step).
#include <cuda_runtime.h>

#include "quantize.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 32;
constexpr int kTile = kThreads * kPerThread;
// f32(1 / 127) and f32(1 / 7), correctly rounded, as XLA folds them
constexpr float kInv127 = 0x1.020408p-7f;
constexpr float kInv7 = 0x1.24924ap-3f;

// the dequantised value of level v at scale sc: (sc * v) * f32(1 / levels)
// (K5) or, for the plane route, (sc * v) / levels, each step .ftz
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

bool bad_shape(int M, int n, int bits, int wire) {
  return M <= 0 || M > 65535 || n <= 0 ||
         !((bits == 8 && wire == n) || (bits == 4 && wire == (n + 1) / 2));
}

}  // namespace

// keys: M (k0, k1) pairs of uint32, in device memory
extern "C" int quantize_leaf(const void* x, int M, int n, int bits,
                             const void* keys, void* scale, void* q, int wire,
                             void* scratch, void* stream) {
  if (M <= 0 || n <= 0 ||
      !((bits == 8 && wire == n) || (bits == 4 && wire == (n + 1) / 2))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const repro::LeafKappa src{static_cast<const uint32_t*>(keys)};
  const auto* xs = static_cast<const float*>(x);
  auto* sc = static_cast<float*>(scale);
  auto* qs = static_cast<uint8_t*>(q);
  auto* scr = static_cast<unsigned*>(scratch);
  const auto st = static_cast<cudaStream_t>(stream);
  return bits == 8 ? repro::launch_quantize_rows<8>(xs, M, n, wire, src, sc,
                                                    qs, scr, st)
                   : repro::launch_quantize_rows<4>(xs, M, n, wire, src, sc,
                                                    qs, scr, st);
}

// plane = 0: K5 (the per-message route); 1: the plane route's
// dequantize_plane, whose reference divides by levels
extern "C" int dequantize_leaf(const void* q, int M, int n, int bits,
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
