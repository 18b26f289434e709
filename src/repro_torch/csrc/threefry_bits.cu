// K0 test entry: the device cipher of threefry.cuh over a batch of message
// seeds and counters, so the cipher can be held bit-exact against the
// plain PyTorch version (repro_torch/kernels/prng.py) on the card.
//
// Replaces: nothing on its own; it exposes the code that quantize_plane.cu
// and randk_plane.cu inline (src/repro/kernels/prng.py:65-130).
//
// Bound: integer operations (one Threefry block per output word against
// 8 bytes moved).  Grid: x over counters, y over messages.  Thread 0 of a
// block folds its message's seed into shared memory, so the cipher's own
// rate shows: every other thread draws its kPerThread counters.  The
// indices are 32-bit, so the C entry refuses B * C > 2^32 words.
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;

__global__ void __launch_bounds__(kThreads)
threefry_bits_kernel(uint32_t s0, uint32_t s1,
                     const uint32_t* __restrict__ sids,
                     const uint32_t* __restrict__ rids,
                     const uint32_t* __restrict__ ctr, uint32_t C, int n,
                     int n_strides, uint32_t* __restrict__ bits,
                     int32_t* __restrict__ off, int32_t* __restrict__ slot) {
  __shared__ repro::Pair seed;
  const int b = blockIdx.y;
  if (threadIdx.x == 0) {
    const repro::Pair es = repro::message_seed(s0, s1, sids[b], rids[b]);
    seed = es;
    if (blockIdx.x == 0) {
      const repro::Pair ob = repro::offset_block(es);
      off[b] = static_cast<int32_t>(ob.x0 % static_cast<uint32_t>(n));
      slot[b] =
          static_cast<int32_t>(ob.x1 % static_cast<uint32_t>(n_strides));
    }
  }
  __syncthreads();
  const repro::Pair es = seed;
  uint32_t* row = bits + blockIdx.y * C;
  const uint32_t base = blockIdx.x * (kThreads * kPerThread) + threadIdx.x;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const uint32_t c = base + i * kThreads;
    if (c < C) row[c] = repro::random_bits(es, __ldg(ctr + c));
  }
}

}  // namespace

extern "C" int threefry_bits(uint32_t s0, uint32_t s1, const void* sids,
                             const void* rids, const void* ctr, int B, int C,
                             int n, int n_strides, void* bits, void* off,
                             void* slot, void* stream) {
  if (B <= 0 || B > 65535 || C <= 0 || n <= 0 || n_strides <= 0 ||
      1LL * B * C > (1LL << 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((C + kThreads * kPerThread - 1) / (kThreads * kPerThread), B);
  threefry_bits_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      s0, s1, static_cast<const uint32_t*>(sids),
      static_cast<const uint32_t*>(rids), static_cast<const uint32_t*>(ctr),
      static_cast<uint32_t>(C), n, n_strides, static_cast<uint32_t*>(bits),
      static_cast<int32_t*>(off), static_cast<int32_t*>(slot));
  return static_cast<int>(cudaGetLastError());
}
