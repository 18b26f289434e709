// K0: Threefry-2x32-20 and the seed/offset/stride derivations, as device
// functions inlined into the plane kernels (quantize_plane.cu,
// randk_plane.cu), the per-message quantizer (quantize_leaf.cu) and the
// threefry_bits test entry.
//
// Replaces: src/repro/kernels/prng.py (threefry2x32 :65, fold :83,
// random_bits :107, uniform01 :114, derive_offset :119,
// derive_stride_slot :127).  On the TPU these were jnp expressions inlined
// into the Pallas kernel bodies; here they are __forceinline__ functions.
//
// Bound: integer operations.  One block, as quantize_plane draws it (seed
// fixed per thread, counter word 1 zero, word 0 kept), compiles to 63 SASS
// instructions on sm_90a (20 add/rotate/xor rounds; chip_smoke.py counts
// them with cuobjdump), so a kernel that draws one block per element is
// limited by the cipher, not by its bytes: at 128 instructions per clock
// per SM, 63 per 5 bytes moved take longer than the bytes at 3.35 TB/s.
// The design keeps the cipher in registers, counts from the element index
// (no state, no random stream in memory), and folds each message's seed
// once per thread.
//
// Bit-equality with the reference: the cipher is plain uint32 arithmetic,
// identical on every backend.  uniform01 converts with round-to-nearest
// (__uint2float_rn), as XLA does; a 24-bit mantissa shortcut would differ.
#pragma once
#include <cstdint>

namespace repro {

constexpr uint32_t kBroadcast = 0xFFFFFFFFu;
constexpr uint32_t kParity = 0x1BD11BDAu;

struct Pair {
  uint32_t x0, x1;
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

#define REPRO_TF_MIX(r)        \
  x0 += x1;                    \
  x1 = rotl32(x1, r) ^ x0;
#define REPRO_TF_ROT0 REPRO_TF_MIX(13) REPRO_TF_MIX(15) REPRO_TF_MIX(26) REPRO_TF_MIX(6)
#define REPRO_TF_ROT1 REPRO_TF_MIX(17) REPRO_TF_MIX(29) REPRO_TF_MIX(16) REPRO_TF_MIX(24)

__device__ __forceinline__ Pair threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t c0, uint32_t c1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  uint32_t x0 = c0 + k0;
  uint32_t x1 = c1 + k1;
  REPRO_TF_ROT0 x0 += k1; x1 += k2 + 1u;
  REPRO_TF_ROT1 x0 += k2; x1 += k0 + 2u;
  REPRO_TF_ROT0 x0 += k0; x1 += k1 + 3u;
  REPRO_TF_ROT1 x0 += k1; x1 += k2 + 4u;
  REPRO_TF_ROT0 x0 += k2; x1 += k0 + 5u;
  return Pair{x0, x1};
}

#undef REPRO_TF_MIX
#undef REPRO_TF_ROT0
#undef REPRO_TF_ROT1

// fold(seed, sid, rid): one block per id, the fold depth in counter word 1
__device__ __forceinline__ Pair message_seed(uint32_t s0, uint32_t s1,
                                             uint32_t sid, uint32_t rid) {
  Pair a = threefry2x32(s0, s1, sid, 0u);
  return threefry2x32(a.x0, a.x1, rid, 1u);
}

__device__ __forceinline__ uint32_t random_bits(Pair es, uint32_t ctr) {
  return threefry2x32(es.x0, es.x1, ctr, 0u).x0;
}

// jax.random.bits(key, shape) in the partitionable threefry mode, at flat
// element j < 2^32: the block at counter (0, j) under the raw key, its two
// words XORed (src/repro_torch/core/jaxrand.py:bits).  Not the same draw
// as random_bits, which keeps word 0 of counter (j, stream).  The
// per-message quantizer (K4) draws its kappas from it.
__device__ __forceinline__ uint32_t jax_bits(uint32_t k0, uint32_t k1,
                                             uint32_t j) {
  const Pair y = threefry2x32(k0, k1, 0u, j);
  return y.x0 ^ y.x1;
}

__device__ __forceinline__ float uniform01(uint32_t bits) {
  return __fmul_rn(__uint2float_rn(bits), 0x1p-32f);
}

// derive_offset and derive_stride_slot share the block at counter (0, 1)
__device__ __forceinline__ Pair offset_block(Pair es) {
  return threefry2x32(es.x0, es.x1, 0u, 1u);
}

// Per-message ids: a null pointer means the default id (0 for senders,
// BROADCAST for receivers), as the reference wrappers fill them.
__device__ __forceinline__ uint32_t id_or(const uint32_t* ids, int m,
                                          uint32_t dflt) {
  return ids == nullptr ? dflt : ids[m];
}

}  // namespace repro
