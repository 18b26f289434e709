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
// Bound: integer operations.  One block is 20 rounds of an add, a rotation
// and a xor, and 12 key-injection adds (fewer where ptxas folds a fixed
// counter word or seed); chip_smoke.py's phase_sass counts its SASS by the
// pipe that issues each instruction.  Rotations (SHF) and xors (LOP3) only
// issue on the ALU pipe, 64 a clock per SM; an add issues on the ALU pipe
// as IADD3 or on the FMA pipe as an IMAD form or a VIADD (a K4 block with
// 14 VIADDs ran at 0.71 clocks per SM in tools/quantize_probe.py's rate
// probe, below the 0.84 that 54 ALU-pipe instructions take).  Left to
// itself, ptxas wrote 3 of the adds of a block as K1 draws it as IADD3:
// 40 SASS on the ALU pipe and 23 on the FMA pipe as compiled, and 40 / 24
// as K4 draws it.  So the adds after the first round are written as
// mad.lo.u32 by a 1 read from constant memory (add_fma), which ptxas
// cannot fold into an add: they stay IMADs on the FMA pipe, and the ALU
// pipe keeps the rotations and xors, 37 / 29 as K1 draws it and 40 / 31
// as K4 does.  Only K1's block lost ALU work: K4's lost its one IADD3 and
// gained a LOP3.  The counter and the first round keep plain adds, so
// that ptxas still folds a fixed counter word or seed into them.  The
// design keeps the cipher in registers, counts from the element
// index (no state, no random stream in memory), and folds each message's
// seed once per thread or block.
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

// a 1 that ptxas cannot fold: the multiplier of add_fma
static __constant__ uint32_t kFmaOne = 1u;

// a + b as an IMAD (the FMA pipe) instead of an IADD3 (the ALU pipe)
__device__ __forceinline__ uint32_t add_fma(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(kFmaOne), "r"(b));
  return r;
}

#define REPRO_TF_MIX(r)        \
  x0 = add_fma(x0, x1);        \
  x1 = rotl32(x1, r) ^ x0;
#define REPRO_TF_ROT0 REPRO_TF_MIX(13) REPRO_TF_MIX(15) REPRO_TF_MIX(26) REPRO_TF_MIX(6)
#define REPRO_TF_ROT1 REPRO_TF_MIX(17) REPRO_TF_MIX(29) REPRO_TF_MIX(16) REPRO_TF_MIX(24)

__device__ __forceinline__ Pair threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t c0, uint32_t c1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  uint32_t x0 = c0 + k0;
  uint32_t x1 = c1 + k1;
  x0 += x1;  // the first round's add, plain (see the header)
  x1 = rotl32(x1, 13) ^ x0;
  REPRO_TF_MIX(15) REPRO_TF_MIX(26) REPRO_TF_MIX(6)
  x0 = add_fma(x0, k1); x1 = add_fma(x1, k2 + 1u);
  REPRO_TF_ROT1 x0 = add_fma(x0, k2); x1 = add_fma(x1, k0 + 2u);
  REPRO_TF_ROT0 x0 = add_fma(x0, k0); x1 = add_fma(x1, k1 + 3u);
  REPRO_TF_ROT1 x0 = add_fma(x0, k1); x1 = add_fma(x1, k2 + 4u);
  REPRO_TF_ROT0 x0 = add_fma(x0, k2); x1 = add_fma(x1, k0 + 5u);
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
