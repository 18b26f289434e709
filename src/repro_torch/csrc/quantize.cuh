// The b-bit stochastic quantizer's per-element arithmetic, shared by the
// plane kernel (K1, quantize_plane.cu) and the per-message kernels (K4,
// quantize_leaf.cu).  Only the source of kappa differs between them.
//
// q = sign(x) * floor(levels * |x| / scale + kappa), in the reference's
// operation order (src/repro/kernels/quantize/kernel.py:43): the explicit
// _rn intrinsics stop nvcc from contracting to FMA and keep the division
// correctly rounded, which is what the reference's IEEE ops give; the
// int8 payload bits depend on it.
#pragma once
#include <cstdint>

namespace repro {

__device__ __forceinline__ float quantize_one(float x, float levels,
                                              float scale, float kappa) {
  const float y =
      __fadd_rn(__fdiv_rn(__fmul_rn(levels, fabsf(x)), scale), kappa);
  const float s = x > 0.f ? 1.f : (x < 0.f ? -1.f : x);  // jnp.sign
  return __fmul_rn(s, floorf(y));
}

// float -> int as XLA converts: saturating, NaN to 0 (127 + a kappa that
// rounds to 1.0 gives 128.0, which must become 127, not wrap to -128)
__device__ __forceinline__ int to_int_sat(float q, float lo, float hi) {
  if (q != q) return 0;
  return static_cast<int>(fminf(fmaxf(q, lo), hi));
}

// offset-8 nibble of a b=4 level in [-8, 8]; NaN counts as level 0.  Level
// 8 gives 16, which the caller packs in int32 and truncates to a byte,
// exactly as the reference does (kernel.py:58-61).
__device__ __forceinline__ int nibble(float q) {
  return (q != q ? 0 : static_cast<int>(q)) + 8;
}

}  // namespace repro
