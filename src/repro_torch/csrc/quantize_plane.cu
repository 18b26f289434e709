// K1: stochastic b-bit quantization of a whole message plane, the row
// scales and the levels in one launch.
//
// Replaces: src/repro/kernels/quantize/kernel.py:148 quantize_plane (body
// _quantize_plane_kernel :128, pallas_call :167) and the scale pass of its
// wrapper (src/repro/kernels/quantize/ops.py:37, jnp.max |x|).
//
// scale[m] = max(max_j |x[m, j]|, tiny);
// q[m, j] = sign(x) * floor(levels * |x| / scale[m] + kappa), with
// kappa = uniform01(random_bits(fold(seed, sid[m], rid[m]), j)); the
// element counter j restarts for every message row.  b=8 stores int8,
// saturating to [-128, 127] as XLA's convert does (127 + kappa rounds to
// 128.0 when kappa rounds to 1.0); b=4 packs the pair (2i, 2i+1) as
// ((hi + 8) << 4) | (lo + 8) in int32 and keeps the low byte, an element
// past n counting as x = 0 (nibble 8).  The output is [M, wire] with
// wire = n (b=8) or ceil(n / 2) (b=4): no padded plane in or out.  The
// f32 steps are the .ftz forms, as XLA computes them (quantize.cuh).
//
// Design: quantize.cuh's quantize_rows with the PlaneKappa source.  Its
// tickets hand out, in order, the max tiles of rows 0..L-1, then row r's
// quantise tiles alternating with row r + L's max tiles; a quantise tile
// waits (acquire) for its row's max tiles, which all hold earlier tickets
// and never wait, so the launch cannot deadlock, and it re-reads x from L2
// (L rows, ~16 MB).  A row of one tile (n <= 8,192) is reduced and
// quantised by one block.  One cudaMemsetAsync zeroes the scratch first.
//
// Bound: integer operations.  Per element one Threefry block (63 SASS
// instructions, 37 of them only on the ALU pipe, 26 adds and moves on
// either; chip_smoke.py's phase_sass counts them) against 4 bytes read
// and 1 (b=8) or 0.5 (b=4) written: at 64 ALU-only instructions a clock
// per SM on 132 SMs, [20, 2^20] takes at least 0.0464 ms of issue against
// 0.031 ms of bytes, [150, 2^20] 0.3479 ms.  The row seed is folded once
// per tile (thread 0, while it waits for the row's scale); x is read in
// 16-byte loads and q written one 4-byte word per 4 int8 levels (8 b=4).
#include <cuda_runtime.h>

#include "quantize.cuh"

extern "C" int quantize_plane(const void* x, int M, int n, int bits,
                              uint32_t s0, uint32_t s1, const void* sids,
                              const void* rids, void* scale, void* q,
                              int wire, void* scratch, void* stream) {
  if (M <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const repro::PlaneKappa src{s0, s1, static_cast<const uint32_t*>(sids),
                              static_cast<const uint32_t*>(rids)};
  const auto* xs = static_cast<const float*>(x);
  auto* sc = static_cast<float*>(scale);
  auto* qs = static_cast<uint8_t*>(q);
  auto* scr = static_cast<unsigned*>(scratch);
  const auto st = static_cast<cudaStream_t>(stream);
  if (bits == 8 && wire == n) {
    return repro::launch_quantize_rows<8>(xs, M, n, wire, src, sc, qs, scr,
                                          st);
  }
  if (bits == 4 && wire == (n + 1) / 2) {
    return repro::launch_quantize_rows<4>(xs, M, n, wire, src, sc, qs, scr,
                                          st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
