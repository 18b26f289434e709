// K11, tensor-core variant: the Mamba2 SSD chunked scan for bf16 on Hopper
// (sm_90a), split over (batch, chunk, head) and run with wgmma.
//
// Replaces: src/repro/kernels/ssm_scan/kernel.py:81 ssd_scan (body
// _ssd_kernel :27, pallas_call :88), as ssd_scan.cu does; this file serves
// the bf16 shapes below, and ssd_scan.cu keeps f32 and the rest
// (ssm_scan/ops.py:route states the rule).
//
// Computes what ssd_scan.cu computes: x [B, T, NH, HD] (dt-scaled), alog
// [B, T, NH] (dt * A), B and C [B, T, NG, DS] at a token stride of their
// own, head h reading group h / (NH / NG), all bf16 and read in place;
// y [B, T, NH, HD] bf16 and h_final [B, NH, DS, HD] f32, zero initial
// state.  Per chunk of Q steps, in f32 as the reference's kernel:
//   cum = cumsum(alog), L[t][s] = exp(cum_t - cum_s) for s <= t, else 0
//   y   = (C B^T o L) X + exp(cum_t) (C h_in)
//   h   = exp(cum_Q) h_in + (B o exp(cum_Q - cum_s))^T X
//
// Work split (Mamba2's SSD decomposition), three launches on one stream:
//   (a) ssd_state_kernel, per (batch, chunk, head): the chunk's cumsum and
//       its own state S_c = Bw^T X (Bw = B o exp(cum_Q - cum_s)), written
//       to device memory in f32, and exp(cum_Q);
//   (b) ssd_pass_kernel, per (batch, head), elementwise over [DS, HD]:
//       h_c = exp(cum_Q) h_{c-1} + S_c across the chunks, writing each
//       chunk's h_in as bf16 pieces (below) and the last state as h_final;
//   (c) ssd_output_kernel, per (batch, chunk, head): y from the chunk's
//       inputs and h_in.
// Separate launches rather than one launch with a look-back between
// chunks: no block ever waits for another, so no launch order or ticket
// is needed to rule out a block waiting on one not yet resident; the cost
// is the state's round trip (S written and read, h_in written and read:
// 4 x 4 x DS x HD bytes a (batch, chunk, head), 168 MB at zamba2-2.7b's
// prefill, much of it in L2) and x read twice.
//
// A block of (a) or (c) takes one chunk of one batch and hb heads of one
// group (hb chosen at launch so that the grid fits the card's resident
// blocks in one wave, at most kMaxHB).  The group's C and B tiles are
// loaded once; in (c) C B^T is computed once for the block and kept in
// shared memory in f32, each thread's accumulator elements in its own
// slots.  The heads go through a ring of two x stages filled by 16-byte
// cp.async, so head i + 1's x loads while head i computes; in (c) the
// single h_in buffer is refilled as soon as every warpgroup has used it
// (after C h_in, before G X).  The cumsums of all hb heads run at the start
// of the block, one head a warp (a lane scans Q / 32 steps, then the lanes
// by shuffles); the exps are spread over every thread.
//
// Tensor-core products (wgmma m64nNk16, f32 accumulation; shared-memory
// tiles in wgmma's 128-byte-swizzled layout, rows of 64 bf16; A from
// registers in the accumulator's fragment layout, as flash_attention_sm90.cu
// does for p.v):
//   C B^T  (c): both operands bf16 from shared memory, K-major: exact
//          products; once per block (group, chunk), N = 64 columns a block
//          of the lower triangle's 64 x 64 blocks.
//   G X    (c): G = C B^T o L is f32; split G = g_hi + g_lo (bf16 pieces,
//          about 16 significant bits), two products with X MN-major.
//   C h_in (c): h_in f32, split h = h_hi + h_lo by (b); two products.
//   Bw^T X (a): Bw f32, split in three (hi, mid, lo: 24 bits), three
//          products.  h_final's limit (1e-5 of its max) is the one at risk:
//          two pieces read 3.8e-6 against the f32 plain version at
//          zamba2's [1, 2048, 80, 64], three 1.3e-7 (the CPU model,
//          ssm_scan/ref.py:ssd_scan_tc_model); y reads one bf16 ulp with
//          two pieces for G and h.
// The exps that reach h_final (exp(cum_Q - cum_s), exp(cum_Q)) are expf,
// as the plain version's exp; L's are __expf (the SFU's ex2, a few f32
// ulps off), which moves y by far less than its limit.  y is rounded to
// bf16 to nearest even.  Every wgmma runs on a path ptxas can see is
// uniform (it serialises them all otherwise, C7520; tools/ssd_probe.py):
// DS < 64 is padded with zeros rather than skipped, chunk 0's h_in is
// zeros, and warpgroup 0 runs warpgroup 1's second column block on a G of
// zeros.
//
// Shapes: Q in {32, 64, 128} and HD in {32, 64} (template), DS a multiple
// of 16 up to 64 (k-steps at run time).  Q = 128 runs two consumer
// warpgroups (t rows 0-63 and 64-127), Q <= 64 one; rows and columns past
// Q (Q = 32 fills a 64-row tile) and state rows past DS are computed and
// dropped.  Base pointers 16-byte aligned, token strides of B and C
// multiples of 8 elements.
//
// Shared memory, Q = 128 (c): x ring 2 x 16 KB, h_in pieces 16 KB, C B^T
// f32 48 KB (the B and C tiles borrow it before C B^T is computed), the
// cumsums hb x 512 B: 98 KB + hb / 2 KB, so two blocks on an SM; (a): x
// ring 32 KB, B 16 KB, cumsums and decays hb KB.  At zamba2-2.7b's prefill
// on an H100 the runtime reports (c) at 104,448 bytes, 128 registers, two
// blocks an SM, hb 10, 256 blocks (one wave); (a) at 57,344 bytes, three
// blocks an SM, hb 7, 384 blocks (ssm_scan/ops.py:tc_launch_info).
//
// Bound (chip_smoke.py's K11-tc row): the bytes of x, y, alog, B, C and
// h_final once each, and, on their own units, the products on the tensor
// cores (C B^T's lower triangle once per group and chunk, each product
// with an f32 operand times its pieces) and the exps on the SFUs; a
// second figure adds the chunk states' round trip.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using repro::fence_operands;
using repro::wgmma_commit;
using repro::wgmma_fence;
using repro::wgmma_rs;
using repro::wgmma_ss;
using repro::wgmma_wait;

constexpr int kRowBytes = 128;  // a tile row: 64 bf16, one swizzle atom wide
constexpr int kPieceBytes = 64 * kRowBytes;  // one h_in piece, DS <= 64 rows
constexpr int kCBBlockBytes = 64 * 64 * 4;   // a 64 x 64 f32 block of C B^T
constexpr int kMaxHB = 16;                   // heads a block walks, at most
constexpr int kPassThreads = 256;

struct Args {
  const bf16* x;
  const bf16* alog;
  const bf16* bm;
  const bf16* cm;
  bf16* y;
  float* h_out;
  float* S;   // [B, NC, NH, DS, HD] each chunk's own state
  bf16* hp;   // [B, NC, NH, 2, DS, HD] h_in of each chunk, hi and lo
  float* E;   // [B, NC, NH] exp(cum_Q)
  int B, T, NH, NG, HD, DS;
  long long b_stride, c_stride;  // elements between tokens of B and C
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk j of row r in a 128-byte-swizzled tile
__device__ __forceinline__ uint32_t sw_chunk(int r, int j) {
  return static_cast<uint32_t>(r * kRowBytes + ((j ^ (r & 7)) << 4));
}

// byte offset of element col of row r
__device__ __forceinline__ uint32_t sw_elem(int r, int col) {
  return sw_chunk(r, col >> 3) + (col & 7) * 2;
}

// wgmma's shared-memory matrix descriptor for the 128-byte swizzle
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// K-major operand (rows = M or N, columns = K): 64 rows from row0, the
// 16 columns of k-step kk
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int row0, int kk) {
  return desc(tile + row0 * kRowBytes + kk * 32, 16, 1024);
}

// MN-major B operand (rows = K, columns = N <= 64): the 16 rows of k-step
// kk (two 1024-byte atoms), the transpose bit set by wgmma_rs
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return desc(tile + kk * 2048, kPieceBytes, 1024);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits for every copy of this thread, then makes the tiles visible to
// wgmma (which reads shared memory through the async proxy)
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (v0, v1) as bf16 pieces: hi = bf16(v), then each next piece the bf16 of
// what the earlier ones left (exact differences in f32)
template <int kPieces>
__device__ __forceinline__ void split(float v0, float v1,
                                      uint32_t (&out)[kPieces]) {
#pragma unroll
  for (int k = 0; k < kPieces; ++k) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(v0, v1);
    out[k] = bits(p);
    const float2 f = __bfloat1622float2(p);
    v0 -= f.x;
    v1 -= f.y;
  }
}

// rows x chunks 16-byte chunks from src (row_stride elements apart) into
// a swizzled tile at dst
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          long long row_stride, int rows,
                                          int chunks, int tid, int nthr) {
  for (int i = tid; i < rows * chunks; i += nthr) {
    const int r = i / chunks, j = i - r * chunks;
    cp_async16(dst + sw_chunk(r, j), src + r * row_stride + 8 * j);
  }
}

// the inclusive cumsum of alog over the chunk's Q steps for heads h0 ..
// h0 + nh - 1, into cum[hh * Q + t]; one head a warp.  With ``dec``, also
// dec[hh * Q + s] = exp(cum_Q - cum_s) and E = exp(cum_Q).  Ends with the
// block synchronised.
template <int kQ>
__device__ void chunk_cumsum(const Args& a, long long tok0, int h0, int nh,
                             float* cum, float* dec, float* E_out) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  for (int i = tid; i < kQ * nh; i += nthr) {
    const int t = i / nh, hh = i - t * nh;
    cum[hh * kQ + t] = __bfloat162float(a.alog[(tok0 + t) * a.NH + h0 + hh]);
  }
  __syncthreads();
  constexpr int kPer = kQ / 32;
  const int warp = tid / 32, lane = tid % 32, nwarps = nthr / 32;
  for (int hh = warp; hh < nh; hh += nwarps) {
    float* c = cum + hh * kQ;
    float v[kPer];
    float run = 0.f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      run += c[lane * kPer + j];
      v[j] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    const float excl = incl - run;
#pragma unroll
    for (int j = 0; j < kPer; ++j) c[lane * kPer + j] = excl + v[j];
    if (dec != nullptr) {
      const float last = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        dec[hh * kQ + lane * kPer + j] = expf(last - (excl + v[j]));
      }
      if (lane == 0) E_out[h0 + hh] = expf(last);
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// (a) each chunk's own state, S = Bw^T X, one warpgroup; M = the state rows
// n (DS, padded to 64 with zeros), N = HD, K = the chunk's steps
// ---------------------------------------------------------------------------

constexpr int kBwPieces = 3;

template <int kQ>
struct StateTiles {
  static constexpr int kTile = kQ * kRowBytes;
  static constexpr int kX0 = 0, kB = 2 * kTile, kCum = 3 * kTile;
  static constexpr int smem(int hb) { return kCum + 8 * hb * kQ + 1024; }
};

template <int kQ, int kHD>
__global__ void __launch_bounds__(128) ssd_state_kernel(Args a, int hb,
                                                        int tiles) {
  using L = StateTiles<kQ>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sp = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const uint32_t base = smem_u32(sp);
  float* cum = reinterpret_cast<float*>(sp + L::kCum);
  float* dec = cum + hb * kQ;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, q = lane & 3;
  const int tile = blockIdx.x % tiles, g = blockIdx.x / tiles;
  const int c = blockIdx.y, b = blockIdx.z, NC = a.T / kQ;
  const int hpg = a.NH / a.NG, h0 = g * hpg + tile * hb;
  const int nh = min(hb, hpg - tile * hb);
  const long long tok0 = static_cast<long long>(b) * a.T +
                         static_cast<long long>(c) * kQ;
  const long long x_row = static_cast<long long>(a.NH) * kHD;
  const long long slot0 = (static_cast<long long>(b) * NC + c) * a.NH;

  load_tile(base + L::kB, a.bm + tok0 * a.b_stride + g * a.DS, a.b_stride,
            kQ, a.DS / 8, tid, 128);
  load_tile(base + L::kX0, a.x + tok0 * x_row + h0 * kHD, x_row, kQ, kHD / 8,
            tid, 128);
  cp_async_commit();
  chunk_cumsum<kQ>(a, tok0, h0, nh, cum, dec, a.E + slot0);

  const bf16* bt = reinterpret_cast<const bf16*>(sp + L::kB);
  const int n_a = 16 * warp + lane / 4;  // state rows n_a and n_a + 8
  constexpr int kHalves = (kQ + 63) / 64;
  for (int hi = 0; hi < nh; ++hi) {
    const int head = h0 + hi;
    const uint32_t xs = base + L::kX0 + (hi & 1) * L::kTile;
    cp_async_wait_all();
    __syncthreads();  // x(hi) and B have arrived; x(hi - 1) is read no more
    if (hi + 1 < nh) {
      load_tile(base + L::kX0 + ((hi + 1) & 1) * L::kTile,
                a.x + tok0 * x_row + (head + 1) * kHD, x_row, kQ, kHD / 8,
                tid, 128);
      cp_async_commit();
    }
    const float* dh = dec + hi * kQ;
    float acc[kHD / 2];
#pragma unroll
    for (int i = 0; i < kHD / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int half = 0; half < kHalves; ++half) {
      constexpr int kAll = kQ / 16;
      const int nk = min(4, kAll - 4 * half);  // k-steps of this half
      uint32_t p[4][4][kBwPieces];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk >= nk) break;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int n = n_a + 8 * (jj & 1);
          const int s = 16 * (4 * half + kk) + 8 * (jj >> 1) + 2 * q;
          // rows past DS read the tile's padding and are zeroed here, with
          // no branch (a wgmma operand set under one serialises them)
          const bool on = n < a.DS;
          const uint8_t* bp = reinterpret_cast<const uint8_t*>(bt);
          const float v0 = __bfloat162float(*reinterpret_cast<const bf16*>(
                               bp + sw_elem(s, n))) * dh[s];
          const float v1 = __bfloat162float(*reinterpret_cast<const bf16*>(
                               bp + sw_elem(s + 1, n))) * dh[s + 1];
          split<kBwPieces>(on ? v0 : 0.f, on ? v1 : 0.f, p[kk][jj]);
        }
      }
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk >= nk) break;
        const uint64_t dx = desc_mn(xs, 4 * half + kk);
#pragma unroll
        for (int k = 0; k < kBwPieces; ++k) {
          const uint32_t frag[4] = {p[kk][0][k], p[kk][1][k], p[kk][2][k],
                                    p[kk][3][k]};
          wgmma_rs(acc, frag, dx, 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) fence_operands(p[kk][jj]);
      }
    }
    float* sb = a.S + (slot0 + head) * a.DS * kHD;
#pragma unroll
    for (int i = 0; i < kHD / 2; i += 2) {
      const int n = n_a + 8 * ((i >> 1) & 1);
      const int col = 8 * (i >> 2) + 2 * q;
      if (n < a.DS) {
        *reinterpret_cast<float2*>(sb + n * kHD + col) =
            make_float2(acc[i], acc[i + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// (b) the states across the chunks, four elements a thread
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kPassThreads) ssd_pass_kernel(Args a,
                                                                int NC) {
  const int dshd = a.DS * a.HD;
  const int e = (blockIdx.x * kPassThreads + threadIdx.x) * 4;
  if (e >= dshd) return;
  const int head = blockIdx.y, b = blockIdx.z;
  const long long slot0 = static_cast<long long>(b) * NC * a.NH + head;
  float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 s = *reinterpret_cast<const float4*>(a.S + slot0 * dshd + e);
  for (int c = 0; c < NC; ++c) {
    const long long slot = slot0 + static_cast<long long>(c) * a.NH;
    float4 s_next = s;
    if (c + 1 < NC) {
      s_next = *reinterpret_cast<const float4*>(a.S + (slot + a.NH) * dshd +
                                                e);
    }
    if (c > 0) {  // chunk 0 starts from zero and reads no h_in
      uint32_t hi[2], lo[2];
      uint32_t p0[2], p1[2];
      split<2>(h.x, h.y, p0);
      split<2>(h.z, h.w, p1);
      hi[0] = p0[0], hi[1] = p1[0], lo[0] = p0[1], lo[1] = p1[1];
      bf16* dst = a.hp + slot * 2 * dshd + e;
      *reinterpret_cast<uint2*>(dst) = make_uint2(hi[0], hi[1]);
      *reinterpret_cast<uint2*>(dst + dshd) = make_uint2(lo[0], lo[1]);
    }
    const float ec = a.E[slot];
    h.x = __fadd_rn(__fmul_rn(ec, h.x), s.x);
    h.y = __fadd_rn(__fmul_rn(ec, h.y), s.y);
    h.z = __fadd_rn(__fmul_rn(ec, h.z), s.z);
    h.w = __fadd_rn(__fmul_rn(ec, h.w), s.w);
    s = s_next;
  }
  *reinterpret_cast<float4*>(
      a.h_out + (static_cast<long long>(b) * a.NH + head) * dshd + e) = h;
}

// ---------------------------------------------------------------------------
// (c) y per (batch, chunk, head); warpgroup w takes rows 64 w .. 64 w + 63
// ---------------------------------------------------------------------------

template <int kQ>
struct OutTiles {
  static constexpr int kMT = kQ > 64 ? 2 : 1;  // warpgroups
  static constexpr int kThreads = 128 * kMT;
  static constexpr int kTile = kQ * kRowBytes;  // x
  static constexpr int kRowsBC = kQ > 64 ? kQ : 64;  // B, C tiles (>= 64)
  static constexpr int kX0 = 0, kH = 2 * kTile, kCB = kH + 2 * kPieceBytes;
  static constexpr int kCBBlocks = kMT * (kMT + 1) / 2;
  static constexpr int kC = kCB + kRowsBC * kRowBytes;  // C's tile
  static constexpr int kCum = kCB + kCBBlocks * kCBBlockBytes;
  static constexpr int smem(int hb) { return kCum + 4 * hb * kQ + 1024; }
  static_assert(2 * kRowsBC * kRowBytes <= kCBBlocks * kCBBlockBytes,
                "the B and C tiles live in C B^T's room");
};

__device__ __forceinline__ uint32_t pick4(const uint32_t (&w)[4], int i) {
  return i == 0 ? w[0] : i == 1 ? w[1] : i == 2 ? w[2] : w[3];
}

template <int kQ, int kHD>
__global__ void __launch_bounds__(OutTiles<kQ>::kThreads, 2)
    ssd_output_kernel(Args a, int hb, int tiles) {
  using L = OutTiles<kQ>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sp = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const uint32_t base = smem_u32(sp);
  float* cum = reinterpret_cast<float*>(sp + L::kCum);
  float4* cbs = reinterpret_cast<float4*>(sp + L::kCB);

  const int tid = threadIdx.x, wg = tid / 128, wtid = tid % 128;
  const int warp = wtid / 32, lane = tid % 32, q = lane & 3;
  const int tile = blockIdx.x % tiles, g = blockIdx.x / tiles;
  const int c = blockIdx.y, b = blockIdx.z, NC = a.T / kQ;
  const int hpg = a.NH / a.NG, h0 = g * hpg + tile * hb;
  const int nh = min(hb, hpg - tile * hb);
  const long long tok0 = static_cast<long long>(b) * a.T +
                         static_cast<long long>(c) * kQ;
  const long long x_row = static_cast<long long>(a.NH) * kHD;
  const long long slot0 = (static_cast<long long>(b) * NC + c) * a.NH;
  const int dshd = a.DS * kHD;

  // h_in's two pieces of head ``head`` into the h buffer
  const auto load_h = [&](int head) {
    const bf16* src = a.hp + (slot0 + head) * 2 * dshd;
    const int chunks = kHD / 8, rows = 2 * a.DS;
    for (int i = tid; i < rows * chunks; i += L::kThreads) {
      const int r = i / chunks, j = i - r * chunks;
      const int piece = r / a.DS, n = r - piece * a.DS;
      cp_async16(base + L::kH + piece * kPieceBytes + sw_chunk(n, j),
                 src + r * kHD + 8 * j);
    }
  };

  // Every wgmma below runs on every warpgroup over all 64 columns of DS:
  // a product under a branch ptxas cannot prove uniform (the warpgroup
  // index, the run-time DS) makes it serialise all of them.  So DS < 64
  // is padded with zeros (B and C's columns, h_in's rows), chunk 0's h_in
  // is zeros, and warpgroup 0 runs warpgroup 1's second block of columns
  // on a G of zeros.
  if (a.DS < 64 || c == 0) {
    // h_in's pieces, and past them the B and C tiles
    const int to = a.DS < 64 ? L::kC + L::kRowsBC * kRowBytes : L::kCB;
    for (int i = L::kH + 16 * tid; i < to; i += 16 * L::kThreads) {
      *reinterpret_cast<uint4*>(sp + i) = make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();
  }
  load_tile(base + L::kCB, a.bm + tok0 * a.b_stride + g * a.DS, a.b_stride,
            kQ, a.DS / 8, tid, L::kThreads);
  load_tile(base + L::kC, a.cm + tok0 * a.c_stride + g * a.DS, a.c_stride,
            kQ, a.DS / 8, tid, L::kThreads);
  load_tile(base + L::kX0, a.x + tok0 * x_row + h0 * kHD, x_row, kQ, kHD / 8,
            tid, L::kThreads);
  if (c > 0) load_h(h0);
  cp_async_commit();
  chunk_cumsum<kQ>(a, tok0, h0, nh, cum, nullptr, nullptr);
  cp_async_wait_all();
  __syncthreads();

  const int row_l = 16 * warp + lane / 4;  // this thread's rows within the
  const int t_a = 64 * wg + row_l;         // warpgroup's 64: t_a, t_a + 8
  // C's rows t_a, t_a + 8 as wgmma A fragments, one k-step of DS each
  uint32_t cf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      cf[kk][jj] = lds32(base + L::kC +
                         sw_elem(t_a + 8 * (jj & 1),
                                 16 * kk + 8 * (jj >> 1) + 2 * q));
    }
  }
  // C B^T, 64 columns a block, then this warpgroup's blocks j <= wg (the
  // lower triangle's) into its slots
  {
    float acc[L::kMT][32];
#pragma unroll
    for (int j = 0; j < L::kMT; ++j) fence_operands(acc[j]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < L::kMT; ++j) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_ss(acc[j], desc_k(base + L::kC, 64 * wg, kk),
                 desc_k(base + L::kCB, 64 * j, kk), kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < L::kMT; ++j) fence_operands(acc[j]);
    __syncthreads();  // every warpgroup is done with the B and C tiles
#pragma unroll
    for (int j = 0; j < L::kMT; ++j) {
      if (j > wg) continue;
      const int blk = wg * (wg + 1) / 2 + j;
#pragma unroll
      for (int i = 0; i < 32; i += 4) {
        cbs[(blk * 8 + i / 4) * 128 + wtid] =
            make_float4(acc[j][i], acc[j][i + 1], acc[j][i + 2],
                        acc[j][i + 3]);
      }
    }
  }

  for (int hi = 0; hi < nh; ++hi) {
    const int head = h0 + hi;
    const uint32_t xs = base + L::kX0 + (hi & 1) * L::kTile;
    if (hi > 0) {
      cp_async_wait_all();
      __syncthreads();  // x(hi), h_in(hi) have arrived; x(hi - 1) is free
    }
    if (hi + 1 < nh) {
      load_tile(base + L::kX0 + ((hi + 1) & 1) * L::kTile,
                a.x + tok0 * x_row + (head + 1) * kHD, x_row, kQ, kHD / 8,
                tid, L::kThreads);
      cp_async_commit();
    }
    const float* ch = cum + hi * kQ;
    const float ct[2] = {ch[min(t_a, kQ - 1)], ch[min(t_a + 8, kQ - 1)]};
    // exp(cum_t) (C h_in), both pieces of h_in
    float y[kHD / 2];
#pragma unroll
    for (int i = 0; i < kHD / 2; ++i) y[i] = 0.f;
    fence_operands(y);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs(y, cf[kk], desc_mn(base + L::kH, kk), 1);
      wgmma_rs(y, cf[kk], desc_mn(base + L::kH + kPieceBytes, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(y);
    const float e[2] = {expf(ct[0]), expf(ct[1])};
#pragma unroll
    for (int i = 0; i < kHD / 2; ++i) y[i] *= e[(i >> 1) & 1];
    __syncthreads();  // every warpgroup is done with h_in(hi)
    if (c > 0 && hi + 1 < nh) {
      load_h(head + 1);
      cp_async_commit();
    }
    // + (C B^T o L) X, block by block of 64 columns s
#pragma unroll
    for (int j = 0; j < L::kMT; ++j) {
      constexpr int kNK = (kQ < 64 ? kQ : 64) / 16;  // k-steps of a block
      const bool live = j <= wg;  // a block of the lower triangle
      const int blk = wg * (wg + 1) / 2 + (live ? j : wg);
      uint32_t ghi[kNK][4], glo[kNK][4];
#pragma unroll
      for (int kk = 0; kk < kNK; ++kk) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          // accumulator elements 8 kk + 4 half .. + 3: rows t_a (first two)
          // and t_a + 8, columns 16 kk + 8 half + 2q, + 1
          const float4 f = cbs[(blk * 8 + 2 * kk + half) * 128 + wtid];
          const int s = 64 * j + 16 * kk + 8 * half + 2 * q;
          // L on the SFU (ex2 of x log2 e, a few f32 ulps; L enters y
          // only), for dead blocks too: a branch around it cost more
          const float cs0 = ch[s], cs1 = ch[s + 1];
          float ex[2][2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            ex[r][0] = __expf(ct[r] - cs0);
            ex[r][1] = __expf(ct[r] - cs1);
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int t = t_a + 8 * r;
            const bool ok0 = live && t < kQ && s <= t;
            const bool ok1 = live && t < kQ && s + 1 <= t;
            const float v0 = r ? f.z : f.x, v1 = r ? f.w : f.y;
            uint32_t pc[2];
            split<2>(ok0 ? v0 * ex[r][0] : 0.f, ok1 ? v1 * ex[r][1] : 0.f,
                     pc);
            ghi[kk][2 * half + r] = pc[0];
            glo[kk][2 * half + r] = pc[1];
          }
        }
      }
      fence_operands(y);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kNK; ++kk) {
        const uint64_t dx = desc_mn(xs, 4 * j + kk);
        wgmma_rs(y, ghi[kk], dx, 1);
        wgmma_rs(y, glo[kk], dx, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(y);
#pragma unroll
      for (int kk = 0; kk < kNK; ++kk) {
        fence_operands(ghi[kk]);
        fence_operands(glo[kk]);
      }
    }
    // y rows t_a, t_a + 8 to bf16; the quad's four lanes trade words so
    // that each writes whole 16-byte runs of 8 columns
    bf16* yb = a.y + tok0 * x_row + static_cast<long long>(head) * kHD;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = t_a + 8 * r;
#pragma unroll
      for (int grp = 0; grp < kHD / 32; ++grp) {
        uint32_t w[4], out[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int ib = 4 * grp + k;
          w[k] = bits(__floats2bfloat162_rn(y[4 * ib + 2 * r],
                                            y[4 * ib + 2 * r + 1]));
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          // lane q takes block 4 grp + q: its word from lane q ^ k
          const uint32_t v =
              __shfl_xor_sync(0xffffffffu, pick4(w, q ^ k), k);
#pragma unroll
          for (int sl = 0; sl < 4; ++sl) out[sl] = sl == (q ^ k) ? v : out[sl];
        }
        if (t < kQ) {
          *reinterpret_cast<uint4*>(yb + t * x_row + 8 * (4 * grp + q)) =
              make_uint4(out[0], out[1], out[2], out[3]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Plan {
  int err;
  int sms, blocks_a, blocks_c;  // resident blocks per SM at kMaxHB heads
};

// the card's SM count and each kernel's resident blocks per SM, once per
// instantiation (the process's first card stands for every card)
template <int kQ, int kHD>
const Plan& plan() {
  static const Plan p = [] {
    Plan r{0, 0, 0, 0};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&r.sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    }
    const int sa = StateTiles<kQ>::smem(kMaxHB);
    const int sc = OutTiles<kQ>::smem(kMaxHB);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(ssd_state_kernel<kQ, kHD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 sa);
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(ssd_output_kernel<kQ, kHD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 sc);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &r.blocks_a, ssd_state_kernel<kQ, kHD>, 128, sa);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &r.blocks_c, ssd_output_kernel<kQ, kHD>, OutTiles<kQ>::kThreads,
          sc);
    }
    if (err != cudaSuccess) cudaGetLastError();
    r.err = static_cast<int>(err);
    if (r.err == 0 && (r.blocks_a < 1 || r.blocks_c < 1)) {
      r.err = static_cast<int>(cudaErrorInvalidConfiguration);
    }
    return r;
  }();
  return p;
}

// heads a block walks: the fewest that fit the (batch, chunk, head) tiles
// into the resident blocks at once
int heads_per_block(const Args& a, int NC, int sms, int per_sm) {
  const long long tiles = static_cast<long long>(a.B) * NC * a.NH;
  const long long slots = static_cast<long long>(sms) * per_sm;
  long long hb = (tiles + slots - 1) / slots;
  hb = hb < 1 ? 1 : hb > kMaxHB ? kMaxHB : hb;
  const int hpg = a.NH / a.NG;
  return static_cast<int>(hb < hpg ? hb : hpg);
}

template <int kQ, int kHD>
int launch(const Args& a, cudaStream_t stream, int* info) {
  const Plan& p = plan<kQ, kHD>();
  if (p.err != 0) return p.err;
  const int NC = a.T / kQ, hpg = a.NH / a.NG;
  const int hb_a = heads_per_block(a, NC, p.sms, p.blocks_a);
  const int hb_c = heads_per_block(a, NC, p.sms, p.blocks_c);
  const int tiles_a = (hpg + hb_a - 1) / hb_a;
  const int tiles_c = (hpg + hb_c - 1) / hb_c;
  if (info != nullptr) {
    cudaFuncAttributes fa, fb, fc;
    cudaError_t err = cudaFuncGetAttributes(&fa, ssd_state_kernel<kQ, kHD>);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&fb, ssd_pass_kernel);
    if (err == cudaSuccess) {
      err = cudaFuncGetAttributes(&fc, ssd_output_kernel<kQ, kHD>);
    }
    int blocks_b = 0;
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks_b, ssd_pass_kernel, kPassThreads, 0);
    }
    if (err != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(err);
    }
    const int out[18] = {
        // (a): threads, dynamic smem at its hb, registers, local bytes,
        // blocks per SM (at kMaxHB heads' smem), heads a block, blocks
        128, StateTiles<kQ>::smem(hb_a), fa.numRegs,
        static_cast<int>(fa.localSizeBytes), p.blocks_a, hb_a,
        a.NG * tiles_a * NC * a.B,
        // (b): threads, registers, blocks per SM
        kPassThreads, fb.numRegs, blocks_b,
        // (c): as (a)
        OutTiles<kQ>::kThreads, OutTiles<kQ>::smem(hb_c), fc.numRegs,
        static_cast<int>(fc.localSizeBytes), p.blocks_c, hb_c,
        a.NG * tiles_c * NC * a.B, p.sms};
    for (int i = 0; i < 18; ++i) info[i] = out[i];
    return 0;
  }
  ssd_state_kernel<kQ, kHD>
      <<<dim3(a.NG * tiles_a, NC, a.B), 128, StateTiles<kQ>::smem(hb_a),
         stream>>>(a, hb_a, tiles_a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_head = (a.DS * a.HD / 4 + kPassThreads - 1) / kPassThreads;
  ssd_pass_kernel<<<dim3(per_head, a.NH, a.B), kPassThreads, 0, stream>>>(
      a, NC);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_output_kernel<kQ, kHD>
      <<<dim3(a.NG * tiles_c, NC, a.B), OutTiles<kQ>::kThreads,
         OutTiles<kQ>::smem(hb_c), stream>>>(a, hb_c, tiles_c);
  return static_cast<int>(cudaGetLastError());
}

int run(const Args& a, int chunk, cudaStream_t stream, int* info) {
  if (a.HD == 64) {
    if (chunk == 128) return launch<128, 64>(a, stream, info);
    if (chunk == 64) return launch<64, 64>(a, stream, info);
    return launch<32, 64>(a, stream, info);
  }
  if (chunk == 128) return launch<128, 32>(a, stream, info);
  if (chunk == 64) return launch<64, 32>(a, stream, info);
  return launch<32, 32>(a, stream, info);
}

bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0;
}

// the shapes this file takes (ssm_scan/ops.py:route mirrors the rule)
bool takes(const void* x, const void* bm, const void* cm, const void* y,
           const void* scratch, int B, int T, int NH, int NG, int HD, int DS,
           int chunk, int b_stride, int c_stride) {
  return B > 0 && B <= 65535 && T > 0 && NH > 0 && NG > 0 && NH % NG == 0 &&
         (HD == 32 || HD == 64) && DS >= 16 && DS <= 64 && DS % 16 == 0 &&
         (chunk == 32 || chunk == 64 || chunk == 128) && T % chunk == 0 &&
         T / chunk <= 65535 && b_stride >= NG * DS && c_stride >= NG * DS &&
         b_stride % 8 == 0 && c_stride % 8 == 0 && !misaligned(x) &&
         !misaligned(bm) && !misaligned(cm) && !misaligned(y) &&
         !misaligned(scratch);
}

Args make_args(const void* x, const void* alog, const void* bm,
               const void* cm, void* y, void* h_out, void* scratch, int B,
               int T, int NH, int NG, int HD, int DS, int chunk, int b_stride,
               int c_stride) {
  const long long n = static_cast<long long>(B) * (T / chunk) * NH * DS * HD;
  uint8_t* s = static_cast<uint8_t*>(scratch);
  return Args{static_cast<const bf16*>(x),
              static_cast<const bf16*>(alog),
              static_cast<const bf16*>(bm),
              static_cast<const bf16*>(cm),
              static_cast<bf16*>(y),
              static_cast<float*>(h_out),
              reinterpret_cast<float*>(s),
              reinterpret_cast<bf16*>(s + 4 * n),
              reinterpret_cast<float*>(s + 8 * n),
              B, T, NH, NG, HD, DS, b_stride, c_stride};
}

}  // namespace

// Returns 0 or a cudaError_t.  bf16 x, y [B, T, NH, HD], alog [B, T, NH],
// B and C [B, T, NG, DS] at token strides b_stride and c_stride, f32 h_out
// [B, NH, DS, HD]; scratch of ssm_scan/ops.py:tc_scratch_bytes bytes (the
// chunk states in f32, h_in's pieces, exp(cum_Q)), 16-byte aligned.
extern "C" int ssd_scan_tc(const void* x, const void* alog, const void* bm,
                           const void* cm, void* y, void* h_out,
                           void* scratch, int B, int T, int NH, int NG,
                           int HD, int DS, int chunk, int b_stride,
                           int c_stride, void* stream) {
  if (!takes(x, bm, cm, y, scratch, B, T, NH, NG, HD, DS, chunk, b_stride,
             c_stride)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return run(make_args(x, alog, bm, cm, y, h_out, scratch, B, T, NH, NG, HD,
                       DS, chunk, b_stride, c_stride),
             chunk, static_cast<cudaStream_t>(stream), nullptr);
}

// What ssd_scan_tc would launch for this shape, as the runtime reports it:
// info[0..6] for (a) (threads, dynamic shared memory bytes, registers,
// local bytes, resident blocks per SM, heads a block, blocks), info[7..9]
// for (b) (threads, registers, blocks per SM), info[10..16] for (c) as
// for (a), info[17] the SM count.  Launches nothing.
extern "C" int ssd_scan_tc_info(int B, int T, int NH, int NG, int HD, int DS,
                                int chunk, int* info, void* stream) {
  alignas(16) static const uint8_t dummy[16] = {};
  (void)stream;
  if (!takes(dummy, dummy, dummy, dummy, dummy, B, T, NH, NG, HD, DS, chunk,
             NG * DS, NG * DS)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return run(make_args(dummy, dummy, dummy, dummy, nullptr, nullptr, nullptr,
                       B, T, NH, NG, HD, DS, chunk, NG * DS, NG * DS),
             chunk, nullptr, info);
}
