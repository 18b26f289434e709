// K10, tensor-core variant: forward GQA flash attention for bf16 on Hopper
// (sm_90a), fed by TMA, warp-specialised, with wgmma for both products.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:84 flash_attention
// (body _flash_kernel :30, pallas_call :107), as flash_attention.cu does;
// this file serves bf16 shapes whose rows TMA can address, and
// flash_attention.cu keeps f32 and the rest (ops.py states the rule).
//
// Computes, for query head h of batch b (kv head h / (H / KH)):
//   s = (q k^T) * scale with -1e30 (here -inf, the same result) where
//   col >= S, or col > row (causal), or row - col >= window; an f32 online
//   softmax over the kv tiles, p = 0 where masked; out = acc / max(l,
//   1e-30), a true division, rounded to bf16 (round-to-nearest-even).
// Layout: q, out [B, T, H, Dh]; k, v [B, S, KH, Dh], read and written in
// place through 4-D TMA tensor maps (no transposes, no repeated kv heads,
// no padded copies).
//
// Work split: one block per (128-row q tile, head, batch), the q tiles of
// the longest causal rows launched first.  Warps 0-7 are two consumer
// warpgroups of 64 q rows each; warps 8-11 are the producer warpgroup, one
// thread of which issues every TMA load.  setmaxnreg moves registers from the
// producer to the consumers.  Q is loaded once; K and V tiles of kBK rows
// go through a ring of two stages with full and empty mbarriers, so the
// next tile's loads are in flight while the consumers compute.  A box is
// 64 columns (128 bytes, the 128-byte swizzle) by 64 q rows or kBK kv
// rows of one head; Dh > 64 takes more boxes, and columns past Dh (Dh 80:
// columns 80-127) and rows past T or S arrive as zeros.  kv tiles wholly
// masked for the block (above the causal diagonal, before the window) are
// skipped, which is exact as in flash_attention.cu; only the tiles that
// straddle the diagonal, the window edge or S evaluate the mask.
//
// Per kv tile, in each consumer warpgroup:
//   q.k^T: wgmma m64n{kBK}k16, both operands K-major from shared memory,
//     bf16 x bf16 products exact in f32, f32 accumulation;
//   softmax in the accumulator registers: row max and row sum across the
//     four threads of a quad (shuffles), exp2 with scale * log2(e) folded
//     in (a few f32 ulps, far below a bf16 ulp); l is the f32 sum of p;
//   p.v, f32-exact: p = p_hi + p_lo with p_hi = bf16(p), p_lo = bf16(p -
//     p_hi) (about 16 significant bits of p), two wgmma m64n{Dh}k16 with A
//     from registers (the accumulator's fragment layout is wgmma's A
//     layout) and V from shared memory MN-major (the transpose bit), both
//     into the same f32 output fragment.  Rounding p to bf16 alone would
//     leave 8 bits and miss the one-ulp limit against the f32 reference.
// Epilogue: each warpgroup divides its rows, rounds them to bf16 into its
// own (now unused) q rows of shared memory in the swizzled layout, and
// stores them with TMA, which clips rows past T and columns past Dh.
//
// Bound: operations.  Three bf16 tensor-core products (q.k^T, p_hi.v,
// p_lo.v) of 2 Dh per unmasked (row, column) pair, the exps on the SFUs,
// and the bytes of q, k, v and out, each on its own units.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "wgmma.cuh"

namespace {

using repro::fence_operands;
using repro::wgmma_commit;
using repro::wgmma_fence;
using repro::wgmma_rs;
using repro::wgmma_ss;
using repro::wgmma_wait;

constexpr int kRows = 128;                  // q rows per block
constexpr int kWGRows = 64;                 // q rows per consumer warpgroup
constexpr int kConsumers = 256;             // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kStages = 2;                  // depth of the k/v ring
constexpr int kBox = 64;                    // columns of a TMA box
constexpr int kRowBytes = 2 * kBox;         // 128: one swizzled row
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;           // m before any valid column

// kD: the head width the products run at (Dh rounded up to an instantiated
// width); kBK: kv columns per tile
template <int kD, int kBK>
struct Tiles {
  static constexpr int kBoxes = (kD + kBox - 1) / kBox;
  static constexpr int kSteps = (kD + 15) / 16;  // q.k^T k-steps
  static constexpr int kQBox = kRows * kRowBytes;
  static constexpr int kKVBox = kBK * kRowBytes;
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kKVBytes = kBoxes * kKVBox;  // one k or v tile
  static constexpr int kBarriers = kQBytes + 2 * kStages * kKVBytes;
  // q_full, full_k[kStages], full_v[kStages], empty[kStages]
  static constexpr int kSmem = kBarriers + 8 * (1 + 3 * kStages);
  static constexpr int kAlloc = kSmem + 1024;  // the base aligned to 1024
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %globaltimer;\n" : "=l"(t));
  return t;
}

// waits for the phase of ``parity`` to complete; a wait of more than ten
// seconds (a lost load or arrival) traps, so the launch fails instead of
// holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint64_t t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = now_ns();
    } else if (now_ns() - t0 > 10000000000ull) {
      __trap();
    }
  }
}

// one box of a 4-D map (coordinates innermost first) into shared memory,
// its bytes reported to ``bar``
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma's shared-memory matrix descriptor for the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units), layout 1
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int kD, int kBK>
__global__ void __launch_bounds__(kThreads, 1) flash_kernel_sm90(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap to, int T, int S, int H, int KH,
    int n_bh, int nq, int causal, int window, float scale_log2) {
  using C = Tiles<kD, kBK>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;  // [kBoxes][kRows][64] bf16, swizzled
  const uint32_t kv_s = base + C::kQBytes;  // per stage: k tile, v tile
  const uint32_t q_full = base + C::kBarriers;
  const uint32_t full_k = q_full + 8, full_v = full_k + 8 * kStages;
  const uint32_t empty = full_v + 8 * kStages;

  const int tid = threadIdx.x;
  const int iq = nq - 1 - static_cast<int>(blockIdx.x) / n_bh;
  const int bh = static_cast<int>(blockIdx.x) % n_bh;
  const int h = bh % H, b = bh / H, kvh = h / (H / KH);
  const int q0 = iq * kRows;
  // the kv tiles not wholly masked for rows q0 .. q0 + kRows - 1
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin -= k_begin % kBK;
  const int k_end = causal ? min(S, q0 + kRows) : S;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warpgroup, one thread of which issues every load.  It
    // hands registers to the consumers (168 a thread at launch, ptxas's
    // count for 384 threads): 128 x 40 + 256 x 232 = 64,512 of the SM's
    // 65,536.  The decrease frees registers a whole warpgroup at a time,
    // so a lone producer warp would leave the consumers' increase waiting
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == kConsumers) {
      uint32_t q_bytes = 0;
      for (int w = 0; w < kRows / kWGRows; ++w) {
        if (q0 + kWGRows * w < T) q_bytes += C::kBoxes * kWGRows * kRowBytes;
      }
      mbar_expect_tx(q_full, q_bytes);
      for (int w = 0; w < kRows / kWGRows; ++w) {
        if (q0 + kWGRows * w >= T) continue;  // rows of no output
        for (int j = 0; j < C::kBoxes; ++j) {
          tma_load(q_s + j * C::kQBox + w * kWGRows * kRowBytes, &tq, q_full,
                   kBox * j, h, q0 + kWGRows * w, b);
        }
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const uint32_t k_t = kv_s + 2 * s * C::kKVBytes;
        const uint32_t v_t = k_t + C::kKVBytes;
        const int c0 = k_begin + it * kBK;
        mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full_k + 8 * s, C::kKVBytes);
        for (int j = 0; j < C::kBoxes; ++j) {
          tma_load(k_t + j * C::kKVBox, &tk, full_k + 8 * s, kBox * j, kvh,
                   c0, b);
        }
        mbar_expect_tx(full_v + 8 * s, C::kKVBytes);
        for (int j = 0; j < C::kBoxes; ++j) {
          tma_load(v_t + j * C::kKVBox, &tv, full_v + 8 * s, kBox * j, kvh,
                   c0, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
    const int r0 = q0 + kWGRows * wg;  // this warpgroup's first row
    const int row_a = r0 + 16 * warp + lane / 4;  // this thread's rows:
    // row_a (accumulator elements 4i, 4i + 1) and row_a + 8 (4i + 2, 4i + 3)
    const uint32_t q_wg = q_s + kWGRows * kRowBytes * wg;
    float o[kD / 2];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    mbar_wait(q_full, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const uint32_t parity = (it / kStages) & 1;
      const uint32_t k_t = kv_s + 2 * s * C::kKVBytes;
      const uint32_t v_t = k_t + C::kKVBytes;
      const int c0 = k_begin + it * kBK;

      float sc[kBK / 2];
      mbar_wait(full_k + 8 * s, parity);
      fence_operands(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::kSteps; ++kk) {
        // 16 columns: 32 bytes into the swizzled row of box kk / 4
        const uint32_t at = (kk % 4) * 32;
        wgmma_ss(sc, desc(q_wg + (kk / 4) * C::kQBox + at, 16, 1024),
                 desc(k_t + (kk / 4) * C::kKVBox + at, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(sc);

      // scale to log2 units, mask where the tile needs it, row max
      const bool masked = c0 + kBK > S || (causal && c0 + kBK - 1 > r0) ||
                          (window > 0 && r0 + kWGRows - 1 - c0 >= window);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const int r = (i >> 1) & 1;
        float x = sc[i] * scale_log2;
        if (masked) {
          const int row = row_a + 8 * r;
          const int col = c0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          const bool ok = col < S && (!causal || row >= col) &&
                          (window <= 0 || row - col < window);
          x = ok ? x : __int_as_float(0xff800000);  // -inf
        }
        sc[i] = x;
        mx[r] = fmaxf(mx[r], x);
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = ex2(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= corr[r];
      }
      // p, its f32 row sum, and its two bf16 halves in wgmma's A layout:
      // k-step kk takes accumulator elements 8 kk .. 8 kk + 7
      uint32_t p_hi[kBK / 16][4], p_lo[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 8 * kk + 2 * j, r = j & 1;
          const float p0 = ex2(sc[i] - m[r]), p1 = ex2(sc[i + 1] - m[r]);
          l[r] += p0 + p1;
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
          const float2 hf = __bfloat1622float2(hi);
          p_hi[kk][j] = bits(hi);
          p_lo[kk][j] = bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
        }
      }
#pragma unroll
      for (int i = 0; i < kD / 2; ++i) o[i] *= corr[(i >> 1) & 1];

      mbar_wait(full_v + 8 * s, parity);
      fence_operands(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // 16 kv rows (two 8-row groups of 1024 bytes); the next 64
        // columns of V one box further
        const uint64_t dv = desc(v_t + kk * 2048, C::kKVBox, 1024);
        wgmma_rs(o, p_hi[kk], dv, 1);
        wgmma_rs(o, p_lo[kk], dv, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(o);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        fence_operands(p_hi[kk]);
        fence_operands(p_lo[kk]);
      }
      if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done
    }

    if (r0 < T) {
      float den[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        den[r] = fmaxf(l[r], 1e-30f);
      }
      // this warpgroup's q rows are read no more: stage the output there
#pragma unroll
      for (int ib = 0; ib < kD / 8; ++ib) {
        const int col = 8 * ib + 2 * (lane & 3);
        const int chunk = (col % kBox) / 8;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 16 * warp + lane / 4 + 8 * r;
          const uint32_t at = q_wg + (col / kBox) * C::kQBox +
                              row * kRowBytes + ((chunk ^ (row & 7)) << 4) +
                              (col & 7) * 2;
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              __fdiv_rn(o[4 * ib + 2 * r], den[r]),
              __fdiv_rn(o[4 * ib + 2 * r + 1], den[r]));
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at), "r"(bits(v))
                       : "memory");
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      if (tid % 128 == 0) {
        for (int j = 0; j < C::kBoxes; ++j) {
          tma_store(&to, q_wg + j * C::kQBox, kBox * j, h, r0, b);
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (the
// library does not link libcuda); null where it is missing
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// [B, rows, heads, D] bf16 as a 4-D map (innermost first): boxes of 64
// columns by box_rows rows of one head, 128-byte swizzle; elements out of
// bounds load as zeros and are not stored
CUresult make_map(CUtensorMap* map, const void* ptr, int B, int rows,
                  int heads, int D, int box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row_bytes = 2ull * D;
  const cuuint64_t strides[3] = {row_bytes, row_bytes * heads,
                                 row_bytes * heads * rows};
  const cuuint32_t box[4] = {kBox, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                   const_cast<void*>(ptr), dims, strides, box, step,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int kD, int kBK>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int T, int S, int H, int KH, int D, int causal, int window,
           float scale_log2, cudaStream_t stream) {
  using C = Tiles<kD, kBK>;
  CUtensorMap tq, tk, tv, to;
  const CUresult res[4] = {make_map(&tq, q, B, T, H, D, kWGRows),
                           make_map(&tk, k, B, S, KH, D, kBK),
                           make_map(&tv, v, B, S, KH, D, kBK),
                           make_map(&to, out, B, T, H, D, kWGRows)};
  for (const CUresult r : res) {
    if (r != CUDA_SUCCESS) return 10000 + static_cast<int>(r);
  }
  const cudaError_t err = cudaFuncSetAttribute(
      flash_kernel_sm90<kD, kBK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kAlloc);
  if (err != cudaSuccess) {
    cudaGetLastError();  // not left for the next launch to report
    return static_cast<int>(err);
  }
  const int nq = (T + kRows - 1) / kRows;
  flash_kernel_sm90<kD, kBK><<<nq * H * B, kThreads, C::kAlloc, stream>>>(
      tq, tk, tv, to, T, S, H, KH, H * B, nq, causal, window, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns 0, a cudaError_t, or 10000 + the CUresult of a failed
// cuTensorMapEncodeTiled.  Takes bf16 q, out [B, T, H, D] and k, v [B, S,
// KH, D], contiguous, with D a multiple of 8 (every stride of the maps a
// multiple of 16 bytes) and 16-byte-aligned base pointers.
extern "C" int flash_attention_tc(const void* q, const void* k, const void* v,
                                  void* out, int B, int T, int S, int H,
                                  int KH, int D, int causal, int window,
                                  float scale, void* stream) {
  const auto misaligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (B <= 0 || T <= 0 || S <= 0 || H <= 0 || KH <= 0 || H % KH != 0 ||
      D <= 0 || D > kMaxD || D % 8 != 0 || misaligned(q) || misaligned(k) ||
      misaligned(v) || misaligned(out) ||
      static_cast<long long>((T + kRows - 1) / kRows) * H * B > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (encoder() == nullptr) {
    return static_cast<int>(cudaErrorSymbolNotFound);
  }
  const float scale_log2 = static_cast<float>(scale * 1.4426950408889634);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto run) {
    return run(q, k, v, out, B, T, S, H, KH, D, causal, window, scale_log2,
               st);
  };
  if (D <= 16) return go(launch<16, 128>);
  if (D <= 32) return go(launch<32, 128>);
  if (D <= 64) return go(launch<64, 128>);
  if (D <= 80) return go(launch<80, 128>);
  if (D <= 128) return go(launch<128, 128>);
  return go(launch<256, 64>);  // 64-column kv tiles keep registers in hand
}
