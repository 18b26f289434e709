// K10: forward GQA flash attention with causal and sliding-window masks.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:84 flash_attention
// (body _flash_kernel :30, pallas_call :107) and its wrapper
// flash_attention/ops.py:23, which transposes q, k and v to [B, H, T, Dh]
// and pads k and v to the 128-column kv block before the TPU kernel.
//
// Computes, for query head h of batch b (kv head h / (H / KH)):
//   s = (q k^T) * scale, masked to -1e30 where col >= S, or col > row
//   (causal), or row - col >= window; an f32 online softmax over the kv
//   tiles (m, l, acc as the reference's scratch, with where(mask, p, 0));
//   out = acc / max(l, 1e-30), a true division, rounded to q's dtype
//   (round-to-nearest-even for bf16).
// Layout: q, out [B, T, H, Dh]; k, v [B, S, KH, Dh], read in place: no
// transposed copies, no repeated kv heads, no padded k/v (the kernel masks
// col >= S itself).
//
// Work split: one block per (q tile of 64 rows, head, batch), 256 threads,
// looping over kv tiles of 64 columns staged in shared memory (q and k
// transposed, v as is, the probabilities transposed).  A kv tile that is
// wholly masked for the q tile (above the causal diagonal, or wholly
// outside the window) is skipped: such a tile gives p = 0 and a correction
// of 1, or, before any valid column, leaves acc = l = 0, which the next
// valid tile's correction zeroes, so skipping is exact.  Each thread holds
// a 4 x 4 tile of scores (rows 4 rg.., columns 4 cg..; the 16 threads of a
// row group share a half-warp, so row max and row sum are shuffles) and up
// to four 4 x 4 tiles of the output accumulator in registers.
//
// Bound: operations.  The unmasked causal half is 4 Dh per (row, column)
// pair of f32 multiply-adds; this simple kernel runs them on the CUDA
// cores (no tensor cores, TMA or wgmma yet), with one shared-memory load
// per four multiply-adds.  Dot products are summed in another order than
// the reference's, so results differ from the plain version by rounding.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // kv columns per tile
constexpr int kThreads = 256;  // 16 row groups x 16 column groups
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int B, T, S, H, KH, D, DP;  // DP: D rounded up to a multiple of 4
  int causal, window;         // window <= 0: none
  float scale;
};

__device__ __forceinline__ float load(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, long long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i,
                                      float v) {
  p[i] = __float2bfloat16_rn(v);
}

size_t smem_floats(int DP) {
  return static_cast<size_t>(DP) * kBQ + static_cast<size_t>(DP) * kBK +
         static_cast<size_t>(kBK) * DP + kBK * kBQ + 2 * kBQ;
}

template <typename T, int kTiles>
__global__ void __launch_bounds__(kThreads, 2) flash_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int D = a.D, DP = a.DP, n_dg = a.DP / 4;
  float* qt = smem;                // [DP][kBQ] q tile, transposed
  float* kt = qt + DP * kBQ;       // [DP][kBK] k tile, transposed
  float* vs = kt + DP * kBK;       // [kBK][DP] v tile
  float* pt = vs + kBK * DP;       // [kBK][kBQ] probabilities, transposed
  float* corr_s = pt + kBK * kBQ;  // [kBQ] this tile's correction per row
  float* l_s = corr_s + kBQ;       // [kBQ] the final row sums

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const long long q_row = static_cast<long long>(a.H) * D;
  const long long kv_row = static_cast<long long>(a.KH) * D;
  const T* qb = static_cast<const T*>(a.q) +
                (static_cast<long long>(b) * a.T * a.H + h) * D;
  const long long kv_base =
      (static_cast<long long>(b) * a.S * a.KH + h / (a.H / a.KH)) * D;
  const T* kb = static_cast<const T*>(a.k) + kv_base;
  const T* vb = static_cast<const T*>(a.v) + kv_base;
  T* ob = static_cast<T*>(a.out) + (static_cast<long long>(b) * a.T * a.H +
                                    h) * D;

  // q tile, transposed (rows past T and columns past D are zero); lanes
  // take consecutive rows, so the transposed stores do not collide
  for (int i = tid; i < kBQ * n_dg; i += kThreads) {
    const int r = i % kBQ, dg = i / kBQ, row = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = 4 * dg + j;
      qt[d * kBQ + r] = row < a.T && d < D ? load(qb, row * q_row + d) : 0.f;
    }
  }

  const int rg = tid >> 4, cg = tid & 15;
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
  }
  float o[kTiles][16];
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
#pragma unroll
    for (int e = 0; e < 16; ++e) o[t][e] = 0.f;
  }
  const int n_otiles = (kBQ / 4) * n_dg;

  // the kv tiles not wholly masked for rows q0 .. q0 + kBQ - 1
  int k_end = a.S;
  if (a.causal) k_end = min(k_end, q0 + kBQ);
  int k_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  k_begin = (k_begin / kBK) * kBK;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * n_dg; i += kThreads) {
      const int c = i % kBK, dg = i / kBK, col = k0 + c;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = 4 * dg + j;
        kt[d * kBK + c] = col < a.S && d < D ? load(kb, col * kv_row + d)
                                             : 0.f;
      }
    }
    for (int i = tid; i < kBK * DP; i += kThreads) {
      const int c = i / DP, d = i % DP, col = k0 + c;
      vs[i] = col < a.S && d < D ? load(vb, col * kv_row + d) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(qt + d * kBQ +
                                                         4 * rg);
      const float4 ka = *reinterpret_cast<const float4*>(kt + d * kBK +
                                                         4 * cg);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }

    // online softmax; every lane runs every row (the shuffles need all 32)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * rg + i;
      bool valid[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + 4 * cg + j;
        valid[j] = col < a.S && (!a.causal || row >= col) &&
                   (a.window <= 0 || row - col < a.window);
        s[i][j] = valid[j] ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m_run[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      const float corr = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * corr + sum;
      m_run[i] = m_new;
      if (cg == 0) corr_s[4 * rg + i] = corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(pt + (4 * cg + j) * kBQ + 4 * rg) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

    // acc = acc * corr + p v on this thread's output tiles
#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
      const int w = tid + t * kThreads;
      if (w < n_otiles) {
        const int ro = w / n_dg, dg = w % n_dg;
        float acc[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[e] = 0.f;
#pragma unroll 4
        for (int j = 0; j < kBK; ++j) {
          const float4 pa = *reinterpret_cast<const float4*>(pt + j * kBQ +
                                                             4 * ro);
          const float4 va = *reinterpret_cast<const float4*>(vs + j * DP +
                                                             4 * dg);
          const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
          const float vv[4] = {va.x, va.y, va.z, va.w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[4 * r + e] = fmaf(pv[r], vv[e], acc[4 * r + e]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float c = corr_s[4 * ro + r];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            o[t][4 * r + e] = o[t][4 * r + e] * c + acc[4 * r + e];
          }
        }
      }
    }
  }

  __syncthreads();
  if (cg == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) l_s[4 * rg + i] = l_run[i];
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
    const int w = tid + t * kThreads;
    if (w < n_otiles) {
      const int ro = w / n_dg, dg = w % n_dg;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = q0 + 4 * ro + r;
        const float den = fmaxf(l_s[4 * ro + r], 1e-30f);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = 4 * dg + e;
          if (row < a.T && d < D) {
            store(ob, row * q_row + d, __fdiv_rn(o[t][4 * r + e], den));
          }
        }
      }
    }
  }
}

template <typename T, int kTiles>
int launch(const Args& a, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(a.DP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, kTiles>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) {
    cudaGetLastError();  // not left for the next launch to report
    return static_cast<int>(err);
  }
  const dim3 grid((a.T + kBQ - 1) / kBQ, a.H, a.B);
  flash_kernel<T, kTiles><<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args& a, cudaStream_t stream) {
  // output tiles per thread: (kBQ / 4) * (DP / 4) over kThreads
  switch ((4 * a.DP + kThreads - 1) / kThreads) {
    case 1:
      return launch<T, 1>(a, stream);
    case 2:
      return launch<T, 2>(a, stream);
    case 3:
      return launch<T, 3>(a, stream);
    case 4:
      return launch<T, 4>(a, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int T, int S, int H, int KH,
                               int D, int causal, int window, float scale,
                               int bf16, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || H <= 0 || KH <= 0 || H % KH != 0 ||
      D <= 0 || D > kMaxD || B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, out, B, T, S, H, KH, D, (D + 3) / 4 * 4,
               causal, window, scale};
  const auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(a, st) : dispatch<float>(a, st);
}
