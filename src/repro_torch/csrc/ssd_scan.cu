// K11: the Mamba2 SSD chunked scan, one block per (head, batch) walking
// the chunks in order with the state h in shared memory.
//
// Replaces: src/repro/kernels/ssm_scan/kernel.py:81 ssd_scan (body
// _ssd_kernel :27, pallas_call :88) and its wrapper ssm_scan/ops.py:15,
// which repeats the groups to heads and moves the head axis forward before
// the TPU kernel.  Here the kernel reads the model layout in place:
//   x [B, T, NH, HD] (dt-scaled), alog [B, T, NH] (the log decay dt * A),
//   B and C [B, T, NG, DS] with a token stride of their own (they arrive as
//   column slices of the conv output); head h reads group h / (NH / NG).
// Outputs: y [B, T, NH, HD] in x's dtype, h_final [B, NH, DS, HD] in f32;
// the initial state is zero.
//
// For each chunk of Q steps (as the reference's kernel, in f32):
//   cum  = cumsum(alog)                          (a warp scan)
//   G    = (C B^T) * where(s <= t, exp(cum_t - cum_s), 0)   [Q, Q]
//   y    = G X + exp(cum_t) * (C h_in)
//   h    = exp(cum_Q) * h_in + (B * exp(cum_Q - cum_s))^T X
// Each product is a loop of 4 x 4 register tiles over shared-memory
// operands (x as is; B, C and G transposed so the tiles load float4s).
// The state never leaves shared memory between chunks.
//
// Shared memory: x [Q][HD], B^T and C^T [DS][Q], G^T [Q][Q], h [DS][HD]
// and three chunk vectors, in f32: 182 KB at Q = 128, HD = DS = 64, past
// the 48 KB a launch gets by default, so the launcher raises the limit
// with cudaFuncSetAttribute and returns its error if that fails.
//
// Bound: operations (per chunk ~Q^2 (DS + HD) + 2 Q DS HD multiply-adds on
// the CUDA cores).  One block per (batch, head): Zamba2's 2 x 80 = 160
// blocks are more than the 132 SMs hold at one block each, so the last 28
// run in a second wave.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 128;  // the warp scan takes 4 steps per lane

struct Args {
  const void* x;
  const void* alog;
  const void* bm;
  const void* cm;
  void* y;
  float* h_out;
  int B, T, NH, NG, HD, DS, Q;
  long long b_stride, c_stride;  // elements between tokens of B and C
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

size_t smem_floats(int Q, int HD, int DS) {
  return static_cast<size_t>(Q) * HD + 2 * static_cast<size_t>(DS) * Q +
         static_cast<size_t>(Q) * Q + static_cast<size_t>(DS) * HD + 3 * Q;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int Q = a.Q, HD = a.HD, DS = a.DS;
  float* xs = smem;          // [Q][HD]
  float* bt = xs + Q * HD;   // [DS][Q]  B transposed
  float* ct = bt + DS * Q;   // [DS][Q]  C transposed
  float* gt = ct + DS * Q;   // [Q][Q]   G transposed: gt[s][t]
  float* hs = gt + Q * Q;    // [DS][HD] the state
  float* cum = hs + DS * HD; // [Q]
  float* ecum = cum + Q;     // [Q] exp(cum_t)
  float* dec = ecum + Q;     // [Q] exp(cum_Q - cum_s)

  const int tid = threadIdx.x, head = blockIdx.x, b = blockIdx.y;
  const int g = head / (a.NH / a.NG);
  const long long x_row = static_cast<long long>(a.NH) * HD;
  const long long tok0 = static_cast<long long>(b) * a.T;
  const T* xb = static_cast<const T*>(a.x) + tok0 * x_row + head * HD;
  const T* ab = static_cast<const T*>(a.alog) + tok0 * a.NH + head;
  const T* bb = static_cast<const T*>(a.bm) + tok0 * a.b_stride + g * DS;
  const T* cb = static_cast<const T*>(a.cm) + tok0 * a.c_stride + g * DS;
  T* yb = static_cast<T*>(a.y) + tok0 * x_row + head * HD;
  const int qg = Q / 4, pgs = HD / 4, ngs = DS / 4;

  for (int i = tid; i < DS * HD; i += kThreads) hs[i] = 0.f;

  for (int c0 = 0; c0 < a.T; c0 += Q) {
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < Q * HD; i += kThreads) {
      const int t = i / HD, p = i % HD;
      xs[i] = load(xb, (c0 + t) * x_row + p);
    }
    for (int i = tid; i < DS * Q; i += kThreads) {
      const int n = i / Q, t = i % Q;
      bt[i] = load(bb, (c0 + t) * a.b_stride + n);
      ct[i] = load(cb, (c0 + t) * a.c_stride + n);
    }
    if (tid < 32) {
      // inclusive scan of alog: each lane sums up to 4 consecutive steps,
      // then the lanes' totals are scanned by shuffles
      const int lane = tid, per = (Q + 31) / 32, t0 = lane * per;
      float v[kMaxChunk / 32];
      float run = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxChunk / 32; ++j) {
        const int t = t0 + j;
        if (j < per && t < Q) run += load(ab, (c0 + t) * a.NH);
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
      for (int j = 0; j < kMaxChunk / 32; ++j) {
        const int t = t0 + j;
        if (j < per && t < Q) {
          cum[t] = excl + v[j];
          ecum[t] = expf(excl + v[j]);
        }
      }
      __syncwarp();
      const float last = cum[Q - 1];
      for (int t = lane; t < Q; t += 32) dec[t] = expf(last - cum[t]);
    }
    __syncthreads();

    // G^T: the masked C B^T, tiles above the diagonal written as zeros
    for (int w = tid; w < qg * qg; w += kThreads) {
      const int tg = w / qg, sg = w % qg;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      }
      if (sg <= tg) {
#pragma unroll 4
        for (int n = 0; n < DS; ++n) {
          const float4 c4 = *reinterpret_cast<const float4*>(ct + n * Q +
                                                             4 * tg);
          const float4 b4 = *reinterpret_cast<const float4*>(bt + n * Q +
                                                             4 * sg);
          const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
          const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], bv[j],
                                                         acc[i][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = 4 * tg + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = 4 * sg + j;
            acc[i][j] = s <= t ? acc[i][j] * expf(cum[t] - cum[s]) : 0.f;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        *reinterpret_cast<float4*>(gt + (4 * sg + j) * Q + 4 * tg) =
            make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
      }
    }
    __syncthreads();

    // y = G X + exp(cum_t) (C h_in)
    for (int w = tid; w < qg * pgs; w += kThreads) {
      const int tg = w / pgs, pg = w % pgs;
      float yi[16], yh[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) yi[e] = yh[e] = 0.f;
      const int s_end = 4 * tg + 4;  // G is zero for s > t
#pragma unroll 4
      for (int s = 0; s < s_end; ++s) {
        const float4 g4 = *reinterpret_cast<const float4*>(gt + s * Q +
                                                           4 * tg);
        const float4 x4 = *reinterpret_cast<const float4*>(xs + s * HD +
                                                           4 * pg);
        const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
        const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) yi[4 * i + e] = fmaf(gv[i], xv[e],
                                                           yi[4 * i + e]);
        }
      }
#pragma unroll 4
      for (int n = 0; n < DS; ++n) {
        const float4 c4 = *reinterpret_cast<const float4*>(ct + n * Q +
                                                           4 * tg);
        const float4 h4 = *reinterpret_cast<const float4*>(hs + n * HD +
                                                           4 * pg);
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
        const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) yh[4 * i + e] = fmaf(cv[i], hv[e],
                                                           yh[4 * i + e]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * tg + i;
        const float et = ecum[t];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          store(yb, (c0 + t) * x_row + 4 * pg + e,
                yi[4 * i + e] + et * yh[4 * i + e]);
        }
      }
    }
    __syncthreads();  // every read of h_in is done

    // h = exp(cum_Q) h_in + (B * exp(cum_Q - cum_s))^T X
    const float e_last = ecum[Q - 1];
    for (int w = tid; w < ngs * pgs; w += kThreads) {
      const int ng = w / pgs, pg = w % pgs;
      float acc[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e] = 0.f;
#pragma unroll 4
      for (int s = 0; s < Q; ++s) {
        const float ds_ = dec[s];
        const float bw[4] = {bt[(4 * ng) * Q + s] * ds_,
                             bt[(4 * ng + 1) * Q + s] * ds_,
                             bt[(4 * ng + 2) * Q + s] * ds_,
                             bt[(4 * ng + 3) * Q + s] * ds_};
        const float4 x4 = *reinterpret_cast<const float4*>(xs + s * HD +
                                                           4 * pg);
        const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[4 * i + e] = fmaf(bw[i], xv[e],
                                                            acc[4 * i + e]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float4* hp = reinterpret_cast<float4*>(hs + (4 * ng + i) * HD +
                                               4 * pg);
        float4 hv = *hp;
        hv.x = e_last * hv.x + acc[4 * i];
        hv.y = e_last * hv.y + acc[4 * i + 1];
        hv.z = e_last * hv.z + acc[4 * i + 2];
        hv.w = e_last * hv.w + acc[4 * i + 3];
        *hp = hv;
      }
    }
  }
  __syncthreads();
  float* hb = a.h_out + (static_cast<long long>(b) * a.NH + head) * DS * HD;
  for (int i = tid; i < DS * HD; i += kThreads) hb[i] = hs[i];
}

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(a.Q, a.HD, a.DS);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) {
    cudaGetLastError();  // not left for the next launch to report
    return static_cast<int>(err);
  }
  ssd_kernel<T><<<dim3(a.NH, a.B), kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ssd_scan(const void* x, const void* alog, const void* bm,
                        const void* cm, void* y, void* h_out, int B, int T,
                        int NH, int NG, int HD, int DS, int chunk,
                        int b_stride, int c_stride, int bf16, void* stream) {
  if (B <= 0 || T <= 0 || NH <= 0 || NG <= 0 || NH % NG != 0 ||
      HD <= 0 || DS <= 0 || HD % 4 || DS % 4 || chunk <= 0 || chunk % 4 ||
      chunk > kMaxChunk || T % chunk || B > 65535 ||
      b_stride < NG * DS || c_stride < NG * DS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{x, alog, bm, cm, y, static_cast<float*>(h_out), B, T, NH, NG,
               HD, DS, chunk, b_stride, c_stride};
  const auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(a, st) : launch<float>(a, st);
}
