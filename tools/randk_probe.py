#!/usr/bin/env python3
"""Split K2's time at the main path's shape between its parts.

    python3 tools/randk_probe.py

Builds the first design of K2 (``randk_gather_plane``, the push variant of
``csrc/randk_plane.cu``) and variants of it from the source below, and
times each with CUDA events on the z-plane of the wide run: [20, 2^20],
stride sampler, k = 629,146.

  a  the kernel as it is (32 j a thread, the seed derived by every
     thread, a runtime remainder per index);
  b  the same loads, the index read from a precomputed int32 plane;
  c  the index math and Threefry alone, storing the index;
  d  a coalesced copy of the same bytes (x[m, j] for j < k);
  e  a as it is, 4 j a thread (a smaller tile: fewer rows in flight);
  f  a with the seed derived once per block.

Design probes g-j (the pull variant with other loads, tiles or order;
see the source), then the package's pull kernels (``randk_gather_pull``,
``randk_scatter_pull``) and the push scatter on the same inputs, beside
``torch.gather`` and ``torch.scatter``.  Needs a CUDA card and nvcc;
prints one JSON object as its last line.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

SOURCE = r"""
#include "threefry.cuh"

struct StrideTable { int32_t v[64]; };
struct Affine { uint32_t off, stride; };

__device__ __forceinline__ Affine affine_of(uint32_t s0, uint32_t s1,
    const uint32_t* sids, const uint32_t* rids, int m, int n,
    const StrideTable& t, int ns) {
  const repro::Pair es = repro::message_seed(s0, s1, sids[m], rids[m]);
  const repro::Pair ob = repro::offset_block(es);
  return Affine{ob.x0 % static_cast<uint32_t>(n),
                static_cast<uint32_t>(t.v[ob.x1 % static_cast<uint32_t>(ns)])};
}

__device__ __forceinline__ int affine_index(Affine a, int j, int n) {
  const int32_t v = static_cast<int32_t>(a.off + static_cast<uint32_t>(j) * a.stride);
  const int32_t r = v % n;
  return r < 0 ? r + n : r;
}

// MODE 0 gather, 1 loads from a precomputed index, 2 index store, 3 copy
template <int PER, int MODE, bool BLOCK_SEED>
__global__ void probe(const float* __restrict__ x,
                      const int* __restrict__ idx_in, int n, int k,
                      uint32_t s0, uint32_t s1, const uint32_t* sids,
                      const uint32_t* rids, StrideTable t, int ns,
                      float* __restrict__ out, int* __restrict__ idx_out) {
  const int m = blockIdx.y;
  Affine a{0u, 0u};
  if (MODE == 0 || MODE == 2) {
    if (BLOCK_SEED) {
      __shared__ Affine sh;
      if (threadIdx.x == 0) sh = affine_of(s0, s1, sids, rids, m, n, t, ns);
      __syncthreads();
      a = sh;
    } else {
      a = affine_of(s0, s1, sids, rids, m, n, t, ns);
    }
  }
  const float* xr = x + static_cast<long long>(m) * n;
  const long long row = static_cast<long long>(m) * k;
  const int base = blockIdx.x * 256 * PER + threadIdx.x;
#pragma unroll 4
  for (int i = 0; i < PER; ++i) {
    const int j = base + i * 256;
    if (j < k) {
      if (MODE == 0) out[row + j] = xr[affine_index(a, j, n)];
      if (MODE == 1) out[row + j] = xr[idx_in[row + j]];
      if (MODE == 2) idx_out[row + j] = affine_index(a, j, n);
      if (MODE == 3) out[row + j] = xr[j];
    }
  }
}

#define ENTRY(name, PER, MODE, BS)                                          \
  extern "C" int name(const void* x, const void* idx_in, int M, int n,     \
                      int k, uint32_t s0, uint32_t s1, const void* sids,   \
                      const void* rids, const void* strides, int ns,       \
                      void* out, void* idx_out, void* stream) {            \
    StrideTable t{};                                                        \
    for (int i = 0; i < ns; ++i) t.v[i] = static_cast<const int32_t*>(strides)[i]; \
    const dim3 grid((k + 256 * PER - 1) / (256 * PER), M);                  \
    probe<PER, MODE, BS><<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>( \
        static_cast<const float*>(x), static_cast<const int*>(idx_in), n, k, \
        s0, s1, static_cast<const uint32_t*>(sids),                         \
        static_cast<const uint32_t*>(rids), t, ns, static_cast<float*>(out), \
        static_cast<int*>(idx_out));                                        \
    return static_cast<int>(cudaGetLastError());                            \
  }

// Design probes of the pull variant (n a power of two); MODE 0 the
// gather with L2-only loads (__ldcg), 1 the gather walked by x position i
// instead (one float4 load of x, j = (i - off) * s^-1, scattered stores
// into the L2-resident out row), 2 the gather with __ldg, 3 the scatter
// with L2-only loads, 4 the scatter with __ldg; VEC outputs a thread,
// THREADS a block.
template <int MODE, int VEC, int THREADS>
__global__ void __launch_bounds__(THREADS) design(
    const float* __restrict__ src, int n, int k, float gain, uint32_t s0,
    uint32_t s1, const uint32_t* sids, const uint32_t* rids, StrideTable t,
    StrideTable inv, int ns, float* __restrict__ out) {
  __shared__ uint32_t sh[3];
  const int m = blockIdx.y;
  if (threadIdx.x == 0) {
    const repro::Pair es = repro::message_seed(s0, s1, sids[m], rids[m]);
    const repro::Pair ob = repro::offset_block(es);
    const uint32_t slot = ob.x1 % static_cast<uint32_t>(ns);
    sh[0] = ob.x0 % static_cast<uint32_t>(n);
    sh[1] = static_cast<uint32_t>(t.v[slot]);
    sh[2] = static_cast<uint32_t>(inv.v[slot]);
  }
  __syncthreads();
  const uint32_t off = sh[0], s = sh[1], si = sh[2], mask = n - 1;
  const int p0 = (blockIdx.x * THREADS + threadIdx.x) * VEC;
  if (MODE == 0 || MODE == 2) {  // gather, pull over j
    if (p0 >= k) return;
    const float* xr = src + static_cast<long long>(m) * n;
    float* orow = out + static_cast<long long>(m) * k;
    uint32_t idx = (off + static_cast<uint32_t>(p0) * s) & mask;
    float val[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      val[e] = p0 + e < k ? (MODE == 0 ? __ldcg(xr + idx) : __ldg(xr + idx)) : 0.0f;
      idx = (idx + s) & mask;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) if (p0 + e < k) orow[p0 + e] = val[e];
  } else if (MODE == 1) {  // gather walked by i, scattered stores
    if (p0 >= n) return;
    const float4 xv = __ldcs(reinterpret_cast<const float4*>(
        src + static_cast<long long>(m) * n + p0));
    const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
    float* orow = out + static_cast<long long>(m) * k;
    uint32_t j = ((static_cast<uint32_t>(p0) - off) * si) & mask;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (j < static_cast<uint32_t>(k)) orow[j] = xs[e];
      j = (j + si) & mask;
    }
  } else {  // scatter, pull over i
    if (p0 >= n) return;
    const float* vrow = src + static_cast<long long>(m) * k;
    uint32_t j = ((static_cast<uint32_t>(p0) - off) * si) & mask;
    float val[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      val[e] = j < static_cast<uint32_t>(k)
                   ? __fmul_rn(gain, MODE == 3 ? __ldcg(vrow + j) : __ldg(vrow + j))
                   : 0.0f;
      j = (j + si) & mask;
    }
    float* orow = out + static_cast<long long>(m) * n + p0;
#pragma unroll
    for (int e = 0; e < VEC; e += 4) {
      if (VEC >= 4) {
        __stcs(reinterpret_cast<float4*>(orow + e),
               make_float4(val[e], val[e + 1 < VEC ? e + 1 : e],
                           val[e + 2 < VEC ? e + 2 : e], val[e + 3 < VEC ? e + 3 : e]));
      }
    }
    if (VEC < 4) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) __stcs(orow + e, val[e]);
    }
  }
}

#define DESIGN(name, MODE, VEC, THREADS, LEN)                                        \
  extern "C" int name(const void* src, int M, int n, int k, float gain,    \
                      uint32_t s0, uint32_t s1, const void* sids,          \
                      const void* rids, const void* strides,               \
                      const void* inverses, int ns, void* out,             \
                      void* stream) {                                       \
    StrideTable t{}, inv{};                                                 \
    for (int i = 0; i < ns; ++i) {                                          \
      t.v[i] = static_cast<const int32_t*>(strides)[i];                     \
      inv.v[i] = static_cast<const int32_t*>(inverses)[i];                  \
    }                                                                       \
    const int len = LEN;                                                    \
    const dim3 grid((len + THREADS * VEC - 1) / (THREADS * VEC), M);        \
    design<MODE, VEC, THREADS>                                              \
        <<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(          \
        static_cast<const float*>(src), n, k, gain, s0, s1,                 \
        static_cast<const uint32_t*>(sids),                                 \
        static_cast<const uint32_t*>(rids), t, inv, ns,                     \
        static_cast<float*>(out));                                          \
    return static_cast<int>(cudaGetLastError());                            \
  }

DESIGN(design_g, 0, 4, 256, k)
DESIGN(design_h, 1, 4, 256, n)
DESIGN(design_i, 2, 8, 256, k)
DESIGN(design_j, 3, 4, 256, n)
DESIGN(design_k, 2, 2, 256, k)
DESIGN(design_l, 2, 1, 256, k)
DESIGN(design_m, 2, 4, 128, k)
DESIGN(design_o, 2, 4, 512, k)
DESIGN(design_p, 4, 2, 256, n)
DESIGN(design_q, 4, 8, 256, n)
DESIGN(design_r, 4, 4, 512, n)

ENTRY(probe_a, 32, 0, false)
ENTRY(probe_b, 32, 1, false)
ENTRY(probe_c, 32, 2, false)
ENTRY(probe_d, 32, 3, false)
ENTRY(probe_e, 4, 0, false)
ENTRY(probe_f, 32, 0, true)
"""

VARIANTS = {
    "a": "the push gather as it is",
    "b": "the same loads, index precomputed (reads 4 B of index more a j)",
    "c": "index math and Threefry alone, index stored",
    "d": "coalesced copy of the same bytes",
    "e": "a with 4 j a thread",
    "f": "a with the seed derived once per block",
}


DESIGNS = {
    "g": "K2 pull, L2-only loads",
    "h": "K2 walked by x position, scattered stores into the out row",
    "i": "K2 pull, 8 j a thread",
    "j": "K3 pull, L2-only loads",
    "k": "K2 pull, 2 j a thread",
    "l": "K2 pull, 1 j a thread",
    "m": "K2 pull, 128 threads a block",
    "o": "K2 pull, 512 threads a block",
    "p": "K3 pull, 2 i a thread",
    "q": "K3 pull, 8 i a thread",
    "r": "K3 pull, 512 threads a block",
}


def build(out_dir):
    from repro_torch.kernels import _build

    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "randk_probe.cu")
    lib = os.path.join(out_dir, "randk_probe.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build._CSRC),
                    "-o", lib, src], check=True)
    dll = ctypes.CDLL(lib)
    P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    for v in VARIANTS:
        fn = getattr(dll, f"probe_{v}")
        fn.argtypes = [P, P, I, I, I, U, U, P, P, P, I, P, P, P]
        fn.restype = I
    for v in DESIGNS:
        fn = getattr(dll, f"design_{v}")
        fn.argtypes = [P, I, I, I, ctypes.c_float, U, U, P, P, P, P, I, P, P]
        fn.restype = I
    return dll


def main():
    import torch

    from repro_torch.core import jaxrand
    from repro_torch.core.topology import Ring
    from repro_torch.kernels import _build, prng
    from repro_torch.kernels.sparse_gather import ops, ref

    if not torch.cuda.is_available():
        print("randk_probe: CUDA is not available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dll = build(os.path.join(ROOT, "build", "probe"))
    _build.build()

    dev = torch.device("cuda")
    nbr = torch.as_tensor(Ring(10).neighbor_table(), device=dev)
    sid = torch.arange(10, device=dev)[:, None].expand(10, 2).reshape(-1) \
        .to(torch.int32).contiguous()
    rid = nbr.reshape(-1).to(torch.int32).contiguous()
    seed = jaxrand.key_seed(jaxrand.fold_in(jaxrand.key(7), 13))
    m, n = 20, 2 ** 20
    k = round(0.6 * n)
    strides = prng.coprime_strides(n)
    table = _build.stride_table(strides)
    x = torch.randn((m, n), device=dev)
    out = torch.empty((m, k), device=dev)
    idx = torch.empty((m, k), dtype=torch.int32, device=dev)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def ms(fn, iters=50, warmup=5):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / iters

    def probe(v):
        def run():
            rc = getattr(dll, f"probe_{v}")(
                x.data_ptr(), idx.data_ptr(), m, n, k, seed[0], seed[1],
                sid.data_ptr(), rid.data_ptr(), table, len(strides),
                out.data_ptr(), idx.data_ptr(), stream())
            if rc:
                raise RuntimeError(f"probe_{v}: CUDA error {rc}")
        return run

    want = ref.randk_gather_plane_ref(seed, sid, rid, x, k=k, strides=strides)
    es = prng.fold(seed, prng.u32(sid), prng.u32(rid))
    want_idx = prng.affine_indices(es, n, k, strides)
    probe("c")()
    torch.cuda.synchronize()
    if not torch.equal(idx.long(), want_idx):
        raise AssertionError("probe c: index mismatch")
    for v in ("a", "e", "f"):
        out.zero_()
        probe(v)()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"probe {v}: gather mismatch")
    res = {}
    # turns: each probe twice, in the order a..f then f..a
    order = list(VARIANTS) + list(reversed(VARIANTS))
    for v in order:
        if v == "b" or v == "c":
            probe("c")()  # b reads the index c stores
        res.setdefault(v, []).append(ms(probe(v)))
    for v in VARIANTS:
        print(f"[probe] K2 {v}: {min(res[v]):.4f} ms (turns "
              f"{', '.join(f'{t:.4f}' for t in res[v])})  {VARIANTS[v]}"
              f" [{card}]", flush=True)

    sid32, rid32 = sid, rid
    pull = torch.empty((m, k), device=dev)

    def gather_pull():
        _build.launch("randk_gather_pull", x.data_ptr(), m, n, k, seed[0],
                      seed[1], sid32.data_ptr(), rid32.data_ptr(), table,
                      len(strides), pull.data_ptr())

    gather_pull()
    torch.cuda.synchronize()
    if not torch.equal(pull, want):
        raise AssertionError("pull gather mismatch")
    gain = n / k
    vg = torch.tensor(gain, dtype=torch.float32, device=dev) * want
    zeros = torch.zeros((m, n), device=dev)
    plane = torch.zeros((m, n), device=dev)
    pulled = torch.empty((m, n), device=dev)
    inv = _build.stride_table(ops.inverse_strides(n, strides))

    def scatter_pull():
        _build.launch("randk_scatter_pull", want.data_ptr(), m, n, k,
                      float(gain), seed[0], seed[1], sid32.data_ptr(),
                      rid32.data_ptr(), table, inv, len(strides),
                      pulled.data_ptr())

    def scatter_push():
        _build.launch("randk_scatter_push", want.data_ptr(), m, n, k,
                      float(gain), seed[0], seed[1], sid32.data_ptr(),
                      rid32.data_ptr(), table, len(strides), None,
                      plane.data_ptr())

    scatter_pull()
    torch.cuda.synchronize()
    want_out = ref.randk_scatter_plane_ref(seed, sid, rid, want, n=n,
                                           gain=gain, strides=strides)
    if not torch.equal(pulled.view(torch.int32), want_out.view(torch.int32)):
        raise AssertionError("pull scatter mismatch")
    new = {}
    for name, fn in (("K2 pull", gather_pull),
                     ("K2 torch.gather", lambda: torch.gather(x, 1,
                                                              want_idx)),
                     ("K3 pull", scatter_pull),
                     ("K3 push", scatter_push),
                     ("K3 torch.scatter", lambda: torch.scatter(
                         zeros, 1, want_idx, vg))):
        new[name] = [ms(fn)]
    for name, fn in (("K3 torch.scatter", lambda: torch.scatter(
                         zeros, 1, want_idx, vg)),
                     ("K3 push", scatter_push),
                     ("K3 pull", scatter_pull),
                     ("K2 torch.gather", lambda: torch.gather(x, 1,
                                                              want_idx)),
                     ("K2 pull", gather_pull)):
        new[name].append(ms(fn))
    inv_t = _build.stride_table(ops.inverse_strides(n, strides))
    dout = {v: pulled if v in "jpqr" else pull for v in DESIGNS}
    dsrc = {v: want if v in "jpqr" else x for v in DESIGNS}

    def design(v):
        def run():
            rc = getattr(dll, f"design_{v}")(
                dsrc[v].data_ptr(), m, n, k, float(gain), seed[0], seed[1],
                sid.data_ptr(), rid.data_ptr(), table, inv_t, len(strides),
                dout[v].data_ptr(), stream())
            if rc:
                raise RuntimeError(f"design_{v}: CUDA error {rc}")
        return run

    for v in DESIGNS:
        dout[v].fill_(float("nan"))
        design(v)()
        torch.cuda.synchronize()
        w = want_out if v in "jpqr" else want
        if not torch.equal(dout[v].view(torch.int32), w.view(torch.int32)):
            raise AssertionError(f"design {v}: mismatch")
    for v in list(DESIGNS) + list(reversed(DESIGNS)):
        new.setdefault(f"design {v}: {DESIGNS[v]}", []).append(
            ms(design(v)))
    for name, t in new.items():
        print(f"[probe] {name}: {min(t):.4f} ms (turns "
              f"{', '.join(f'{v:.4f}' for v in t)}) [{card}]", flush=True)
    print(json.dumps({"card": card, "shape": [m, n], "k": k,
                      "probe_ms": {v: min(t) for v, t in res.items()},
                      "ms": {nm: min(t) for nm, t in new.items()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
