// K4 and K5: per-message stochastic b-bit quantize and dequantize, one
// launch for all M messages of a call (one scale and one key per row).
//
// Replaces: src/repro/kernels/quantize/kernel.py:73 quantize (bodies
// _quantize8_kernel :38 and _quantize4_kernel :53, pallas_call :86/:99)
// and :188 dequantize (bodies :48 and :64, pallas_call :195/:208), with
// their wrappers quantize_tensor/dequantize_tensor (quantize/ops.py:86,
// :104), which the reference runs once per message under vmap; K4 also
// replaces the wrapper's scale pass (jnp.max |x|, ops.py:95).
//
// K4: scale[m] = max(max_j |x[m, j]|, tiny) and q[m, j] = sign(x) *
// floor(levels * |x| / scale[m] + kappa) with kappa = f32(bits) * 2^-32
// (round-to-nearest, so kappa can be 1.0) and bits =
// jax.random.bits(key[m], (n_pad,))[j].  The reference reads that uint32
// stream from device memory only so that interpret mode on a CPU can
// reproduce it (kernel.py:13-16); here each element draws its word in the
// kernel (threefry.cuh jax_bits), which gives the same bits and keeps an
// [M, n_pad] uint32 tensor out of memory.  b=8 stores int8 saturating as
// XLA's convert does; b=4 packs the pair (2i, 2i+1) as
// ((hi + 8) << 4) | (lo + 8) in int32 and keeps the low byte, an element
// past n counting as x = 0 (nibble 8), as the reference's zero padding to
// BLOCK = 1024 does.  The output is [M, wire] (wire = n or ceil(n / 2)):
// the reference slices its padded output to exactly that.  Design: K1's
// (quantize.cuh quantize_rows, ticketed max and quantise tiles in one
// launch after one memset, .ftz arithmetic), with the LeafKappa source
// (the keys in device memory).
//
// K4's shard form (shard_tree_absmax, shard_tree_quantize): a rank's
// shards of the leaves of one message tree that tensor parallelism cuts
// over the "model" axis, and FSDP over "data" (a leaf cut on one dim of
// each: index class 3), each quantised as its part of the whole leaf's
// message, one launch a pass for the whole tree (up to kMaxLeaves leaves a
// launch).  The scale is the whole leaf's, so the rank's row max is its own
// pass (each row's max |x| as uint32 bits: for a non-negative f32 the bits
// order as the value, a NaN's above +inf's), the caller all-reduces the
// cut leaves' words (a prefix) with MAX over the axes, and the quantise
// pass takes them; each element's kappa is the whole leaf's bit at its
// global flat index.  Design and index classes: quantize.cuh, "K4's shard
// form, grouped".  b=4 packs the shard's own pairs.  Dequantising the
// rank's payload is K5 unchanged.
//
// K5: out[m, j] = (scale[m] * q[m, j]) * (1 / levels), two rounded .ftz
// multiplies (a product below tiny becomes a zero of its sign, as XLA
// gives), no FMA; b=4 unpacks the nibbles.  The reference writes
// (scale * q) / levels, but XLA strength-reduces a division by a constant
// into a multiply by the constant's f32 reciprocal, so that is what its
// kernel computes (a true division differs from it in the last bit for
// some levels and scales).  The reference's pad bytes (0 at b=8, 0x88 at
// b=4) only feed elements past n, which it slices away, so the kernel
// stops at n.  The same kernel serves the plane route's dequantize_plane
// (plane = 1), whose reference is the jnp expression (scale * q) / levels
// (src/repro/kernels/quantize/ops.py:71), a true division there: its
// second step is an .ftz division, one pass where the flush in PyTorch
// would take four.
//
// Bound: K4 by integer operations (one full Threefry block per element,
// both words kept; chip_smoke.py's phase_sass counts its SASS by pipe),
// against 4 bytes read and 1 or 0.5 written; K5 by bytes (1 or 0.5 read,
// 4 written per element).
//
// K5's design: the rows are one flat walk over the M * n elements of
// out, in quads of kDqQuad = 4 consecutive elements, one float4 store a
// quad: a thread takes kDqQuads quads, kDqThreads * 4 elements apart, so
// each warp's store covers 512 contiguous bytes (a thread writing 16
// consecutive elements in four float4s instead would leave every warp
// store half of each 32-byte sector, which measured slower than one
// 4-byte store an element).  The flat walk holds because q [M, wire] is
// flat too: element e = m n + j is byte e at b=8 and nibble e + m pad at
// b=4, where pad = 2 wire - n is 1 for odd n (each row's last byte
// carries a pad nibble) and 0 for even n.  A quad's levels come from the
// aligned 4-byte words of q that hold them (one word, two where they
// straddle a word), shifted into place, so q may start at any byte: a
// warp's loads cover 128 (b=8) or 64 (b=4) contiguous bytes.  A quad
// takes its row's scale (m = e / n, one division a thread, the other
// quads' rows by a compare); a quad that straddles two rows, or whose
// words reach past q, and the last n mod 4 elements go one element at a
// time.  Where out is not 16-byte aligned every element does.  No 2-D
// grid, so any M; the indices are 32-bit, so the C entry refuses
// M * n >= kDqMostElements (2^31 - 2^11 elements, 8 GiB of out).
#include <cuda_runtime.h>

#include <algorithm>

#include "quantize.cuh"

namespace {

// K5's walk (mirrored in kernels/quantize/ops.py)
constexpr int kDqThreads = 256;
constexpr int kDqQuad = 4;    // elements a quad: one float4 store
constexpr int kDqQuads = 2;   // quads a thread, kDqThreads quads apart
// M * n stays below this, so that every element, nibble and word index,
// and a thread's quads past the last (< total + 4 kDqQuads kDqThreads),
// fits 32 bits
constexpr long long kDqMostElements =
    ((1LL << 32) - 8LL * kDqQuads * kDqThreads) / 2;
// f32(1 / 127) and f32(1 / 7), correctly rounded, as XLA folds them
constexpr float kInv127 = 0x1.020408p-7f;
constexpr float kInv7 = 0x1.24924ap-3f;

// the dequantised value of level v at scale sc: (sc * v) * f32(1 / levels)
// (K5) or, for the plane route, (sc * v) / levels, each step .ftz
template <int kBits, bool kDiv>
__device__ __forceinline__ float dequantize_one(float sc, float v) {
  const float p = repro::mul_ftz(sc, v);
  return kDiv ? repro::div_ftz(p, kBits == 8 ? 127.f : 7.f)
              : repro::mul_ftz(p, kBits == 8 ? kInv127 : kInv7);
}

// the store of a whole quad, streaming (evict-first): out is written once
__device__ __forceinline__ void store_quad(float4* p, float4 v) {
  __stcs(p, v);
}

// level k (0..3) of a quad from its word: at b=8 four int8 levels
// (little-endian); at b=4 the top 16 bits hold four nibbles, the first on
// top, offset 8
template <int kBits>
__device__ __forceinline__ float quad_level(uint32_t w, int k) {
  if (kBits == 8) return static_cast<float>(static_cast<int8_t>(w >> (8 * k)));
  return static_cast<float>(static_cast<int>((w >> (28 - 4 * k)) & 0xFu) - 8);
}

// element e of the flat walk, alone: its row, its level, its value
template <int kBits, bool kDiv, bool kPad>
__device__ __forceinline__ float dequantize_element(
    const uint8_t* __restrict__ q, uint32_t e, uint32_t n,
    const float* __restrict__ scale) {
  const uint32_t m = e / n;
  float v;
  if (kBits == 8) {
    v = static_cast<float>(static_cast<int8_t>(__ldg(q + e)));
  } else {
    const uint32_t nib = kPad ? e + m : e;  // odd n: a pad nibble a row
    const int byte = __ldg(q + (nib >> 1));
    v = static_cast<float>(((nib & 1) ? (byte & 0xF) : (byte >> 4)) - 8);
  }
  return dequantize_one<kBits, kDiv>(__ldg(scale + m), v);
}

// Dequantise the M * n elements of q [M, wire] into out [M, n] (see the
// header): quads [4 i, 4 i + 4) for i < quads, the rest one element at a
// time.  q's words are read from qw, q rounded down to 4 bytes (q0 = q's
// offset in its first word), words [0, qwords) lying in q's storage up to
// q's last byte.
template <int kBits, bool kDiv, bool kPad>
__global__ void __launch_bounds__(kDqThreads)
dequantize_rows(const uint8_t* __restrict__ q, const uint32_t* __restrict__ qw,
                int q0, uint32_t qwords, uint32_t total, uint32_t n,
                uint32_t quads, const float* __restrict__ scale,
                float* __restrict__ out) {
  constexpr uint32_t kStep = 4 * kDqThreads;  // elements between quads
  const uint32_t e0 = 4 * (blockIdx.x * (kDqQuads * kDqThreads) +
                           threadIdx.x);
  const uint32_t m0 = e0 / n, r0 = e0 - m0 * n;
  uint32_t lo[kDqQuads], hi[kDqQuads];
  uint32_t m[kDqQuads];
  int shift[kDqQuads];
  bool whole[kDqQuads];  // in one row, its words in bounds
  // every quad's row and words first, so that the loads are in flight
  // together
#pragma unroll
  for (int h = 0; h < kDqQuads; ++h) {
    const uint32_t e = e0 + h * kStep;
    uint32_t r = r0 + h * kStep;
    m[h] = m0;
    if (r + kDqQuad > n) {  // another row, or across two
      m[h] = e / n;
      r = e - m[h] * n;
    }
    // the quad's first byte (b=8) or nibble (b=4) from qw, its word and
    // its place in that word; a second word where the quad runs past it
    const uint32_t at = kBits == 8 ? q0 + e : 2 * q0 + e + (kPad ? m[h] : 0);
    const uint32_t word = kBits == 8 ? at >> 2 : at >> 3;
    shift[h] = static_cast<int>(kBits == 8 ? at & 3 : at & 7);
    const bool two = kBits == 8 ? shift[h] != 0 : shift[h] > 4;
    whole[h] = e / 4 < quads && r + kDqQuad <= n && word + two < qwords;
    if (whole[h]) {
      lo[h] = __ldg(qw + word);
      hi[h] = two ? __ldg(qw + word + 1) : 0u;
    }
  }
  const float sc0 = __ldg(scale + min(m0, total / n - 1));
#pragma unroll
  for (int h = 0; h < kDqQuads; ++h) {
    const uint32_t e = e0 + h * kStep;
    if (e / 4 >= quads) continue;
    if (whole[h]) {
      const float sc = m[h] == m0 ? sc0 : __ldg(scale + m[h]);
      // the quad's 4 bytes, or its 4 nibbles in the top 16 bits
      const uint32_t w =
          kBits == 8 ? __byte_perm(lo[h], hi[h], 0x3210 + 0x1111 * shift[h])
                     : __funnelshift_l(__byte_perm(hi[h], 0u, 0x0123),
                                       __byte_perm(lo[h], 0u, 0x0123),
                                       4 * shift[h]);
      store_quad(reinterpret_cast<float4*>(out) + e / 4,
                 make_float4(
                     dequantize_one<kBits, kDiv>(sc, quad_level<kBits>(w, 0)),
                     dequantize_one<kBits, kDiv>(sc, quad_level<kBits>(w, 1)),
                     dequantize_one<kBits, kDiv>(sc, quad_level<kBits>(w, 2)),
                     dequantize_one<kBits, kDiv>(sc,
                                                 quad_level<kBits>(w, 3))));
    } else {  // straddles two rows, or its words reach past q
#pragma unroll
      for (int i = 0; i < kDqQuad; ++i) {
        out[e + i] = dequantize_element<kBits, kDiv, kPad>(q, e + i, n,
                                                           scale);
      }
    }
  }
  // the elements past the last quad: all of them where there are no quads
  const uint32_t stride = gridDim.x * kDqThreads;
  for (uint32_t e = 4 * quads + blockIdx.x * kDqThreads + threadIdx.x;
       e < total; e += stride) {
    out[e] = dequantize_element<kBits, kDiv, kPad>(q, e, n, scale);
  }
}

template <int kBits, bool kDiv, bool kPad>
int launch_dequantize(const void* q, long long total, int n,
                      long long qbytes, const float* scale, float* out,
                      cudaStream_t st) {
  const auto qa = reinterpret_cast<uintptr_t>(q);
  const int q0 = static_cast<int>(qa & 3);
  // quads where out takes float4 stores (a tensor from the caching
  // allocator always does)
  const long long quads =
      reinterpret_cast<uintptr_t>(out) % 16 ? 0 : total / kDqQuad;
  const long long rest = total - kDqQuad * quads;
  const long long per_block = 1LL * kDqQuads * kDqThreads;
  const long long blocks =
      std::max((quads + per_block - 1) / per_block,
               std::min((rest + kDqThreads - 1) / kDqThreads, 1LL << 16));
  dequantize_rows<kBits, kDiv, kPad>
      <<<static_cast<unsigned>(blocks), kDqThreads, 0, st>>>(
          static_cast<const uint8_t*>(q),
          reinterpret_cast<const uint32_t*>(qa - q0), q0,
          static_cast<uint32_t>((q0 + qbytes) / 4),
          static_cast<uint32_t>(total), static_cast<uint32_t>(n),
          static_cast<uint32_t>(quads), scale, out);
  return static_cast<int>(cudaGetLastError());
}

template <int kBits, bool kPad>
int dequantize_form(const void* q, long long total, int n, long long qbytes,
                    const float* scale, float* out, int plane,
                    cudaStream_t st) {
  return plane ? launch_dequantize<kBits, true, kPad>(q, total, n, qbytes,
                                                      scale, out, st)
               : launch_dequantize<kBits, false, kPad>(q, total, n, qbytes,
                                                       scale, out, st);
}

bool bad_shape(int M, int n, int bits, int wire) {
  return M <= 0 || n <= 0 ||
         !((bits == 8 && wire == n) || (bits == 4 && wire == (n + 1) / 2));
}

}  // namespace

// keys: M (k0, k1) pairs of uint32, in device memory
extern "C" int quantize_leaf(const void* x, int M, int n, int bits,
                             const void* keys, void* scale, void* q, int wire,
                             void* scratch, void* stream) {
  if (M <= 0 || n <= 0 ||
      !((bits == 8 && wire == n) || (bits == 4 && wire == (n + 1) / 2))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const repro::LeafKappa src{static_cast<const uint32_t*>(keys)};
  const auto* xs = static_cast<const float*>(x);
  auto* sc = static_cast<float*>(scale);
  auto* qs = static_cast<uint8_t*>(q);
  auto* scr = static_cast<unsigned*>(scratch);
  const auto st = static_cast<cudaStream_t>(stream);
  return bits == 8 ? repro::launch_quantize_rows<8>(xs, M, n, wire, src, sc,
                                                    qs, scr, st)
                   : repro::launch_quantize_rows<4>(xs, M, n, wire, src, sc,
                                                    qs, scr, st);
}

namespace {

// ShardTreeArgs of one launch: the x pointers from the host array xs
bool tree_args(repro::ShardTreeArgs* a, const void* table, int leaves,
               unsigned tiles, const void* xs) {
  if (leaves < 1 || leaves > repro::kMaxLeaves || tiles < 1) return false;
  *a = repro::ShardTreeArgs{};
  a->table = static_cast<const uint32_t*>(table);
  a->leaves = leaves;
  a->tiles = tiles;
  const auto* x = static_cast<const float* const*>(xs);
  for (int i = 0; i < leaves; ++i) a->x[i] = x[i];
  return true;
}

}  // namespace

// K4's shard form, first pass: the words (max |x| bits) of every row of a
// launch's leaves.  table: the plan's device entries; xs: a host array of
// the leaves' x pointers; counters: an arrival counter a word slot (zero
// before, zero after); partials: a word a tile of the launch.
extern "C" int shard_tree_absmax(const void* table, int leaves,
                                 unsigned tiles, const void* xs, void* words,
                                 void* counters, void* partials,
                                 void* stream) {
  repro::ShardTreeArgs a;
  if (!tree_args(&a, table, leaves, tiles, xs)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.words = static_cast<unsigned*>(words);
  a.counters = static_cast<unsigned*>(counters);
  a.partials = static_cast<unsigned*>(partials);
  repro::shard_tree_absmax<<<
      repro::persistent_grid(repro::shard_tree_absmax, 0, tiles),
      repro::kQThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K4's shard form, second pass: q and scale of every row of a launch's
// leaves at max(word, tiny), the word of a slot below cut from reduced
// (the all-reduced prefix) and the others' from words.  keys: (k0, k1) of
// row m of the tree's leaf k at m * key_stride + k, in device memory; q:
// the tree's q buffer (each leaf at its entry's offset); scale: a float a
// slot.
extern "C" int shard_tree_quantize(const void* table, int leaves,
                                   unsigned tiles, const void* xs, int bits,
                                   const void* keys, int key_stride,
                                   const void* reduced, unsigned cut,
                                   const void* words, void* scale, void* q,
                                   void* stream) {
  repro::ShardTreeArgs a;
  if (!tree_args(&a, table, leaves, tiles, xs) || key_stride < 1 ||
      (bits != 8 && bits != 4) || (cut > 0 && reduced == nullptr) ||
      keys == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.key_stride = key_stride;
  a.keys = static_cast<const uint32_t*>(keys);
  a.reduced = static_cast<const unsigned*>(reduced);
  a.cut = cut;
  a.words = const_cast<unsigned*>(static_cast<const unsigned*>(words));
  a.scale = static_cast<float*>(scale);
  a.q = static_cast<uint8_t*>(q);
  const auto st = static_cast<cudaStream_t>(stream);
  if (bits == 8) {
    repro::shard_tree_quantize<8><<<
        repro::persistent_grid(repro::shard_tree_quantize<8>, 1, tiles),
        repro::kQThreads, 0, st>>>(a);
  } else {
    repro::shard_tree_quantize<4><<<
        repro::persistent_grid(repro::shard_tree_quantize<4>, 2, tiles),
        repro::kQThreads, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// plane = 0: K5 (the per-message route); 1: the plane route's
// dequantize_plane, whose reference divides by levels
extern "C" int dequantize_leaf(const void* q, int M, int n, int bits,
                               const void* scale, void* out, int wire,
                               int plane, void* stream) {
  if (bad_shape(M, n, bits, wire)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = 1LL * M * n;
  if (total >= kDqMostElements) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long qbytes = 1LL * M * wire;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* sc = static_cast<const float*>(scale);
  auto* o = static_cast<float*>(out);
  if (bits == 8) {
    return dequantize_form<8, false>(q, total, n, qbytes, sc, o, plane, st);
  }
  return n % 2 ? dequantize_form<4, true>(q, total, n, qbytes, sc, o, plane,
                                          st)
               : dequantize_form<4, false>(q, total, n, qbytes, sc, o, plane,
                                           st);
}
