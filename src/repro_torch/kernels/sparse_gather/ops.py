"""Wrappers of the fused RandK plane kernels (K2 gather, K3 scatter;
``csrc/randk_plane.cu``), of the arbitrary-index gather/scatter kernels
(K6, K7; ``csrc/gather_scatter.cu``) and of the cyclic-window
gather/scatter kernels (K8, K9; ``csrc/cyclic.cu``).

On a CUDA tensor each wrapper launches its kernel; on a CPU tensor it
runs the plain version (``ref.py``), as the reference runs Pallas in
interpret mode off the TPU.  The index set of every message is derived
in the kernel from ``(seed, sender, receiver)``: ``seed`` is the round's
pair of uint32 ints, ``sids``/``rids`` are per-message ids (int32 tensors
holding uint32 bit patterns; ``rids=None`` marks one-to-all messages) and
``strides`` the static stride table (``(1,)`` for the block sampler).
K6/K7 take index rows computed outside the kernel, as the reference
does (a permutation, a top-k sort or the affine stride set); K8/K9 take
one offset per message (RandK's block sampler) and compute the window in
the kernel.

K2 and K3 have two variants each, chosen by ``variant`` before the
launch, a rule on ``(n, k, strides)`` alone:

* ``"pull"`` where ``indices_unique`` holds (every main-path shape: n a
  power of two, or an int32 sum that never wraps, as at the paper's
  n = 5): each kernel walks its output in order with 16-byte stores;
  the gather steps ``idx_j`` from j to j + 1, the scatter inverts the
  map, ``j = (i - off) * stride^-1 mod n``.  The scatter writes every
  element of its plane, so its output is ``torch.empty``; the host
  passes ``inverse_strides`` beside the strides.
* ``"push"`` where a row may repeat an index (n not a power of two and
  the int32 sum wraps): the gather walks j, the scatter writes onto a
  ``torch.zeros`` plane after a claim pass that keeps the last j.

K7 (``sparse_scatter``) has two variants, chosen by ``scatter_variant``
from the caller's ``unique``: "unique" and "claim" (the last j of a
repeated index wins).  Both bin the (index, value) rows by plane segment
and write each segment in order, so the plane is ``torch.empty``.  K6
and K7 read the index rows in the dtype the caller holds (int32 or
int64), in place: no conversion pass.

A launch that the chosen kernel refuses raises; nothing gives way to the
other variant or to the plain version.  ``launches_<variant>`` counts
each variant, ``launches`` their sum.

On a ``meta`` or fake tensor (a dry-run's trace of the card's route) a
wrapper takes its fake route: outputs of the kernel's shapes and dtypes,
no launch.  Both routes report the call to the active
``launch.op_analysis.OpCounter`` as one op under the kernel's id.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quantize.ops import _plane_ids
from repro_torch.kernels.sparse_gather import ref
from repro_torch.launch import op_analysis


def _fake(kid, inputs, lead, w, like):
    """A fake route's output ``[*lead, w]`` f32, reported as ``kid``."""
    return op_analysis.kernel_op(kid, inputs, torch.empty(
        tuple(lead) + (w,), dtype=torch.float32, device=like.device))


def indices_unique(n: int, k: int, strides: tuple) -> bool:
    """True when no row's index set can repeat an index: k <= n, every
    stride coprime to n, and the int32 sum ``off + j * stride`` never
    wraps, or n divides 2^32 (a power of two) so the wrap leaves the
    residues mod n intact.  Then ``j -> (off + j * stride) mod n`` is a
    bijection of Z_n, inverted by ``inverse_strides``."""
    if k > n or any(math.gcd(s, n) != 1 for s in strides):
        return False
    return (n & (n - 1) == 0
            or (n - 1) + (k - 1) * max(abs(s) for s in strides) < 2 ** 31)


@functools.lru_cache(maxsize=64)
def inverse_strides(n: int, strides: tuple) -> tuple:
    """``stride^-1 mod n`` of each stride of the static table (raises
    ValueError for a stride not coprime to n).  Cached per table: the
    pull scatter's second kernel-argument table."""
    return tuple(pow(s % n, -1, n) for s in strides)


@functools.lru_cache(maxsize=256)
def variant(n: int, k: int, strides: tuple) -> str:
    """K2/K3's variant for these shapes: "pull" or "push" (module doc).
    Cached: a wrapper asks on every launch, for a few static tables."""
    return "pull" if indices_unique(n, k, strides) else "push"


def _count(wrapper, kind: str) -> None:
    setattr(wrapper, f"launches_{kind}",
            getattr(wrapper, f"launches_{kind}") + 1)
    wrapper.launches += 1


def randk_gather_plane(seed, sids, rids, x, *, k, strides):
    """RandK compress of every message of ``x [..., n]``: ``[..., k]``."""
    if x.device.type == "cpu":
        return ref.randk_gather_plane_ref(seed, sids, rids, x, k=k,
                                          strides=strides)
    if op_analysis.is_abstract(x):
        return _fake("K2", (x,), x.shape[:-1], k, x)
    lead, n, xf = _build.rows(x, "x", torch.float32)
    m = xf.shape[0]
    sid, rid = _plane_ids(sids, lead), _plane_ids(rids, lead)
    strides = tuple(strides)
    kind = variant(n, k, strides)
    out = torch.empty((m, k), dtype=torch.float32, device=x.device)
    _build.launch(
        f"randk_gather_{kind}", xf.data_ptr(), m, n, k, seed[0], seed[1],
        _build.id_ptr(sid, m, x.device), _build.id_ptr(rid, m, x.device),
        _build.stride_table(strides), len(strides), out.data_ptr(),
    )
    _count(randk_gather_plane, kind)
    return op_analysis.kernel_op("K2", (xf,), out.reshape(lead + (k,)))


# launches of each variant; ``launches`` is their sum
randk_gather_plane.launches = 0
randk_gather_plane.launches_pull = 0
randk_gather_plane.launches_push = 0


def randk_scatter_plane(seed, sids, rids, v, *, n, gain, strides):
    """RandK decompress of ``v [..., k]``: ``gain * v`` written at each
    message's index set of an ``[..., n]`` plane, +0.0 elsewhere.  The
    pull variant writes every element of a ``torch.empty`` plane; the
    push variant scatters onto ``torch.zeros``, after a claim pass where
    an index may repeat."""
    if v.device.type == "cpu":
        return ref.randk_scatter_plane_ref(seed, sids, rids, v, n=n,
                                           gain=gain, strides=strides)
    if op_analysis.is_abstract(v):
        return _fake("K3", (v,), v.shape[:-1], n, v)
    lead, k, vf = _build.rows(v, "v", torch.float32)
    m = vf.shape[0]
    sid, rid = _plane_ids(sids, lead), _plane_ids(rids, lead)
    strides = tuple(strides)
    ids = (_build.id_ptr(sid, m, v.device), _build.id_ptr(rid, m, v.device))
    if variant(n, k, strides) == "pull":
        out = torch.empty((m, n), dtype=torch.float32, device=v.device)
        _build.launch(
            "randk_scatter_pull", vf.data_ptr(), m, n, k, float(gain),
            seed[0], seed[1], *ids, _build.stride_table(strides),
            _build.stride_table(inverse_strides(n, strides)), len(strides),
            out.data_ptr(),
        )
        _count(randk_scatter_plane, "pull")
        return op_analysis.kernel_op("K3", (vf,), out.reshape(lead + (n,)))
    out = torch.zeros((m, n), dtype=torch.float32, device=v.device)
    winner = (None if indices_unique(n, k, strides) else
              torch.full((m, n), -1, dtype=torch.int32, device=v.device))
    _build.launch(
        "randk_scatter_push", vf.data_ptr(), m, n, k, float(gain), seed[0],
        seed[1], *ids, _build.stride_table(strides), len(strides),
        None if winner is None else winner.data_ptr(), out.data_ptr(),
    )
    _count(randk_scatter_plane, "push")
    return op_analysis.kernel_op("K3", (vf,), out.reshape(lead + (n,)))


randk_scatter_plane.launches = 0
randk_scatter_plane.launches_pull = 0
randk_scatter_plane.launches_push = 0


def _index_rows(idx, lead, k, device):
    """``idx [..., k]`` as ``[M, k]`` rows that the kernels read in place,
    in the dtype the caller holds (int32 or int64): ``(rows, int64?, row
    stride in elements)``.  The prefix ``[..., :k]`` of an ``[..., n]``
    tensor (a permutation, a top-k sort) is a view with row stride n."""
    if tuple(idx.shape) != lead + (k,):
        raise ValueError(f"idx of shape {tuple(idx.shape)} != "
                         f"{lead + (k,)}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"idx must be int32 or int64, got {idx.dtype}")
    if idx.device != device:
        raise ValueError(f"idx must be on {device}, got {idx.device}")
    rows = idx.reshape(-1, k)
    ld = rows.stride(0) if rows.shape[0] > 1 else k
    if (k > 1 and rows.stride(1) != 1) or ld < k:
        raise ValueError(f"idx rows must be unit-stride and apart by >= k, "
                         f"got strides {rows.stride()}")
    return rows, rows.dtype == torch.int64, ld


def sparse_gather(x, idx):
    """``out[..., j] = x[..., idx[..., j]]`` (0 for an index outside
    [0, n)): every message of ``x [..., n]`` in one launch; ``idx`` int32
    or int64, read in place; returns ``[..., k]``."""
    if x.device.type == "cpu":
        return ref.sparse_gather_ref(x, idx)
    if op_analysis.is_abstract(x):
        return _fake("K6", (x, idx), idx.shape[:-1], idx.shape[-1], x)
    _, n, xf = _build.rows(x, "x", torch.float32)
    lead, k = tuple(idx.shape[:-1]), idx.shape[-1]
    if tuple(x.shape[:-1]) != lead:
        raise ValueError(f"x lead shape {tuple(x.shape[:-1])} != idx lead "
                         f"shape {lead}")
    m = xf.shape[0]
    ix, wide, ld = _index_rows(idx, lead, k, x.device)
    out = torch.empty((m, k), dtype=torch.float32, device=x.device)
    _build.launch("sparse_gather", xf.data_ptr(), m, n, ix.data_ptr(),
                  int(wide), ld, k, out.data_ptr())
    sparse_gather.launches += 1
    return op_analysis.kernel_op("K6", (xf, ix), out.reshape(lead + (k,)))


sparse_gather.launches = 0

# The sizes of csrc/gather_scatter.cu (a CPU test holds them equal): K6's
# scattered loads a thread; K7's j per bin tile, segments per window at
# most, and each variant's segment length (log2; the claim variant keeps
# 8 bytes an element in shared memory, so half as many)
GATHER_PER = 2
BIN_TILE = 4096
MAX_SEGS = 4096
SEG_LOG = {"unique": 14, "claim": 13}


def scatter_variant(unique: bool) -> str:
    """K7's variant: "unique" where the caller proves every row's indices
    distinct (a float a plane element in shared memory), else "claim"
    (a 64-bit word an element, (j + 1, value) by atomicMax: the last j of
    a repeated index wins)."""
    return "unique" if unique else "claim"


def bin_layout(m: int, n: int, k: int, kind: str) -> tuple:
    """The binned scatter's segments a window (a row of more than MAX_SEGS
    segments is scattered window by window), windows a row, tiles a row,
    and the int32 words of its scratch, which every window reuses: the
    pairs ``[m, tiles, BIN_TILE]`` (the claim variant's (offset | position
    << 16, value) in 2 words each; the unique variant's values, then its
    16-bit offsets: 1.5 words each), then the run starts ``[m, segments +
    1, tiles]``."""
    segs = (n + (1 << SEG_LOG[kind]) - 1) >> SEG_LOG[kind]
    nseg, windows = min(segs, MAX_SEGS), -(-segs // MAX_SEGS)
    tiles = -(-k // BIN_TILE)
    pair_words = (4 if kind == "claim" else 3) * m * tiles * BIN_TILE // 2
    return nseg, windows, tiles, pair_words, m * (nseg + 1) * tiles


def sparse_scatter(v, idx, n: int, gain=1.0, *, unique: bool):
    """``zeros(n).at[idx].set(gain * v)`` per message (two launches: bin,
    fill); ``v``/``idx [..., k]``, idx int32 or int64 read in place,
    returns ``[..., n]``.  Every element of the plane is written, so
    nothing is zero-filled; ``unique=False`` (the caller cannot prove each
    row's indices distinct) takes the claim variant, so that a repeated
    index keeps the last j, as the reference's scatter does."""
    if v.device.type == "cpu":
        return ref.sparse_scatter_ref(v, idx, n, gain)
    if op_analysis.is_abstract(v):
        return _fake("K7", (v, idx), v.shape[:-1], n, v)
    lead, k, vf = _build.rows(v, "v", torch.float32)
    m = vf.shape[0]
    ix, wide, ld = _index_rows(idx, lead, k, v.device)
    kind = scatter_variant(unique)
    *_, pair_words, start_words = bin_layout(m, n, k, kind)
    scratch = torch.empty(pair_words + start_words, dtype=torch.int32,
                          device=v.device)
    out = torch.empty((m, n), dtype=torch.float32, device=v.device)
    _build.launch("sparse_scatter", vf.data_ptr(), ix.data_ptr(), int(wide),
                  ld, m, n, k, float(gain), int(kind == "claim"),
                  scratch.data_ptr(),
                  scratch.data_ptr() + 4 * pair_words, out.data_ptr())
    _count(sparse_scatter, kind)
    return op_analysis.kernel_op("K7", (vf, ix), out.reshape(lead + (n,)))


# launches of each variant; ``launches`` is their sum
sparse_scatter.launches = 0
sparse_scatter.launches_unique = 0
sparse_scatter.launches_claim = 0


def _offsets(off, lead, device):
    """Per-message offsets as contiguous int64 ``[M]`` on ``device`` (the
    kernels reduce them mod n)."""
    if tuple(off.shape) != lead:
        raise ValueError(f"off of shape {tuple(off.shape)} != {lead}")
    return off.reshape(-1).to(device=device, dtype=torch.int64).contiguous()


def _check_window(n: int, k: int):
    if not 1 <= k <= n < 2 ** 30:
        raise ValueError(f"cyclic window needs 1 <= k <= n < 2^30, got "
                         f"k={k}, n={n}")


def cyclic_gather(x, off, k: int):
    """``out[..., j] = x[..., (off + j) mod n]`` for j < k: every message
    of ``x [..., n]`` (offsets ``off [...]``) in one launch; returns
    ``[..., k]``."""
    if x.device.type == "cpu":
        return ref.cyclic_gather_ref(x, off, k)
    if op_analysis.is_abstract(x):
        return _fake("K8", (x, off), x.shape[:-1], k, x)
    lead, n, xf = _build.rows(x, "x", torch.float32)
    _check_window(n, k)
    m = xf.shape[0]
    o = _offsets(off, lead, x.device)
    out = torch.empty((m, k), dtype=torch.float32, device=x.device)
    _build.launch("cyclic_gather", xf.data_ptr(), o.data_ptr(), m, n, k,
                  out.data_ptr())
    cyclic_gather.launches += 1
    return op_analysis.kernel_op("K8", (xf, o), out.reshape(lead + (k,)))


cyclic_gather.launches = 0


def cyclic_scatter(v, off, n: int, gain=1.0):
    """``gain * v [..., k]`` written at each message's window ``(off + j)
    mod n`` of an ``[..., n]`` plane, zero elsewhere, in one launch.  As
    the reference's kernel does, a -0.0 value comes out as +0.0.  The
    kernel writes every element, so the plane is not zero-filled first."""
    if v.device.type == "cpu":
        return ref.cyclic_scatter_ref(v, off, n, gain)
    if op_analysis.is_abstract(v):
        return _fake("K9", (v, off), v.shape[:-1], n, v)
    lead, k, vf = _build.rows(v, "v", torch.float32)
    _check_window(n, k)
    m = vf.shape[0]
    o = _offsets(off, lead, v.device)
    out = torch.empty((m, n), dtype=torch.float32, device=v.device)
    _build.launch("cyclic_scatter", vf.data_ptr(), o.data_ptr(), m, n, k,
                  float(gain), out.data_ptr())
    cyclic_scatter.launches += 1
    return op_analysis.kernel_op("K9", (vf, o), out.reshape(lead + (n,)))


cyclic_scatter.launches = 0
