"""Wrappers of the fused plane quantizer (K1, ``csrc/quantize_plane.cu``)
and of the per-message quantize/dequantize kernels (K4/K5,
``csrc/quantize_leaf.cu``), K4's shard form among them (``tree_absmax``,
``quantize_tree``: a rank's shards of a message tree's leaves cut over
the "model" axis, one launch a pass for the whole tree).

Each wrapper launches its CUDA kernel on a CUDA tensor and runs the plain
version (``ref.py``) on a CPU tensor, as the reference runs Pallas in
interpret mode off the TPU.  K1 and K4 compute the row scales in the same
launch as the levels (``csrc/quantize.cuh``), so their wrappers only
allocate: q, scale, and the kernel's scratch (a ticket, a counter and a
max word per row), which the C entry zeroes on the stream before the
launch.  ``dequantize_plane``, a jnp expression in the reference
(``quantize/ops.py:71``), runs K5's kernel in its division form on the
card.  K5 walks its rows as one flat array in quads of 4 elements
(``DQ_*`` mirror its sizes); a call of 2^31 - 2^11 elements or more goes
in row groups, one launch each.

On a ``meta`` or fake tensor (a dry-run's trace of the card's route) a
wrapper takes its fake route: it returns outputs of the kernel's shapes
and dtypes and launches nothing.  Both routes report the call to the
active ``launch.op_analysis.OpCounter`` as one op under the kernel's id.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from repro_torch.kernels import _build, prng
from repro_torch.kernels.quantize import ref
from repro_torch.launch import op_analysis


# K5's walk, as csrc/quantize_leaf.cu sizes it: the M * n elements of out
# as one flat array in quads of DQ_QUAD (one float4 store each, where out
# is 16-byte aligned), a thread DQ_QUADS quads 4 * DQ_THREADS elements
# apart, a block DQ_THREADS threads
DQ_THREADS = 256
DQ_QUAD = 4
DQ_QUADS = 2
# its element, nibble and word indices are 32-bit: the C entry refuses
# M * n at or above kDqMostElements (2^31 - 2^11), so a larger call goes
# in row groups below it
DQ_MOST_ELEMENTS = ((1 << 32) - 8 * DQ_QUADS * DQ_THREADS) // 2


def wire_len(n: int, bits: int) -> int:
    """Wire bytes of one quantized message of n elements."""
    return n if bits == 8 else -(-n // 2)


def scratch(m: int, device):
    """The fused quantiser's scratch for m rows: a ticket, then an arrival
    counter and a max word per row (uint32; zeroed by the C entry).  One
    per call, so two calls on two streams never share one."""
    return torch.empty((1 + 2 * m,), dtype=torch.int32, device=device)


def _check_bits(bits):
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")


def _q_dtype(bits):
    return torch.int8 if bits == 8 else torch.uint8


def _fake_quantize(kid, x, bits):
    """The fake route of K1/K4: ``(q [..., wire_len], scale [...])``."""
    lead, n = tuple(x.shape[:-1]), x.shape[-1]
    return op_analysis.kernel_op(kid, (x,), (
        torch.empty(lead + (wire_len(n, bits),), dtype=_q_dtype(bits),
                    device=x.device),
        torch.empty(lead, dtype=torch.float32, device=x.device)))


def _fake_dequantize(q, scale, n):
    """The fake route of K5: ``[..., n]`` f32."""
    return op_analysis.kernel_op("K5", (q, scale), torch.empty(
        tuple(q.shape[:-1]) + (n,), dtype=torch.float32, device=q.device))


def quantize_plane(seed, sids, rids, x, *, bits=8):
    """Quantize every message of ``x [..., n]`` (f32) in one launch, the
    stochastic-rounding bits derived in the kernel from ``(seed, sender,
    receiver, element)``.  ``seed`` is the round's pair of uint32 ints;
    ``sids``/``rids`` are per-message ids (int32 tensors holding uint32
    bit patterns, broadcastable to the lead shape) and ``rids=None`` marks
    one-to-all messages.  Returns ``(q [..., wire_len], scale [...])``."""
    _check_bits(bits)
    if x.device.type == "cpu":
        return ref.quantize_plane_ref(seed, sids, rids, x, bits=bits)
    if op_analysis.is_abstract(x):
        return _fake_quantize("K1", x, bits)
    lead, n, xf = _build.rows(x, "x", torch.float32)
    m, wire = xf.shape[0], wire_len(n, bits)
    sid = _plane_ids(sids, lead)
    rid = _plane_ids(rids, lead)
    scale = torch.empty((m,), dtype=torch.float32, device=x.device)
    q = torch.empty((m, wire), device=x.device, dtype=_q_dtype(bits))
    _build.launch(
        "quantize_plane", xf.data_ptr(), m, n, bits, seed[0], seed[1],
        _build.id_ptr(sid, m, x.device), _build.id_ptr(rid, m, x.device),
        scale.data_ptr(), q.data_ptr(), wire,
        scratch(m, x.device).data_ptr(),
    )
    quantize_plane.launches += 1
    return op_analysis.kernel_op("K1", (xf,), (q.reshape(lead + (wire,)),
                                               scale.reshape(lead)))


quantize_plane.launches = 0


def _plane_ids(ids, lead):
    """Per-message ids for the kernels: int32 ``[M]`` (None stays None)."""
    if ids is None:
        return None
    try:
        ids = ids.broadcast_to(lead)
    except RuntimeError as e:
        raise ValueError(f"ids of shape {tuple(ids.shape)} do not broadcast "
                         f"to the messages' shape {lead}") from e
    return ids.reshape(-1).to(torch.int32).contiguous()


def quantize_tensor(keys, x, *, bits=8):
    """Quantize every message of ``x [..., n]`` (f32) in one launch, the
    counterpart of the reference's per-message ``quantize_tensor``
    (``quantize/ops.py:86``) batched over the lead dims.  ``keys [..., 2]``
    (``core.jaxrand`` keys, one per message): message m's rounding bits are
    ``jax.random.bits(keys[m], (n_pad,))``, drawn in the kernel.  Returns
    ``(q [..., wire_len], scale [...])``."""
    _check_bits(bits)
    if x.device.type == "cpu":
        return ref.quantize_tensor_ref(keys, x, bits=bits)
    if op_analysis.is_abstract(x):
        return _fake_quantize("K4", x, bits)
    lead, n, xf = _build.rows(x, "x", torch.float32)
    m, wire = xf.shape[0], wire_len(n, bits)
    kd = _key_words(keys, lead, x.device)
    scale = torch.empty((m,), dtype=torch.float32, device=x.device)
    q = torch.empty((m, wire), device=x.device, dtype=_q_dtype(bits))
    _build.launch("quantize_leaf", xf.data_ptr(), m, n, bits, kd.data_ptr(),
                  scale.data_ptr(), q.data_ptr(), wire,
                  scratch(m, x.device).data_ptr())
    quantize_tensor.launches += 1
    return op_analysis.kernel_op("K4", (xf,), (q.reshape(lead + (wire,)),
                                               scale.reshape(lead)))


quantize_tensor.launches = 0


# ---------------------------------------------------------------------------
# K4's shard form over a message tree (csrc/quantize.cuh "K4's shard form,
# grouped"): one launch a pass for all of the tree's leaves
# ---------------------------------------------------------------------------

Q_TILE = 8192  # elements of a row a tile (csrc: kQTile)
MAX_LEAVES = 128  # leaves a launch (csrc: kMaxLeaves)
# a table entry's words (csrc: ShardWord)
SHARD_WORDS = 64
SW = {name: i for i, name in enumerate((
    "n", "tiles", "first", "slot", "key", "q8", "q4", "cls", "base",
    "delta", "block", "block_m", "block_s", "inner", "inner_m", "inner_s",
    "gdim", "ldim", "pieces"))}
SW.update(ls=19, gs=19 + ref.MAX_PIECES, len=19 + 2 * ref.MAX_PIECES)
_W2 = 19 + 3 * ref.MAX_PIECES  # class 3's words: the outer cut dim's
SW.update({name: _W2 + i for i, name in enumerate((
    "mid", "mid_m", "mid_s", "ldim2", "ldim2_m", "ldim2_s", "gdim2",
    "pieces2"))})
SW.update(ls2=_W2 + 8, gs2=_W2 + 8 + ref.MAX_PIECES,
          len2=_W2 + 8 + 2 * ref.MAX_PIECES)
_PIECE_WORDS = ("ls", "gs", "len", "ls2", "gs2", "len2")
Q_ALIGN = 16  # bytes between a leaf's q and the next's, rounded up


def fast_divmod(d: int) -> tuple:
    """The constants of ``n // d`` for every 32-bit n by a multiply-high
    (csrc ``fast_div``; Granlund and Montgomery 1994, fig. 4.1): ``(m,
    s1 | s2 << 8)`` with l = ceil(log2 d), m = floor(2^32 (2^l - d) / d)
    + 1 (below 2^32), s1 = min(l, 1), s2 = max(l - 1, 0)."""
    if not 1 <= d < 2 ** 32:
        raise ValueError(f"a divisor of 1..2^32 - 1, got {d}")
    ln = (d - 1).bit_length()
    m = ((1 << 32) * ((1 << ln) - d)) // d + 1
    return m, min(ln, 1) | max(ln - 1, 0) << 8


def _covered(pieces, ldim):
    """Raise unless ``pieces`` cover a local dim of ``ldim`` in order."""
    at = 0
    for ls, _, ln, _ in pieces:
        if ls != at or ln < 1:
            raise ValueError(f"pieces {pieces} do not cover the local "
                             f"dim of {ldim} in order")
        at += ln
    if at != ldim:
        raise ValueError(f"pieces {pieces} cover {at} of {ldim}")


def _piece_words(pieces, suffix=""):
    return {k + suffix: [pc[c] for pc in pieces]
            for c, k in enumerate(("ls", "gs", "len"))}


def shard_entry(lay) -> dict:
    """A leaf's index class and constants for the quantise pass (the
    table's words from ``cls`` on): class 0 where the shard is one run of
    the whole leaf (a leaf held whole: the identity), 1 for one piece
    along the cut dim (a run an outer index), 2 for more, 3 for a shard
    cut on two dims (FSDP's "data" dim beside the "model" dim, either
    first): the inner cut dim's pieces as class 2's, the outer one's in
    the ``*2`` words, ``mid`` the elements between them.  Raises unless
    the whole leaf has fewer than 2^32 elements and the pieces (at most
    ``MAX_PIECES`` a dim) cover each local cut dim in order."""
    if lay.numel >= 2 ** 32:
        raise ValueError(f"a leaf of {lay.numel} elements: the kernel's "
                         "counters are 32-bit")
    e = dict.fromkeys(("delta", "gdim", "ldim", "pieces", "gdim2",
                       "pieces2"), 0)
    e.update(block=1, inner=1, mid=1, ldim2=1)
    if not lay.cut:
        return {**e, "cls": 0, "base": 0, "n": lay.numel}
    loc = lay.local_shape
    if lay.dim2 is not None:
        (lo, plo), (hi, phi) = sorted(((lay.dim, lay.pieces),
                                       (lay.dim2, lay.pieces2)))
        _covered(plo, loc[lo])
        _covered(phi, loc[hi])
        inner = math.prod(lay.shape[hi + 1:])
        e.update(cls=3, n=math.prod(loc), inner=inner, gdim=lay.shape[hi],
                 ldim=loc[hi], pieces=len(phi), block=loc[hi] * inner,
                 base=0, mid=math.prod(lay.shape[lo + 1:hi]),
                 ldim2=loc[lo], gdim2=lay.shape[lo], pieces2=len(plo),
                 **_piece_words(phi), **_piece_words(plo, "2"))
        return e
    inner, gdim, ldim, pieces = lay.words()[:4]
    d = lay.dim
    outer = math.prod(lay.shape[:d])
    _covered(lay.pieces, ldim)
    e.update(n=outer * ldim * inner, inner=inner, gdim=gdim, ldim=ldim,
             pieces=pieces, block=ldim * inner,
             base=lay.pieces[0][1] * inner, **_piece_words(lay.pieces))
    if pieces > 1:
        e["cls"] = 2
    elif outer == 1:
        e["cls"] = 0
    else:
        e.update(cls=1, delta=(gdim - ldim) * inner)
    return e


class ShardPlan:
    """What the grouped passes need of a tree's layouts and rows, built
    once per ``(layouts, rows, device)`` (``shard_plan``): the leaves in
    ``ref.tree_order``, each's word slots, tiles and q offsets, the
    device table of each launch (``MAX_LEAVES`` leaves a launch), the max
    pass's counters (zero) and partials, and a host array of x pointers a
    launch.  The counters are one set a plan: two passes of one plan do
    not run at once on two streams."""

    def __init__(self, layouts, m: int, device):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.m, self.device = m, device
        self.index = -1 if device.type == "cpu" else device.index
        self.order = ref.tree_order(layouts)
        self.slots = len(layouts) * m
        entries, self.n = [], [0] * len(layouts)
        off = {8: 0, 4: 0}
        # q's parts in the plan's order, a leaf's bytes then its padding
        self.q_parts = {8: [], 4: []}
        for p, i in enumerate(self.order):
            e = shard_entry(layouts[i])
            self.n[i] = e["n"]
            e.update(slot=p * m, key=i,
                     tiles=-(-e["n"] // Q_TILE))
            for bits in (8, 4):
                e[f"q{bits}"] = off[bits]
                nb = m * wire_len(e["n"], bits)
                padded = -(-nb // Q_ALIGN) * Q_ALIGN
                self.q_parts[bits] += [nb, padded - nb]
                off[bits] += padded
            for k in ("block", "inner", "mid", "ldim2"):
                e[f"{k}_m"], e[f"{k}_s"] = fast_divmod(e[k])
            entries.append((i, e))
        if max(off.values()) >= 2 ** 32:
            raise ValueError(f"a tree of {off[8]} q bytes: the offsets are "
                             "32-bit")
        self.qbytes = off
        self.entries = dict(entries)
        tiles = 0
        self.launches = []
        for c0 in range(0, len(entries), MAX_LEAVES):
            chunk = entries[c0:c0 + MAX_LEAVES]
            words, first = [], 0
            for _, e in chunk:
                e["first"] = first
                first += m * e["tiles"]
                words += _entry_words(e)
            if tiles + first >= 2 ** 32:
                raise ValueError("a tree of 2^32 tiles or more")
            table = torch.tensor([w - 2 ** 32 if w >= 2 ** 31 else w
                                  for w in words], dtype=torch.int32)
            self.launches.append(_Launch(
                [i for i, _ in chunk], table.to(device), first, tiles,
                (ctypes.c_void_p * len(chunk))(),
                any(e["cls"] == 3 for _, e in chunk)))
            tiles += first
        # an arrival counter a slot, then a partial a tile
        self.scratch = torch.zeros((self.slots + tiles,), dtype=torch.int32,
                                   device=device)

    def fill_x(self, xs):
        """Check ``xs`` ([M, n_i] rows, contiguous f32 on the plan's
        device) against the entries and write their pointers into each
        launch's host array."""
        for i, x in enumerate(xs):
            if (x.dtype != torch.float32 or x.get_device() != self.index
                    or not x.is_contiguous()
                    or x.shape[-1] != self.n[i] or x.numel() != self.m
                    * self.n[i]):
                raise ValueError(
                    f"leaf {i}: x {tuple(x.shape)} {x.dtype} on {x.device}"
                    f" (contiguous {x.is_contiguous()}), the plan's rows of "
                    f"{self.n[i]} f32 on {self.device}")
        for ln in self.launches:
            ln.xs[:] = [xs[i].data_ptr() for i in ln.leaves]


@dataclasses.dataclass
class _Launch:
    leaves: list  # the tree's leaf indices, in the table's order
    table: torch.Tensor
    tiles: int
    tile0: int  # its first tile among the plan's
    xs: object  # host array of the leaves' x pointers
    two_axis: bool  # a leaf of class 3 among its leaves


def _entry_words(e) -> list:
    w = [0] * SHARD_WORDS
    for k, i in SW.items():
        if k in _PIECE_WORDS:
            w[i:i + len(e.get(k, ()))] = e.get(k, ())
        else:
            w[i] = e[k]
    return w


@functools.lru_cache(maxsize=32)
def shard_plan(layouts: tuple, m: int, device) -> ShardPlan:
    """The cached ``ShardPlan`` of a tree's layouts (a tuple of
    ``ref.ShardLayout``) at ``m`` rows a leaf on a CUDA ``device``."""
    return ShardPlan(layouts, m, device)


def _fake_tree(xs, layouts, bits):
    """The fake route of the quantise pass: ``[(q, scale)]``."""
    lead = tuple(xs[0].shape[:-1])
    return [(torch.empty(lead + (wire_len(x.shape[-1], bits),),
                         dtype=_q_dtype(bits), device=x.device),
             torch.empty(lead, dtype=torch.float32, device=x.device))
            for x in xs]


def tree_absmax(xs, layouts):
    """The first pass of K4's shard form over a message tree: the rank's
    shards ``xs`` (``[..., n_i]`` f32, one lead shape, leaf i laid out as
    ``layouts[i]``), each message's max |x| as the uint32 bits of the f32,
    int32 ``[leaves * M]`` in ``ref.tree_order`` (the cut leaves' rows
    first: all-reduce the first ``cut_rows`` with MAX over the ranks
    before ``quantize_tree``).  One launch (one a ``MAX_LEAVES`` leaves),
    no memset."""
    x0 = xs[0]
    if x0.device.type == "cpu":
        return ref.tree_absmax_ref(xs, layouts)
    if op_analysis.is_abstract(x0):
        m = ref.tree_rows(xs)[1]
        return op_analysis.kernel_op("K4", tuple(xs), torch.empty(
            (len(xs) * m,), dtype=torch.int32, device=x0.device))
    # the rows of the first leaf; fill_x holds every leaf to them
    plan = shard_plan(tuple(layouts), x0.numel() // x0.shape[-1], x0.device)
    plan.fill_x(xs)
    words = torch.empty((plan.slots,), dtype=torch.int32, device=x0.device)
    base = plan.scratch.data_ptr()
    for ln in plan.launches:
        _build.launch("shard_tree_absmax", ln.table.data_ptr(),
                      len(ln.leaves), ln.tiles, ln.xs, words.data_ptr(),
                      base, base + 4 * (plan.slots + ln.tile0))
        tree_absmax.launches += 1
    return op_analysis.kernel_op("K4", tuple(xs), words)


tree_absmax.launches = 0


def cut_rows(layouts, m: int) -> int:
    """The words of ``tree_absmax`` that the all-reduce covers: the cut
    leaves' rows."""
    return sum(lay.cut for lay in layouts) * m


def quantize_tree(keys, xs, words, layouts, *, bits=8, reduced=None):
    """K4's shard form over a message tree: each rank's shard ``xs[i]``
    (``[..., n_i]`` f32) quantised as its part of the whole leaf's
    message, at the scales ``max(word, tiny)`` of ``words``
    (``tree_absmax``'s, ``reduced`` standing for its first
    ``reduced.numel()``: the cut leaves' rows all-reduced with MAX; a
    leaf held whole keeps its own), kappa the whole leaf's
    ``jax.random.bits(keys[..., i, :], (n_pad,))`` at each element's flat
    index in the whole leaf (``keys [..., L, 2]``, converted once by
    ``_key_words``).  One launch (one a ``MAX_LEAVES`` leaves).  Returns
    ``[(q [..., wire_len(n_i)], scale [...])]`` in the leaves' order:
    views of one q and one scale buffer."""
    _check_bits(bits)
    x0 = xs[0]
    if x0.device.type == "cpu":
        return ref.quantize_tree_ref(keys, xs, words, layouts, bits=bits,
                                     reduced=reduced)
    if op_analysis.is_abstract(x0):
        return op_analysis.kernel_op("K4", tuple(xs),
                                     _fake_tree(xs, layouts, bits))
    dev, lead = x0.device, tuple(x0.shape[:-1])
    plan = shard_plan(tuple(layouts), x0.numel() // x0.shape[-1], dev)
    plan.fill_x(xs)
    kd = _key_words(keys, lead + (len(xs),), dev)
    _build.check_tensor("words", words, torch.int32, dev, (plan.slots,))
    cut = 0
    if reduced is not None:
        cut = reduced.numel()
        _build.check_tensor("reduced", reduced, torch.int32, dev, (cut,))
    scale = torch.empty((plan.slots,), dtype=torch.float32, device=dev)
    q = torch.empty((plan.qbytes[bits],), dtype=_q_dtype(bits), device=dev)
    for ln in plan.launches:
        _build.launch("shard_tree_quantize", ln.table.data_ptr(),
                      len(ln.leaves), ln.tiles, ln.xs, bits, kd.data_ptr(),
                      len(xs), None if reduced is None else
                      reduced.data_ptr(), cut, words.data_ptr(),
                      scale.data_ptr(), q.data_ptr())
        quantize_tree.launches += 1
        quantize_tree.launches_two_axis += ln.two_axis
    parts = q.split(plan.q_parts[bits])
    scales = scale.split(plan.m)
    out = [None] * len(xs)
    for p, i in enumerate(plan.order):
        sc = scales[p] if len(lead) == 1 else scales[p].view(lead)
        out[i] = (parts[2 * p].view(lead + (wire_len(plan.n[i], bits),)), sc)
    return op_analysis.kernel_op("K4", tuple(xs), out)


quantize_tree.launches = 0
quantize_tree.launches_two_axis = 0  # those of them with a class-3 leaf


def _key_words(keys, lead, device):
    """``[..., 2]`` keys -> contiguous int32 ``[M, 2]`` uint32 bit patterns
    on ``device``, converted where the keys lie.  Host keys bound for a
    CUDA device go through pinned memory in a non-blocking copy, so the
    host does not wait for the stream (a copy from pageable memory
    would)."""
    if tuple(keys.shape) != lead + (2,):
        raise ValueError(f"keys of shape {tuple(keys.shape)} do not match "
                         f"the messages' shape {lead}")
    words = (keys.reshape(-1, 2) & prng.MASK).to(torch.int32).contiguous()
    if words.device.type == "cpu" and torch.device(device).type == "cuda":
        words = words.pin_memory()
    return words.to(device, non_blocking=True)


def row_groups(m: int, n: int, most: int = DQ_MOST_ELEMENTS):
    """Slices of consecutive rows of an ``[m, n]`` call, each fewer than
    ``most`` elements: one slice unless m * n reaches it."""
    if n >= most:
        raise ValueError(f"a row of {n} elements is past the dequantise "
                         f"kernel's {most}")
    per = (most - 1) // n
    return [slice(r0, min(m, r0 + per)) for r0 in range(0, max(m, 1), per)]


def _dequantize(q, scale, n, bits, plane):
    """The dequantise kernel over q's rows (``plane``: the division form
    of ``dequantize_plane``): one launch per row group (``row_groups``).
    Returns ``(out, launches)``."""
    lead, wire, qf = _build.rows(q, "q",
                                 torch.int8 if bits == 8 else torch.uint8)
    if wire != wire_len(n, bits):
        raise ValueError(f"q holds {wire} bytes per message, not "
                         f"{wire_len(n, bits)} for n={n}, bits={bits}")
    m = qf.shape[0]
    sc = scale.reshape(-1)
    _build.check_tensor("scale", sc, torch.float32, q.device, (m,))
    out = torch.empty((m, n), dtype=torch.float32, device=q.device)
    groups = row_groups(m, n)
    for g in groups:
        _build.launch("dequantize_leaf", qf[g].data_ptr(),
                      g.stop - g.start, n, bits, sc[g].data_ptr(),
                      out[g].data_ptr(), wire, plane)
    return out.reshape(lead + (n,)), len(groups)


def dequantize_tensor(q, scale, *, n, bits=8):
    """Inverse of ``quantize_tensor`` in one launch: ``(scale * q) *
    f32(1 / levels)`` per message, as the reference's compiled
    ``dequantize_tensor`` computes it (``quantize/ops.py:104``).
    ``q [..., wire_len]``, ``scale [...]``; returns ``[..., n]`` f32."""
    _check_bits(bits)
    if q.device.type == "cpu":
        return ref.dequantize_tensor_ref(q, scale, n=n, bits=bits)
    if op_analysis.is_abstract(q):
        return _fake_dequantize(q, scale, n)
    out, launches = _dequantize(q, scale, n, bits, 0)
    dequantize_tensor.launches += launches
    return op_analysis.kernel_op("K5", (q, scale), out)


dequantize_tensor.launches = 0


def dequantize_plane(q, scale, *, n, bits=8):
    """Elementwise inverse of ``quantize_plane``: ``(scale * q) / levels``
    as the reference's jnp expression (``quantize/ops.py:71``) computes
    it, subnormal results flushed as XLA flushes them.  On the card one
    launch of K5's kernel in its division form (``csrc/quantize_leaf.cu``),
    where the flush in PyTorch would take four passes over the plane."""
    _check_bits(bits)
    if q.device.type == "cpu":
        return ref.dequantize_plane_ref(q, scale, n=n, bits=bits)
    if op_analysis.is_abstract(q):
        return _fake_dequantize(q, scale, n)
    out, launches = _dequantize(q, scale, n, bits, 1)
    dequantize_plane.launches += launches
    return op_analysis.kernel_op("K5", (q, scale), out)


dequantize_plane.launches = 0
