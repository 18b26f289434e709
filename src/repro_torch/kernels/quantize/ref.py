"""Plain PyTorch versions of the fused plane quantizer (K1), of the
per-message quantize/dequantize kernels (K4, K5) and of K4's shard form
(``ShardLayout``, ``row_absmax_ref``, ``quantize_shard_ref``, grouped over
a message tree by ``tree_absmax_ref`` / ``quantize_tree_ref``), and the
quantizer arithmetic shared with the per-message torch route of
``core/compression.py``.

The reference's f32 arithmetic runs under XLA, whose CPU backend (and the
TPU) keeps no f32 subnormal: a subnormal operand counts as a zero of its
sign and a subnormal result becomes one.  Eager PyTorch keeps them, so the
quantiser's and dequantiser's steps go through ``ftz`` wherever a
subnormal can arise."""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import jaxrand
from repro_torch.kernels import prng

TINY = torch.finfo(torch.float32).tiny
BLOCK = 1024  # the reference kernels' tile: the per-message wrappers pad to it


def plane_ids(ids, lead, fill, device):
    """Per-message ids as an int64 ``[M]`` vector of uint32 values
    (``None`` -> ``fill`` for every message)."""
    m = 1
    for d in lead:
        m *= d
    if ids is None:
        return torch.full((max(m, 1),), fill, dtype=torch.int64, device=device)
    return prng.u32(torch.as_tensor(ids, device=device)
                    .broadcast_to(lead).reshape(-1))


def ftz(t):
    """f32 subnormals to zeros of the same sign (NaN and inf kept)."""
    return torch.where(t.abs() < TINY, t * 0.0, t)


def round_ftz(v):
    """f64 ``v``, the result of one f32 multiply or divide taken in f64
    (exact for a product; for a quotient, rounding twice to 53 then 24
    bits gives the correctly rounded f32), rounded to f32 as XLA's
    flushing arithmetic rounds it: to nearest with an unbounded exponent,
    then to a zero of its sign if below tiny.  IEEE rounding differs just
    below tiny: it gives tiny for |v| in [tiny - 2^-150, tiny - 2^-151),
    which XLA rounds to tiny - 2^-150 and flushes."""
    a = v.abs()
    r = v.to(torch.float32)
    small = torch.where(a >= TINY - 2.0 ** -151,
                        torch.copysign(torch.full_like(r, TINY), r), r * 0.0)
    return torch.where(a < TINY, small, r)


def row_scale(xf):
    """Per-row inf-norm scale, floored at the f32 tiny (``[M]``)."""
    return torch.amax(xf.abs(), dim=-1).clamp_min(TINY)


def quantize_values(x, scale, kappa, levels: int):
    """``sign(x) * floor(levels * |x| / scale + kappa)`` in f32, in the
    reference's operation order, subnormals flushed as XLA does: x (so
    that sign(x) of a subnormal is a zero) and the quotient.  The other
    steps cannot give one: ``levels * |x|`` of a normal x is normal, kappa
    is 0 or at least 2^-32, and the last product is a whole number."""
    x = ftz(x)
    q = torch.floor(ftz(levels * x.abs() / ftz(scale)) + kappa)
    return torch.sign(x) * q


def dequantize_values(q, scale, levels: int):
    """``(scale * q) / levels`` over ``q [..., n]``, ``scale [...]``, as
    the reference's jnp dequantisers write it, subnormals flushed as XLA
    does (at scale = tiny, q = -1 gives -0.0)."""
    p = ftz(scale)[..., None] * q.to(torch.float32)  # never below tiny
    return round_ftz(p.double() / levels)


def _windows(n: int, window):
    """Column windows ``(j0, j1)`` over n elements: one, or ``window``
    (even, so a nibble pair never straddles two) at a time."""
    w = n if window is None else window
    if w < n and w % 2:
        raise ValueError(f"window {w} must be even")
    return [(j0, min(n, j0 + w)) for j0 in range(0, max(n, 1), w)]


def quantize_ref(x_flat, rnd_bits, scale, *, bits=8):
    """The reference's leaf oracle (``quantize/ref.py:43``) under its
    signature: ``x_flat [n]``, its uint32 stream ``rnd_bits [n]`` (kappa =
    bits * 2^-32) and the scale -> int8 levels, or at b=4 offset-8
    nibbles two a byte (n even).  The arithmetic of
    ``quantize_tensor_ref``, which draws the bits from a key instead."""
    levels = 2 ** (bits - 1) - 1
    q = quantize_values(torch.as_tensor(x_flat).to(torch.float32),
                        torch.as_tensor(scale, dtype=torch.float32),
                        prng.uniform01(prng.u32(rnd_bits)), levels)
    return to_int8(q) if bits == 8 else pack4(q)


def dequantize_ref(q, scale, *, bits=8, n=None, out_dtype=torch.float32):
    """The reference's leaf dequantiser (``quantize/ref.py:55``) under its
    signature: ``scale * q / levels`` (nibbles unpacked at b=4, cut to n
    when given), cast to ``out_dtype``.  Eager jax divides, where the
    compiled kernel (and ``dequantize_tensor_ref``) multiplies by the
    reciprocal."""
    levels = 2 ** (bits - 1) - 1
    q = torch.as_tensor(q)
    if bits == 8:
        qf = q.to(torch.float32)
    else:
        qf = unpack4(q, 2 * q.shape[-1] if n is None else n)
    scale = torch.as_tensor(scale, dtype=torch.float32)
    return dequantize_values(qf, scale, levels).to(out_dtype)


def dequantize_plane_ref(q, scale, *, n, bits=8, window=None):
    """The plane route's dequantiser (the reference's jnp
    ``dequantize_plane``, ``quantize/ops.py:71``): ``q [..., wire]``,
    ``scale [...]``; returns ``[..., n]`` f32.  ``window`` computes the
    same values that many columns at a time (bounds the f64
    temporaries of a large plane)."""
    levels = 2 ** (bits - 1) - 1
    if window is None:
        qf = q if bits == 8 else unpack4(q, n)
        return dequantize_values(qf, scale, levels)
    out = torch.empty(q.shape[:-1] + (n,), dtype=torch.float32,
                      device=q.device)
    for j0, j1 in _windows(n, window):
        qw = (q[..., j0:j1] if bits == 8
              else unpack4(q[..., j0 // 2:-(-j1 // 2)], j1 - j0))
        out[..., j0:j1] = dequantize_values(qw, scale, levels)
    return out


def to_int8(q):
    """f32 -> int8 as XLA converts: saturating, NaN to 0.  A plain cast
    would turn 128.0 (127 + a kappa that rounds to 1.0) into -128."""
    q = torch.where(torch.isnan(q), 0.0, q)
    return q.clamp(-128.0, 127.0).to(torch.int8)


def pack4(q):
    """f32 levels in [-8, 8] -> offset-8 nibbles, two per byte (even
    element in the high nibble; an odd tail pads with nibble 8).  Packed
    in int32 and truncated to uint8, as the reference does."""
    qi = torch.where(torch.isnan(q), 0.0, q).to(torch.int32) + 8
    if qi.shape[-1] % 2:
        qi = torch.cat([qi, torch.full_like(qi[..., :1], 8)], dim=-1)
    return (((qi[..., 0::2] << 4) | qi[..., 1::2]) & 0xFF).to(torch.uint8)


def unpack4(packed, n: int):
    """Inverse of ``pack4``: ``[..., ceil(n/2)]`` uint8 -> ``[..., n]``
    int32 levels."""
    p = packed.to(torch.int32)
    q = torch.stack([(p >> 4) & 0xF, p & 0xF], dim=-1)
    return q.reshape(packed.shape[:-1] + (-1,))[..., :n] - 8


EDGE_ROWS = ("subnormal only", "normal with subnormal elements",
             "max below 127 tiny", "all +-0", "a NaN", "+inf", "-inf",
             "max at the last element")


def edge_rows(x):
    """Overwrite the first ``len(EDGE_ROWS)`` rows of ``x [M, n]`` (f32,
    fewer if M is smaller) with the quantiser's edge cases, made from each
    row's own values (scaled in f64): a row of subnormals only, a normal
    row with every fifth element subnormal, a row whose max is 50 tiny
    (below 127 tiny, so levels * |x| / scale and the dequantised levels
    reach the subnormal range), a row of +0.0 and -0.0, rows holding a
    NaN, a +inf and a -inf, and a row whose max |x| is its last element.
    Returns ``x``."""
    n = x.shape[-1]
    xd = x.double()
    peak = xd.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    at = [torch.tensor([j], device=x.device)
          for j in (n // 2, n // 3, (2 * n) // 3, n - 1)]
    rows = (
        lambda: xd[0] * (1e-40 / peak[0]),
        lambda: torch.where(torch.arange(n, device=x.device) % 5 == 0,
                            xd[1] * (1e-41 / peak[1]), xd[1]),
        lambda: xd[2] * (50 * TINY / peak[2]),
        lambda: torch.where(xd[3] < 0, -0.0, 0.0).to(torch.float64),
        lambda: xd[4].index_fill(0, at[0], float("nan")),
        lambda: xd[5].index_fill(0, at[1], float("inf")),
        lambda: xd[6].index_fill(0, at[2], float("-inf")),
        lambda: xd[7].index_fill(0, at[3], -2.0 * float(peak[7])),
    )
    for r, row in enumerate(rows[:x.shape[0]]):
        x[r] = row().to(torch.float32)
    return x


def quantize_plane_ref(seed, sids, rids, x, *, bits=8, window=None):
    """K1's plain version: the counter-PRNG kappas materialised as a
    ``[M, n]`` tensor (``window``: that many columns at a time, which
    bounds the int64 Threefry temporaries of a large plane; element j's
    kappa depends only on the ids and j).  Returns ``(q [..., wire_len],
    scale [...])``."""
    lead, n = tuple(x.shape[:-1]), x.shape[-1]
    xf = x.reshape(-1, n).to(torch.float32)
    s = plane_ids(sids, lead, 0, x.device)
    r = plane_ids(rids, lead, prng.BROADCAST, x.device)
    scale = row_scale(xf)
    es = prng.fold(seed, s, r)
    levels = 2 ** (bits - 1) - 1
    parts = []
    for j0, j1 in _windows(n, window):
        ctr = torch.arange(j0, j1, dtype=torch.int64, device=x.device)
        kappa = prng.uniform01(
            prng.random_bits((es[0][:, None], es[1][:, None]), ctr[None, :])
        )
        q = quantize_values(xf[:, j0:j1], scale[:, None], kappa, levels)
        parts.append(to_int8(q) if bits == 8 else pack4(q))
    q = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
    return q.reshape(lead + (q.shape[-1],)), scale.reshape(lead)


def _pad_last(t, size: int, fill):
    pad = size - t.shape[-1]
    if not pad:
        return t
    return torch.cat([t, torch.full(t.shape[:-1] + (pad,), fill,
                                    dtype=t.dtype, device=t.device)], dim=-1)


def quantize_tensor_ref(keys, x, *, bits=8):
    """K4's plain version with its wrapper, as the reference runs them per
    message (``quantize/ops.py:86``): rows padded with zeros to a multiple
    of BLOCK, kappa from the materialised ``jax.random.bits(key, (n_pad,))``
    stream, the output sliced to the wire length.  ``keys [..., 2]``,
    ``x [..., n]``; returns ``(q [..., wire], scale [...])``."""
    lead, n = tuple(x.shape[:-1]), x.shape[-1]
    xf = x.reshape(-1, n).to(torch.float32)
    scale = row_scale(xf)
    n_pad = -(-n // BLOCK) * BLOCK
    rnd = jaxrand.bits(keys.to(x.device).reshape(-1, 2), (n_pad,))
    levels = 2 ** (bits - 1) - 1
    q = quantize_values(_pad_last(xf, n_pad, 0.0), scale[:, None],
                        prng.uniform01(rnd), levels)
    q = to_int8(q) if bits == 8 else pack4(q)
    wire = n if bits == 8 else -(-n // 2)
    return q[:, :wire].reshape(lead + (wire,)), scale.reshape(lead)


def dequantize_tensor_ref(q, scale, *, n, bits=8):
    """K5's plain version with its wrapper (``quantize/ops.py:104``): the
    wire bytes padded back to BLOCK (zeros at b=8, ``0x88`` nibble pairs at
    b=4), ``(scale * q) * f32(1 / levels)``, sliced to n.  The reference
    writes ``scale * q / levels``; XLA compiles the division by a constant
    into that multiply by its f32 reciprocal, so its kernel's bits are
    these.  ``q [..., wire]``, ``scale [...]``; returns ``[..., n]``
    f32."""
    lead, wire = tuple(q.shape[:-1]), q.shape[-1]
    qf = q.reshape(-1, wire)
    if bits == 8:
        qf = _pad_last(qf, -(-wire // BLOCK) * BLOCK, 0).to(torch.float32)
    else:
        half = BLOCK // 2
        qp = _pad_last(qf, -(-wire // half) * half, 0x88)
        qf = unpack4(qp, 2 * qp.shape[-1]).to(torch.float32)
    inv = torch.tensor(1.0, dtype=torch.float32) / (2 ** (bits - 1) - 1)
    p = ftz(scale.reshape(-1, 1).to(torch.float32)) * qf  # never below tiny
    out = round_ftz(p.double() * inv.to(q.device, torch.float64))
    return out[:, :n].reshape(lead + (n,))


# ---------------------------------------------------------------------------
# K4's shard form: a rank's shard of a leaf quantised as part of the whole
# ---------------------------------------------------------------------------

MAX_PIECES = 4  # the shard form's pieces along the cut dim (csrc: kMaxPieces)


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """Where a rank's shard of one leaf lies in the whole leaf: ``shape``
    the whole leaf's, ``dim`` a cut dim (None: the rank holds the whole
    leaf), ``pieces`` the shard's parts along ``dim`` in order, ``(local
    start, global start, length, cut)`` each (``cut``: the rank's part of
    a piece the axis splits; otherwise a piece every rank holds whole).
    ``dim2`` and ``pieces2``: a second cut dim and its pieces, for a leaf
    cut over two axes (FSDP's "data" dim, one piece, beside the "model"
    dim's pieces, either first).  ``axes``: the mesh axis that cuts
    ``dim`` (and the one that cuts ``dim2``), none for a whole leaf.
    ``launch.sharding.shard_layouts`` builds them from the ``tp_plan``."""

    shape: tuple
    dim: int | None = None
    pieces: tuple = ()
    dim2: int | None = None
    pieces2: tuple = ()
    axes: tuple = ()

    def cut_over(self, axis: str) -> bool:
        """Whether ``axis`` cuts one of the shard's dims."""
        return axis in self.axes

    def __post_init__(self):
        if len(self.axes) != len(self._cuts()):
            raise ValueError(f"cut dims {self.dim}, {self.dim2} over axes "
                             f"{self.axes}")
        for d, ps in ((self.dim, self.pieces), (self.dim2, self.pieces2)):
            if d is not None and not 1 <= len(ps) <= MAX_PIECES:
                raise ValueError(f"a shard of 1..{MAX_PIECES} pieces, got "
                                 f"{len(ps)}")
        if self.dim2 is not None and (self.dim is None
                                      or self.dim2 == self.dim):
            raise ValueError(f"a second cut dim {self.dim2} beside "
                             f"{self.dim}")

    def _cuts(self) -> tuple:
        """``((dim, pieces), ...)`` of the cut dims."""
        return tuple((d, ps) for d, ps in ((self.dim, self.pieces),
                                           (self.dim2, self.pieces2))
                     if d is not None)

    @property
    def cut(self) -> bool:
        """Whether the rank holds a part of the leaf only."""
        return any(p[3] for _, ps in self._cuts() for p in ps)

    @property
    def local_shape(self) -> tuple:
        s = list(self.shape)
        for d, ps in self._cuts():
            s[d] = sum(p[2] for p in ps)
        return tuple(s)

    @property
    def numel(self) -> int:
        return math.prod(self.shape)

    def _along(self, d, pieces, device):
        """The local index along ``d`` -> (its global index, held whole)
        as int64 / bool vectors."""
        g = torch.empty(self.local_shape[d], dtype=torch.int64,
                        device=device)
        whole = torch.empty_like(g, dtype=torch.bool)
        for ls, gs, n, cut in pieces:
            g[ls:ls + n] = torch.arange(gs, gs + n, device=device)
            whole[ls:ls + n] = not cut
        return g, whole

    def _expand(self, d, along):
        view = [1] * len(self.shape)
        view[d] = -1
        return along.reshape(view).expand(self.local_shape).reshape(-1)

    def counters(self, device) -> torch.Tensor:
        """The whole leaf's flat index of each of the shard's elements
        (int64 ``[n_local]``, in the shard's flat order)."""
        if self.dim is None:
            return torch.arange(self.numel, dtype=torch.int64, device=device)
        cuts = dict(self._cuts())
        idx = torch.zeros((), dtype=torch.int64, device=device)
        stride = 1
        for d in reversed(range(len(self.shape))):
            g = (self._along(d, cuts[d], device)[0] if d in cuts else
                 torch.arange(self.shape[d], dtype=torch.int64,
                              device=device))
            view = [1] * len(self.shape)
            view[d] = -1
            idx = idx + g.reshape(view) * stride
            stride *= self.shape[d]
        return idx.expand(self.local_shape).reshape(-1)

    def whole_mask(self, device) -> torch.Tensor:
        """Which of the shard's elements lie in a piece held whole on
        ``dim`` (bool ``[n_local]``): all of them for a leaf held whole."""
        if self.dim is None:
            return torch.ones(self.numel, dtype=torch.bool, device=device)
        return self._expand(self.dim, self._along(self.dim, self.pieces,
                                                  device)[1])

    def words(self) -> tuple:
        """The cut's description: inner, the whole and the local length of
        ``dim``, the piece count, then ``(local start, global start,
        length)`` for ``MAX_PIECES`` pieces (zeros past the last); the
        kernel's table entry is built from it (``ops.shard_entry``).  A
        second cut dim adds the same of ``dim2``, and then ``mid``: the
        elements between the two cut dims."""
        out = []
        for d, ps in self._cuts():
            out += [math.prod(self.shape[d + 1:]), self.shape[d],
                    self.local_shape[d], len(ps)]
            for i in range(MAX_PIECES):
                out += list(ps[i][:3]) if i < len(ps) else [0, 0, 0]
        if self.dim2 is not None:
            lo, hi = sorted((self.dim, self.dim2))
            out.append(math.prod(self.shape[lo + 1:hi]))
        return tuple(out)


def row_absmax_ref(x):
    """The shard form's max pass: each message's max |x| of ``x [..., n]``
    as the uint32 bits of the f32 (int32 ``[...]``; a NaN's bits exceed
    +inf's, so a max over the bits propagates it as amax does)."""
    bits_ = x.to(torch.float32).contiguous().view(torch.int32) & 0x7FFFFFFF
    return bits_.amax(dim=-1)


def scale_of(words):
    """The scale ``max(max |x|, tiny)`` from a row max's bits (int32)."""
    return words.clamp_min(0x00800000).view(torch.float32)


def quantize_shard_ref(keys, x, words, layout: ShardLayout, *, bits=8,
                       window=None):
    """K4's shard form, plain: the rank's elements ``x [..., n_local]`` of
    a leaf laid out as ``layout`` quantised as the whole leaf's message
    is (``quantize_tensor_ref``): at the scale ``scale_of(words)`` (the
    all-reduced row max's bits, ``[...]``) and with kappa from the
    ``jax.random.bits(key, (n_pad,))`` stream at each element's flat
    index in the whole leaf.  The levels are packed in the shard's own
    order (b=4: local pairs, an odd tail padded with nibble 8).
    ``window``: that many columns at a time.  Returns ``(q [...,
    wire_len(n_local)], scale [...])``."""
    lead, n = tuple(x.shape[:-1]), x.shape[-1]
    xf = x.reshape(-1, n).to(torch.float32)
    scale = scale_of(words.reshape(-1).to(torch.int32))
    ctr = layout.counters(x.device)
    if ctr.numel() != n:
        raise ValueError(f"a shard of {ctr.numel()} elements, rows of {n}")
    kd = keys.to(x.device).reshape(-1, 2)
    levels = 2 ** (bits - 1) - 1
    parts = []
    for j0, j1 in _windows(n, window):
        kappa = prng.uniform01(jaxrand.bits_at(kd, ctr[j0:j1]))
        q = quantize_values(xf[:, j0:j1], scale[:, None], kappa, levels)
        parts.append(to_int8(q) if bits == 8 else pack4(q))
    q = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
    return q.reshape(lead + (q.shape[-1],)), scale.reshape(lead)


# ---------------------------------------------------------------------------
# K4's shard form over a message tree: one pass each for all of its leaves
# ---------------------------------------------------------------------------


def tree_order(layouts) -> tuple:
    """The order of a tree's leaves in the grouped passes' words: the cut
    leaves first (flatten order), then the leaves held whole, so that the
    all-reduce covers one prefix."""
    return (tuple(i for i, lay in enumerate(layouts) if lay.cut)
            + tuple(i for i, lay in enumerate(layouts) if not lay.cut))


def tree_rows(xs) -> tuple:
    """``(lead shape, rows)`` of a tree's shards ``xs`` (one lead shape,
    ``[..., n_i]`` each)."""
    lead = tuple(xs[0].shape[:-1])
    if any(tuple(x.shape[:-1]) != lead for x in xs):
        raise ValueError(f"the leaves' lead shapes differ: "
                         f"{[tuple(x.shape[:-1]) for x in xs]}")
    return lead, math.prod(lead)


def tree_absmax_ref(xs, layouts):
    """The grouped max pass, plain: ``row_absmax_ref`` of each leaf's rows,
    in ``tree_order`` (int32 ``[leaves * M]``)."""
    return torch.cat([row_absmax_ref(xs[i]).reshape(-1)
                      for i in tree_order(layouts)])


def quantize_tree_ref(keys, xs, words, layouts, *, bits=8, reduced=None,
                      window=None):
    """The grouped quantise pass, plain: ``quantize_shard_ref`` of each
    leaf, a leaf held whole under the identity layout, at the words of
    its rows in ``tree_order`` (``reduced``, where given, replaces the
    first ``reduced.numel()``: the all-reduced cut leaves').  ``keys
    [..., L, 2]``: leaf i's ``keys[..., i, :]``.  Returns ``[(q [...,
    wire_len(n_i)], scale [...])]`` in the leaves' order."""
    lead, m = tree_rows(xs)
    w = words.reshape(-1).to(torch.int32)
    if reduced is not None:
        r = reduced.reshape(-1).to(w)
        w = torch.cat([r, w[r.numel():]])
    out = [None] * len(xs)
    for p, i in enumerate(tree_order(layouts)):
        lay = layouts[i] if layouts[i].cut else ShardLayout(
            tuple(layouts[i].shape))
        out[i] = quantize_shard_ref(keys[..., i, :], xs[i],
                                    w[p * m:(p + 1) * m].reshape(lead), lay,
                                    bits=bits, window=window)
    return out
