"""Tensor parallelism over the "model" axis of the ambient mesh
(``launch.mesh.use_mesh``): the collectives that a tensor-parallel
forward and its backward need, and the rank's part of a sharded dim.

The reference gets tensor parallelism from GSPMD, which partitions every
product under the parameters' shardings (``launch/sharding.py``
``param_rules``) and differentiates the partitioned program.  The port
runs it by hand: ``sharding.shard_params`` leaves each rank its shard of
the parameters, the layers read from a weight's shape whether it is
sharded (a dim smaller than the config's), and they meet here.  Each
collective is a ``torch.autograd.Function`` whose backward is the one
that the place it stands in asks for, classified by whether its
consumer is replicated over the axis or each rank's own:

* ``enter``: the entry of a tensor-parallel region, before every
  column-parallel product that reads a replicated activation: identity
  forward, the sum of the ranks' partial gradients backward;
* ``all_reduce``: the row-parallel sum whose result is replicated (the
  residual stream, a loss term): sum forward, identity backward;
* ``all_reduce_local``: a sum that feeds each rank's own channels (the
  Mamba gated norm's sum of squares): sum forward, sum backward;
* ``all_reduce_exact``: the vocab-parallel embedding's sum, where one
  rank holds each row: sum forward, identity backward;
* ``all_gather``: the vocab-sharded logits gathered; backward takes the
  rank's columns;
* ``sum_grad``: a leaf held whole on every rank but used in part by each
  (a qk-norm scale on the rank's heads, the KV projection where the axis
  divides the query heads only, a Mamba mixer's B|C columns): identity
  forward, its gradient (or the listed pieces of it) summed backward;
* ``all_reduce_max``: a max over the axis, outside autograd (the
  vocab-parallel cross entropy's shift, a quantiser's scale).

A backward collective takes the process group its forward saw, so it
runs without the ambient mesh (the autograd engine may run it on another
thread).  Nothing here runs without an ambient mesh whose "model" axis
has more than one rank: the layers call these functions only for
sharded weights.  Outside autograd (serving, ``torch.no_grad``) each
function is its plain collective.

A row-parallel product of 16-bit operands returns its partial in f32
(``partial_mm``, through ``torch.mm(..., out_dtype=torch.float32)`` on
the card), the partials are summed in f32 and the sum is rounded to the
activations' dtype once, as the one-rank product rounds its f32
accumulation once.

``stats`` counts the collectives this process issued and the bytes it
handed to them, backward ones included; under remat
(``torch.utils.checkpoint``) a block's forward collectives run again in
its backward and count twice.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import axes_of, current_mesh

AXIS = "model"
_NARROW = (torch.bfloat16, torch.float16)

stats = {"all_reduce": 0, "all_gather": 0, "bytes": 0}


def reset_stats():
    for k in stats:
        stats[k] = 0


def mesh():
    """The ambient mesh when its "model" axis has more than one rank,
    else None."""
    m = current_mesh()
    if m is None:
        return None
    ax = axes_of(m)
    if AXIS not in ax.axis_names or ax.shape[AXIS] == 1:
        return None
    return m


def size() -> int:
    m = mesh()
    return 1 if m is None else axes_of(m).shape[AXIS]


def rank() -> int:
    m = mesh()
    return 0 if m is None else m.get_local_rank(AXIS)


def _group():
    m = mesh()
    if m is None:
        raise RuntimeError("a sharded weight needs an ambient mesh with a "
                           f"{AXIS!r} axis (launch.mesh.use_mesh)")
    return m.get_group(AXIS)


def local_count(n: int, axis_size: int | None = None) -> int:
    """A rank's length of a dim of ``n`` that the axis (of
    ``axis_size``, default the ambient one's) shards: ``n / size`` where
    the size divides it (``sharding.sanitize_spec``'s rule), else
    ``n``."""
    s = size() if axis_size is None else axis_size
    return n // s if n % s == 0 else n


def part(n: int) -> tuple:
    """The rank's ``[start, stop)`` of a dim of ``n`` that the axis
    shards contiguously (the whole dim where the size does not divide
    it)."""
    k = local_count(n)
    if k == n:
        return 0, n
    r = rank()
    return r * k, (r + 1) * k


def sharded(local: int, full: int) -> bool:
    """Whether a weight dim of ``local`` elements is the rank's part of
    one of ``full``."""
    if local == full:
        return False
    if local * size() != full:
        raise ValueError(f"a dim of {local} is no rank's part of {full} "
                         f"over a {AXIS!r} axis of {size()}")
    return True


def partial_mm(a, w):
    """``a [..., K] @ w [K, N]``, the rank's partial of a row-parallel
    product: in f32 for 16-bit operands on the card (or a trace of its
    route), else in ``a``'s dtype."""
    a2 = a.reshape(-1, a.shape[-1])
    if a.dtype in _NARROW and a.device.type != "cpu":
        out = (_WideMM.apply(a2, w) if _grad_on(a2, w)
               else torch.mm(a2, w, out_dtype=torch.float32))
    else:
        out = a2 @ w
    return out.reshape(*a.shape[:-1], w.shape[-1])


class _WideMM(torch.autograd.Function):
    """``torch.mm(a, w, out_dtype=torch.float32)`` (16-bit operands, f32
    result), which has no derivative of its own: the gradients are the
    products of the gradient rounded to the operands' dtype, as a 16-bit
    product's are."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        return torch.mm(a, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g = g.to(a.dtype)
        return g @ w.t(), a.t() @ g


def _grad_on(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _sum(t, group, dtype=None):
    """The sum of ``t`` over ``group`` in ``dtype`` (default ``t``'s): a
    16-bit ``t`` in f32, any other in place (callers hand over a
    temporary)."""
    dtype = t.dtype if dtype is None else dtype
    wide = t.float() if t.dtype in _NARROW else t
    stats["all_reduce"] += 1
    stats["bytes"] += wide.numel() * wide.element_size()
    dist.all_reduce(wide, group=group)
    return wide.to(dtype)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _sum(g.contiguous().clone(), ctx.group), None


class _Reduce(torch.autograd.Function):
    """Sum forward; backward the identity (``local=False``) or the sum
    (``local=True``)."""

    @staticmethod
    def forward(ctx, t, group, dtype, local):
        ctx.group, ctx.dtype, ctx.local = group, t.dtype, local
        return _sum(t.contiguous().clone(), group, dtype)

    @staticmethod
    def backward(ctx, g):
        if ctx.local:
            g = _sum(g.contiguous().clone(), ctx.group)
        return g.to(ctx.dtype), None, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, n, r, dim):
        ctx.dim, ctx.r, ctx.k = dim, r, t.shape[dim]
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        stats["all_gather"] += 1
        stats["bytes"] += t.numel() * t.element_size()
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.r * ctx.k, ctx.k), None, None, None, None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, group, pieces):
        ctx.group, ctx.pieces = group, pieces
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        if ctx.pieces is None:
            return _sum(g, ctx.group), None, None
        for lo, hi in ctx.pieces:
            g[..., lo:hi] = _sum(g[..., lo:hi].contiguous(), ctx.group)
        return g, None, None


def enter(t):
    """The entry of a tensor-parallel region: ``t`` itself forward, the
    sum over the axis of its gradient backward (each rank's column-parallel
    products give a partial one)."""
    if not _grad_on(t):
        return t
    return _Enter.apply(t, _group())


def all_reduce(t, dtype=None):
    """The sum of ``t`` over the axis in ``dtype`` (default ``t``'s), for a
    consumer replicated over it: the gradient passes unchanged.  A 16-bit
    ``t`` is summed in f32; outside autograd any other is summed in place
    (the callers hand over a temporary)."""
    if not _grad_on(t):
        return _sum(t, _group(), dtype)
    return _Reduce.apply(t, _group(), t.dtype if dtype is None else dtype,
                         False)


def all_reduce_local(t):
    """The sum of ``t`` over the axis for a consumer that is each rank's
    own (its gradient on each rank is a partial): summed backward too."""
    if not _grad_on(t):
        return _sum(t, _group())
    return _Reduce.apply(t, _group(), t.dtype, True)


def all_reduce_exact(t):
    """The sum of ``t`` over the axis in ``t``'s own dtype, where every
    rank but one holds zeros (the vocab-parallel embedding): exact.  The
    gradient passes unchanged."""
    if not _grad_on(t):
        out = t.contiguous().clone()
        stats["all_reduce"] += 1
        stats["bytes"] += out.numel() * out.element_size()
        dist.all_reduce(out, group=_group())
        return out
    return _Reduce.apply(t, _group(), t.dtype, False)


def all_reduce_max(t, group=None):
    """The elementwise max of ``t`` over the axis, or over ``group`` where
    given (no gradient)."""
    out = t.detach().contiguous().clone()
    stats["all_reduce"] += 1
    stats["bytes"] += out.numel() * out.element_size()
    dist.all_reduce(out, op=dist.ReduceOp.MAX,
                    group=_group() if group is None else group)
    return out


def all_gather(t, dim: int):
    """The ranks' ``t`` concatenated along ``dim`` in rank order; the
    gradient of the whole gives each rank its own part."""
    return _Gather.apply(t, _group(), size(), rank(), dim % t.dim())


def sum_grad(w, pieces=None):
    """``w`` itself forward; backward its gradient summed over the axis,
    or only the pieces ``((lo, hi), ...)`` of its last dim: a leaf held
    whole on every rank whose uses are each rank's own."""
    if not _grad_on(w):
        return w
    return _SumGrad.apply(w, _group(), pieces)
