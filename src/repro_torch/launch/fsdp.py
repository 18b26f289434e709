"""FSDP over the "data" axis of the ambient mesh (``launch.mesh.use_mesh``):
the collectives that gather a parameter cut over the axis at its point of
use, and the gradient's way back to the rank's part.

The reference shards every parameter's ``"embed"`` dim over "data" in
mode "serve" and on the multi-pod mesh (``launch/sharding.py``
``param_rules``), and GSPMD gathers the weights where a product needs
them.  The port runs it by hand: ``sharding.shard_params`` leaves each
rank its part of that dim (one contiguous part), and the model gathers a
unit's parameters where it runs it (``gather_tree``, called from
``models.transformer``), so the whole unit lives only while it runs;
under remat the backward gathers again.  The blocks then see weights
that are whole over "data" and run tensor-parallel over "model" as
before (``launch.tp``).

* ``gather(shard, dim)``: the ranks' parts concatenated along ``dim``
  forward; backward the gradient of the whole leaf reduce-scattered with
  a sum, so each rank keeps its part (each rank's rows gave a partial);
* ``gather(shard, dim, same_rows=True)``: the form for a leaf used by
  every rank of the axis on the same rows (a batch that "data" does not
  divide): each rank's gradient of the whole is already the whole
  batch's, and it keeps its part of it, with no collective;
* ``all_reduce(t)``: the sum over the axis (the gradient of a leaf that
  "data" does not divide, each rank's a partial), outside autograd.

``same_rows()`` makes the second form the ambient one inside its block
(``gather`` reads it at the call); a remat'd unit re-enters the mode its
forward ran under (``models.transformer._remat``).

Outside autograd (serving, ``torch.no_grad``) ``gather`` is the plain
all-gather.  A backward collective takes the process group its forward
saw, so it runs without the ambient mesh.  Gloo has no reduce-scatter:
there the backward sums the whole gradient (``all_reduce``) and keeps
the rank's part; NCCL reduce-scatters.

``stats`` counts the gathers, the reduce-scatters and the bytes this
process handed to them (a gather its shard's, a reduce-scatter the whole
gradient's); under remat a unit's gathers run again in its backward and
count twice.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.launch.mesh import axes_of, current_mesh

AXIS = "data"
_NARROW = (torch.bfloat16, torch.float16)

stats = {"gather": 0, "reduce_scatter": 0, "all_reduce": 0, "bytes": 0}


def reset_stats():
    for k in stats:
        stats[k] = 0


def mesh():
    """The ambient mesh when its "data" axis has more than one rank, else
    None."""
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


_ROWS = threading.local()


@contextlib.contextmanager
def same_rows(on: bool = True):
    """Inside the block the ranks of the axis run the same rows: a gather's
    backward keeps the rank's part of the gradient without a sum."""
    prev = getattr(_ROWS, "on", False)
    _ROWS.on = on
    try:
        yield
    finally:
        _ROWS.on = prev


def rows_shared() -> bool:
    """Whether ``same_rows`` is ambient."""
    return getattr(_ROWS, "on", False)


def _grad_on(t) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def _all_gather(t, group, n, dim):
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    stats["gather"] += 1
    stats["bytes"] += t.numel() * t.element_size()
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def _sum(t, group):
    """The sum over ``group`` of a temporary ``t`` (16-bit in f32)."""
    wide = t.float() if t.dtype in _NARROW else t
    dist.all_reduce(wide, group=group)
    return wide.to(t.dtype)


def _reduce_scatter(g, group, n, r, dim):
    """The rank's part along ``dim`` of the sum over ``group`` of ``g``."""
    k = g.shape[dim] // n
    stats["reduce_scatter"] += 1
    stats["bytes"] += g.numel() * g.element_size()
    if dist.get_backend(group) == "nccl" and g.dtype not in _NARROW:
        whole = g.movedim(dim, 0).contiguous()
        out = torch.empty((k,) + tuple(whole.shape[1:]), dtype=g.dtype,
                          device=g.device)
        dist.reduce_scatter_tensor(out, whole, group=group)
        return out.movedim(0, dim)
    return _sum(g.contiguous().clone(), group).narrow(dim, r * k, k).clone()


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, group, n, r, dim, same):
        ctx.group, ctx.n, ctx.r, ctx.dim, ctx.same = group, n, r, dim, same
        ctx.k = shard.shape[dim]
        return _all_gather(shard, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.same:
            part = g.narrow(ctx.dim, ctx.r * ctx.k, ctx.k)
        else:
            part = _reduce_scatter(g, ctx.group, ctx.n, ctx.r, ctx.dim)
        return part, None, None, None, None, None


def gather(shard, dim: int, same_rows=None):
    """The ranks' parts of a leaf cut on ``dim`` over the axis,
    concatenated in rank order.  Backward: the rank's part of the summed
    gradient, or, with ``same_rows`` (default: ``rows_shared()``), the
    rank's part of its own."""
    m = mesh()
    if m is None:
        raise RuntimeError("a leaf cut over 'data' needs an ambient mesh "
                           "with a 'data' axis (launch.mesh.use_mesh)")
    group, n = m.get_group(AXIS), axes_of(m).shape[AXIS]
    dim = dim % shard.dim()
    if not _grad_on(shard):
        return _all_gather(shard, group, n, dim)
    same = rows_shared() if same_rows is None else same_rows
    return _Gather.apply(shard, group, n, m.get_local_rank(AXIS), dim, same)


def all_reduce(t):
    """The sum of ``t`` over the axis, outside autograd (in place for a
    tensor of 32 bits or more; callers hand over a temporary)."""
    m = mesh()
    if m is None:
        return t
    stats["all_reduce"] += 1
    stats["bytes"] += t.numel() * t.element_size()
    return _sum(t, m.get_group(AXIS))


def data_dim(spec):
    """The dim that the "data" axis cuts in a leaf of ``spec`` (a
    ``ParamSpec``): its first ``"embed"`` axis (``param_rules`` gives
    "data" to "embed" alone, and ``sanitize_spec`` keeps the first of a
    repeated axis), or None."""
    return spec.axes.index("embed") if "embed" in spec.axes else None


def _cut(leaf, spec) -> int | None:
    """The dim on which ``leaf`` is the rank's part of the leaf of
    ``spec`` over the ambient axis, or None where it is whole."""
    d = data_dim(spec)
    # a stacked spec's leading dims may be indexed away (a unit's view)
    off = len(spec.shape) - leaf.dim()
    if d is None or d < off:
        return None
    full, local = spec.shape[d], leaf.shape[d - off]
    if local == full:
        return None
    if local * size() != full:
        raise ValueError(f"a dim of {local} is no rank's part of {full} "
                         f"over a {AXIS!r} axis of {size()}")
    return d - off


def gather_tree(tree, specs):
    """``tree`` (dicts or ``Params`` of tensors laid out as ``specs``,
    ``ParamSpec`` leaves, stacked ones indexed) with every leaf that is
    the rank's part over the ambient "data" axis gathered (``gather``).
    A subtree with no such leaf comes back as it is (the same object), so
    without an ambient axis nothing changes; a gathered Mamba mixer comes
    back as a new module of the whole weights."""
    if mesh() is None:
        return tree
    return _walk(tree, specs)


def _walk(node, spec):
    if isinstance(node, torch.Tensor):
        d = _cut(node, spec)
        return node if d is None else gather(node, d)
    keys = node.keys()
    out = {k: _walk(node[k], spec[k]) for k in keys}
    if all(out[k] is node[k] for k in keys):
        return node
    if isinstance(node, nn.Module) and hasattr(node, "cfg"):
        return type(node)(node.cfg, out)
    return out


def gathers(specs, data_size: int) -> int:
    """How many leaves of ``specs`` a data axis of ``data_size`` cuts (the
    gathers ``gather_tree`` makes of them)."""
    from repro_torch.common.trees import tree_flatten
    from repro_torch.models.common import is_spec

    n = 0
    for s in tree_flatten(specs, is_leaf=is_spec)[0]:
        d = data_dim(s)
        n += d is not None and s.shape[d] % data_size == 0
    return n


def cut_dim(leaf, spec):
    """The dim of ``leaf`` that is the rank's part over the ambient "data"
    axis of the leaf of ``spec`` (a ``ParamSpec``), or None (no ambient
    axis, or the leaf whole over it)."""
    return None if mesh() is None else _cut(leaf, spec)


def take_rows(data, idx):
    """The rows ``idx [A, b]`` (indices over an agent's whole rows) of
    ``data``, whose leaves ``[A, m / D, ...]`` are the rank's contiguous
    part of the agent's rows over the ambient axis of D ranks: each rank
    puts the rows it holds and zeros elsewhere, and one sum over the axis
    a leaf gives every rank the whole minibatch (exact: one rank holds
    each row)."""
    m = mesh()
    group, r = m.get_group(AXIS), m.get_local_rank(AXIS)
    agents = torch.arange(idx.shape[0], device=idx.device)[:, None]

    def one(x):
        k = x.shape[1]
        local = idx - r * k
        inside = (local >= 0) & (local < k)
        rows = x[agents, local.clamp(0, k - 1)]
        mask = inside.reshape(inside.shape + (1,) * (rows.dim() - 2))
        rows = torch.where(mask, rows, torch.zeros((), dtype=rows.dtype,
                                                   device=rows.device))
        stats["all_reduce"] += 1
        stats["bytes"] += rows.numel() * rows.element_size()
        dist.all_reduce(rows, group=group)
        return rows

    return {k: one(v) for k, v in data.items()}
