"""Tensor parallelism over the "model" axis of the ambient mesh
(``launch.mesh.use_mesh``): the collectives that a tensor-parallel
forward needs, and the rank's part of a sharded dim.

The reference gets tensor parallelism from GSPMD, which partitions every
product under the parameters' shardings (``launch/sharding.py``
``param_rules``).  The port runs it by hand: ``sharding.shard_params``
leaves each rank its shard of the parameters, the layers read from a
weight's shape whether it is sharded (a dim smaller than the config's),
and they meet here to sum row-parallel partials (``all_reduce``) and to
gather the vocab-sharded logits (``all_gather``).  Nothing here runs
without an ambient mesh whose "model" axis has more than one rank: the
layers call these functions only for sharded weights.

A row-parallel product of 16-bit operands returns its partial in f32
(``partial_mm``, through ``torch.mm(..., out_dtype=torch.float32)`` on
the card), the partials are summed in f32 and the sum is rounded to the
activations' dtype once, as the one-rank product rounds its f32
accumulation once.

``stats`` counts the collectives this process issued and the bytes it
handed to them.
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
        out = torch.mm(a2, w, out_dtype=torch.float32)
    else:
        out = a2 @ w
    return out.reshape(*a.shape[:-1], w.shape[-1])


def all_reduce(t, dtype=None):
    """The sum of ``t`` over the axis in ``dtype`` (default ``t``'s).  A
    16-bit ``t`` is summed in f32; any other is summed in place (the
    callers hand over a temporary)."""
    dtype = t.dtype if dtype is None else dtype
    wide = t.float() if t.dtype in _NARROW else t
    stats["all_reduce"] += 1
    stats["bytes"] += wide.numel() * wide.element_size()
    dist.all_reduce(wide, group=_group())
    return wide.to(dtype)


def all_reduce_exact(t):
    """The sum of ``t`` over the axis in ``t``'s own dtype, where every
    rank but one holds zeros (the vocab-parallel embedding): exact."""
    out = t.contiguous().clone()
    stats["all_reduce"] += 1
    stats["bytes"] += out.numel() * out.element_size()
    dist.all_reduce(out, group=_group())
    return out


def all_gather(t, dim: int):
    """The ranks' ``t`` concatenated along ``dim`` in rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(size())]
    stats["all_gather"] += 1
    stats["bytes"] += t.numel() * t.element_size()
    dist.all_gather(parts, t, group=_group())
    return torch.cat(parts, dim=dim)
