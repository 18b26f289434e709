"""Sharding rules: logical parameter axes -> mesh axes, per execution mode
(the counterpart of ``src/repro/launch/sharding.py``).

Modes
-----
admm  (train): LT-ADMM-CC.  The agent graph lives on the agent axis
      ("data" on a single pod; "pod" on the multi-pod mesh).
serve (prefill/decode): no agent axis; batch over the data-like axes,
      tensor parallel over "model"; long-context caches fall back to
      sequence sharding when the batch does not divide.

Every spec is sanitized against the concrete shape: a mesh axis is
dropped from a dim that it does not divide (kv_heads=8 on a 16-way model
axis), so every architecture gets a spec on every mesh without per-arch
rules.

The port keeps its own ``PartitionSpec``: a tuple of mesh axis names (or
tuples of them, or None) per tensor dim, equal tuple for tuple to the
reference's.  The rules read a mesh through ``mesh.axes_of``: a
``DeviceMesh``, or any stand-in with ``shape`` (``{name: size}``) and
``axis_names``.  ``shard_like`` turns specs into DTensor placements
(``Shard``/``Replicate`` per mesh dim) for ``distribute_tensor``.

Tensor parallelism: ``tp_plan`` says how a rank holds each parameter
over the "model" axis, ``local_shard`` cuts a tensor to the rank's slice
and ``shard_params`` cuts a whole parameter tree (or a stacked ``[A,
...]`` one) to the rank's shard; ``gather_shards`` puts the shards back
together and ``shard_layouts`` says where each shard lies in its whole
leaf (the compressors' ``ShardLayout``).
Both axes are applied: the "model" dim by pieces, and the "data" dim
that mode "serve" and the multi-pod mesh give ``embed`` (FSDP,
``launch.fsdp``) in one contiguous part a rank; mode
"serve_replicated" and single-pod mode "admm" put no "data" entry on a
parameter, as the reference's rules say.  A Mamba mixer is cut over
"model" by SSD head (``_mamba_plan``), not by the spec's contiguous
slice of its concatenated projection.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.common.trees import tree_flatten
from repro_torch.launch.mesh import agent_axis_for, axes_of
from repro_torch.launch.fsdp import AXIS as DATA_AXIS
from repro_torch.launch.tp import AXIS as TP_AXIS
from repro_torch.models.common import is_spec


class PartitionSpec(tuple):
    """Mesh axes per tensor dim: a name, a tuple of names, or None.  A
    one-name tuple is kept as the name, as jax's ``PartitionSpec`` keeps
    it."""

    def __new__(cls, *axes):
        return super().__new__(cls, tuple(
            a[0] if isinstance(a, tuple) and len(a) == 1 else a
            for a in axes))

    def __repr__(self):
        return "P" + tuple.__repr__(self)


P = PartitionSpec


def is_pspec(x) -> bool:
    return isinstance(x, PartitionSpec)


def _map(fn, tree, is_leaf):
    leaves, rebuild = tree_flatten(tree, is_leaf=is_leaf)
    return rebuild([fn(leaf) for leaf in leaves])


def _axis_size(mesh, name):
    if name is None:
        return 1
    if isinstance(name, tuple):
        return math.prod(_axis_size(mesh, n) for n in name)
    return mesh.shape[name]


def sanitize_spec(mesh, shape, spec) -> PartitionSpec:
    """Drop mesh axes that do not divide the corresponding dim, and
    de-duplicate axes that appear on several dims (the first dim wins:
    MoE expert weights [E, d, ff] map both "experts" and "ffn" to
    'model'; the expert dim keeps it)."""
    mesh = axes_of(mesh)
    out = []
    used = set()
    for i, name in enumerate(spec):
        if name is None or i >= len(shape):
            out.append(None)
            continue
        if isinstance(name, tuple):
            # the longest prefix of the tuple that divides and is unused
            kept = []
            size = 1
            for n in name:
                if n in used:
                    continue
                if shape[i] % (size * _axis_size(mesh, n)) == 0:
                    kept.append(n)
                    size *= _axis_size(mesh, n)
            used.update(kept)
            out.append(tuple(kept) if kept else None)
        else:
            ok = name not in used and shape[i] % _axis_size(mesh, name) == 0
            if ok:
                used.add(name)
            out.append(name if ok else None)
    while len(out) < len(shape):
        out.append(None)
    return P(*out)


def param_rules(mesh, mode: str) -> dict:
    """Logical axis name -> mesh axis (before sanitizing).  Mode
    "serve_replicated": tensor parallel only, the weights replicated over
    the data axes (decode of a model that fits a device)."""
    multi_pod = "pod" in axes_of(mesh).axis_names
    if mode == "serve_replicated":
        fsdp = ()
    else:
        fsdp = ("data",) if (mode == "serve" or multi_pod) else ()
    # "embed" carries FSDP (it is in every matmul's non-TP dim);
    # heads/ffn/experts/vocab carry tensor parallelism
    return {
        "embed": fsdp[0] if fsdp else None,
        "heads": "model",
        "kv_heads": "model",
        "head": None,
        "ffn": "model",
        "experts": "model",
        "vocab": "model",
        "ssm_inner": "model",
        "layers": None,
        None: None,
    }


def param_pspec(mesh, mode: str, spec_tree):
    """PartitionSpec tree for (per-agent) model parameters."""
    rules = param_rules(mesh, mode)
    return _map(lambda s: sanitize_spec(mesh, s.shape,
                                        P(*[rules.get(a) for a in s.axes])),
                spec_tree, is_spec)


def prefix_pspec(pspec_tree, *prefix):
    """Prepend mesh axes (the agent axis) to every PartitionSpec."""
    return _map(lambda sp: P(*prefix, *sp), pspec_tree, is_pspec)


def placements(mesh, spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(i)`` where the dim's name shards tensor dim ``i``, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    dims = {}
    for i, name in enumerate(spec):
        for n in (name if isinstance(name, tuple) else (name,)):
            if n is not None:
                dims[n] = i
    return tuple(Shard(dims[n]) if n in dims else Replicate()
                 for n in axes_of(mesh).axis_names)


def shard_like(mesh, pspec_tree):
    """The placements tree of ``pspec_tree`` (the reference's
    ``NamedSharding`` tree): hand each leaf to ``distribute_tensor(t,
    mesh, placements)``."""
    return _map(lambda sp: placements(mesh, sp), pspec_tree, is_pspec)


# ---------------------------------------------------------------------------
# Activation / data shardings
# ---------------------------------------------------------------------------


def train_data_pspec(mesh, leaves_ndim: dict):
    """ADMM train data [A, m, ...]: A on the agent axis; m on 'data' when
    the agent axis is 'pod' (hierarchical mode)."""
    aaxis = agent_axis_for(mesh)
    inner = "data" if aaxis == "pod" else None
    return {k: P(aaxis, inner, *([None] * (v - 2)))
            for k, v in leaves_ndim.items()}


def batch_pspec(mesh, shape):
    """Serve-mode batched tensor: the batch dim takes every data-like axis
    that divides it; the sequence dim (axis 1, if present) takes 'data'
    when the batch cannot (long-context single-request decode)."""
    ax = axes_of(mesh)
    data_axes = [a for a in ax.axis_names if a != "model"]
    batch_axes = []
    size = 1
    for a in data_axes:
        if shape[0] % (size * ax.shape[a]) == 0:
            batch_axes.append(a)
            size *= ax.shape[a]
    spec = [tuple(batch_axes) if batch_axes else None]
    leftover = [a for a in data_axes if a not in batch_axes]
    if len(shape) > 2 and leftover:
        kept = []
        size = 1
        for a in leftover:
            if shape[1] % (size * ax.shape[a]) == 0:
                kept.append(a)
                size *= ax.shape[a]
        spec.append(tuple(kept) if kept else None)
    while len(spec) < len(shape):
        spec.append(None)
    return sanitize_spec(mesh, shape, P(*spec))


def cache_pspec(mesh, cache_tree):
    """Decode caches: [B, S, KH, Dh] / [B, S, r] / SSM states [B, ...]
    (a None entry, an absent cache, stays None)."""
    def one(x):
        if x is None:
            return None
        shape = tuple(x.shape)
        if len(shape) >= 2:
            base = batch_pspec(mesh, shape)
            # model parallelism on the heads dim (axis 2) of a KV cache
            if len(shape) == 4:
                lst = list(base) + [None] * (4 - len(base))
                if lst[2] is None:
                    lst[2] = "model"
                return sanitize_spec(mesh, shape, P(*lst))
            return base
        return P(*([None] * len(shape)))

    return _map(one, cache_tree, None)


# ---------------------------------------------------------------------------
# Tensor parallelism: the rank's shard of the parameters
# ---------------------------------------------------------------------------

# a Mamba mixer's leaves (``models.mamba.mamba_specs``)
_MAMBA_KEYS = frozenset(("in_proj", "conv_w", "conv_b", "A_log", "D",
                         "dt_bias", "norm", "out_proj"))


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """How a rank holds one parameter: ``dim`` is the dim the "model"
    axis cuts (None: held whole over it), ``segments`` its pieces
    ``((length, cut), ...)`` in order along that dim, each cut piece split
    into the axis's size contiguous parts (the rank keeps its part) and
    each other piece held whole; a plain shard is one cut piece.
    ``data_dim``: the dim the "data" axis cuts into its size contiguous
    parts (FSDP), or None.  ``differs``: the rank's slice over "model" is
    not the one the reference's spec gives (``param_pspec``)."""

    dim: int | None
    segments: tuple = ()
    differs: bool = False
    data_dim: int | None = None


def _axis_dim(spec, axis):
    """The dim whose entry names ``axis``, or None."""
    for d, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (entry,)
        if axis in names:
            if len(names) > 1:
                raise ValueError(f"{spec}: the {axis!r} axis shares dim "
                                 f"{d} with {names}; only {axis!r} alone "
                                 "is applied")
            return d
    return None


def _model_dim(spec):
    """The dim whose entry names the "model" axis, or None."""
    return _axis_dim(spec, TP_AXIS)


def _pieces(segments, rank: int, size: int) -> tuple:
    """A rank's pieces of a dim that ``segments`` tile (``LeafPlan``)
    over a "model" axis of ``size``: ``(local start, global start,
    length, cut)`` each, a cut piece's part the rank's, a piece held
    whole all of it."""
    out, ls, start = [], 0, 0
    for length, cut in segments:
        if cut and length % size:
            raise ValueError(f"a piece of {length} does not split over "
                             f"{size} ranks")
        k = length // size if cut else length
        out.append((ls, start + (rank * k if cut else 0), k, bool(cut)))
        ls += k
        start += length
    return tuple(out)


def _coord(mesh, axis) -> tuple:
    """``(rank, size)`` of the mesh's ``axis`` (``(0, 1)`` where the mesh
    lacks it or it has one rank)."""
    n = axes_of(mesh).shape.get(axis, 1)
    return (0, 1) if n == 1 else (mesh.get_local_rank(axis), n)


def local_shard(mesh, spec, tensor, segments=None):
    """The rank's slice of ``tensor`` for a sanitized ``spec``: the dim
    whose entry names "model" cut into the axis's size contiguous parts
    (by ``segments``, as ``LeafPlan`` says, where given), and the dim
    whose entry names "data" cut into that axis's size contiguous parts,
    as a tensor of its own, so that the whole one can be freed.  No other
    entry is applied.  A spec that cuts nothing returns ``tensor``
    itself."""
    d, dd = _model_dim(spec), _axis_dim(spec, DATA_AXIS)
    r, n = _coord(mesh, TP_AXIS)
    rd, nd = _coord(mesh, DATA_AXIS)
    if dd is not None and nd == 1:
        dd = None
    if d is None and dd is None:
        return tensor
    out, fresh = tensor, False
    if d is not None:
        segments = segments or ((tensor.shape[d], True),)
        if sum(length for length, _ in segments) != tensor.shape[d]:
            raise ValueError(f"segments {segments} do not tile dim {d} of "
                             f"{tuple(tensor.shape)}")
        pieces = [tensor.narrow(d, g, k)
                  for _, g, k, _ in _pieces(segments, r, n)]
        out = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=d)
        fresh = len(pieces) > 1
    if dd is not None:
        if out.shape[dd] % nd:
            raise ValueError(f"dim {dd} of {tuple(tensor.shape)} does not "
                             f"split over {nd} ranks")
        k = out.shape[dd] // nd
        out, fresh = out.narrow(dd, rd * k, k), False
    if not fresh:
        out = out.clone(memory_format=torch.contiguous_format)
    return out


def _mamba_plan(mesh, specs, pspecs):
    """A Mamba mixer's plan, cut by SSD head: z, x, dt, ``A_log``, ``D``
    and ``dt_bias`` take the rank's heads, B and C (and their conv
    channels) are held whole, ``norm`` and ``out_proj`` take the rank's
    heads' channels (the spec's own slice).  With heads not divisible by
    the axis the mixer is held whole over "model".  The "data" dims are
    the spec's."""
    n = axes_of(mesh).shape[TP_AXIS]
    di, nh = specs["norm"].shape[-1], specs["A_log"].shape[-1]
    groups = specs["conv_b"].shape[-1] - di  # B | C: 2 * n_groups * d_state
    ref = {k: _model_dim(pspecs[k]) for k in _MAMBA_KEYS}
    data = {k: _axis_dim(pspecs[k], DATA_AXIS) for k in _MAMBA_KEYS}
    if nh % n:
        return {k: LeafPlan(None, differs=ref[k] is not None,
                            data_dim=data[k]) for k in _MAMBA_KEYS}
    heads = ((nh, True),)
    last = {"in_proj": ((di, True), (di, True), (groups, False), (nh, True)),
            "conv_w": ((di, True), (groups, False)),
            "conv_b": ((di, True), (groups, False)),
            "A_log": heads, "D": heads, "dt_bias": heads,
            "norm": ((di, True),)}
    plan = {}
    for k, segs in last.items():
        d = len(specs[k].shape) - 1
        plan[k] = LeafPlan(d, segs, differs=ref[k] != d or len(segs) > 1,
                           data_dim=data[k])
    d = len(specs["out_proj"].shape) - 2
    plan["out_proj"] = LeafPlan(d, ((di, True),), differs=ref["out_proj"] != d,
                                data_dim=data["out_proj"])
    return plan


def tp_plan(mesh, mode: str, spec_tree, model: bool = True):
    """``LeafPlan`` per parameter of ``spec_tree`` (``ParamSpec`` leaves)
    over ``mesh``: the dim that ``param_pspec`` gives the "model" axis,
    cut contiguously, and a Mamba mixer by head (``_mamba_plan``); the
    dim it gives "data" (FSDP).  ``model=False``: every leaf held whole
    over "model" (the archs whose blocks do not run tensor-parallel)."""
    pspecs = param_pspec(mesh, mode, spec_tree)
    model = model and axes_of(mesh).shape.get(TP_AXIS, 1) > 1

    def walk(specs, ps):
        if is_spec(specs):
            d = _model_dim(ps) if model else None
            return LeafPlan(d, () if d is None else
                            ((specs.shape[d], True),),
                            data_dim=_axis_dim(ps, DATA_AXIS))
        if model and _MAMBA_KEYS <= set(specs) and all(
                is_spec(specs[k]) for k in _MAMBA_KEYS):
            plan = _mamba_plan(mesh, specs, ps)
            rest = {k: walk(specs[k], ps[k]) for k in specs
                    if k not in _MAMBA_KEYS}
            return {**plan, **rest}
        return {k: walk(specs[k], ps[k]) for k in specs}

    return walk(spec_tree, pspecs)


def _leaf_spec(p: LeafPlan, ndim: int, lead: int):
    return PartitionSpec(*[
        TP_AXIS if p.dim is not None and i == p.dim + lead else
        DATA_AXIS if p.data_dim is not None and i == p.data_dim + lead
        else None for i in range(ndim)])


def shard_params(tree, mesh, mode: str, spec_tree, lead: int = 0,
                 model: bool = True):
    """The rank's shard of the whole parameter tree ``tree`` (nested
    dicts of tensors laid out as ``spec_tree``; the reference's tree,
    carried across) over ``mesh``'s "model" and "data" axes, by
    ``tp_plan``.  The whole tree is emptied as its leaves are cut, so
    that a caller that holds no other reference frees each whole leaf (a
    leaf held whole moves to the new tree as it is).  ``lead``: dims in
    front of each leaf's spec shape (the agents of a stacked ``[A, ...]``
    tree); ``model`` as ``tp_plan``."""
    plan = tp_plan(mesh, mode, spec_tree, model)

    def walk(node, p):
        if isinstance(p, LeafPlan):
            if p.dim is None and p.data_dim is None:
                return node
            return local_shard(mesh, _leaf_spec(p, node.dim(), lead), node,
                               p.segments or None)
        return {k: walk(node.pop(k), p[k]) for k in list(node)}

    return walk(tree, plan)


def leaf_layout(plan: LeafPlan, shape, rank: int, size: int,
                data_rank: int = 0, data_size: int = 1):
    """A rank's ``ShardLayout`` of a leaf of ``shape`` that ``plan`` cuts
    over a "model" axis of ``size`` (each segment a piece: its local
    start, global start, length, and whether the axis cuts it) and over a
    "data" axis of ``data_size`` (one cut piece, the rank's part).  A
    leaf cut over one axis takes the one-dim layout of its cut; over both,
    the "model" dim's pieces and the "data" dim's part."""
    from repro_torch.kernels.quantize.ref import ShardLayout

    shape = tuple(shape)
    dd = plan.data_dim if data_size > 1 else None
    data = None
    if dd is not None:
        k = shape[dd] // data_size
        data = ((0, data_rank * k, k, True),)
    if plan.dim is None:
        return (ShardLayout(shape) if dd is None
                else ShardLayout(shape, dd, data, axes=(DATA_AXIS,)))
    pieces = _pieces(plan.segments, rank, size)
    if dd is None:
        return ShardLayout(shape, plan.dim, pieces, axes=(TP_AXIS,))
    return ShardLayout(shape, plan.dim, pieces, dd, data,
                       axes=(TP_AXIS, DATA_AXIS))


def shard_layouts(mesh, mode: str, spec_tree, model: bool = True) -> list:
    """The rank's ``ShardLayout`` of every parameter of ``spec_tree`` over
    ``mesh``'s "model" and "data" axes (``tp_plan``), in flatten order."""
    r, n = _coord(mesh, TP_AXIS)
    rd, nd = _coord(mesh, DATA_AXIS)
    plans = tree_flatten(tp_plan(mesh, mode, spec_tree, model),
                         is_leaf=lambda x: isinstance(x, LeafPlan))[0]
    specs = tree_flatten(spec_tree, is_leaf=is_spec)[0]
    return [leaf_layout(p, s.shape, r, n, rd, nd)
            for p, s in zip(plans, specs)]


def _gather_axis(t, mesh, axis):
    import torch.distributed as dist

    n = axes_of(mesh).shape[axis]
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=mesh.get_group(axis))
    return parts


def gather_shards(tree, mesh, mode: str, spec_tree, lead: int = 0,
                  model: bool = True):
    """Inverse of ``shard_params`` on every rank: each leaf's parts
    ``all_gather``ed over ``mesh``'s "data" axis and joined along its
    "data" dim, then its shards over the "model" axis put back in the
    whole leaf's layout (a piece held whole taken from the axis's rank
    0).  For checks and checkpoints; ``lead`` and ``model`` as
    ``shard_params``."""
    n = axes_of(mesh).shape.get(TP_AXIS, 1)
    nd = axes_of(mesh).shape.get(DATA_AXIS, 1)
    plan = tp_plan(mesh, mode, spec_tree, model)

    def walk(node, p):
        if not isinstance(p, LeafPlan):
            return {k: walk(node[k], p[k]) for k in node}
        t = node
        if p.data_dim is not None and nd > 1:
            dd = p.data_dim + lead
            t = torch.cat(_gather_axis(t, mesh, DATA_AXIS), dim=dd)
        if p.dim is None:
            return t
        d = p.dim + lead
        parts = _gather_axis(t, mesh, TP_AXIS)
        out = []
        for ls, _, k, cut in _pieces(p.segments, 0, n):
            out += ([q.narrow(d, ls, k) for q in parts] if cut
                    else [parts[0].narrow(d, ls, k)])
        return torch.cat(out, dim=d)

    return walk(tree, plan)
