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
Only "model" is applied; the "data" entries that mode "serve" puts on
``embed`` (FSDP) are held whole.  A Mamba mixer is cut by SSD head
(``_mamba_plan``), not by the spec's contiguous slice of its
concatenated projection.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.common.trees import tree_flatten
from repro_torch.launch.mesh import agent_axis_for, axes_of
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
    """How a rank holds one parameter over the "model" axis: ``dim`` is
    the dim the axis cuts (None: held whole), ``segments`` its pieces
    ``((length, cut), ...)`` in order along that dim, each cut piece split
    into the axis's size contiguous parts (the rank keeps its part) and
    each other piece held whole; a plain shard is one cut piece.
    ``differs``: the rank's slice is not the one the reference's spec
    gives (``param_pspec``)."""

    dim: int | None
    segments: tuple = ()
    differs: bool = False


def _model_dim(spec):
    """The dim whose entry names the "model" axis, or None."""
    for d, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (entry,)
        if TP_AXIS in names:
            if len(names) > 1:
                raise ValueError(f"{spec}: the {TP_AXIS!r} axis shares dim "
                                 f"{d} with {names}; only {TP_AXIS!r} alone "
                                 "is applied")
            return d
    return None


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


def local_shard(mesh, spec, tensor, segments=None):
    """The rank's slice of ``tensor`` for a sanitized ``spec``: the dim
    whose entry names "model" cut into the axis's size contiguous parts
    (by ``segments``, as ``LeafPlan`` says, where given), as a tensor of
    its own, so that the whole one can be freed.  No other entry is
    applied: a "data" dim stays whole.  A spec without "model" returns
    ``tensor`` itself."""
    d = _model_dim(spec)
    if d is None:
        return tensor
    segments = segments or ((tensor.shape[d], True),)
    if sum(length for length, _ in segments) != tensor.shape[d]:
        raise ValueError(f"segments {segments} do not tile dim {d} of "
                         f"{tuple(tensor.shape)}")
    pieces = [tensor.narrow(d, g, k) for _, g, k, _ in _pieces(
        segments, mesh.get_local_rank(TP_AXIS), axes_of(mesh).shape[TP_AXIS])]
    if len(pieces) == 1:
        return pieces[0].clone(memory_format=torch.contiguous_format)
    return torch.cat(pieces, dim=d)


def _mamba_plan(mesh, specs, pspecs):
    """A Mamba mixer's plan, cut by SSD head: z, x, dt, ``A_log``, ``D``
    and ``dt_bias`` take the rank's heads, B and C (and their conv
    channels) are held whole, ``norm`` and ``out_proj`` take the rank's
    heads' channels (the spec's own slice).  With heads not divisible by
    the axis the mixer is held whole."""
    n = axes_of(mesh).shape[TP_AXIS]
    di, nh = specs["norm"].shape[-1], specs["A_log"].shape[-1]
    groups = specs["conv_b"].shape[-1] - di  # B | C: 2 * n_groups * d_state
    ref = {k: _model_dim(pspecs[k]) for k in _MAMBA_KEYS}
    if nh % n:
        return {k: LeafPlan(None, differs=ref[k] is not None)
                for k in _MAMBA_KEYS}
    heads = ((nh, True),)
    last = {"in_proj": ((di, True), (di, True), (groups, False), (nh, True)),
            "conv_w": ((di, True), (groups, False)),
            "conv_b": ((di, True), (groups, False)),
            "A_log": heads, "D": heads, "dt_bias": heads,
            "norm": ((di, True),)}
    plan = {}
    for k, segs in last.items():
        d = len(specs[k].shape) - 1
        plan[k] = LeafPlan(d, segs, differs=ref[k] != d or len(segs) > 1)
    d = len(specs["out_proj"].shape) - 2
    plan["out_proj"] = LeafPlan(d, ((di, True),), differs=ref["out_proj"] != d)
    return plan


def tp_plan(mesh, mode: str, spec_tree):
    """``LeafPlan`` per parameter of ``spec_tree`` (``ParamSpec`` leaves)
    over ``mesh``'s "model" axis: the dim that ``param_pspec`` gives the
    axis, cut contiguously, and a Mamba mixer by head
    (``_mamba_plan``)."""
    pspecs = param_pspec(mesh, mode, spec_tree)

    def walk(specs, ps):
        if is_spec(specs):
            d = _model_dim(ps)
            return LeafPlan(d, () if d is None else
                            ((specs.shape[d], True),))
        if _MAMBA_KEYS <= set(specs) and all(
                is_spec(specs[k]) for k in _MAMBA_KEYS):
            plan = _mamba_plan(mesh, specs, ps)
            rest = {k: walk(specs[k], ps[k]) for k in specs
                    if k not in _MAMBA_KEYS}
            return {**plan, **rest}
        return {k: walk(specs[k], ps[k]) for k in specs}

    return walk(spec_tree, pspecs)


def shard_params(tree, mesh, mode: str, spec_tree, lead: int = 0):
    """The rank's shard of the whole parameter tree ``tree`` (nested
    dicts of tensors laid out as ``spec_tree``; the reference's tree,
    carried across) over ``mesh``'s "model" axis, by ``tp_plan``.  The
    whole tree is emptied as its leaves are cut, so that a caller that
    holds no other reference frees each whole leaf (a leaf held whole
    moves to the new tree as it is).  ``lead``: dims in front of each
    leaf's spec shape (the agents of a stacked ``[A, ...]`` tree)."""
    plan = tp_plan(mesh, mode, spec_tree)

    def walk(node, p):
        if isinstance(p, LeafPlan):
            if p.dim is None:
                return node
            spec = PartitionSpec(*[TP_AXIS if i == p.dim + lead else None
                                   for i in range(node.dim())])
            return local_shard(mesh, spec, node, p.segments)
        return {k: walk(node.pop(k), p[k]) for k in list(node)}

    return walk(tree, plan)


def leaf_layout(plan: LeafPlan, shape, rank: int, size: int):
    """A rank's ``ShardLayout`` of a leaf of ``shape`` that ``plan`` cuts
    over a "model" axis of ``size``: each segment a piece (its local
    start, global start, length, and whether the axis cuts it)."""
    from repro_torch.kernels.quantize.ref import ShardLayout

    if plan.dim is None:
        return ShardLayout(tuple(shape))
    return ShardLayout(tuple(shape), plan.dim,
                       _pieces(plan.segments, rank, size))


def shard_layouts(mesh, mode: str, spec_tree) -> list:
    """The rank's ``ShardLayout`` of every parameter of ``spec_tree`` over
    ``mesh``'s "model" axis (``tp_plan``), in flatten order."""
    n = axes_of(mesh).shape[TP_AXIS]
    r = mesh.get_local_rank(TP_AXIS)
    plans = tree_flatten(tp_plan(mesh, mode, spec_tree),
                         is_leaf=lambda x: isinstance(x, LeafPlan))[0]
    specs = tree_flatten(spec_tree, is_leaf=is_spec)[0]
    return [leaf_layout(p, s.shape, r, n) for p, s in zip(plans, specs)]


def gather_shards(tree, mesh, mode: str, spec_tree, lead: int = 0):
    """Inverse of ``shard_params`` on every rank: each leaf's shards
    ``all_gather``ed over ``mesh``'s "model" axis and put back in the
    whole leaf's layout (a piece held whole taken from the axis's rank
    0).  For checks and checkpoints; ``lead`` as ``shard_params``."""
    import torch.distributed as dist

    n = axes_of(mesh).shape[TP_AXIS]
    group = mesh.get_group(TP_AXIS)
    plan = tp_plan(mesh, mode, spec_tree)

    def walk(node, p):
        if not isinstance(p, LeafPlan):
            return {k: walk(node[k], p[k]) for k in node}
        if p.dim is None:
            return node
        t = node.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        d = p.dim + lead
        out = []
        for ls, _, k, cut in _pieces(p.segments, 0, n):
            out += ([q.narrow(d, ls, k) for q in parts] if cut
                    else [parts[0].narrow(d, ls, k)])
        return torch.cat(out, dim=d)

    return walk(tree, plan)
