"""Shared model-building blocks: parameter specs, norms, RoPE, embeddings
(the counterpart of ``src/repro/models/common.py``).

Every layer defines a ``*_specs(cfg)`` function returning a tree of
``ParamSpec`` (shape, logical axis names, initializer).  ``init_params``
draws the reference's weights from such a tree, through ``core.jaxrand``,
and ``Params`` holds a tree of weights as an ``nn.Module`` whose
parameters keep the reference's shapes and names (``wq [d, h, dh]``), so
the layers' einsums read as the reference's do.  The layers read a plain
nested dict of tensors just as well, which is what training hands them
(its leaves require grad; ``Params`` would cut them from autograd).
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping

import torch.utils.checkpoint as ckpt

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import jaxrand
from repro_torch.launch import tp


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple  # logical axis name per dim (None = replicated dim)
    init: str = "normal"  # normal | zeros | ones | embed
    scale: float = 1.0  # multiplier on the default fan-in scale

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in length")


def is_spec(x):
    return isinstance(x, ParamSpec)


def _spec_leaves(tree, path=()):
    """(path, spec) in ``jax.tree.flatten`` order: dict keys sorted."""
    if is_spec(tree):
        return [(path, tree)]
    return [leaf for k in sorted(tree)
            for leaf in _spec_leaves(tree[k], path + (k,))]


# elements drawn per slice of a large leaf: its int64 Threefry
# temporaries stay near 1 GiB (zamba2's stacked in_proj has 2.4e8)
_DRAW_SLICE = 1 << 24


def _normal(k, shape, mult: float, dtype):
    """``(jax.random.normal(k, shape) * mult).astype(dtype)``, drawn in
    flat slices (each element's draw depends only on its flat counter)."""
    n = math.prod(shape)
    m = torch.tensor(mult, dtype=torch.float32, device=k.device)
    out = torch.empty(n, dtype=dtype, device=k.device)
    for start in range(0, n, _DRAW_SLICE):
        cnt = min(_DRAW_SLICE, n - start)
        out[start:start + cnt] = (jaxrand.normal(k, (cnt,), start)
                                  * m).to(dtype)
    return out.reshape(shape)


def init_params(key, spec_tree, dtype=torch.float32, device=None):
    """The reference's ``init_params(key, spec_tree, dtype)``: one key per
    leaf from ``split(key, n_leaves)`` in flatten order, fan-in scaled
    normals drawn in f32 and cast to ``dtype``.  Returns the nested dict
    of tensors on ``device`` (default: the key's)."""
    dev = torch.device(device) if device is not None else key.device
    leaves = _spec_leaves(spec_tree)
    keys = jaxrand.split(key.to(dev), len(leaves))
    out: dict = {}

    def place(path, val):
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = val

    def empty_dicts(tree, path=()):
        # subtrees without leaves (a non-parametric norm) stay as {}
        if isinstance(tree, Mapping):
            if not tree and path:
                place(path, {})
            for k, v in tree.items():
                empty_dicts(v, path + (k,))

    empty_dicts(spec_tree)
    for k, (path, s) in zip(keys, leaves):
        if s.init == "zeros":
            val = torch.zeros(s.shape, dtype=dtype, device=dev)
        elif s.init == "ones":
            val = torch.ones(s.shape, dtype=dtype, device=dev)
        elif s.init == "embed":
            val = _normal(k, s.shape, s.scale, dtype)
        else:
            # fan-in scaled normal; the leading "layers" stack axis is a
            # batch of independent layers, not a fan-in dimension
            dims = [d for d, a in zip(s.shape, s.axes) if a != "layers"]
            fan_in = dims[0] if len(dims) > 1 else (dims[-1] if dims else 1)
            val = _normal(k, s.shape, s.scale / math.sqrt(max(fan_in, 1)),
                          dtype)
        place(path, val)
    return out


def _map_specs(fn, spec_tree):
    if is_spec(spec_tree):
        return fn(spec_tree)
    return {k: _map_specs(fn, v) for k, v in spec_tree.items()}


def abstract_params(spec_tree, dtype=torch.float32):
    """The tree of ``meta`` tensors (shape and dtype, no storage) of a
    spec tree: the reference's ``ShapeDtypeStruct`` tree."""
    return _map_specs(lambda s: torch.empty(s.shape, dtype=dtype,
                                            device="meta"), spec_tree)


def partition_specs(spec_tree, rules: dict):
    """Each spec's logical axis names mapped to mesh axes through
    ``rules`` (``{logical name: mesh axis | tuple | None}``): a tree of
    ``launch.sharding.PartitionSpec``."""
    from repro_torch.launch.sharding import PartitionSpec

    return _map_specs(lambda s: PartitionSpec(*[rules.get(a)
                                                for a in s.axes]),
                      spec_tree)


def param_count(spec_tree) -> int:
    return sum(math.prod(s.shape) for _, s in _spec_leaves(spec_tree))


class Params(nn.Module):
    """A tree of weights as an ``nn.Module``: each mapping of the tree a
    child module, each tensor a parameter (no gradient: inference) under
    the reference's name.  ``params["wq"]``, ``params.get("ln1", {})``
    and ``name in params`` read it as the reference reads its dicts; a
    value that already is a module is kept as the child."""

    def __init__(self, tree: Mapping):
        super().__init__()
        for name, val in tree.items():
            if isinstance(val, nn.Module):
                self.add_module(name, val)
            elif isinstance(val, Mapping):
                self.add_module(name, Params(val))
            else:
                self.register_parameter(
                    name, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, name):
        if name not in self:
            raise KeyError(name)
        return getattr(self, name)

    def __contains__(self, name):
        return name in self._parameters or name in self._modules

    def get(self, name, default=None):
        return self[name] if name in self else default

    def keys(self):
        return list(self._parameters) + list(self._modules)

    def tree(self) -> dict:
        """The weights as a nested dict of tensors (a ``ModuleList``
        child as a list)."""
        def one(v):
            if isinstance(v, Params):
                return v.tree()
            if isinstance(v, nn.ModuleList):
                return [one(m) for m in v]
            return v.data
        return {k: one(self[k]) for k in self.keys()}


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_specs(d):
    return {"scale": ParamSpec((d,), ("embed",), init="ones")}


def rmsnorm(params, x, eps=1e-6):
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * params["scale"]).to(x.dtype)


def nonparam_layernorm(x, eps=1e-5):
    """OLMo-style non-parametric LayerNorm (no learnable scale/bias)."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def make_norm(kind: str, d):
    """Returns (specs, apply(params, x))."""
    if kind == "rms":
        return rmsnorm_specs(d), rmsnorm
    if kind == "nonparam_ln":
        return {}, lambda p, x: nonparam_layernorm(x)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(dim: int, theta: float = 10000.0, device=None):
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta=10000.0):
    """x: [..., T, H, Dh]; positions: [..., T] (broadcastable)."""
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, x.device)  # [Dh/2]
    angles = positions[..., None].float() * freqs  # [..., T, Dh/2]
    cos = torch.cos(angles)[..., None, :]  # [..., T, 1, Dh/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embedding_specs(vocab, d):
    return {"embedding": ParamSpec((vocab, d), ("vocab", "embed"),
                                   init="embed", scale=0.02)}


def embed(params, tokens, vocab=None):
    """Token embeddings.  Where the table holds fewer than ``vocab`` rows
    it is the rank's vocab shard (tensor parallelism, ``launch.tp``):
    tokens outside the rank's range read 0 and the ranks' rows are
    summed, which is exact (one rank holds each token's row)."""
    w = params["embedding"]
    if vocab is None or not tp.sharded(w.shape[0], vocab):
        return F.embedding(tokens, w)
    lo, hi = tp.part(vocab)
    local = tokens - lo
    inside = (local >= 0) & (local < hi - lo)
    rows = F.embedding(local.clamp(0, hi - lo - 1), w)
    return tp.all_reduce_exact(torch.where(inside[..., None], rows,
                                           torch.zeros((), dtype=w.dtype,
                                                       device=w.device)))


def unembed(params, x):
    """Logits from the tied table; a vocab shard's give the rank's
    columns."""
    return torch.einsum("...d,vd->...v", x, params["embedding"])


def unembed_head_specs(vocab, d):
    return {"w": ParamSpec((d, vocab), ("embed", "vocab"))}


def unembed_head(params, x):
    return torch.einsum("...d,dv->...v", x, params["w"])


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def _chunk_step(xf, chunk, labels, off: int, m, s, gold):
    """One vocab chunk of the online logsumexp: the running (max,
    sumexp, gold logit) after ``chunk [vc, d]``'s logits."""
    vc = chunk.shape[0]
    logits_c = torch.einsum("btd,vd->btv", xf, chunk.float())
    m_new = torch.maximum(m, torch.amax(logits_c, dim=-1))
    s = s * torch.exp(m - m_new) + torch.sum(
        torch.exp(logits_c - m_new[..., None]), dim=-1)
    local = labels - off
    in_chunk = (local >= 0) & (local < vc)
    picked = torch.gather(logits_c, -1,
                          local.clamp(0, vc - 1)[..., None])[..., 0]
    return m_new, s, torch.where(in_chunk, picked, gold)


def softmax_xent_streamed(x, embedding, labels, n_chunks=8, vocab=None):
    """Fused unembed + cross-entropy, streamed over vocab chunks.

    Never materializes the [B, T, V] logits tensor: loops over
    V/n_chunks slices of the tied embedding, carrying the running (max,
    sumexp, gold logit) of an online logsumexp.  Each chunk runs under
    ``torch.utils.checkpoint``, so the backward pass recomputes its
    logits instead of storing them (the reference's ``jax.checkpoint``).

    x [B, T, d] final hidden states; embedding [V, d]; labels [B, T].
    Where ``embedding`` holds fewer than ``vocab`` rows it is the rank's
    vocab shard (tensor parallelism, ``launch.tp``): the shard is streamed
    in ``n_chunks`` chunks and the ranks' (max, sumexp, gold logit) are
    combined over the "model" axis (``_vocab_parallel_nll``).
    """
    v, d = embedding.shape
    if v % n_chunks:
        raise ValueError(f"vocab {v} is not a multiple of n_chunks "
                         f"{n_chunks}")
    shard = vocab is not None and tp.sharded(v, vocab)
    off = tp.part(vocab)[0] if shard else 0
    vc = v // n_chunks
    xf = (tp.enter(x) if shard else x).float()
    labels = labels.long()
    b, t = labels.shape
    m = torch.full((b, t), -torch.inf, dtype=torch.float32, device=x.device)
    s = torch.zeros((b, t), dtype=torch.float32, device=x.device)
    gold = torch.zeros((b, t), dtype=torch.float32, device=x.device)
    for c in range(n_chunks):
        m, s, gold = ckpt.checkpoint(
            _chunk_step, xf, embedding[c * vc:(c + 1) * vc], labels,
            off + c * vc, m, s, gold, use_reentrant=False)
    if shard:
        return torch.mean(_vocab_parallel_nll(m, s, gold))
    nll = m + torch.log(s) - gold
    return torch.mean(nll)


def _vocab_parallel_nll(m, s, gold):
    """The nll from each rank's (max, sumexp at that max, gold logit or 0)
    over its vocab columns: the max all-reduced over the "model" axis
    (outside autograd: the logsumexp does not depend on it), the sums of
    exponentials at that max and the gold logits (one rank holds each)
    all-reduced as replicated sums."""
    mx = tp.all_reduce_max(m)
    total = tp.all_reduce(s * torch.exp(m - mx))
    return mx + torch.log(total) - tp.all_reduce(gold)


def softmax_xent(logits, labels, mask=None, vocab=None):
    """Mean next-token cross entropy.  logits [..., V]; labels [...] int.
    Logits of fewer than ``vocab`` columns are the rank's vocab columns
    (tensor parallelism): the logsumexp and the gold logit are reduced
    over the "model" axis, and the [..., V] logits are never gathered."""
    logits = logits.float()
    labels = labels.long()
    if vocab is not None and tp.sharded(logits.shape[-1], vocab):
        lo, hi = tp.part(vocab)
        local = labels - lo
        inside = (local >= 0) & (local < hi - lo)
        picked = torch.gather(logits, -1,
                              local.clamp(0, hi - lo - 1)[..., None])[..., 0]
        m = torch.amax(logits, dim=-1)
        s = torch.sum(torch.exp(logits - m.detach()[..., None]), dim=-1)
        nll = _vocab_parallel_nll(m.detach(), s,
                                  torch.where(inside, picked, 0.0))
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        nll = logz - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
