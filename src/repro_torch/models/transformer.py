"""Decoder-only language model assembler, the counterpart of
``src/repro/models/transformer.py``.

A model is a stack of *units*; each unit is a short pattern of blocks
(``("attn",)`` for dense models, ``("mamba",)*6`` for Zamba2 with a shared
attention block applied after each unit, ``("mlstm",)*5 + ("slstm",)``
for xLSTM), after ``first_dense`` leading dense layers (DeepSeek's,
stacked as ``"first"``).  The reference stacks the units' parameters
along a leading axis and runs them under ``lax.scan``; here ``forward``
loops over the units.  It takes either

* the reference's tree itself (nested dicts of tensors, the units
  stacked; ``common.init_params`` draws it): each unit is a view of the
  stacked tensors, so gradients reach the stacked leaves in their own
  layout (training); or
* that tree as the port's modules (``model_params``: ``units`` a
  ``ModuleList`` of views, inference only, Mamba mixers as modules whose
  forward hooks see each block's input).

``cfg.remat`` runs each unit under ``torch.utils.checkpoint`` when
autograd records (``remat_policy="dots"`` keeps the outputs of the
products without batch dims, as jax's ``dots_with_no_batch_dims_saveable``
does); neither changes a value.

Block kinds:
    attn         pre-norm GQA attention + SwiGLU FFN (or parallel block)
    shared_attn  (Zamba2) one attention+FFN block whose parameters are
                 shared across all its invocations (after every unit)
    moe          pre-norm GQA attention + MoE FFN (+ shared experts)
    mla          pre-norm MLA attention + MoE FFN
    mla_dense    pre-norm MLA attention + dense FFN (DeepSeek first-k-dense)
    mamba        pre-norm Mamba2 (SSD) block
    mlstm, slstm xLSTM blocks (no separate FFN)
The encoder-decoder is ``models/encdec.py``.

Tensor parallelism (``launch.tp``, serving and training): given the rank's shard of
the parameters (``launch.sharding.shard_params``) under a mesh
(``launch.mesh.use_mesh``), the blocks of kinds attn, shared_attn and
mamba run over its "model" axis: the vocab-parallel embedding, GQA over
the rank's heads (``attention``), the SwiGLU FFN column-parallel in wg/wu
and row-parallel in wd (one sum over the axis; a parallel block sums its
attention's and FFN's partials at once), the Mamba mixer by SSD head
(``mamba``), and the logits of the rank's vocab columns, whose cross
entropy ``loss_fn`` reduces over the axis without gathering them.  Each
layer reads from its weights' shapes whether it holds a shard, so the
whole tree runs as before under any mesh.  The collectives carry their
backward (``launch.tp``), so ``torch.autograd.grad`` of the loss gives
each rank the gradient of its shard; a remat'd unit recomputes under the
mesh it ran under.

FSDP (``launch.fsdp``): where the rank holds its part of a parameter's
"embed" dim over the mesh's "data" axis (``sharding.shard_params`` in
mode "serve" or on the multi-pod mesh), the parameters are gathered at
their point of use and freed after: a unit's inside ``_unit_forward``
(so a remat'd unit gathers again in its backward and the whole unit is
never kept), each leading dense layer's, the shared block's a call, and
the embedding, ``final_norm`` and the head (or the tied table) once a
forward or decode step (``_outer_gathered``: one gather and one
reduce-scatter of the tied table).  The blocks see weights that are
whole over "data".
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as ckpt
from torch import nn

from repro_torch.launch import fsdp, tp
from repro_torch.launch.mesh import current_mesh, use_mesh
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.common import (
    ParamSpec,
    Params,
    embed,
    embedding_specs,
    make_norm,
    softmax_xent,
    softmax_xent_streamed,
    unembed,
    unembed_head,
    unembed_head_specs,
)

@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    vocab: int
    pattern: tuple = ("attn",)  # repeating unit of block kinds
    d_ff: int = 0  # dense FFN hidden size
    attn: Any = None  # AttnConfig
    mla: Any = None  # MLAConfig
    moe: Any = None  # MoEConfig
    ssm: Any = None  # SSMConfig
    lstm: Any = None  # XLSTMConfig
    norm: str = "rms"
    parallel_block: bool = False  # command-r style fused attn+ffn residual
    shared_attn: bool = False  # Zamba2 shared block after each unit
    first_dense: int = 0  # DeepSeek: leading dense layers
    d_ff_first: int = 0  # their FFN width
    tie_embeddings: bool = True
    dtype: Any = torch.float32
    remat: bool = True
    remat_policy: str = "full"  # full | dots (dots_with_no_batch_dims)
    use_flash: bool = False
    # >0: streamed fused unembed+xent over this many vocab chunks (never
    # materializes [B,T,V] logits); tied embeddings only
    xent_chunks: int = 0
    # VLM / audio stubs feed embeddings, not token ids
    inputs_via_embeds: bool = False

    @property
    def n_units(self) -> int:
        n = (self.n_layers - self.first_dense) // len(self.pattern)
        if n * len(self.pattern) + self.first_dense != self.n_layers:
            raise ValueError(f"n_layers {self.n_layers} must be first_dense "
                             f"+ k * len(pattern {self.pattern})")
        return n

    @property
    def first_kind(self) -> str:
        """The leading dense layers' block kind."""
        return "mla_dense" if self.mla else "attn"


# ---------------------------------------------------------------------------
# Block specs / forward / decode
# ---------------------------------------------------------------------------


def _ffn_specs(d, d_ff):
    return {
        "wg": ParamSpec((d, d_ff), ("embed", "ffn")),
        "wu": ParamSpec((d, d_ff), ("embed", "ffn")),
        "wd": ParamSpec((d_ff, d), ("ffn", "embed")),
    }


def _ffn_sharded(params, d_ff) -> bool:
    return d_ff is not None and tp.sharded(params["wg"].shape[-1], d_ff)


def _ffn(params, x, d_ff=None, reduce=True):
    """SwiGLU.  With the rank's ``d_ff`` columns (``d_ff`` the config's
    width) x enters the tensor-parallel region (``tp.enter``), wg and wu
    are column-parallel and wd row-parallel: its partial, summed over the
    "model" axis where ``reduce``."""
    sharded = _ffn_sharded(params, d_ff)
    if sharded:
        x = tp.enter(x)
    h = F.silu(torch.einsum("btd,df->btf", x, params["wg"]))
    h = h * torch.einsum("btd,df->btf", x, params["wu"])
    if not sharded:
        return torch.einsum("btf,fd->btd", h, params["wd"])
    y = tp.partial_mm(h, params["wd"])
    return tp.all_reduce(y, x.dtype) if reduce else y


def _parallel_sum(x, params, cfg: ModelConfig, a, h):
    """The parallel block's ``x + attention + FFN``; the attention's
    partial ``a`` (``reduce=False``) and the FFN's are summed over the
    "model" axis at once where both are partials."""
    a_part = attn_lib.heads_sharded(params["attn"], cfg.attn)
    f_part = _ffn_sharded(params["ffn"], cfg.d_ff)
    if not (a_part or f_part):
        return x + a + _ffn(params["ffn"], h)
    f = _ffn(params["ffn"], h, cfg.d_ff, reduce=False)
    if a_part and f_part:
        return x + tp.all_reduce(a + f, x.dtype)
    if a_part:
        return x + tp.all_reduce(a, x.dtype) + f
    return x + a + tp.all_reduce(f, x.dtype)


_KINDS = ("attn", "shared_attn", "moe", "mla", "mla_dense", "mamba", "mlstm",
          "slstm")
_MLA_KINDS = ("mla", "mla_dense")
_MOE_KINDS = ("moe", "mla")


def _check_kind(kind: str):
    if kind not in _KINDS:
        raise ValueError(kind)


def block_specs(cfg: ModelConfig, kind: str):
    _check_kind(kind)
    d = cfg.d_model
    norm_specs, _ = make_norm(cfg.norm, d)
    if kind == "mamba":
        return {"ln": dict(norm_specs), "mamba": mamba_lib.mamba_specs(cfg.ssm)}
    if kind == "mlstm":
        return {"ln": dict(norm_specs),
                "cell": xlstm_lib.mlstm_specs(cfg.lstm)}
    if kind == "slstm":
        return {"ln": dict(norm_specs),
                "cell": xlstm_lib.slstm_specs(cfg.lstm)}
    mla = kind in _MLA_KINDS
    specs = {"ln1": dict(norm_specs),
             "attn": (attn_lib.mla_specs(cfg.mla) if mla
                      else attn_lib.gqa_specs(cfg.attn))}
    if kind in _MOE_KINDS:
        specs["ln2"] = dict(norm_specs)
        specs["moe"] = moe_lib.moe_specs(cfg.moe)
        return specs
    if mla or not cfg.parallel_block:
        specs["ln2"] = dict(norm_specs)
    specs["ffn"] = _ffn_specs(d, cfg.d_ff_first if mla else cfg.d_ff)
    return specs


def block_forward(params, cfg: ModelConfig, kind: str, x, positions):
    """Full-sequence block application.  Returns (y, aux_loss)."""
    _check_kind(kind)
    _, norm = make_norm(cfg.norm, cfg.d_model)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "mamba":
        h = norm(params.get("ln", {}), x)
        mixer = params["mamba"]
        if isinstance(mixer, nn.Module):
            return x + mixer(h), aux
        return x + mamba_lib.mamba_forward(mixer, cfg.ssm, h), aux
    if kind in ("mlstm", "slstm"):
        fwd = (xlstm_lib.mlstm_forward if kind == "mlstm"
               else xlstm_lib.slstm_forward)
        h = norm(params.get("ln", {}), x)
        return x + fwd(params["cell"], cfg.lstm, h), aux
    h = norm(params.get("ln1", {}), x)
    parallel = cfg.parallel_block and kind in ("attn", "shared_attn")
    if kind in _MLA_KINDS:
        a = attn_lib.mla_forward(params["attn"], cfg.mla, h, positions)
    else:
        a = attn_lib.gqa_forward(params["attn"], cfg.attn, h, positions,
                                 use_flash=cfg.use_flash,
                                 reduce=not parallel)
    if parallel:
        return _parallel_sum(x, params, cfg, a, h), aux
    x = x + a
    h = norm(params.get("ln2", {}), x)
    if kind in _MOE_KINDS:
        y, aux = moe_lib.moe_forward(params["moe"], cfg.moe, h)
        return x + y, aux
    return x + _ffn(params["ffn"], h, _d_ff(cfg, kind)), aux


def _d_ff(cfg: ModelConfig, kind: str) -> int:
    return cfg.d_ff_first if kind in _MLA_KINDS else cfg.d_ff


def block_init_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     device=None, tp_size: int = 1):
    """The zero cache of one block; ``tp_size``: the "model" axis that
    the block's weights are sharded over (attn, shared_attn and mamba
    hold the rank's heads where it divides them)."""
    _check_kind(kind)
    if kind == "mamba":
        return mamba_lib.mamba_init_cache(
            cfg.ssm, batch, cfg.dtype, device,
            heads=tp.local_count(cfg.ssm.n_heads, tp_size))
    if kind == "mlstm":
        return xlstm_lib.mlstm_init_cache(cfg.lstm, batch, cfg.dtype, device)
    if kind == "slstm":
        return xlstm_lib.slstm_init_cache(cfg.lstm, batch, cfg.dtype, device)
    if kind in _MLA_KINDS:
        return attn_lib.mla_init_cache(cfg.mla, batch, max_len, cfg.dtype,
                                       device)
    kv = (tp.local_count(cfg.attn.n_kv_heads, tp_size)
          if kind in ("attn", "shared_attn") else None)
    return attn_lib.gqa_init_cache(cfg.attn, batch, max_len, cfg.dtype,
                                   device, kv_heads=kv)


def block_decode(params, cfg: ModelConfig, kind: str, cache, x, pos: int):
    _check_kind(kind)
    _, norm = make_norm(cfg.norm, cfg.d_model)
    if kind == "mamba":
        h = norm(params.get("ln", {}), x)
        y, cache = mamba_lib.mamba_decode(params["mamba"], cfg.ssm, cache, h,
                                          pos)
        return x + y, cache
    if kind in ("mlstm", "slstm"):
        decode = (xlstm_lib.mlstm_decode if kind == "mlstm"
                  else xlstm_lib.slstm_decode)
        h = norm(params.get("ln", {}), x)
        y, cache = decode(params["cell"], cfg.lstm, cache, h, pos)
        return x + y, cache
    h = norm(params.get("ln1", {}), x)
    parallel = cfg.parallel_block and kind in ("attn", "shared_attn")
    if kind in _MLA_KINDS:
        a, cache = attn_lib.mla_decode(params["attn"], cfg.mla, cache, h,
                                       pos)
    else:
        a, cache = attn_lib.gqa_decode(params["attn"], cfg.attn, cache, h,
                                       pos, reduce=not parallel)
    if parallel:
        return _parallel_sum(x, params, cfg, a, h), cache
    x = x + a
    h = norm(params.get("ln2", {}), x)
    if kind in _MOE_KINDS:
        return x + moe_lib.moe_forward(params["moe"], cfg.moe, h)[0], cache
    return x + _ffn(params["ffn"], h, _d_ff(cfg, kind)), cache


# ---------------------------------------------------------------------------
# Whole-model specs / params / forward / decode
# ---------------------------------------------------------------------------


def _stack_specs(specs, n):
    """Prepend a stacking axis of size n to every ParamSpec."""
    if isinstance(specs, ParamSpec):
        return ParamSpec((n,) + specs.shape, ("layers",) + specs.axes,
                         init=specs.init, scale=specs.scale)
    return {k: _stack_specs(v, n) for k, v in specs.items()}


def model_specs(cfg: ModelConfig):
    unit = {f"{i}_{kind}": block_specs(cfg, kind)
            for i, kind in enumerate(cfg.pattern)}
    specs = {
        "embed": embedding_specs(cfg.vocab, cfg.d_model),
        "units": _stack_specs(unit, cfg.n_units),
        "final_norm": make_norm(cfg.norm, cfg.d_model)[0],
    }
    if cfg.first_dense:
        specs["first"] = _stack_specs(block_specs(cfg, cfg.first_kind),
                                      cfg.first_dense)
    if cfg.shared_attn:
        specs["shared"] = block_specs(cfg, "shared_attn")
    if not cfg.tie_embeddings:
        specs["unembed"] = unembed_head_specs(cfg.vocab, cfg.d_model)
    return specs


def _block_module(cfg: ModelConfig, kind: str, tree) -> Params:
    if kind == "mamba":
        tree = {**tree, "mamba": mamba_lib.Mamba(cfg.ssm, tree["mamba"])}
    return Params(tree)


def _index(tree, u: int):
    if isinstance(tree, dict):
        return {k: _index(v, u) for k, v in tree.items()}
    return tree[u]


def model_params(cfg: ModelConfig, tree) -> Params:
    """The reference's parameter tree (nested dicts of tensors, the units
    stacked along a leading axis, as ``model_specs`` lays it out and
    ``common.init_params`` draws it) as the port's modules for inference:
    ``units`` a ``ModuleList`` with one ``Params`` per unit, and
    ``first`` one with a ``Params`` per leading dense layer, whose
    parameters are views of the stacked tensors (they do not require
    grad; ``forward`` takes the tree itself for training)."""
    top = {k: v for k, v in tree.items()
           if k not in ("units", "shared", "first")}
    if cfg.shared_attn:
        top["shared"] = _block_module(cfg, "shared_attn", tree["shared"])
    params = Params(top)
    params.add_module("units", nn.ModuleList(
        Params({name: _block_module(cfg, name.split("_", 1)[1],
                                    _index(blk, u))
                for name, blk in tree["units"].items()})
        for u in range(cfg.n_units)))
    if cfg.first_dense:
        params.add_module("first", nn.ModuleList(
            Params(_index(tree["first"], u)) for u in range(cfg.first_dense)))
    return params


def _layers(params, name: str, n: int):
    """Each stacked layer's parameters under ``name`` ("units" or
    "first"): the modules of ``model_params``, or views of the stacked
    tree's leaves."""
    if n == 0:
        return []
    layers = params[name]
    if isinstance(layers, nn.ModuleList):
        return list(layers)
    return [_index(layers, u) for u in range(n)]


@functools.lru_cache(maxsize=64)
def _part_specs(cfg: ModelConfig) -> dict:
    """The specs ``fsdp.gather_tree`` reads: a unit's, a leading dense
    layer's, the shared block's, and the top-level leaves'."""
    specs = model_specs(cfg)
    return {"unit": {f"{i}_{kind}": block_specs(cfg, kind)
                     for i, kind in enumerate(cfg.pattern)},
            "first": (block_specs(cfg, cfg.first_kind)
                      if cfg.first_dense else None),
            **{k: v for k, v in specs.items() if k not in ("units", "first")}}


def _gathered(cfg: ModelConfig, params, name: str, part=None):
    """``params[name]`` (or ``part``, laid out as ``name``'s specs) with
    its leaves cut over "data" gathered (``fsdp.gather_tree``); as it is
    without an ambient "data" axis."""
    node = params[name] if part is None else part
    if node is None or fsdp.mesh() is None:
        return node
    return fsdp.gather_tree(node, _part_specs(cfg)[name])


def _outer_gathered(cfg: ModelConfig, params):
    """``params`` with the leaves outside the layers (the embedding, the
    head and ``final_norm``) gathered over "data", once a forward or
    decode step: a tied table serves the lookup and the logits from one
    gather, and its gradient takes one reduce-scatter.  A gathered leaf
    is whole, so a later ``_gathered`` of it gathers nothing."""
    if fsdp.mesh() is None:
        return params
    out = {k: params[k] for k in params.keys()}
    for k in ("embed", "unembed", "final_norm"):
        if k in out:
            out[k] = _gathered(cfg, params, k)
    return out


def _unit_forward(cfg: ModelConfig, unit_params, shared_params, x,
                  positions):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    unit_params = _gathered(cfg, None, "unit", unit_params)
    for i, kind in enumerate(cfg.pattern):
        x, a = block_forward(unit_params[f"{i}_{kind}"], cfg, kind, x,
                             positions)
        aux = aux + a
    if cfg.shared_attn:
        x, a = block_forward(_gathered(cfg, None, "shared", shared_params),
                             cfg, "shared_attn", x, positions)
        aux = aux + a
    return x, aux


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat_policy="dots"``: keep the
    outputs of the products without batch dims (the einsums over [B, T,
    d] rows become ``mm``), recompute the rest."""
    del ctx, args, kwargs
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _under_mesh(mesh, rows, fn, *args):
    with use_mesh(mesh), fsdp.same_rows(rows):
        return fn(*args)


def _remat(cfg: ModelConfig, fn):
    """``fn`` under ``torch.utils.checkpoint`` when ``cfg.remat`` and
    autograd records; ``fn`` itself otherwise.  A config without
    ``remat_policy`` (the encoder-decoder's) rematerialises in full."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn
    mesh = current_mesh()
    if mesh is not None:
        # the recomputation in backward re-enters the forward's mesh and
        # FSDP rows mode (the autograd engine may run it on another thread)
        fn = functools.partial(_under_mesh, mesh, fsdp.rows_shared(), fn)
    kw = {}
    policy = getattr(cfg, "remat_policy", "full")
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)
    elif policy != "full":
        raise ValueError(f"remat_policy {policy!r}: full | dots")
    return functools.partial(ckpt.checkpoint, fn, use_reentrant=False, **kw)


def _logits(params, cfg: ModelConfig, x):
    """The logits, or the rank's vocab columns of them where the table
    (or head) is the rank's vocab shard (``gather_vocab`` joins them;
    ``softmax_xent`` takes them as they are), x entering the region.
    The table (or head) is gathered over "data" here (FSDP) unless the
    caller's ``_outer_gathered`` already did."""
    name = "embed" if cfg.tie_embeddings else "unembed"
    head = _gathered(cfg, params, name)
    w = head["embedding"] if cfg.tie_embeddings else head["w"]
    if tp.sharded(w.shape[0 if cfg.tie_embeddings else -1], cfg.vocab):
        x = tp.enter(x)
    if cfg.tie_embeddings:
        return unembed(head, x)
    return unembed_head(head, x)


def gather_vocab(cfg: ModelConfig, logits):
    """``logits [..., V]`` from the ranks' vocab columns (``_logits``
    under tensor parallelism), gathered over the "model" axis; logits
    that hold every column are returned as they are."""
    if logits.shape[-1] == cfg.vocab:
        return logits
    return tp.all_gather(logits, -1)


def forward(params, cfg: ModelConfig, tokens=None, embeds=None,
            positions=None, return_hidden=False):
    """Train / prefill forward.  Returns (logits [B, T, vocab] | hidden
    [B, T, d], aux_loss): aux is the f32 sum of the blocks' auxiliary
    losses (the MoE blocks' load balance; 0 without them).  On a rank's
    shard the logits are the rank's vocab columns (``gather_vocab``)."""
    params = _outer_gathered(cfg, params)
    if embeds is None:
        x = embed(_gathered(cfg, params, "embed"), tokens,
                  cfg.vocab).to(cfg.dtype)
    else:
        x = embeds.to(cfg.dtype)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    # the leading dense layers run without remat, as the reference's do
    for layer_p in _layers(params, "first", cfg.first_dense):
        x, aux = block_forward(_gathered(cfg, None, "first", layer_p), cfg,
                               cfg.first_kind, x, positions)
        aux_total = aux_total + aux
    shared = params.get("shared")
    for unit_p in _layers(params, "units", cfg.n_units):
        body = _remat(cfg, functools.partial(_unit_forward, cfg, unit_p,
                                             shared))
        x, aux = body(x, positions)
        aux_total = aux_total + aux
    _, norm = make_norm(cfg.norm, cfg.d_model)
    x = norm(_gathered(cfg, params, "final_norm"), x)
    if return_hidden:
        return x, aux_total
    return _logits(params, cfg, x), aux_total


def loss_fn(params, cfg: ModelConfig, batch):
    """batch: {"tokens": [B, T+1]} or {"embeds": [B, T, d], "labels":
    [B, T]}.  Mean next-token cross entropy plus the blocks' aux loss.
    On a rank's shard (tensor parallelism) the cross entropy runs over the
    rank's vocab columns, reduced over the "model" axis: the loss is the
    whole model's on every rank."""
    params = _outer_gathered(cfg, params)
    if cfg.xent_chunks and cfg.tie_embeddings:
        if "embeds" in batch:
            x, aux = forward(params, cfg, embeds=batch["embeds"],
                             return_hidden=True)
            labels = batch["labels"]
        else:
            x, aux = forward(params, cfg, tokens=batch["tokens"][:, :-1],
                             return_hidden=True)
            labels = batch["tokens"][:, 1:]
        table = _gathered(cfg, params, "embed")["embedding"]
        loss = softmax_xent_streamed(x, table, labels, cfg.xent_chunks,
                                     cfg.vocab)
        return loss + aux
    if "embeds" in batch:
        logits, aux = forward(params, cfg, embeds=batch["embeds"])
        loss = softmax_xent(logits, batch["labels"], vocab=cfg.vocab)
    else:
        tokens = batch["tokens"]
        logits, aux = forward(params, cfg, tokens=tokens[:, :-1])
        loss = softmax_xent(logits, tokens[:, 1:], vocab=cfg.vocab)
    return loss + aux


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None,
               tp_size: int = 1):
    """Zero decode caches: ``{"units": [per unit {block: cache}],
    "shared": [per unit shared-block cache] | None}``, and ``"first":
    [per leading dense layer cache]`` where the config has them.
    ``tp_size``: a rank's caches under tensor parallelism over a "model"
    axis of that size (``block_init_cache``)."""
    n = cfg.n_units
    cache = {
        "units": [{f"{i}_{kind}": block_init_cache(cfg, kind, batch, max_len,
                                                   device, tp_size)
                   for i, kind in enumerate(cfg.pattern)}
                  for _ in range(n)],
        "shared": ([block_init_cache(cfg, "shared_attn", batch, max_len,
                                     device, tp_size) for _ in range(n)]
                   if cfg.shared_attn else None),
    }
    if cfg.first_dense:
        cache["first"] = [block_init_cache(cfg, cfg.first_kind, batch,
                                           max_len, device)
                          for _ in range(cfg.first_dense)]
    return cache


def decode_step(params, cfg: ModelConfig, cache, token=None, embed_in=None,
                pos: int = 0):
    """One-token decode.  token [B] int or embed_in [B,1,d]; pos the
    (int) position.  Updates ``cache`` in place; returns (logits
    [B, 1, vocab], cache); on a rank's shard the rank's vocab columns
    (``gather_vocab``)."""
    params = _outer_gathered(cfg, params)
    if embed_in is None:
        x = embed(_gathered(cfg, params, "embed"), token[:, None],
                  cfg.vocab).to(cfg.dtype)
    else:
        x = embed_in.to(cfg.dtype)
    for i, layer_p in enumerate(_layers(params, "first", cfg.first_dense)):
        x, cache["first"][i] = block_decode(
            _gathered(cfg, None, "first", layer_p), cfg, cfg.first_kind,
            cache["first"][i], x, pos)
    shared = params.get("shared")
    if shared is not None:
        shared = _gathered(cfg, params, "shared")
    for u, unit_p in enumerate(_layers(params, "units", cfg.n_units)):
        unit_p = _gathered(cfg, None, "unit", unit_p)
        c = cache["units"][u]
        for i, kind in enumerate(cfg.pattern):
            key = f"{i}_{kind}"
            x, c[key] = block_decode(unit_p[key], cfg, kind, c[key], x, pos)
        if cfg.shared_attn:
            x, cache["shared"][u] = block_decode(
                shared, cfg, "shared_attn", cache["shared"][u], x, pos)
    _, norm = make_norm(cfg.norm, cfg.d_model)
    return _logits(params, cfg, norm(_gathered(cfg, params, "final_norm"),
                                     x)), cache
