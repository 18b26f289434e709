"""Step builders, the counterpart of ``src/repro/launch/steps.py``: the
solver train step (LT-ADMM-CC or any registered baseline), the
all-reduce DDP train step, ``build_prefill`` and ``build_serve`` for the
decoder-only models and the encoder-decoder (``arch_def.kind ==
"encdec"``; tensor-parallel over a mesh's "model" axis where
``tp_serving`` holds), and the training loop's ``DivergenceWatchdog``.

The agents run in one process through the host-simulated ``Exchange``,
or, given a ``DeviceMesh`` (``launch.mesh``), one rank's agent rows a
process over the mesh's agent axis; ``build_train`` then also returns
the reference's ``state_sharding`` tree and ``build_ddp_train`` its
TP/FSDP specs and an all-reduce of the gradients over "data".  Where
``tensor_parallel`` holds (the archs of ``tp_serving`` on a mesh whose
"model" axis has more than one rank), the per-leaf LT-ADMM-CC round
(``packed=false``) and the DDP step run tensor-parallel over "model" on
each rank's shard of the parameters and of every state leaf
(``sharding.shard_params(tree, mesh, "admm", specs, lead=1)`` cuts the
stacked x0; ``"serve"`` the DDP parameters), as the reference's GSPMD
partitions its step; the compressors run on the shards
(``compression.ShardedTree``).  FSDP over "data" (``launch.fsdp``)
applies where the reference's rules put "data" on the parameters: the
DDP step's mode "serve" shards, the served weights in mode "serve", and
the per-leaf LT-ADMM-CC round on the multi-pod mesh, where each agent
(a "pod") is FSDP+TP over its "data" x "model" ranks and holds its m/D
rows a rank (``FsdpRows``).  ``abstract_train_state`` gives the state's
``meta`` tree.

The model is differentiated by autograd, as the reference differentiates
through jnp: no kernel lies on the gradient path.  The solvers take
batched gradient callables (``core.vr``): params ``[A, ...]`` and token
rows ``[A, b, T+1]`` in, one gradient per agent out, each of the agent's
own mean loss over its rows (one forward and ``torch.autograd.grad`` per
agent, where the reference vmaps).  The batches are dicts, so the
encoder-decoder trains through ``build_train`` as it is, on
``{"src_embeds" [A, m, S, d], "tgt_tokens" [A, m, T+1]}``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import math

import torch

from repro_torch.common.trees import (is_namedtuple, meta_like,
                                      tree_children, tree_flatten, tree_map)
from repro_torch.core import compression, jaxrand, vr
from repro_torch.core.schedule import build_graph
from repro_torch.core.solver import (make_solver, parse_solver_spec,
                                     solver_entry)
from repro_torch.launch import fsdp
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import agent_axis_for, axes_of, use_mesh
from repro_torch.models import encdec
from repro_torch.models import transformer as tr
from repro_torch.models.common import abstract_params, is_spec
from repro_torch.optim import optimizers


def model_specs(arch_def, cfg):
    if arch_def.kind == "encdec":
        return encdec.model_specs(cfg)
    return tr.model_specs(cfg)


def model_loss(arch_def, cfg):
    """``loss(params, batch)``: the model's ``loss_fn`` on one batch."""
    if arch_def.kind == "encdec":
        return lambda p, b: encdec.loss_fn(p, cfg, b)
    return lambda p, b: tr.loss_fn(p, cfg, b)


def value_and_grad(loss, params, batch):
    """``(loss value, grads)`` of ``loss(params, batch)`` for a tree of
    tensors: each leaf enters as a detached view that requires grad (no
    copy), and a leaf the loss does not use gets a zero gradient, as
    ``jax.grad`` gives."""
    leaves, rebuild = tree_flatten(params)
    xs = [leaf.detach().requires_grad_() for leaf in leaves]
    with torch.enable_grad():
        val = loss(rebuild(xs), batch)
        gs = torch.autograd.grad(val, xs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(xs, gs)]
    return val.detach(), rebuild(grads)


def batched_grad(loss, one=None):
    """The per-agent gradient of ``loss`` as ``core.vr`` calls it:
    ``grad(params [A, ...], data [A, b, ...]) -> grads [A, ...]``, agent
    a's gradient of its own ``loss(params[a], data[a])`` (or ``one(params
    [a], data[a])``'s gradient tree), written into one ``[A, ...]`` tensor
    per leaf."""
    if one is None:
        def one(p, b):
            return value_and_grad(loss, p, b)[1]

    def grad(params, data):
        leaves, rebuild = tree_flatten(params)
        out = [torch.empty_like(leaf) for leaf in leaves]
        for a in range(leaves[0].shape[0]):
            g = one(rebuild([leaf[a] for leaf in leaves]),
                    tree_map(lambda d: d[a], data))
            for o, ga in zip(out, tree_flatten(g)[0]):
                o[a].copy_(ga)
        return rebuild(out)

    return grad


# ---------------------------------------------------------------------------
# Solver train step (LT-ADMM-CC + every registered baseline)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrainRecipe:
    """Transformer-scale solver defaults.

    gamma is much smaller than the convex-experiment value (0.3): L for a
    transformer loss is far larger.  batch_size counts sequences per inner
    step out of the agent's m_local.  Every field is a DEFAULT: params in
    the solver spec string given to ``build_train`` win.
    """

    rho: float = 0.1
    beta: float = 0.01
    gamma: float = 0.02
    r: float = 1.0
    eta: float = 1.0
    tau: int = 5
    batch_size: int = 4
    # compressor spec string ("qbit:bits=4", "randk:fraction=0.25,
    # sampler=block", ...); paper Fig. 2's default: the 8-bit quantizer
    compressor: str = "qbit"
    # agent graph spec, anything ``schedule.build_graph`` accepts: a
    # static family ("ring", "complete", "erdos:p=0.3", ...) or a
    # time-varying schedule ("cycle:ring|star", "drop:p=0.2,base=complete")
    topology: str = "ring"
    # the SVRG anchor's full gradient over m_local in this many
    # sequential microbatches (bounds the live activations; 1 = one pass)
    anchor_microbatches: int = 1

    def solver_defaults(self, solver_name: str) -> dict:
        """Fallback params for ``make_solver`` (spec params override;
        keys a solver does not accept are dropped there)."""
        if solver_name == "ltadmm":
            return {
                "rho": self.rho,
                "beta": self.beta,
                "gamma": self.gamma,
                "r": self.r,
                "eta": self.eta,
                "tau": self.tau,
                "batch_size": self.batch_size,
                "compressor": self.compressor,
            }
        return {
            "batch_size": self.batch_size,
            "compressor": self.compressor,
        }


def build_estimator(arch_def, cfg, recipe: TrainRecipe, kind: str,
                    rows=None):
    """Gradient estimator over the model loss: ``"vr"`` -> SVRG anchor
    (its full gradient optionally in microbatches over m_local, the mean
    of the chunk means as the reference's ``lax.map`` gives it),
    ``"sgd"`` -> plain minibatch gradients.  ``rows``: an ``FsdpRows``
    where each agent's rows are cut over the mesh's "data" axis (the
    minibatch gathered, the gradients reduced over the axis)."""
    if rows is not None:
        grad_fn, batch_fn = rows.grad(split=True), rows.batch_grad
        if kind != "vr":
            return vr.PlainSgd(batch_grad=batch_fn, take=rows.take,
                               row_shards=rows.size)
    else:
        grad_fn = batch_fn = batched_grad(model_loss(arch_def, cfg))
    if kind != "vr":
        return vr.PlainSgd(batch_grad=grad_fn)
    if recipe.anchor_microbatches > 1:
        nmb = recipe.anchor_microbatches

        def full_grad(params, data):
            m = tree_flatten(data)[0][0].shape[1]
            if m % nmb:
                raise ValueError(f"m_local {m} is not a multiple of "
                                 f"anchor_microbatches {nmb}")
            c = m // nmb
            grads = [grad_fn(params, tree_map(
                lambda x, i=i: x[:, i * c:(i + 1) * c], data))
                for i in range(nmb)]
            return tree_map(lambda *g: torch.mean(torch.stack(g), dim=0),
                            *grads)
    else:
        full_grad = grad_fn
    if rows is not None:
        return vr.SvrgAnchor(batch_grad=batch_fn, full_grad=full_grad,
                             take=rows.take, row_shards=rows.size)
    return vr.SvrgAnchor(batch_grad=grad_fn, full_grad=full_grad)


def data_grads(loss, params, batch, specs, size: int, split: bool):
    """``(loss value, grads)`` of a rank's ``loss(params, batch)`` under
    FSDP over the ambient mesh's "data" axis of ``size`` ranks
    (``specs``: the flat ``ParamSpec`` list of ``params``).  ``split``:
    the ranks' rows are disjoint equal shares of one batch, so the rank
    differentiates its mean over ``size`` (its rows' part of the batch's
    mean), a cut leaf's gradient is summed by its gather's
    reduce-scatter and a leaf that "data" does not cut is summed here;
    otherwise every rank runs the same rows and keeps its part of its
    own gradient (``fsdp.same_rows``)."""
    def scaled(p, b):
        val = loss(p, b)
        return val / size if split else val

    with fsdp.same_rows(not split):
        val, g = value_and_grad(scaled, params, batch)
    if split:
        leaves, rebuild = tree_flatten(g)
        g = rebuild([gl if fsdp.cut_dim(gl, sp) is not None
                     else fsdp.all_reduce(gl) for gl, sp in zip(leaves,
                                                               specs)])
    return val, g


class FsdpRows:
    """The gradients of an agent whose rows are cut over the mesh's
    "data" axis (``train_data_pspec`` on the multi-pod mesh: the rank's
    contiguous m/D of the agent's m_local) and whose parameters are its
    FSDP(+TP) shard.

    ``take`` gathers a minibatch drawn over the whole m_local
    (``fsdp.take_rows``).  ``batch_grad`` splits the minibatch's b rows:
    where "data" divides them each rank takes its contiguous share and
    differentiates its rows' token sum over the whole batch's count (its
    mean over D), the gathers' reduce-scatters and a sum over the axis of
    each leaf that "data" does not cut giving every rank the batch's
    gradient of its shard; where it does not (``sanitize_spec``'s rule),
    every rank computes the whole batch and keeps its part of it
    (``fsdp.same_rows``).  The anchor's full gradient runs on the rank's
    own rows, split.  Every rank runs every forward, rows of its own or
    not: the gathers are collectives."""

    def __init__(self, arch_def, cfg, mesh):
        self.mesh = mesh
        self.size = axes_of(mesh).shape[fsdp.AXIS]
        self.loss = model_loss(arch_def, cfg)
        self.specs = tree_flatten(model_specs(arch_def, cfg),
                                  is_leaf=is_spec)[0]

    def take(self, data, idx):
        with use_mesh(self.mesh):
            return fsdp.take_rows(data, idx)

    def grad(self, split: bool):
        """``grad(params [A, ...], rows [A, b', ...])``: each agent's
        gradient, its rows the rank's share (``split``) or the batch."""
        def one(params, data):
            with use_mesh(self.mesh):
                return data_grads(self.loss, params, data, self.specs,
                                  self.size, split)[1]

        return batched_grad(self.loss, one)

    def batch_grad(self, params, batch):
        b = tree_flatten(batch)[0][0].shape[1]
        if b % self.size:
            return self.grad(split=False)(params, batch)
        k = b // self.size
        r = self.mesh.get_local_rank(fsdp.AXIS)
        return self.grad(split=True)(params, tree_map(
            lambda t: t[:, r * k:(r + 1) * k], batch))


def build_train(arch_def, cfg, n_agents: int | None, solver_spec: str,
                recipe: TrainRecipe | None = None, device=None, mesh=None):
    """Train-step builder for ANY registered solver.

    Returns ``(step_fn, init_fn, solver)``: ``step_fn(state, data, seed)``
    advances one outer round under the key ``jaxrand.key(seed)``,
    ``init_fn(x0_stacked)`` builds the state from stacked ``[A, ...]``
    params, and ``solver`` carries the graph, config and accounting
    hooks.  The recipe supplies topology and hyperparameter defaults;
    params in ``solver_spec`` win.  The agents run in one process on
    ``device`` (default the card) through the host-simulated exchange.

    With a ``mesh``, the graph's exchange runs over its agent axis
    (``n_agents`` None: one agent a rank, the reference's layout), each
    rank's state and data hold its agent rows, and the return is
    ``(step_fn, state_sharding, init_fn, solver)`` as the reference's:
    ``state_sharding`` the state's ``PartitionSpec`` tree (the packed
    plane on the agent axis and replicated elsewhere; per-leaf TP specs
    on the pytree path).  LT-ADMM-CC on the pytree path
    (``packed=false``) runs tensor-parallel over the mesh's "model" axis
    where ``tensor_parallel`` holds: ``init_fn`` takes the rank's shard
    of the stacked params (``sharding.shard_params(x0, mesh, "admm",
    specs, lead=1)``), every state leaf is the rank's shard, the data
    rows are the same on every rank of the axis, the gradients and the
    compressors run on the shards and the exchange stays over the agent
    axis at the rank's "model" coordinate; ``solver.tp_layouts`` says
    where each shard lies (``admm.consensus_error`` takes them).  The
    packed plane stays replicated over "model", as in the reference.
    """
    recipe = recipe or TrainRecipe()
    aaxis = None if mesh is None else agent_axis_for(mesh)
    if n_agents is None:
        if mesh is None:
            raise ValueError("build_train needs n_agents or a mesh")
        n_agents = axes_of(mesh).shape[aaxis]
    graph, exchange = build_graph(recipe.topology, n_agents, axis=aaxis,
                                  mesh=mesh)
    entry = solver_entry(solver_spec)
    # the per-leaf LT-ADMM-CC round (packed=false) runs on the shards
    sharded_leaves = (mesh is not None and entry.name == "ltadmm"
                      and not compression.coerce_param(
                          parse_solver_spec(solver_spec)[1].get("packed",
                                                                True)))
    fsdp_on = sharded_leaves and fsdp_training(arch_def, cfg, mesh)
    est = build_estimator(arch_def, cfg, recipe, entry.estimator,
                          FsdpRows(arch_def, cfg, mesh) if fsdp_on else None)
    solver = make_solver(solver_spec, graph, exchange, est,
                         defaults=recipe.solver_defaults(entry.name),
                         device=device)

    if mesh is None:
        def step_fn(state, data, seed):
            return solver.step(state, data, jaxrand.key(seed))

        return step_fn, solver.init, solver
    tp_on = tensor_parallel(arch_def, cfg, mesh)
    if sharded_leaves and (tp_on or fsdp_on):
        layouts = tuple(shd.shard_layouts(mesh, "admm",
                                          model_specs(arch_def, cfg),
                                          model=tp_on))
        c = solver.cfg
        solver = dataclasses.replace(
            solver, tp_layouts=layouts, cfg=dataclasses.replace(
                c, compressor_x=compression.ShardedTree(c.compressor_x,
                                                        layouts),
                compressor_z=compression.ShardedTree(c.compressor_z,
                                                     layouts)))

    def step_fn(state, data, seed):
        # the estimator's tensor-parallel forward and the compressors
        # read the ambient mesh
        with use_mesh(mesh):
            return solver.step(state, data, jaxrand.key(seed))

    if getattr(solver, "packed", False):
        # the packed plane [A, N]: the agent axis, replicated elsewhere
        x_ps = shd.P(aaxis)
        edge_ps = shd.P(aaxis, None)
    else:
        pps = shd.param_pspec(mesh, "admm", model_specs(arch_def, cfg))
        x_ps = shd.prefix_pspec(pps, aaxis)  # [A, ...]
        edge_ps = shd.prefix_pspec(pps, aaxis, None)  # [A, S, ...]
    state_ps = solver.state_sharding(x_ps, edge_ps, shd.P())
    return step_fn, state_ps, solver.init, solver


def abstract_train_state(arch_def, cfg, solver):
    """The solver state's ``meta`` tree for stacked ``[A, ...]`` params of
    ``cfg`` (nothing is allocated)."""
    a = solver.graph.n_agents
    x_sds = tree_map(lambda t: meta_like((a,) + tuple(t.shape), t.dtype),
                     abstract_params(model_specs(arch_def, cfg), cfg.dtype))
    return solver.abstract_state(x_sds)


# ---------------------------------------------------------------------------
# All-reduce DDP baseline train step (what the paper's method replaces)
# ---------------------------------------------------------------------------


def build_ddp_train(arch_def, cfg, lr=1e-3, mesh=None, eps=1e-8):
    """Standard data-parallel Adam training step:
    ``step_fn(params, opt_state, batch, seed) -> (params, opt_state,
    loss)``; returns ``(step_fn, opt)``.  ``lr`` and ``eps`` are Adam's
    (the reference's ``optimizers.adam`` defaults).

    With a ``mesh`` each rank takes its equal share of the batch, and
    every rank applies the update of the whole batch.  The return is then
    ``(step_fn, pspecs, opt)``, ``pspecs`` the reference's TP + FSDP
    parameter specs (mode "serve").  ``params`` (and Adam's state) are
    the rank's shard, ``serve_shard(arch_def, cfg, tree, mesh)``: cut
    over "model" where ``tensor_parallel`` holds (the forward and
    backward run tensor-parallel) and over "data" (FSDP: the model
    gathers its weights where it uses them).  Each rank differentiates
    its rows' mean over the "data" size; a cut leaf's gradient reaches
    the rank summed by its gather's reduce-scatter, a leaf that "data"
    does not cut and the loss are summed over "data" (``data_grads``).
    Whole parameters train as before (each leaf's cut is read from its
    shape)."""
    loss = model_loss(arch_def, cfg)
    opt = optimizers.adam(lr, eps=eps)
    world = 1 if mesh is None else axes_of(mesh).shape["data"]
    specs = tree_flatten(model_specs(arch_def, cfg), is_leaf=is_spec)[0]
    ambient = (contextlib.nullcontext if mesh is None
               else functools.partial(use_mesh, mesh))

    def step_fn(params, opt_state, batch, seed):
        del seed
        with ambient():
            loss_val, grads = data_grads(loss, params, batch, specs, world,
                                         split=True)
            loss_val = fsdp.all_reduce(loss_val)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optimizers.apply_updates(params, updates)
        return params, opt_state, loss_val

    if mesh is None:
        return step_fn, opt
    return step_fn, shd.param_pspec(mesh, "serve",
                                    model_specs(arch_def, cfg)), opt


# ---------------------------------------------------------------------------
# Inference steps
# ---------------------------------------------------------------------------


# block kinds that run tensor-parallel over "model" (serving)
TP_KINDS = frozenset(("attn", "mamba"))


def tp_serving(arch_def, cfg) -> bool:
    """Whether the arch serves tensor-parallel over a mesh's "model" axis:
    the decoder-only models whose blocks are GQA + FFN or Mamba2 (with
    zamba2's shared block).  The MoE, MLA and xLSTM blocks and the
    encoder-decoder run whole on every rank (ROADMAP Queue 1)."""
    return (arch_def.kind == "lm" and set(cfg.pattern) <= TP_KINDS
            and not cfg.first_dense)


def _tp_size(mesh) -> int:
    return axes_of(mesh).shape.get(shd.TP_AXIS, 1)


def tensor_parallel(arch_def, cfg, mesh) -> bool:
    """Whether the arch runs tensor-parallel over ``mesh``'s "model" axis
    (``tp_serving``'s archs, an axis of more than one rank)."""
    return (mesh is not None and tp_serving(arch_def, cfg)
            and _tp_size(mesh) > 1)


def _data_size(mesh) -> int:
    return axes_of(mesh).shape.get(fsdp.AXIS, 1)


def fsdp_training(arch_def, cfg, mesh) -> bool:
    """Whether the per-leaf LT-ADMM-CC round runs FSDP over ``mesh``'s
    "data" axis: the multi-pod mesh (the agents on "pod", each agent's
    parameters and rows cut over its "data" ranks, as the reference's
    rules give them), ``tp_serving``'s archs, an axis of more than one
    rank.  The MoE, MLA and xLSTM archs train whole over "data" (ROADMAP
    Queue 1: their aux loss is not a mean over rows)."""
    return (mesh is not None and tp_serving(arch_def, cfg)
            and agent_axis_for(mesh) == "pod" and _data_size(mesh) > 1)


def _ambient(arch_def, cfg, mesh) -> bool:
    """Whether serving runs under ``mesh`` (``use_mesh``): a decoder-only
    model on a mesh whose "model" axis it runs tensor-parallel over or
    whose "data" axis may cut its weights (FSDP)."""
    return mesh is not None and arch_def.kind != "encdec" and (
        tensor_parallel(arch_def, cfg, mesh) or _data_size(mesh) > 1)


def serve_shard(arch_def, cfg, tree, mesh, mode: str = "serve"):
    """The rank's shard of the whole weights ``tree`` for serving in
    ``mode``: cut over "model" where ``tp_serving`` holds, and over
    "data" where ``mode``'s rules put it (FSDP; mode "serve" does,
    "serve_replicated" does not).  The encoder-decoder is held whole
    (its FSDP is ROADMAP Queue 1's)."""
    if arch_def.kind == "encdec":
        return tree
    return shd.shard_params(tree, mesh, mode, model_specs(arch_def, cfg),
                            model=tp_serving(arch_def, cfg))


def batch_rows(arch_def, cfg, mesh, n: int) -> tuple:
    """The rank's ``[lo, hi)`` of a served batch of ``n`` rows: its
    ``batch_pspec`` share over "data" where the axis divides ``n``, else
    every row.  An arch with MoE blocks serves every row on each rank:
    the experts' capacity, and so which tokens drop, is a function of the
    whole batch (the reference's GSPMD routes the global batch), so
    splitting the rows would change the outputs."""
    spec = shd.batch_pspec(mesh, (n, 1))
    if spec[0] is None or cfg.moe is not None:
        return 0, n
    k = n // _data_size(mesh)
    r = mesh.get_local_rank(fsdp.AXIS)
    return r * k, (r + 1) * k


def build_prefill(arch_def, cfg, mesh=None):
    """``prefill(params, batch) -> logits [B, 1, vocab]`` of the last
    position.  ``batch`` holds ``tokens [B, T]`` or ``embeds [B, T, d]``;
    for the encoder-decoder ``src_embeds [B, S, d]`` and ``tgt_tokens
    [B, T]``.  With ``cfg.use_flash`` the self-attention runs the flash
    kernel (K10).

    With a ``mesh``, where ``tp_serving`` holds, ``prefill`` runs
    tensor-parallel over the mesh's "model" axis on the rank's shard of
    the parameters (``serve_shard(arch_def, cfg, tree, mesh, mode)``)
    and gathers the last position's vocab columns; a decoder-only model
    on a mesh with a "data" axis runs FSDP, gathering its weights over
    the axis where the shard cuts them (mode "serve"), on the rank's
    batch rows (``batch_pspec``); otherwise it runs whole on the whole
    parameters, as without a mesh.  The reference's builder takes
    ``mode`` and returns ``(prefill, param_pspec(mesh, mode, specs))``
    for its jit; here the caller's shard is what applies ``mode``, and
    ``sharding.param_pspec`` gives the specs."""
    if arch_def.kind == "encdec":
        def prefill(params, batch):
            logits = encdec.forward(params, cfg, batch["src_embeds"],
                                    batch["tgt_tokens"])
            return logits[:, -1:, :]
    else:
        def prefill(params, batch):
            logits, _ = tr.forward(params, cfg, tokens=batch.get("tokens"),
                                   embeds=batch.get("embeds"))
            return tr.gather_vocab(cfg, logits[:, -1:, :])

    if not _ambient(arch_def, cfg, mesh):
        return prefill

    def tp_prefill(params, batch):
        with use_mesh(mesh):
            return prefill(params, batch)

    return tp_prefill


def build_serve(arch_def, cfg, mesh=None):
    """``(serve, init_cache)``: ``serve(params, cache, batch) -> (logits
    [B, 1, vocab], cache)`` decodes one token (``batch["token"] [B]`` at
    the int ``batch["pos"]``), updating ``cache`` in place.

    ``init_cache`` makes the zero cache.  Its signature follows the
    model: ``init_cache(batch_size, max_len, device)`` for the
    decoder-only models, ``init_cache(params, memory, max_len)`` for the
    encoder-decoder, whose cache holds the cross-attention K/V projected
    from the encoder's ``memory [B, S, d]`` (``encdec.encode``).

    With a ``mesh``: tensor-parallel as ``build_prefill`` says (and, as
    there, without the reference's ``mode`` and specs); ``init_cache``
    then makes the rank's cache (the KV heads it holds, as
    ``cache_pspec`` shards them, and its SSD heads and conv channels)."""
    if arch_def.kind == "encdec":
        def serve(params, cache, batch):
            return encdec.decode_step(params, cfg, cache, batch["token"],
                                      batch["pos"])

        def init_cache(params, memory, max_len):
            return encdec.init_cache(params, cfg, memory, max_len)

        return serve, init_cache

    tp_size = 1
    if mesh is not None and tp_serving(arch_def, cfg):
        tp_size = _tp_size(mesh)

    def serve(params, cache, batch):
        logits, cache = tr.decode_step(params, cfg, cache,
                                       token=batch["token"],
                                       pos=batch["pos"])
        return tr.gather_vocab(cfg, logits), cache

    def init_cache(batch_size, max_len, device=None):
        return tr.init_cache(cfg, batch_size, max_len, device, tp_size)

    if not _ambient(arch_def, cfg, mesh):
        return serve, init_cache

    def tp_serve(params, cache, batch):
        with use_mesh(mesh):
            return serve(params, cache, batch)

    return tp_serve, init_cache


def _snapshot(tree):
    """A copy of ``tree`` whose tensors are clones: an in-place update of
    the live state cannot reach it.  Other leaves (the round counter) are
    kept as they are."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    kids = tree_children(tree)
    if kids is None:
        return tree
    vals = [_snapshot(child) for _, child in kids]
    if is_namedtuple(tree):
        return type(tree)(*vals)
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), vals))
    if isinstance(tree, (list, tuple)):
        return type(tree)(vals)
    return type(tree)(**dict(zip(sorted(tree), vals)))


class DivergenceWatchdog:
    """Divergence detection and rollback to a ring of last-good snapshots
    (the reference's ``launch/steps.py`` watchdog).

    After every logged chunk the training loop reports ``(state,
    metric)``; a NaN or inf metric, or one beyond ``blowup`` times the
    best seen, marks the window poisoned and rolls the state back to the
    OLDEST snapshot in the ring.  Healthy states are snapshotted as clones, so the ring survives
    an in-place update of the live state.  Rollback does not rewind the
    round counter: with deterministic per-round keys, rewinding would
    replay the same divergence.  More than ``max_consecutive`` rollbacks
    without a healthy window in between raise."""

    def __init__(self, depth: int = 3, blowup: float = 1e4,
                 max_consecutive: int = 3):
        assert depth >= 1 and blowup > 1.0, (depth, blowup)
        self.blowup = float(blowup)
        self.max_consecutive = max_consecutive
        self._ring = collections.deque(maxlen=depth)
        self._best = math.inf
        self._consecutive = 0
        self.rollbacks = 0

    def _bad(self, m: float) -> bool:
        if not math.isfinite(m):
            return True
        return (math.isfinite(self._best)
                and m > self.blowup * max(self._best, 1e-12))

    def observe(self, state, metric):
        """-> ``(state, rolled_back)``: the input state (now snapshotted)
        when healthy, else a copy of the last-good rollback state."""
        m = float(metric)
        if not self._bad(m):
            self._best = min(self._best, m)
            self._ring.append(_snapshot(state))
            self._consecutive = 0
            return state, False
        self.rollbacks += 1
        self._consecutive += 1
        if not self._ring:
            raise RuntimeError(
                f"divergence (metric={m}) before any healthy snapshot")
        if self._consecutive > self.max_consecutive:
            raise RuntimeError(
                f"divergence watchdog: {self._consecutive} consecutive "
                f"rollbacks without re-stabilizing (metric={m})")
        # a copy: the caller may update it in place, and the ring entry
        # must survive for a possible second rollback
        return _snapshot(self._ring[0]), True
