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
(``compression.ShardedTree``).  FSDP over "data" is not applied.
``abstract_train_state`` gives the state's ``meta`` tree.

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
from repro_torch.core.solver import make_solver, solver_entry
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import agent_axis_for, axes_of, use_mesh
from repro_torch.models import encdec
from repro_torch.models import transformer as tr
from repro_torch.models.common import abstract_params
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


def batched_grad(loss):
    """The per-agent gradient of ``loss`` as ``core.vr`` calls it:
    ``grad(params [A, ...], data [A, b, ...]) -> grads [A, ...]``, agent
    a's gradient of its own ``loss(params[a], data[a])``, written into
    one ``[A, ...]`` tensor per leaf."""
    def grad(params, data):
        leaves, rebuild = tree_flatten(params)
        out = [torch.empty_like(leaf) for leaf in leaves]
        for a in range(leaves[0].shape[0]):
            _, g = value_and_grad(loss, rebuild([leaf[a] for leaf in leaves]),
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


def build_estimator(arch_def, cfg, recipe: TrainRecipe, kind: str):
    """Gradient estimator over the model loss: ``"vr"`` -> SVRG anchor
    (its full gradient optionally in microbatches over m_local, the mean
    of the chunk means as the reference's ``lax.map`` gives it),
    ``"sgd"`` -> plain minibatch gradients."""
    grad_fn = batched_grad(model_loss(arch_def, cfg))
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
    return vr.SvrgAnchor(batch_grad=grad_fn, full_grad=full_grad)


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
    est = build_estimator(arch_def, cfg, recipe, entry.estimator)
    solver = make_solver(solver_spec, graph, exchange, est,
                         defaults=recipe.solver_defaults(entry.name),
                         device=device)

    if mesh is None:
        def step_fn(state, data, seed):
            return solver.step(state, data, jaxrand.key(seed))

        return step_fn, solver.init, solver
    if (entry.name == "ltadmm" and not solver.packed
            and tensor_parallel(arch_def, cfg, mesh)):
        layouts = tuple(shd.shard_layouts(mesh, "admm",
                                          model_specs(arch_def, cfg)))
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

    With a ``mesh`` each rank takes its equal share of the batch; the
    loss and the gradients are averaged over the "data" axis (an
    ``all_reduce`` sum, then a division), so every rank applies the
    update of the whole batch.  The return is then ``(step_fn, pspecs,
    opt)``, ``pspecs`` the reference's TP + FSDP parameter specs (mode
    "serve").  Where ``tensor_parallel`` holds, ``params`` (and Adam's
    state) are the rank's shard over "model"
    (``sharding.shard_params(tree, mesh, "serve", specs)``): the forward
    and backward run tensor-parallel, each rank's gradients are its
    shard's, averaged over "data".  Otherwise, and always over "data"
    (FSDP, ROADMAP Queue 1), the parameters are whole on every rank."""
    loss = model_loss(arch_def, cfg)
    opt = optimizers.adam(lr, eps=eps)
    group = None if mesh is None else mesh.get_group("data")
    world = 1 if mesh is None else axes_of(mesh).shape["data"]
    ambient = (functools.partial(use_mesh, mesh)
               if tensor_parallel(arch_def, cfg, mesh)
               else contextlib.nullcontext)

    def mean_over_data(t):
        if group is not None:
            torch.distributed.all_reduce(t, group=group)
            t.div_(world)
        return t

    def step_fn(params, opt_state, batch, seed):
        del seed
        with ambient():
            loss_val, grads = value_and_grad(loss, params, batch)
        grads = tree_map(mean_over_data, grads)
        loss_val = mean_over_data(loss_val)
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


def build_prefill(arch_def, cfg, mesh=None):
    """``prefill(params, batch) -> logits [B, 1, vocab]`` of the last
    position.  ``batch`` holds ``tokens [B, T]`` or ``embeds [B, T, d]``;
    for the encoder-decoder ``src_embeds [B, S, d]`` and ``tgt_tokens
    [B, T]``.  With ``cfg.use_flash`` the self-attention runs the flash
    kernel (K10).

    With a ``mesh``, where ``tp_serving`` holds, ``prefill`` runs
    tensor-parallel over the mesh's "model" axis on the rank's shard of
    the parameters (``sharding.shard_params(tree, mesh, mode, specs)``)
    and gathers the last position's vocab columns; otherwise it runs
    whole on the whole parameters, as without a mesh.  The reference's
    builder takes ``mode`` and returns ``(prefill, param_pspec(mesh,
    mode, specs))`` for its jit; here the caller's ``shard_params`` is
    what applies ``mode``, and ``sharding.param_pspec`` gives the specs."""
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

    if (mesh is None or not tp_serving(arch_def, cfg)
            or _tp_size(mesh) == 1):
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

    if tp_size == 1:
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
