"""Checks of the mesh path, one process per rank (the counterpart of the
reference's ``tests/_distributed_check.py`` and
``tests/_topology_spmd_check.py``).

Every check takes a ``DeviceMesh`` and the rank's device, runs the mesh
path and the one-process path on the same inputs, and raises unless the
rank's rows of the two agree bit for bit.  It returns the rank's rows
(numpy) for a caller that holds them against something else, such as the
reference's run.  ``tests/test_torch_mesh.py`` runs ``suite`` in a gloo
world of 8 CPU ranks on a ``(4 data, 2 model)`` mesh; ``chip_smoke.py``
runs the LT-ADMM-CC, gossip and dada checks in a one-rank NCCL world on
the card.  Run
the gloo world with ``pytest tests/test_torch_mesh.py``.

``tp_suite`` (``CHECKS["tp"]``) serves the smoke configs of the archs
that run tensor-parallel (``steps.tp_serving``) over the "model" axis of
two meshes of the same world, ``(W / 2, 2)`` and ``(1, W)``: prefill and
greedy decode on the rank's shard of numpy-seeded weights
(``tp_weights``), returning the gathered logits, the tokens, the rank's
parameter leaves and its cache shapes for the caller to hold against the
reference; ``tests/test_torch_tp.py`` runs it in a gloo world of 4 CPU
ranks.

``tp_train_suite`` (``CHECKS["tp_train"]``) trains the smoke configs of
``TP_TRAIN_ARCHS`` tensor-parallel over the same two meshes (all of them
on the ``(1, W)`` one, ``TP_TRAIN_ARCHS_2D`` on the other): each rank's
gradients of ``loss_fn`` (gathered), the qbit8 / qbit4 payloads of every
leaf cut over "model" (K4's shard form, plain on the CPU), one
``ltadmm:packed=false`` round of ``build_train`` (the state gathered)
and a ``build_ddp_train`` step (held against the one-rank step here);
``tests/test_torch_tp_train.py`` holds the rest against the reference
and the port's one-rank round.

``fsdp_suite`` (``CHECKS["fsdp"]``) serves ``FSDP_SERVE_ARCHS`` FSDP
over "data" (and TP over "model" where ``tp_serving`` holds) on the
``(W / 2, 2)`` and ``(W, 1)`` meshes, each rank on its batch rows, runs
the mode "serve" DDP step and counts the gathers;
``fsdp_train_suite`` (``CHECKS["fsdp_train"]``) takes a ``("pod",
"data", "model")`` mesh (``start_world(..., pods=2)``): the
``FsdpRows`` gradients, the two-axis payloads and one multi-pod round.
``tests/test_torch_fsdp.py`` and ``tests/test_torch_fsdp_train.py`` hold
them against the reference.

``start_world`` starts a world of ``torch.multiprocessing`` processes
that meet at a ``FileStore`` (no TCP port) and runs one named check on
every rank; ``collect_world`` waits for them and returns each rank's
result.
"""
from __future__ import annotations

import functools
import os
import pickle

import numpy as np
import torch

from repro_torch.common.trees import dict_paths, tree_flatten, tree_map
from repro_torch.core import admm
from repro_torch.core import schedule as sched_mod
from repro_torch.core import topology as topo_mod
from repro_torch.core import vr
from repro_torch.core.schedule import union_topology
from repro_torch.core.solver import make_solver, solver_entry
from repro_torch.core.topology import Exchange
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import axes_of, make_host_mesh, use_mesh, world
from repro_torch.models import attention
from repro_torch.problems.logistic import LogisticProblem

QBIT8 = "ltadmm:tau=3,compressor=qbit:bits=8,impl=kernel"
RANDK_STRIDE = ("ltadmm:tau=3,eta=0.5,compressor=randk:fraction=0.6,"
                "sampler=stride,impl=kernel")
FAULTS = ",faults=faults:drop=0.1|corrupt=0.1|stale=0.1|crash=0.05|seed=0"

# LT-ADMM-CC + SAGA (n = 6, m = 20, tau = 3) on the graphs of the
# reference's SPMD checks: (graph recipe, agents, rounds, spec)
ADMM_CASES = {
    "star": (("star",), 4, 3, QBIT8),
    "cycle": (("cycle", "ring", "star"), 4, 4, QBIT8),
    "churn": (("churn", "complete", 0.3, 1, 4), 4, 4, QBIT8),
    "ring8": (("ring",), 8, 3, QBIT8),
    "randk": (("ring",), 4, 1, RANDK_STRIDE),
    "faults": (("churn", "complete", 0.3, 1, 4), 4, 4, QBIT8 + FAULTS),
}
# cases run wrapped in the telemetry counters (every counter compared)
TELEMETRY_CASES = ("faults",)
EXCHANGE_GRAPHS = {"ring": ("ring",), "star": ("star",),
                   "complete": ("complete",), "erdos": ("erdos", 0.5, 0)}
PROBLEM = dict(n=6, m=20)
# the gossip baselines and dada (plain SGD, n = 6, m = 20): (graph spec,
# agents, rounds, spec); every state leaf bit-equal to the host path's
_Q8 = "compressor=qbit:bits=8,impl=kernel"
GOSSIP_CASES = {
    "dsgd": ("ring", 4, 3, "dsgd"),
    "choco": ("ring", 4, 3, f"choco:{_Q8}"),
    "lead": ("ring", 4, 3, f"lead:{_Q8}"),
    "cold": ("ring", 4, 3, "cold:compressor=randk:fraction=0.5,impl=kernel"),
    "cedas": ("ring", 4, 3, "cedas:compressor=qbit:bits=4,impl=kernel"),
    "dpdc": ("ring", 4, 3, "dpdc:compressor=topk:fraction=0.5,impl=kernel"),
    "choco-tree-drop": ("drop:p=0.3,base=complete", 4, 3,
                        f"choco:packed=false,{_Q8}"),
    "lead-faults": ("ring", 4, 3,
                    f"lead:{_Q8},faults=faults:drop=0.2|crash=0.1|seed=0"),
    "dada": ("complete", 4, 3, "dada:"),
}
# tensor-parallel serving: the archs (``steps.tp_serving``), the prompt
# (batch, length) and the greedy steps
TP_ARCHS = ("qwen3-0.6b", "qwen2-1.5b", "olmo-1b", "command-r-plus-104b",
            "pixtral-12b", "zamba2-2.7b")
TP_BATCH, TP_PROMPT, TP_STEPS = 2, 8, 4
# sequence-sharded attention cases: (T, window)
ATTN_CASES = ((64, None), (64, 20), (66, None), (66, 20))
ATTN_SHAPE = dict(b=2, h=4, kh=2, dh=8)


def make_graph(recipe, n_agents: int):
    """A graph from a recipe tuple: a static family name (with
    ``erdos``'s p and seed), ``("cycle", name, name)`` or ``("churn",
    base, p, seed, period)``."""
    kind = recipe[0]
    static = {"ring": topo_mod.Ring, "star": topo_mod.Star,
              "complete": topo_mod.Complete}
    if kind in static:
        return static[kind](n_agents)
    if kind == "erdos":
        return topo_mod.ErdosRenyi(n_agents, p=recipe[1], seed=recipe[2])
    if kind == "cycle":
        return sched_mod.cycle_schedule(
            [static[n](n_agents) for n in recipe[1:]])
    if kind == "churn":
        _, base, p, seed, period = recipe
        return sched_mod.churn_schedule(static[base](n_agents), p=p,
                                        seed=seed, period=period)
    raise ValueError(f"unknown graph recipe {recipe!r}")


def _equal(name, got, want):
    if got.dtype != want.dtype or got.shape != want.shape \
            or not torch.equal(got, want):
        diff = ((got.double() - want.double()).abs().max().item()
                if got.shape == want.shape else "shape")
        raise AssertionError(f"{name}: mesh rows differ from the host rows "
                             f"(max |diff| {diff})")


def _numpy(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# The exchange primitive
# ---------------------------------------------------------------------------


def exchange_inputs(n_agents: int, seed: int = 0, kinds: bool = False):
    """The f32 ``[A, 6, 8]`` messages of ``check_exchange`` (numpy), and
    with ``kinds`` also its int8 ``[A, 6]`` and bool ``[A]`` leaves."""
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(n_agents, 6, 8)).astype(np.float32)
    if not kinds:
        return x
    return x, rng.randint(-128, 128, (n_agents, 6), np.int8), \
        rng.rand(n_agents) < 0.5


def check_exchange(mesh, device, recipe, axis="data", seed=0):
    """``gather_from_neighbors``, ``gather_batched`` and
    ``exchange_batched`` over a 4-agent graph: f32, int8 and bool leaves,
    masked slots included; returns the routed f32 rows."""
    topo = make_graph(recipe, 4)
    host, ex = Exchange(topo), Exchange(topo, axis=axis, mesh=mesh)
    rows = slice(ex.rows.start, ex.rows.stop)
    s = topo.n_slots
    tree = {k: torch.from_numpy(v).to(device) for k, v in zip(
        ("x", "q", "ok"), exchange_inputs(topo.n_agents, seed, kinds=True))}
    edge = tree_map(lambda t: torch.stack(
        [t + s_ if t.dtype != torch.bool else t ^ bool(s_ % 2)
         for s_ in range(s)], dim=1), tree)
    local = tree_map(lambda t: t[rows], tree)
    local_edge = tree_map(lambda t: t[rows], edge)
    out = {}
    for s_, (g, w) in enumerate(zip(ex.gather_from_neighbors(local),
                                    host.gather_from_neighbors(tree))):
        for k in g:
            _equal(f"gather_from_neighbors slot {s_} {k}", g[k], w[k][rows])
    for name, got, want in (
            ("gather_batched", ex.gather_batched(local),
             host.gather_batched(tree)),
            ("exchange_batched", ex.exchange_batched(local_edge),
             host.exchange_batched(edge))):
        for k in got:
            _equal(f"{name} {k}", got[k], want[k][rows])
        out[name] = _numpy(got["x"])
    out["rows"] = (ex.rows.start, ex.rows.stop)
    return out


# ---------------------------------------------------------------------------
# LT-ADMM-CC rounds
# ---------------------------------------------------------------------------


def admm_pair(spec, graph, mesh, device, axis="data", problem=None,
              wrap=False):
    """``(host solver, mesh solver, problem)``: ``spec`` with SAGA, on
    ``graph`` through the host exchange and through ``mesh``'s axis
    (both wrapped in the telemetry counters with ``wrap``)."""
    from repro_torch.obs.telemetry import with_telemetry

    prob = problem or LogisticProblem(n_agents=graph.n_agents, **PROBLEM)
    est = vr.SagaTable(sample_grads=prob.sample_grads, m=prob.m)
    union = union_topology(graph)
    host = make_solver(spec, graph, Exchange(union), est, device=device)
    on_mesh = make_solver(spec, graph, Exchange(union, axis=axis, mesh=mesh),
                          est, device=device)
    if wrap:
        host, on_mesh = with_telemetry(host), with_telemetry(on_mesh)
    return host, on_mesh, prob


def state_leaves(state) -> dict:
    """``{field: tensor}`` of a solver state, a named tuple or a gossip
    solver's dict (None fields and the counter left out; a pytree field's
    leaves as ``field[i]``)."""
    items = state.items() if isinstance(state, dict) else zip(
        state._fields, state)
    out = {}
    for f, v in items:
        if isinstance(v, torch.Tensor):
            out[f] = v
        elif isinstance(v, (dict, list, tuple)):
            for i, t in enumerate(tree_flatten(v)[0]):
                out[f"{f}[{i}]"] = t
    return out


def compare_telemetry(name, got, want, rows):
    """Every telemetry counter of the mesh run equals the host run's: the
    per-agent vectors at the rank's rows, the scalars whole."""
    for f, g in zip(got._fields, got):
        w = getattr(want, f)
        _equal(f"{name}.telemetry.{f}", g,
               w[rows.start:rows.stop] if w.dim() else w)


def compare_states(name, mesh_state, host_state, rows):
    """Every state leaf of the mesh run equals the host run's rows, bit
    for bit, and the round counters agree (a telemetry-wrapped state's
    counters too)."""
    if hasattr(mesh_state, "telemetry"):
        compare_telemetry(name, mesh_state.telemetry, host_state.telemetry,
                          rows)
        mesh_state, host_state = mesh_state.inner, host_state.inner
    k_m, k_h = (st["k"] if isinstance(st, dict) else st.k
                for st in (mesh_state, host_state))
    if k_m != k_h:
        raise AssertionError(f"{name}: round {k_m} against {k_h}")
    host = state_leaves(host_state)
    got = state_leaves(mesh_state)
    if got.keys() != host.keys():
        raise AssertionError(f"{name}: fields {sorted(got)} against "
                             f"{sorted(host)}")
    for f in got:
        _equal(f"{name}.{f}", got[f], host[f][rows.start:rows.stop])


def run_rounds(solver, state, data, rounds: int, first_key: int = 100):
    """``rounds`` rounds under the keys ``key(first_key + i)``, as the
    reference's SPMD checks step."""
    from repro_torch.core import jaxrand

    for i in range(rounds):
        state = solver.step(state, data, jaxrand.key(first_key + i))
    return state


def check_admm(mesh, device, case, data_np, x0_np, axis="data"):
    """One ``ADMM_CASES`` case on the mesh and on the host from the same
    data and x0 (numpy, all agents): every state leaf bit-equal; returns
    the rank's state rows, wire bytes and rows."""
    recipe, n_agents, rounds, spec = ADMM_CASES[case]
    graph = make_graph(recipe, n_agents)
    host, on_mesh, _ = admm_pair(spec, graph, mesh, device, axis,
                                 wrap=case in TELEMETRY_CASES)
    rows = on_mesh.exchange.rows
    data = {k: torch.from_numpy(v).to(device) for k, v in data_np.items()}
    x0 = torch.from_numpy(x0_np).to(device)
    st_h = run_rounds(host, host.init(x0), data, rounds)
    st_m = run_rounds(on_mesh, on_mesh.init(x0[rows.start:rows.stop]),
                      {k: v[rows.start:rows.stop] for k, v in data.items()},
                      rounds)
    compare_states(case, st_m, st_h, rows)
    inner_m, inner_h = (getattr(st, "inner", st) for st in (st_m, st_h))
    for fn in (admm.consensus_mean, admm.consensus_error):
        # global over the agent axis: one all_reduce, sums reassociated
        torch.testing.assert_close(fn(inner_m, on_mesh.exchange),
                                   fn(inner_h), rtol=1e-5, atol=1e-6)
    params = np.zeros((PROBLEM["n"],), np.float32)
    if on_mesh.wire_bytes(params) != host.wire_bytes(params):
        raise AssertionError(f"{case}: wire bytes differ")
    inner = getattr(st_m, "inner", st_m)
    return {"rows": (rows.start, rows.stop),
            "state": {f: _numpy(v) for f, v in state_leaves(inner).items()},
            "wire_bytes": on_mesh.wire_bytes(params)}


# ---------------------------------------------------------------------------
# The gossip baselines and dada
# ---------------------------------------------------------------------------


def gossip_inputs(n_agents: int, seed: int = 1):
    """The logistic problem's data ``{"a" [A, m, n], "b" [A, m]}`` (labels
    +-1) and x0 ``[A, n]``, numpy, from seeds."""
    n, m = PROBLEM["n"], PROBLEM["m"]
    rng = np.random.RandomState(seed)
    data = {"a": rng.normal(size=(n_agents, m, n)).astype(np.float32),
            "b": np.where(rng.rand(n_agents, m) < 0.5, 1.0, -1.0).astype(
                np.float32)}
    x0 = np.random.RandomState(seed + 1).normal(
        size=(n_agents, n)).astype(np.float32)
    return data, x0


def check_gossip(mesh, device, case, axis="data"):
    """One ``GOSSIP_CASES`` case through ``mesh``'s axis and through the
    host exchange from the same data and x0: every state leaf bit-equal
    after its rounds.  Returns the rank's rows, its state rows and the
    host state (numpy)."""
    from repro_torch.core.schedule import build_graph

    gspec, n_agents, rounds, spec = GOSSIP_CASES[case]
    prob = LogisticProblem(n_agents=n_agents, **PROBLEM)
    est = vr.PlainSgd(batch_grad=prob.batch_grad)
    hg, hex_ = build_graph(gspec, n_agents)
    mg, mex = build_graph(gspec, n_agents, axis=axis, mesh=mesh)
    host = make_solver(spec, hg, hex_, est, device=device)
    on_mesh = make_solver(spec, mg, mex, est, device=device)
    rows = mex.rows
    data_np, x0_np = gossip_inputs(n_agents)
    data = {k: torch.from_numpy(v).to(device) for k, v in data_np.items()}
    x0 = torch.from_numpy(x0_np).to(device)
    st_h = run_rounds(host, host.init(x0), data, rounds)
    st_m = run_rounds(
        on_mesh, on_mesh.init(tree_map(lambda t: t[rows.start:rows.stop],
                                       x0)),
        {k: v[rows.start:rows.stop] for k, v in data.items()}, rounds)
    compare_states(case, st_m, st_h, rows)
    return {"rows": (rows.start, rows.stop),
            **{name: {f: _numpy(v) for f, v in state_leaves(st).items()}
               for name, st in (("state", st_m), ("host", st_h))}}


def paper_solver(mesh, device, spec, gspec, axis="data"):
    """The paper's problem (``LogisticProblem()``: N = 10, n = 5, m = 100;
    SAGA for LT-ADMM-CC, plain SGD for the solvers registered with the
    "sgd" estimator) and ``spec``'s solver on the graph ``gspec``,
    through ``mesh``'s axis (the host exchange when ``mesh`` is None)."""
    from repro_torch.core.schedule import build_graph

    prob = LogisticProblem()
    graph, ex = build_graph(gspec, prob.n_agents,
                            axis=None if mesh is None else axis, mesh=mesh)
    est = (vr.SagaTable(sample_grads=prob.sample_grads, m=prob.m)
           if solver_entry(spec).estimator == "vr"
           else vr.PlainSgd(batch_grad=prob.batch_grad))
    return prob, make_solver(spec, graph, ex, est, device=device)


def paper_run(mesh, device, spec, gspec, rounds, axis="data"):
    """``paper_solver``'s run on ``make_data(0)`` for ``rounds`` rounds.
    Returns the sampled metric, the wire bytes, the rank's rows and its
    final state rows (numpy)."""
    from repro_torch.bench import run_solver

    prob, solver = paper_solver(mesh, device, spec, gspec, axis)
    ex = solver.exchange
    idx, gns, st = run_solver(prob, prob.make_data(0), solver, rounds,
                              return_state=True)
    return {"idx": idx, "gns": gns, "rows": (ex.rows.start, ex.rows.stop),
            "wire_bytes": solver.wire_bytes(
                {"x": np.zeros(prob.n, np.float32)}),
            "state": {f: _numpy(v) for f, v in state_leaves(st).items()}}


# ---------------------------------------------------------------------------
# shard_like and sequence-sharded attention
# ---------------------------------------------------------------------------

SHARD_TREE = {"a": ((8, 6), ("data", "model")),
              "b": ((4, 2, 3), (None, "model", None)),
              "c": ((8, 4), (("data", "model"), None)),
              "d": ((5,), (None,))}


def check_shard_like(mesh, device):
    """``distribute_tensor`` with ``shard_like``'s placements gives every
    rank the slice its spec names."""
    from torch.distributed.tensor import distribute_tensor

    specs = {k: shd.P(*axes) for k, (_, axes) in SHARD_TREE.items()}
    placements = shd.shard_like(mesh, specs)
    sizes = axes_of(mesh).shape
    for k, (shape, axes) in SHARD_TREE.items():
        full = torch.arange(float(np.prod(shape))).reshape(shape).to(device)
        local = distribute_tensor(full, mesh, placements[k]).to_local()
        want = full
        for dim, ax in enumerate(axes):
            ax = () if ax is None else (ax if isinstance(ax, tuple)
                                        else (ax,))
            n, pos = 1, 0
            for a in ax:
                pos = pos * sizes[a] + mesh.get_local_rank(a)
                n *= sizes[a]
            c = shape[dim] // n
            want = want.narrow(dim, pos * c, c)
        _equal(f"shard_like {k}", local, want)
    return {"placements": {k: repr(v) for k, v in placements.items()}}


def attention_inputs(t: int, seed: int = 0):
    """f32 ``q [B, T, H, Dh]``, ``k``/``v [B, T, KH, Dh]`` from a seed."""
    rng = np.random.RandomState(seed + t)
    b, h, kh, dh = (ATTN_SHAPE[k] for k in ("b", "h", "kh", "dh"))
    return tuple(rng.normal(size=(b, t, n, dh)).astype(np.float32)
                 for n in (h, kh, kh))


def check_attention(mesh, device, axis="data"):
    """Sequence-sharded blockwise attention over ``axis`` (causal, with
    and without a window; T divisible by the axis and not) within 1e-5
    relative of the unsharded ``sdpa_blockwise``; also once through
    ``gqa_forward`` with ``seq_shard_axis``.  Returns the outputs."""
    out = {}
    with use_mesh(mesh):
        for t, window in ATTN_CASES:
            q, k, v = (torch.from_numpy(a).to(device)
                       for a in attention_inputs(t))
            got = attention._seq_sharded_blockwise(
                q, k, v, causal=True, window=window, axis=axis)
            want = attention.sdpa_blockwise(q, k, v, causal=True,
                                            window=window)
            torch.testing.assert_close(
                got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())
            out[(t, window)] = _numpy(got)
        d, h, kh, dh = 16, ATTN_SHAPE["h"], ATTN_SHAPE["kh"], \
            ATTN_SHAPE["dh"]
        cfg = attention.AttnConfig(d, h, kh, dh, seq_shard_axis=axis)
        rng = np.random.RandomState(1)
        params = {n: torch.from_numpy(
            (rng.normal(size=s) / 4).astype(np.float32)).to(device)
            for n, s in (("wq", (d, h, dh)), ("wk", (d, kh, dh)),
                         ("wv", (d, kh, dh)), ("wo", (h, dh, d)))}
        x = torch.from_numpy(rng.normal(size=(2, 64, d)).astype(
            np.float32)).to(device)
        pos = torch.arange(64, device=device)[None].expand(2, 64)
        got = attention.gqa_forward(params, cfg, x, pos, impl="blockwise")
    want = attention.gqa_forward(
        params, attention.AttnConfig(d, h, kh, dh), x, pos,
        impl="blockwise")
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())
    return out


def check_ddp(mesh, device, arch_id="qwen3-0.6b", per_rank=2, t=16):
    """``build_ddp_train`` with the mesh: each "data" rank steps on its
    ``per_rank`` sequences; the averaged loss and Adam's first moment (a
    tenth of the averaged gradient) lie within 1e-5 of one process's
    step on the whole batch.  Returns the loss."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.launch import steps
    from repro_torch.models.common import abstract_params

    arch = ARCHS[arch_id]
    cfg = dataclasses.replace(arch.make_smoke(), dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)  # the same weights on every rank
    params = tree_map(
        lambda t: (torch.randn(t.shape, generator=gen) / 8).to(device),
        abstract_params(steps.model_specs(arch, cfg)))
    w, p = axes_of(mesh).shape["data"], mesh.get_local_rank("data")
    tokens = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab, (per_rank * w, t + 1))).to(device)
    step, _, opt = steps.build_ddp_train(arch, cfg, mesh=mesh)
    _, st, loss = step(params, opt.init(params),
                       {"tokens": tokens[p * per_rank:(p + 1) * per_rank]},
                       0)
    one_step, one_opt = steps.build_ddp_train(arch, cfg)
    _, want, want_loss = one_step(params, one_opt.init(params),
                                  {"tokens": tokens}, 0)
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=1e-6)
    for g, r in zip(tree_flatten(st["m"])[0], tree_flatten(want["m"])[0]):
        torch.testing.assert_close(g, r, rtol=1e-5,
                                   atol=1e-5 * r.abs().max().item())
    return float(loss)


# ---------------------------------------------------------------------------
# The whole suite, and the world around it
# ---------------------------------------------------------------------------


def suite(mesh, device, admm_inputs):
    """Every check on one rank: the exchanges over the four graphs, the
    ``ADMM_CASES`` (``admm_inputs[case] = (data, x0)`` numpy), shard_like,
    the attention and the DDP step.  Returns the rank's results."""
    import time

    seconds = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t0
        return out

    return {"rank": torch.distributed.get_rank(),
            "coords": tuple(mesh.get_coordinate()),
            "exchange": timed("exchange", lambda: {
                n: check_exchange(mesh, device, r)
                for n, r in EXCHANGE_GRAPHS.items()}),
            "admm": timed("admm", lambda: {
                c: check_admm(mesh, device, c, *admm_inputs[c])
                for c in ADMM_CASES}),
            "gossip": timed("gossip", lambda: {
                c: check_gossip(mesh, device, c) for c in GOSSIP_CASES}),
            "shard_like": timed("shard_like",
                                lambda: check_shard_like(mesh, device)),
            "attention": timed("attention",
                               lambda: check_attention(mesh, device)),
            "ddp_loss": timed("ddp", lambda: check_ddp(mesh, device)),
            "seconds": seconds}


# ---------------------------------------------------------------------------
# Tensor-parallel serving
# ---------------------------------------------------------------------------


def tp_weights(arch_id: str, seed: int = 0) -> dict:
    """The smoke config's weights as a numpy tree (the reference's layout,
    units stacked), f32 from a seeded ``RandomState``: fan-in scaled
    normals, and the norms, biases and Mamba scalars perturbed around
    their initial values, so every leaf is exercised.  A fresh copy of
    each call (the draw is made once a process)."""
    return tree_map(np.copy, _tp_weights(arch_id, seed))


@functools.lru_cache(maxsize=None)
def _tp_weights(arch_id: str, seed: int) -> dict:
    from repro_torch.configs import ARCHS
    from repro_torch.launch import steps
    from repro_torch.models.common import _map_specs

    arch = ARCHS[arch_id]
    cfg = arch.make_smoke()
    rng = np.random.RandomState(seed)

    def draw(spec):
        dims = [d for d, a in zip(spec.shape, spec.axes) if a != "layers"]
        fan_in = dims[0] if len(dims) > 1 else (dims[-1] if dims else 1)
        z = rng.normal(size=spec.shape).astype(np.float32)
        if spec.init == "ones":
            return 1.0 + 0.1 * z
        if spec.init == "zeros":
            return 0.1 * z
        scale = spec.scale if spec.init == "embed" else (
            spec.scale / np.sqrt(max(fan_in, 1)))
        return (z * np.float32(scale)).astype(np.float32)

    return _map_specs(draw, steps.model_specs(arch, cfg))


def tp_inputs(arch_id: str, seed: int = 1) -> dict:
    """The prefill's ``tokens [B, P]`` (or ``embeds [B, P, d]`` where the
    arch takes embeddings) and the first decoded token ``[B]``, numpy."""
    from repro_torch.configs import ARCHS

    cfg = ARCHS[arch_id].make_smoke()
    rng = np.random.RandomState(seed)
    out = {"first": rng.randint(0, cfg.vocab, (TP_BATCH,))}
    if cfg.inputs_via_embeds:
        out["embeds"] = rng.normal(size=(TP_BATCH, TP_PROMPT, cfg.d_model)
                                   ).astype(np.float32)
    else:
        out["tokens"] = rng.randint(0, cfg.vocab, (TP_BATCH, TP_PROMPT))
    return out


def check_tp(mesh, device, arch_id: str):
    """One arch's smoke config served tensor-parallel over ``mesh``'s
    "model" axis in f32: the prefill's gathered last logits and
    ``TP_STEPS`` greedy decode steps from ``tp_inputs``' first token, on
    the rank's shard of ``tp_weights``.  Raises unless every rank of the
    axis decodes the same tokens.  Returns the logits, tokens, the rank's
    parameter leaves and cache shapes (numpy)."""
    from repro_torch.checkpoint.reference import params_tree_from_reference
    from repro_torch.configs import ARCHS
    from repro_torch.launch import steps

    arch = ARCHS[arch_id]
    cfg = arch.make_smoke()
    specs = steps.model_specs(arch, cfg)
    shard = shd.shard_params(params_tree_from_reference(
        tp_weights(arch_id), device), mesh, "serve", specs)
    inp = tp_inputs(arch_id)
    batch = {k: torch.from_numpy(v).to(device) for k, v in inp.items()
             if k != "first"}
    prefill = steps.build_prefill(arch, cfg, mesh)
    serve, init_cache = steps.build_serve(arch, cfg, mesh)
    with torch.no_grad():
        last = prefill(shard, batch)
        cache = init_cache(TP_BATCH, TP_STEPS, device)
        tok = torch.from_numpy(inp["first"]).to(device)
        logits, tokens = [], []
        for pos in range(TP_STEPS):
            lg, cache = serve(shard, cache, {"token": tok, "pos": pos})
            tok = torch.argmax(lg[:, 0], dim=-1)
            logits.append(_numpy(lg))
            tokens.append(_numpy(tok))
    tokens = np.stack(tokens, axis=1)
    group = mesh.get_group("model")
    seen = [None] * axes_of(mesh).shape["model"]
    torch.distributed.all_gather_object(seen, tokens.tolist(), group=group)
    if any(t != tokens.tolist() for t in seen):
        raise AssertionError(f"{arch_id}: the ranks decode different tokens")
    flat_cache = {}
    for u, unit in enumerate(cache["units"]):
        for name, c in unit.items():
            for k, v in c.items():
                flat_cache[f"units.{u}.{name}.{k}"] = tuple(v.shape)
    for u, c in enumerate(cache["shared"] or []):
        for k, v in c.items():
            flat_cache[f"shared.{u}.{k}"] = tuple(v.shape)
    return {"prefill": _numpy(last), "decode": np.stack(logits, axis=1),
            "tokens": tokens,
            "params": {k: _numpy(v) for k, v in dict_paths(shard).items()},
            "cache": flat_cache}


def tp_suite(mesh, device, archs=TP_ARCHS):
    """``check_tp`` of each arch over ``mesh`` (``(W / 2, 2)``) and over
    a ``(1, W)`` mesh of the same world.  Returns ``{model size: {arch:
    result}}`` with the rank's coordinates."""
    torch.backends.cuda.matmul.allow_tf32 = False
    world_size = torch.distributed.get_world_size()
    out = {"rank": torch.distributed.get_rank()}
    for m in (mesh, make_host_mesh(world_size, model=world_size)):
        n = axes_of(m).shape["model"]
        out[n] = {"coords": tuple(m.get_coordinate()),
                  "model_rank": m.get_local_rank("model"),
                  **{a: check_tp(m, device, a) for a in archs}}
    return out


# ---------------------------------------------------------------------------
# Tensor-parallel training
# ---------------------------------------------------------------------------

# qwen3 (its 2 KV heads whole on a 4-way axis), zamba2 (Mamba pieces),
# command-r (the parallel block) and pixtral (untied head, embeds)
TP_TRAIN_ARCHS = ("qwen3-0.6b", "zamba2-2.7b", "command-r-plus-104b",
                  "pixtral-12b")
# those of them on the (W / 2, 2) mesh: the agents' rows split over "data"
# beside a 2-way "model" axis, through attention, Mamba and the untied
# head (command-r's parallel block is held on the (1, W) mesh)
TP_TRAIN_ARCHS_2D = ("qwen3-0.6b", "zamba2-2.7b", "pixtral-12b")
# the batch of the gradient check (B, T), the round's agents, sequences an
# agent, sequence length, and the round's spec
TP_GRAD_BATCH, TP_GRAD_T = 2, 8
TP_AGENTS, TP_M, TP_T = 2, 4, 8
TP_ROUND = ("ltadmm:packed=false,tau=2,batch_size=2,"
            "compressor=qbit:bits=8,impl=kernel")
TP_RECIPE = dict(topology="complete", gamma=0.05)
TP_PAYLOAD_KEY = 5  # leaf i's key: fold_in(key(5), i)
TP_DDP_TOL = 1e-5


def tp_batch(arch_id: str, b: int, t: int, seed: int, lead=()) -> dict:
    """A training batch of ``b`` sequences of ``t`` tokens (numpy, with
    ``lead`` dims in front): ``tokens [..., b, t + 1]``, or ``embeds
    [..., b, t, d]`` and ``labels [..., b, t]`` where the arch takes
    embeddings."""
    from repro_torch.configs import ARCHS

    cfg = ARCHS[arch_id].make_smoke()
    rng = np.random.RandomState(seed)
    lead = tuple(lead)
    if cfg.inputs_via_embeds:
        return {"embeds": rng.normal(size=lead + (b, t, cfg.d_model))
                .astype(np.float32),
                "labels": rng.randint(0, cfg.vocab, lead + (b, t))}
    return {"tokens": rng.randint(0, cfg.vocab, lead + (b, t + 1))}


def tp_round_inputs(arch_id: str):
    """The round's x0 (``[A, ...]`` numpy tree: agent a's weights are
    ``tp_weights(arch, a)``) and data (``[A, m, ...]``)."""
    ws = [tp_weights(arch_id, a) for a in range(TP_AGENTS)]
    x0 = tree_map(lambda *t: np.stack(t), *ws)
    return x0, tp_batch(arch_id, TP_M, TP_T, 7, (TP_AGENTS,))


def tp_recipe():
    from repro_torch.launch import steps

    return steps.TrainRecipe(**TP_RECIPE)


def _tensors(tree, device):
    return tree_map(lambda a: torch.from_numpy(np.asarray(a)).to(device),
                    tree)


def check_tp_grads(mesh, device, arch_id, remat=False):
    """``loss_fn``'s value and gradients on the rank's shard of
    ``tp_weights`` under the mesh, the gradients gathered (numpy);
    ``remat``: each unit under ``torch.utils.checkpoint``, whose backward
    issues the unit's forward collectives again."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.launch import steps

    arch = ARCHS[arch_id]
    cfg = dataclasses.replace(arch.make_smoke(), remat=remat)
    specs = steps.model_specs(arch, cfg)
    shard = shd.shard_params(_tensors(tp_weights(arch_id), device), mesh,
                             "admm", specs)
    batch = _tensors(tp_batch(arch_id, TP_GRAD_BATCH, TP_GRAD_T, 3), device)
    with use_mesh(mesh):
        val, grads = steps.value_and_grad(steps.model_loss(arch, cfg), shard,
                                          batch)
    whole = shd.gather_shards(grads, mesh, "admm", specs)
    return {"loss": float(val),
            "grads": {k: _numpy(v) for k, v in dict_paths(whole).items()}}


def check_tp_payloads(mesh, device, arch_id):
    """Every leaf cut over "model" through K4's shard form (qbit8 and
    qbit4, the kernel route; and qbit8 on the torch route, ``"torch"``)
    under the key ``fold_in(key(5), i)``: the rank's levels (unpacked)
    and scale, and each level's flat index in the whole leaf.  A leaf
    held whole is left out."""
    from repro_torch.configs import ARCHS
    from repro_torch.core import compression, jaxrand
    from repro_torch.kernels.quantize import ref as qref
    from repro_torch.launch import steps

    arch = ARCHS[arch_id]
    specs = steps.model_specs(arch, arch.make_smoke())
    shard = shd.shard_params(_tensors(tp_weights(arch_id), device), mesh,
                             "admm", specs)
    leaves = tree_flatten(shard)[0]
    names = list(dict_paths(shard))
    layouts = shd.shard_layouts(mesh, "admm", specs)
    out = {}
    with use_mesh(mesh):
        for i, (name, x, lay) in enumerate(zip(names, leaves, layouts)):
            if not lay.cut:
                continue
            key = jaxrand.fold_in(jaxrand.key(TP_PAYLOAD_KEY), i)[None]
            got = {"index": _numpy(lay.counters(x.device))}
            for bits, impl in ((8, "kernel"), (4, "kernel"), (8, "torch")):
                comp = compression.BBitQuantizer(bits=bits, impl=impl)
                p = compression.ShardLeaf(comp, lay).compress(
                    key, x.reshape(1, -1).float())
                q = p["q"][0]
                lv = q if bits == 8 else qref.unpack4(q, x.numel())
                got[bits if impl == "kernel" else impl] = (
                    _numpy(lv.to(torch.int8)), float(p["scale"][0]))
            out[name] = got
    return out


def check_tp_round(mesh, device, arch_id):
    """One ``TP_ROUND`` round of ``build_train`` with the mesh on the
    rank's agent rows and shard of ``tp_round_inputs`` (on the multi-pod
    mesh an agent a pod, FSDP+TP, its m rows cut over "data": each rank
    its contiguous m / D): the state gathered (numpy), the minibatch
    indices each local step drew, the consensus error, the wire bytes
    and the bytes the rank handed to the exchange."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.core import admm as admm_mod
    from repro_torch.core import compression, jaxrand
    from repro_torch.launch import steps

    arch = ARCHS[arch_id]
    cfg = arch.make_smoke()
    specs = steps.model_specs(arch, cfg)
    _, _, init, solver = steps.build_train(
        arch, cfg, TP_AGENTS, TP_ROUND, tp_recipe(), device=device,
        mesh=mesh)
    drawn, est = [], solver.grad_est

    def take(data, idx):
        drawn.append(_numpy(idx))
        return est.take(data, idx)

    solver = dataclasses.replace(
        solver, grad_est=dataclasses.replace(est, take=take))
    rows = solver.exchange.rows
    x0_np, data_np = tp_round_inputs(arch_id)
    x0 = shd.shard_params(_tensors(tree_map(
        lambda a: a[rows.start:rows.stop], x0_np), device), mesh, "admm",
        specs, lead=1)
    mine = slice(None)
    if steps.fsdp_training(arch, cfg, mesh):
        k = TP_M // axes_of(mesh).shape["data"]
        r = mesh.get_local_rank("data")
        mine = slice(r * k, (r + 1) * k)
    data = _tensors(tree_map(lambda a: a[rows.start:rows.stop, mine],
                             data_np), device)
    with use_mesh(mesh):
        st = solver.step(init(x0), data, jaxrand.key(11))
    out = {"rows": (rows.start, rows.stop), "k": st.k, "drawn": drawn,
           "row_shards": est.row_shards,
           "axes": solver.tp_layouts and compression.cut_axes(
               solver.tp_layouts, mesh)}
    for f in st._fields:
        v = getattr(st, f)
        if isinstance(v, dict):
            whole = shd.gather_shards(v, mesh, "admm", specs,
                                      lead=admm_mod.STATE_LEAD[f])
            out[f] = {k: _numpy(t) for k, t in dict_paths(whole).items()}
    with use_mesh(mesh):
        out["consensus_error"] = float(admm_mod.consensus_error(
            st, solver.exchange, solver.tp_layouts))
    out["wire_bytes"] = solver.wire_bytes(x0)
    out["exchange_bytes"] = solver.exchange.collectives["bytes"]
    out["tp_layouts"] = solver.tp_layouts is not None
    return out


def check_tp_ddp(mesh, device, arch_id):
    """A ``build_ddp_train`` step on the rank's shard (mode "serve") and
    its share of the batch within ``TP_DDP_TOL`` of one process's step on
    the whole weights and batch, cut to the rank's shard: the loss and
    Adam's two moments (the averaged gradient and its square).  Returns
    the largest gaps relative to each leaf's scale, and the new
    parameters' (not held: Adam's first step is g / (|g| + eps), which
    turns a reassociated gradient near eps into an update a good part of
    lr apart)."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch import steps

    arch = ARCHS[arch_id]
    cfg = arch.make_smoke()
    specs = steps.model_specs(arch, cfg)
    w = axes_of(mesh).shape["data"]
    p = mesh.get_local_rank("data")
    batch = _tensors(tp_batch(arch_id, 2 * w, TP_GRAD_T, 4), device)
    mine = tree_map(lambda t: t[2 * p:2 * p + 2], batch)
    shard = shd.shard_params(_tensors(tp_weights(arch_id), device), mesh,
                             "serve", specs)
    step, _, opt = steps.build_ddp_train(arch, cfg, mesh=mesh)
    params, st, loss = step(shard, opt.init(shard), mine, 0)
    one_step, one_opt = steps.build_ddp_train(arch, cfg)
    whole = _tensors(tp_weights(arch_id), device)
    want_p, want, want_loss = one_step(whole, one_opt.init(whole), batch, 0)
    gaps = {"loss": abs(float(loss) - float(want_loss))
            / max(abs(float(want_loss)), 1e-30)}
    for name, got_t, ref_t in (("m", st["m"], want["m"]),
                               ("v", st["v"], want["v"]),
                               ("params", params, want_p)):
        # each leaf's scale is the whole leaf's
        scales = [float(r.abs().max()) for r in tree_flatten(ref_t)[0]]
        ref_t = shd.shard_params(ref_t, mesh, "serve", specs)
        g_l, r_l = tree_flatten(got_t)[0], tree_flatten(ref_t)[0]
        gaps[name] = max(float((g - r).abs().max()) / max(sc, 1e-30)
                         for g, r, sc in zip(g_l, r_l, scales))
    # v is the gradient squared: twice its relative gap
    if max(gaps["loss"], gaps["m"], gaps["v"] / 2) > TP_DDP_TOL:
        raise AssertionError(f"{arch_id}: the tensor-parallel DDP step "
                             f"lies {gaps} from the one-rank step")
    return gaps


def check_tp_randk(mesh, device):
    """RandK on a cut leaf raises ``NotImplementedError`` at the round."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch import steps

    arch = ARCHS["qwen3-0.6b"]
    cfg = arch.make_smoke()
    step, _, init, solver = steps.build_train(
        arch, cfg, TP_AGENTS, "ltadmm:packed=false,tau=1,batch_size=2,"
        "compressor=randk:fraction=0.5", tp_recipe(), device=device,
        mesh=mesh)
    rows = solver.exchange.rows
    x0_np, data_np = tp_round_inputs("qwen3-0.6b")
    x0 = shd.shard_params(_tensors(tree_map(
        lambda a: a[rows.start:rows.stop], x0_np), device), mesh, "admm",
        steps.model_specs(arch, cfg), lead=1)
    data = _tensors(tree_map(lambda a: a[rows.start:rows.stop], data_np),
                    device)
    try:
        step(init(x0), data, 11)
    except NotImplementedError as e:
        return str(e)
    raise AssertionError("RandK on a leaf cut over 'model' did not raise")


def tp_train_suite(mesh, device):
    """The tensor-parallel training checks of ``TP_TRAIN_ARCHS_2D`` over
    ``mesh`` (``(W / 2, 2)``) and of ``TP_TRAIN_ARCHS`` over a ``(1, W)``
    mesh of the same world.  Returns ``{model size: {arch: {...}}}`` with
    the rank's coordinates."""
    import time

    torch.backends.cuda.matmul.allow_tf32 = False
    world_size = torch.distributed.get_world_size()
    out = {"rank": torch.distributed.get_rank(), "seconds": {}}
    for m, archs in ((mesh, TP_TRAIN_ARCHS_2D),
                     (make_host_mesh(world_size, model=world_size),
                      TP_TRAIN_ARCHS)):
        n = axes_of(m).shape["model"]
        res = {"coords": tuple(m.get_coordinate()),
               "model_rank": m.get_local_rank("model"),
               "remat": check_tp_grads(m, device, archs[0], remat=True)}
        for a in archs:
            t0 = time.perf_counter()
            res[a] = {"grads": check_tp_grads(m, device, a),
                      "payloads": check_tp_payloads(m, device, a),
                      "round": check_tp_round(m, device, a),
                      "ddp": check_tp_ddp(m, device, a)}
            out["seconds"][f"{a} model{n}"] = time.perf_counter() - t0
        res["randk"] = check_tp_randk(m, device)
        out[n] = res
    return out


# ---------------------------------------------------------------------------
# FSDP over "data"
# ---------------------------------------------------------------------------

# the archs served FSDP: the six tensor-parallel ones (FSDP+TP) and the
# MoE, MLA and xLSTM ones, whose blocks run whole over "model"
FSDP_SERVE_ARCHS = TP_ARCHS + ("granite-moe-1b-a400m", "deepseek-v2-lite-16b",
                               "xlstm-125m")
# the served batch (every data axis of the 4-rank world divides it)
FSDP_BATCH = 4
# the multi-pod round's mesh (pod, data, model) and its gradient batches:
# 4 rows (split over "data") and 3 (every rank the whole batch)
FSDP_PODS = 2
FSDP_GRAD_ROWS = (4, 3)


def fsdp_inputs(arch_id: str, seed: int = 1) -> dict:
    """``tp_inputs`` at ``FSDP_BATCH`` rows."""
    from repro_torch.configs import ARCHS

    cfg = ARCHS[arch_id].make_smoke()
    rng = np.random.RandomState(seed)
    out = {"first": rng.randint(0, cfg.vocab, (FSDP_BATCH,))}
    if cfg.inputs_via_embeds:
        out["embeds"] = rng.normal(
            size=(FSDP_BATCH, TP_PROMPT, cfg.d_model)).astype(np.float32)
    else:
        out["tokens"] = rng.randint(0, cfg.vocab, (FSDP_BATCH, TP_PROMPT))
    return out


def check_fsdp_serve(mesh, device, arch_id: str):
    """One arch's smoke config served FSDP over ``mesh``'s "data" axis
    (and tensor-parallel over "model" where ``tp_serving`` holds), mode
    "serve", in f32, on the rank's batch rows of ``fsdp_inputs``
    (``steps.batch_rows``): the
    prefill's last logits and ``TP_STEPS`` greedy decode steps.  Returns
    them with the rank's rows, its parameter leaves, whether
    ``gather_shards`` gives the whole weights back, and the prefill's
    gathers (``fsdp.stats``)."""
    from repro_torch.checkpoint.reference import params_tree_from_reference
    from repro_torch.configs import ARCHS
    from repro_torch.launch import fsdp, steps

    arch = ARCHS[arch_id]
    cfg = arch.make_smoke()
    specs = steps.model_specs(arch, cfg)
    shard = steps.serve_shard(arch, cfg, params_tree_from_reference(
        tp_weights(arch_id), device), mesh)
    back = shd.gather_shards(shard, mesh, "serve", specs,
                             model=steps.tp_serving(arch, cfg))
    inverse = all(torch.equal(a, torch.from_numpy(b).to(device))
                  for a, b in zip(tree_flatten(back)[0],
                                  tree_flatten(tp_weights(arch_id))[0]))
    inp = fsdp_inputs(arch_id)
    lo, hi = steps.batch_rows(arch, cfg, mesh, FSDP_BATCH)
    batch = {k: torch.from_numpy(v[lo:hi]).to(device)
             for k, v in inp.items() if k != "first"}
    prefill = steps.build_prefill(arch, cfg, mesh)
    serve, init_cache = steps.build_serve(arch, cfg, mesh)
    with torch.no_grad():
        fsdp.reset_stats()
        last = prefill(shard, batch)
        gathers = fsdp.stats["gather"]
        cache = init_cache(hi - lo, TP_STEPS, device)
        tok = torch.from_numpy(inp["first"][lo:hi]).to(device)
        logits, tokens = [], []
        for pos in range(TP_STEPS):
            lg, cache = serve(shard, cache, {"token": tok, "pos": pos})
            tok = torch.argmax(lg[:, 0], dim=-1)
            logits.append(_numpy(lg))
            tokens.append(_numpy(tok))
    return {"rows": (lo, hi), "prefill": _numpy(last),
            "decode": np.stack(logits, axis=1),
            "tokens": np.stack(tokens, axis=1), "inverse": inverse,
            "gathers": gathers,
            "params": {k: _numpy(v) for k, v in dict_paths(shard).items()}}


def check_fsdp_gathers(mesh, device, arch_id="qwen3-0.6b"):
    """The gathers of one forward and backward of ``loss_fn`` on the
    rank's mode "serve" shard, without remat and with every unit under
    ``torch.utils.checkpoint`` (whose backward gathers the unit again),
    beside the gathers a unit's and the whole tree's cut leaves make."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.launch import fsdp, steps
    from repro_torch.models import transformer as tr

    arch = ARCHS[arch_id]
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(arch.make_smoke(), remat=remat)
        shard = steps.serve_shard(arch, cfg, _tensors(tp_weights(arch_id),
                                                      device), mesh)
        batch = _tensors(tp_batch(arch_id, 2, TP_GRAD_T, 3), device)
        fsdp.reset_stats()
        with use_mesh(mesh):
            steps.value_and_grad(steps.model_loss(arch, cfg), shard, batch)
        out[remat] = dict(fsdp.stats)
    cfg = arch.make_smoke()
    size = axes_of(mesh).shape["data"]
    out["unit"] = fsdp.gathers(tr._part_specs(cfg)["unit"], size)
    out["tree"] = fsdp.gathers(steps.model_specs(arch, cfg), size)
    out["units"] = cfg.n_units
    return out


def fsdp_suite(mesh, device, archs=FSDP_SERVE_ARCHS):
    """FSDP over the "data" axis of ``mesh`` (``(W / 2, 2)``) and of a
    ``(W, 1)`` mesh of the same world: ``check_fsdp_serve`` of every arch
    of ``archs``, the mode "serve" DDP step (``check_tp_ddp``) of
    ``TP_TRAIN_ARCHS``, and ``check_fsdp_gathers``.  Returns ``{model
    size: {...}}`` with the rank's coordinates."""
    torch.backends.cuda.matmul.allow_tf32 = False
    world_size = torch.distributed.get_world_size()
    out = {"rank": torch.distributed.get_rank()}
    for m in (mesh, make_host_mesh(world_size, model=1)):
        n = axes_of(m).shape["model"]
        out[n] = {"coords": tuple(m.get_coordinate()),
                  "data_rank": m.get_local_rank("data"),
                  "model_rank": m.get_local_rank("model"),
                  "serve": {a: check_fsdp_serve(m, device, a)
                            for a in archs},
                  "ddp": {a: check_tp_ddp(m, device, a)
                          for a in TP_TRAIN_ARCHS},
                  "gathers": check_fsdp_gathers(m, device)}
    return out


def check_fsdp_grads(mesh, device, arch_id, rows: int):
    """``steps.FsdpRows.batch_grad`` of one agent (the rank's pod) on its
    mode "admm" FSDP+TP shard of ``tp_weights`` and a batch of ``rows``
    sequences (each rank its share where "data" divides them, else the
    whole batch), the gradients gathered (numpy)."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch import steps

    arch = ARCHS[arch_id]
    cfg = arch.make_smoke()
    specs = steps.model_specs(arch, cfg)
    shard = shd.shard_params(_tensors(tree_map(
        lambda a: a[None], tp_weights(arch_id)), device), mesh, "admm",
        specs, lead=1)
    batch = _tensors(tp_batch(arch_id, rows, TP_GRAD_T, 3, (1,)), device)
    g = steps.FsdpRows(arch, cfg, mesh).batch_grad(shard, batch)
    whole = shd.gather_shards(g, mesh, "admm", specs, lead=1)
    return {k: _numpy(v[0]) for k, v in dict_paths(whole).items()}


def fsdp_train_suite(mesh, device, archs=("qwen3-0.6b", "zamba2-2.7b")):
    """Multi-pod training over ``mesh`` (``("pod", "data", "model")``):
    for each arch of ``archs`` the gathered gradients of both
    ``FSDP_GRAD_ROWS`` batches, the qbit8 / qbit4 payloads of every leaf
    cut over "data" or "model" (``check_tp_payloads``) and one
    ``TP_ROUND`` round (``check_tp_round``)."""
    import time

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"rank": torch.distributed.get_rank(),
           "coords": tuple(mesh.get_coordinate()), "seconds": {}}
    for a in archs:
        t0 = time.perf_counter()
        out[a] = {"grads": {n: check_fsdp_grads(mesh, device, a, n)
                            for n in FSDP_GRAD_ROWS},
                  "payloads": check_tp_payloads(mesh, device, a),
                  "round": check_tp_round(mesh, device, a)}
        out["seconds"][a] = time.perf_counter() - t0
    return out


CHECKS = {"suite": suite, "paper": paper_run, "tp": tp_suite,
          "tp_train": tp_train_suite, "fsdp": fsdp_suite,
          "fsdp_train": fsdp_train_suite}



def _rank_main(rank, check, world_size, model, backend, store_dir, kw,
               pods=1):
    torch.set_num_threads(1)
    device = torch.device("cpu")
    if backend == "nccl":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    with world(backend, os.path.join(store_dir, "store"), rank, world_size,
               device if backend == "nccl" else None):
        mesh = make_host_mesh(world_size, model=model, pods=pods)
        res = CHECKS[check](mesh, device, **kw)
        torch.distributed.barrier()
    with open(os.path.join(store_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def start_world(check: str, world_size: int, store_dir: str,
                model: int = 1, backend: str = "gloo", pods: int = 1,
                **kw):
    """Start ``CHECKS[check](mesh, device, **kw)`` on every rank of a new
    world of ``world_size`` processes on a ``(world_size / model,
    model)`` mesh, or with ``pods`` > 1 a ``(pods, world_size / (pods *
    model), model)`` one (one card a rank with NCCL); returns the
    processes' context for ``collect_world``."""
    import torch.multiprocessing as mp

    return mp.start_processes(
        _rank_main, args=(check, world_size, model, backend, store_dir, kw,
                          pods),
        nprocs=world_size, join=False, start_method="spawn")


def collect_world(ctx, world_size: int, store_dir: str) -> list:
    """Wait for ``start_world``'s ranks and return each one's result in
    rank order.  A rank that raised fails the call."""
    while not ctx.join():
        pass
    out = []
    for r in range(world_size):
        with open(os.path.join(store_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
