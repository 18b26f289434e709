"""Shared helpers of the port's harnesses (port of
``benchmarks/common.py``): the paper-scale problem, the solver runner,
the linear-rate fit and the convergence sweep behind
``topology_sweep.py`` and ``schedule_sweep.py``.

Round i uses the key ``fold_in(key(seed), i)``, as the reference does,
and ||grad F(x̄)||² is computed only at the sample rounds 0, every, 2 *
every, ... (after that round's step), so the loop between samples is
pure solver steps.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.trees import tree_flatten, tree_map
from repro_torch.core import jaxrand, vr
from repro_torch.core.costmodel import CostModel
from repro_torch.core.schedule import build_graph
from repro_torch.core.solver import make_solver
from repro_torch.problems.logistic import LogisticProblem

# the sweeps' recipe: 8-bit quantizer, SAGA (tests/test_schedule.py)
SWEEP_SPEC = "ltadmm:compressor=qbit:bits=8"


def make_problem(seed=0, topology="ring"):
    """The paper-scale convex problem on any agent graph: ``(prob, data,
    graph, exchange)``; ``topology`` is a ``build_graph`` spec, static
    ("ring", "star", "erdos:p=0.4", ...) or time-varying
    ("drop:p=0.2,base=complete", ...).  The data are the reference's
    ``make_data(jax.random.key(seed))``, on the CPU."""
    prob = LogisticProblem()
    data = prob.make_data(seed)
    graph, ex = build_graph(topology, prob.n_agents)
    return prob, data, graph, ex


def with_impl(spec: str, impl) -> str:
    """``spec`` with its compressor's route pinned (``impl`` None: as
    is): placed before a nested ``faults=`` (which would take a later
    item as a fault param), after a ``:`` where the compressor spec has
    no params of its own."""
    if impl is None:
        return spec
    head, sep, tail = spec.partition(",faults=")
    comp = head.rpartition("compressor=")[2]
    return f"{head}{',' if ':' in comp else ':'}impl={impl}{sep}{tail}"


def saga(prob):
    return vr.SagaTable(sample_grads=prob.sample_grads, m=prob.m)


def linear_rate(idx, gns):
    """Log-linear slope of the pre-floor segment (per round)."""
    g = np.asarray(gns)
    i = np.asarray(idx)
    keep = (g > 1e-14) & (i > 0)
    if keep.sum() < 3:
        return float("nan")
    sl, _ = np.polyfit(i[keep], np.log(g[keep]), 1)
    return float(sl)


def convergence_sweep(specs, rounds, label, print_rows=True, device=None,
                      impl=None):
    """Paper-scale convergence over graph specs (static topologies or
    schedules): N = 10 agents, 8-bit quantizer, SAGA.  Rows ``(name,
    final_gradnorm_sq, rate_per_round, wire_bytes, t_round)``, as the
    reference's."""
    rows = []
    for spec in specs:
        prob, data, graph, ex = make_problem(topology=spec)
        solver = make_solver(with_impl(SWEEP_SPEC, impl), graph, ex,
                             saga(prob), device=device)
        # metric_every=1: fast-mixing graphs (complete) hit the float32
        # floor within ~20 rounds, and the rate fit needs the pre-floor
        # points
        idx, gns = run_solver(prob, data, solver, rounds, metric_every=1)
        wire = solver.wire_bytes({"x": np.zeros((prob.n,), np.float32)})
        t_round = solver.round_cost(CostModel.for_topology(graph), prob.m)
        rows.append((f"{label}/{graph.name}", float(gns[-1]),
                     linear_rate(idx, gns), wire, t_round))
    if print_rows:
        print(f"{label:34s} {'final ||grad||^2':>16s} "
              f"{'rate/round':>11s} {'wire B/round':>13s} {'t/round':>8s}")
        for name, final, rate, wire, t_round in rows:
            print(f"{name:34s} {final:16.3e} {rate:11.4f} {wire:13d} "
                  f"{t_round:8.1f}")
    return rows


def run_solver(prob, data, solver, rounds: int, metric_every: int = 10,
               seed: int = 12345, return_state: bool = False, x0=None):
    """Returns ``(rounds_idx, gradnorm_sq)`` numpy arrays (and the final
    state when ``return_state``).  ``data`` is moved to the solver's
    device.  ``x0``: the stacked initial params (a tree for
    ``packed=false``; zeros ``[A, n]`` when None), whose consensus mean
    packs into the problem's ``[n]`` vector.  On a mesh exchange ``data``
    and ``x0`` still hold all A agents: the solver takes its rank's rows,
    and the metric's mean is over every agent's x, gathered over the
    agent axis (the one-process run's mean, bit for bit)."""
    data = {k: (v if isinstance(v, torch.Tensor) else
                torch.from_numpy(np.array(v))).to(solver.device)
            for k, v in data.items()}
    if x0 is None:
        x0 = torch.zeros((prob.n_agents, prob.n), device=solver.device)
    ex = getattr(solver, "exchange", None)
    mine, gather = data, (lambda tree: tree)
    if ex is not None and ex.mesh is not None:
        rows = slice(ex.rows.start, ex.rows.stop)
        mine = {k: v[rows] for k, v in data.items()}
        x0 = tree_map(lambda t: t[rows], x0)
        gather = ex.gather_rows
    st = solver.init(x0)
    base = jaxrand.key(seed)
    idx, gns = [], []
    for i in range(rounds):
        st = solver.step(st, mine, jaxrand.fold_in(base, i))
        if i % metric_every == 0:
            xbar = _flat_mean(gather(solver.consensus_params(st)))
            idx.append(i)
            gns.append(prob.global_grad_norm_sq(xbar, data))
    gns = np.asarray([float(g) for g in gns], dtype=np.float64)
    out = (np.asarray(idx), gns)
    return out + (st,) if return_state else out


def _flat_mean(params):
    """Consensus mean of stacked params, leaves flattened and joined in
    tree order into one vector."""
    return torch.cat([torch.mean(x, dim=0).reshape(-1)
                      for x in tree_flatten(params)[0]])


def rounds_to_tol(idx, gns, tol: float):
    """First sampled round with ||grad F||² <= tol, or None."""
    hit = np.nonzero(np.asarray(gns) <= tol)[0]
    return int(np.asarray(idx)[hit[0]]) if hit.size else None
