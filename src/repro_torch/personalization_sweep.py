"""Personalization sweep: consensus against learned-graph personalized
models (port of ``benchmarks/personalization_sweep.py``).

On the planted-cluster logistic problem (``problems.clusters``: 16
agents, 4 clusters with orthogonal separators) it sweeps the clusters'
separation and compares at each level:

* ``ltadmm:``, exact consensus: one compromise model for all clusters;
* ``dada:``, per-agent models plus a learned sparse collaboration graph
  (``core.graphlearn``).

Each row: the mean per-agent test loss of both, and the learned graph's
edge precision and recall against the planted intra-cluster edges.
Runs on the card by default:

    PYTHONPATH=src python -m repro_torch.personalization_sweep
    PYTHONPATH=src python -m repro_torch.personalization_sweep --device cpu

Round i uses the key ``fold_in(key(seed + 1), i)``, as the reference's
scan does; the data are the reference's ``make_split(key(seed))``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.bench import saga
from repro_torch.core import jaxrand, vr
from repro_torch.core.graphlearn import (edge_precision_recall,
                                         personalized_grad_norm_sq)
from repro_torch.core.schedule import build_graph
from repro_torch.core.solver import make_solver
from repro_torch.device import resolve_device
from repro_torch.problems.clusters import ClusteredLogisticProblem

DADA_SPEC = ("dada:lr=0.05,mu=0.5,lambda_g=0.05,graph_every=5,"
             "degree_cap=3,batch_size=8")
LTADMM_SPEC = "ltadmm:tau=5"
SEPARATIONS = (0.0, 1.0, 3.0)
ROUNDS = 300


def _solver(prob, spec, device):
    """``spec`` on the candidate complete graph: SAGA for LT-ADMM, plain
    minibatch gradients for dada."""
    graph, ex = build_graph("complete", prob.n_agents)
    est = (saga(prob) if spec.startswith("ltadmm")
           else vr.PlainSgd(batch_grad=prob.batch_grad))
    return make_solver(spec, graph, ex, est, device=device)


def _run(prob, spec, train, rounds, seed, device=None):
    """Build and run one registry spec; returns ``(solver, final
    state)``."""
    solver = _solver(prob, spec, device)
    st = solver.init(torch.zeros((prob.n_agents, prob.n),
                                 device=solver.device))
    base = jaxrand.key(seed)
    for i in range(rounds):
        st = solver.step(st, train, jaxrand.fold_in(base, i))
    return solver, st


def compare_at(separation, rounds=ROUNDS, seed=0, device=None):
    """One sweep point: the consensus and personalized mean test losses
    and the learned graph's precision and recall."""
    dev = resolve_device(device)
    prob = ClusteredLogisticProblem(separation=separation)
    train, test = prob.make_split(seed, device=dev)

    ref, st_ref = _run(prob, LTADMM_SPEC, train, rounds, seed + 1, dev)
    consensus = prob.mean_test_loss(
        torch.mean(ref.consensus_params(st_ref), dim=0), test)

    dada, st_d = _run(prob, DADA_SPEC, train, rounds, seed + 1, dev)
    personal = prob.mean_test_loss(dada.consensus_params(st_d), test)
    precision, recall = edge_precision_recall(
        dada.learned_weights(st_d), prob.intra_cluster_edges())
    return {
        "separation": separation,
        "consensus_test_loss": float(consensus),
        "dada_test_loss": float(personal),
        "edge_precision": float(precision),
        "edge_recall": float(recall),
    }


def run(print_rows=True, separations=SEPARATIONS, rounds=ROUNDS,
        device=None):
    """Rows ``(name, consensus_loss, dada_loss, precision, recall)``."""
    rows = []
    for sep in separations:
        r = compare_at(sep, rounds=rounds, device=device)
        rows.append((f"personalization/sep={sep:g}",
                     r["consensus_test_loss"], r["dada_test_loss"],
                     r["edge_precision"], r["edge_recall"]))
    if print_rows:
        print(f"{'sweep point':26s} {'consensus':>10s} {'dada':>10s} "
              f"{'edge P':>7s} {'edge R':>7s}")
        for name, cons, dd, p, rc in rows:
            print(f"{name:26s} {cons:10.4f} {dd:10.4f} {p:7.2f} {rc:7.2f}")
    return rows


def perf_trajectory(rounds=400, seed=0, device=None, every=10):
    """The perf row's run: ``(solver, idx, metric, seconds)``, the metric
    ``graphlearn.personalized_grad_norm_sq`` (the personalized
    stationarity measure) after rounds ``idx`` = every, 2 * every, ...;
    one host sync, at the end."""
    dev = resolve_device(device)
    prob = ClusteredLogisticProblem()
    train, _ = prob.make_split(seed, device=dev)
    t0 = time.perf_counter()
    solver = _solver(prob, DADA_SPEC, dev)
    st = solver.init(torch.zeros((prob.n_agents, prob.n), device=dev))
    base = jaxrand.key(seed + 1)
    gns = []
    for i in range(rounds):
        st = solver.step(st, train, jaxrand.fold_in(base, i))
        if (i + 1) % every == 0:
            gns.append(personalized_grad_norm_sq(solver, st, prob.full_grad,
                                                 train))
    g = torch.stack(gns).cpu().numpy()
    idx = (np.arange(rounds // every) + 1) * every
    return solver, idx, g, time.perf_counter() - t0


def perf_row(rounds=400, tol=2e-3, seed=0, device=None):
    """The fixed-seed dada perf-smoke row (the reference's keys), its run
    timed cold, then warm.  The consensus gradient norm is the wrong
    yardstick for a solver that does not reach consensus, so the row
    reads ``perf_trajectory``'s personalized measure."""
    cold_s = perf_trajectory(rounds, seed, device)[3]
    solver, idx, g, warm_s = perf_trajectory(rounds, seed, device)
    hit = np.nonzero(g <= tol)[0]
    return {
        "name": "dada/complete16/learned-graph",
        "spec": DADA_SPEC,
        "rounds": rounds,
        "cold_wall_s": round(cold_s, 3),
        "warm_wall_s": round(warm_s, 3),
        "rounds_to_tol": int(idx[hit[0]]) if hit.size else None,
        "tol": tol,
        "final_gradnorm_sq": float(g[-1]),
        "wire_bytes_per_round": solver.wire_bytes(
            np.zeros((ClusteredLogisticProblem().n,), np.float32)),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run(device=args.device)


if __name__ == "__main__":
    main()
