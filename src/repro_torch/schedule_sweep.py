"""Convergence of LT-ADMM-CC across time-varying topology schedules (port
of ``benchmarks/schedule_sweep.py``).

Exact convergence survives link failures, switching, randomized gossip
and node churn as long as every union edge fires within the period, at
a rate that degrades with the failure rate, while the per-round wire
cost drops with the live links and the gradient cost with the
participation rate.  Per schedule: the final gradient-norm floor, the
rate per round, the busiest agent's period-mean wire bytes and the
degree- and participation-aware (t_g, t_c) time of one round.
``--participation`` sweeps rounds-to-tolerance against the node
participation rate (``sample:`` schedules over a complete base).  Runs
on the card by default:

    PYTHONPATH=src python -m repro_torch.schedule_sweep --rounds 300
    PYTHONPATH=src python -m repro_torch.schedule_sweep --participation
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.bench import (SWEEP_SPEC, convergence_sweep, make_problem,
                               rounds_to_tol, run_solver, saga, with_impl)
from repro_torch.core.costmodel import CostModel
from repro_torch.core.solver import make_solver

DEFAULT_SCHEDULES = (
    "ring",                                     # static reference
    "cycle:ring|star",                          # deterministic switching
    "complete",                                 # static reference
    "drop:p=0.1,base=complete,seed=0",          # light link failures
    "drop:p=0.3,base=complete,seed=0",
    "drop:p=0.5,base=complete,seed=0",          # half the links dead/round
    "gossip:edges=3,base=ring,seed=1",          # randomized activation
    "churn:p=0.2,base=complete,seed=0",         # i.i.d. node dropout
    "burst:fail=0.2,recover=0.5,seed=0",        # correlated node outages
    "sample:frac=0.5,base=complete,seed=0",     # partial participation
)

PARTICIPATION_FRACS = (1.0, 0.75, 0.5, 0.25)


def run(schedules=DEFAULT_SCHEDULES, rounds=1500, print_rows=True,
        device=None, impl=None):
    return convergence_sweep(schedules, rounds, "schedule",
                             print_rows=print_rows, device=device, impl=impl)


def participation_sweep(fracs=PARTICIPATION_FRACS, rounds=5000, tol=1e-10,
                        print_rows=True, device=None, impl=None):
    """Rounds-to-tolerance against the node participation rate: rows
    ``(spec, participation, rounds_to_tol, t_round, wire, final)`` over
    ``sample:frac=...`` on a complete base (frac=1.0 is the
    full-participation reference), as the reference's."""
    rows = []
    for frac in fracs:
        spec = f"sample:frac={frac},base=complete,seed=0"
        prob, data, graph, ex = make_problem(topology=spec)
        solver = make_solver(with_impl(SWEEP_SPEC, impl), graph, ex,
                             saga(prob), device=device)
        idx, gns = run_solver(prob, data, solver, rounds, metric_every=10)
        t_round = solver.round_cost(CostModel.for_topology(graph), prob.m)
        wire = solver.wire_bytes({"x": np.zeros((prob.n,), np.float32)})
        rows.append((spec, graph.participation(),
                     rounds_to_tol(idx, gns, tol), t_round, wire,
                     float(gns[-1])))
    if print_rows:
        print(f"{'schedule':38s} {'particip.':>9s} {'rounds@tol':>10s} "
              f"{'t/round':>8s} {'wire B/round':>13s} {'final':>10s}")
        for spec, part, rtt, t_round, wire, final in rows:
            print(f"{spec:38s} {part:9.2f} "
                  f"{rtt if rtt is not None else '-':>10} "
                  f"{t_round:8.1f} {wire:13d} {final:10.2e}")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--schedules", nargs="+", default=list(DEFAULT_SCHEDULES))
    ap.add_argument("--rounds", type=int, default=1500)
    ap.add_argument("--participation", action="store_true",
                    help="rounds-to-tolerance vs participation rate "
                         "(sample: sweep) instead of the schedule sweep")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.participation:
        participation_sweep(device=args.device)
    else:
        run(args.schedules, rounds=args.rounds, device=args.device)


if __name__ == "__main__":
    main()
