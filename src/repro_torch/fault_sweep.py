"""Fault-injection sweep: LT-ADMM-CC's resilience against fault rate (port
of ``benchmarks/fault_sweep.py``).

For each fault kind (message drop, payload bit flip, stale round replay,
node crash-restart; injected by ``core.faults`` at the exchange boundary)
the sweep reports rounds-to-tolerance and the recovery overhead: the
ratio of rounds-to-tolerance against the fault-free run of the same
recipe.  Detection is the sealed payload's checksum and round tag;
recovery is the asynchronous-ADMM hold on edges that went dark for the
round.  Everything is seeded, so every row replays bit for bit.  Runs on
the card by default:

    PYTHONPATH=src python -m repro_torch.fault_sweep
    PYTHONPATH=src python -m repro_torch.fault_sweep --smoke --device cpu

``--smoke`` prints the one fixed-seed combined-fault row
(``smoke_row``), the reference's ``admm/ring/q8+saga+faults`` perf row.
The data come from ``LogisticProblem.make_data(0)``, the reference's draw.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.bench import rounds_to_tol, run_solver
from repro_torch.core import vr
from repro_torch.core.schedule import build_graph
from repro_torch.core.solver import make_solver
from repro_torch.problems.logistic import LogisticProblem

BASE_SPEC = "ltadmm:compressor=qbit:bits=8"
SMOKE_FAULTS = "faults:drop=0.05,corrupt=1e-3,crash=0.01,seed=0"
SWEEP = (
    ("drop", (0.02, 0.05, 0.1)),
    ("corrupt", (1e-3, 5e-3, 1e-2)),
    ("stale", (0.02, 0.05, 0.1)),
    ("crash", (0.01, 0.02, 0.05)),
)
ROUNDS = 600
TOL = 1e-8


def solver_for(fault_spec, device=None, impl=None):
    """``(prob, data, solver)``: q8 + SAGA LT-ADMM-CC on the paper's
    problem with ``fault_spec`` nested (None: no faults); ``impl`` pins
    the compressor's route (``kernel`` runs the kernels' plain versions on
    the CPU)."""
    prob = LogisticProblem()
    data = prob.make_data(0)
    graph, ex = build_graph("ring", prob.n_agents)
    saga = vr.SagaTable(sample_grads=prob.sample_grads, m=prob.m)
    spec = BASE_SPEC + ("" if impl is None else f",impl={impl}")
    if fault_spec is not None:
        # ``|`` separates the fault params, so the solver spec's ``,``
        # parser leaves them intact
        spec += f",faults={fault_spec.replace(',', '|')}"
    return prob, data, make_solver(spec, graph, ex, saga, device=device)


def _converge(fault_spec, rounds=ROUNDS, tol=TOL, device=None, impl=None):
    """-> (rounds_to_tol or None, final ||grad F||^2)."""
    prob, data, solver = solver_for(fault_spec, device, impl=impl)
    idx, gns = run_solver(prob, data, solver, rounds, metric_every=10)
    return rounds_to_tol(idx, gns, tol), float(gns[-1])


def run(print_rows=True, rounds=ROUNDS, tol=TOL, device=None, impl=None):
    """Rows ``(name, rounds_to_tol, final_gradnorm_sq, overhead)``, the
    overhead relative to the fault-free run (NaN where the faulty run
    never reached tolerance)."""
    base_rounds, base_final = _converge(None, rounds, tol, device, impl)
    rows = [("faults/none", base_rounds, base_final, 1.0)]
    for kind, rates in SWEEP:
        for rate in rates:
            r2t, final = _converge(f"faults:{kind}={rate},seed=0", rounds,
                                   tol, device, impl)
            overhead = (r2t / base_rounds
                        if r2t is not None and base_rounds else float("nan"))
            rows.append((f"faults/{kind}={rate:g}", r2t, final, overhead))
    if print_rows:
        print(f"{'sweep point':24s} {'rounds@1e-8':>12s} "
              f"{'final ||grad||^2':>17s} {'overhead':>9s}")
        for name, r2t, final, ov in rows:
            print(f"{name:24s} {str(r2t):>12s} {final:17.3e} {ov:9.2f}")
    return rows


def smoke_row(rounds=ROUNDS, tol=TOL, device=None, impl=None):
    """The fixed-seed combined-fault row (the schema of the reference's
    perf rows): LT-ADMM-CC under simultaneous drop, corruption and crash
    faults still converges.  Run twice: ``cold_wall_s`` holds the kernels'
    first build and launch, ``warm_wall_s`` the rerun (host clock)."""
    prob, data, solver = solver_for(SMOKE_FAULTS, device, impl=impl)

    def once():
        t0 = time.perf_counter()
        idx, gns = run_solver(prob, data, solver, rounds, metric_every=10)
        return time.perf_counter() - t0, idx, gns

    cold_s, _, _ = once()
    warm_s, idx, gns = once()
    return {
        "name": "admm/ring/q8+saga+faults",
        "spec": SMOKE_FAULTS,
        "rounds": rounds,
        "cold_wall_s": round(cold_s, 3),
        "warm_wall_s": round(warm_s, 3),
        "rounds_to_tol": rounds_to_tol(idx, gns, tol),
        "tol": tol,
        "final_gradnorm_sq": float(gns[-1]),
        "wire_bytes_per_round": solver.wire_bytes(
            {"x": np.zeros((prob.n,), np.float32)}),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the single fixed-seed combined-fault recipe; "
                         "prints its JSON row")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.smoke:
        print(json.dumps(smoke_row(device=args.device), indent=2))
    else:
        run(device=args.device)


if __name__ == "__main__":
    main()
