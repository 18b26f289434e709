"""Paper Fig. 2 on the port: LT-ADMM-CC against LEAD, CEDAS, COLD and DPDC
under the time model t_c = 10 t_g (8-bit quantizer everywhere, |B| = 1);
port of ``benchmarks/paper_fig2.py``.

Reported per method: the simulated time to reach ||grad F(x̄)||² <= 1e-8
and the floor reached.  LT-ADMM-CC should be the only stochastic-gradient
method to reach the threshold (exact convergence through VR and error
feedback), and faster than the full-gradient variants of COLD and DPDC
in time units.  Runs on the card by default:

    PYTHONPATH=src python -m repro_torch.paper_fig2
    PYTHONPATH=src python -m repro_torch.paper_fig2 --device cpu

The data come from ``LogisticProblem.make_data(0)``, the reference's
``jax.random`` draw (features within a few ulp), so both packages solve
the same problem.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.bench import run_solver
from repro_torch.core import vr
from repro_torch.core.costmodel import CostModel
from repro_torch.core.schedule import build_graph
from repro_torch.core.solver import make_solver
from repro_torch.problems.logistic import LogisticProblem

THRESHOLD = 1e-8
TAU = 5
ADMM_ROUNDS = 1200
BASELINE_ITERS = TAU * ADMM_ROUNDS  # same local-iteration budget

# method -> (solver spec, estimator kind).  "saga"/"full" converge
# exactly; "sgd" is the stochastic regime where only LT-ADMM-CC does.
METHODS = {
    "lt-admm-cc": (f"ltadmm:tau={TAU},compressor=qbit:bits=8", "saga"),
    "lead+sgd": ("lead:lr=0.1,compressor=qbit:bits=8", "sgd"),
    "cedas+sgd": ("cedas:lr=0.1,compressor=qbit:bits=8", "sgd"),
    "cold+sgd": ("cold:lr=0.1,compressor=qbit:bits=8", "sgd"),
    "dpdc+sgd": ("dpdc:lr=0.1,compressor=qbit:bits=8", "sgd"),
    "cold+full": ("cold:lr=0.1,compressor=qbit:bits=8", "full"),
    "dpdc+full": ("dpdc:lr=0.1,compressor=qbit:bits=8", "full"),
}


def _estimator(kind, prob):
    if kind == "saga":
        return vr.SagaTable(sample_grads=prob.sample_grads, m=prob.m)
    if kind == "full":
        return vr.FullGrad(full_grad=prob.full_grad)
    return vr.PlainSgd(batch_grad=prob.batch_grad)


def time_to_threshold(times, gns, thr=THRESHOLD):
    g = np.asarray(gns)
    t = np.asarray(times)
    hit = np.nonzero(g <= thr)[0]
    return float(t[hit[0]]) if hit.size else float("inf")


def run_method(name, prob, data, solver, cm, admm_rounds=ADMM_ROUNDS,
               baseline_iters=BASELINE_ITERS):
    """One method's row ``(f"fig2/{name}", time_to_1e-8, floor)``: the
    per-iteration (t_g, t_c) cost comes from the solver itself; LT-ADMM
    runs ``admm_rounds`` rounds, a baseline ``baseline_iters``
    iterations (seeds and sampling as in the reference)."""
    t_iter = solver.round_cost(cm, prob.m)
    if solver.name == "ltadmm":
        rounds, metric_every, seed = admm_rounds, 10, 12345
    else:
        rounds, metric_every, seed = baseline_iters, 50, 999
    idx, gns = run_solver(prob, data, solver, rounds,
                          metric_every=metric_every, seed=seed)
    times = np.asarray(idx) * t_iter
    return f"fig2/{name}", time_to_threshold(times, gns), float(gns[-1])


def run(print_rows=True, device=None, admm_rounds=ADMM_ROUNDS,
        baseline_iters=BASELINE_ITERS):
    prob = LogisticProblem()
    data = prob.make_data(0)
    graph, ex = build_graph("ring", prob.n_agents)
    cm = CostModel(t_g=1.0, t_c=10.0)
    rows = []
    for name, (spec, est_kind) in METHODS.items():
        solver = make_solver(spec, graph, ex, _estimator(est_kind, prob),
                             device=device)
        rows.append(run_method(name, prob, data, solver, cm, admm_rounds,
                               baseline_iters))
    if print_rows:
        for name, ttt, floor in rows:
            print(f"# fig2 {name:18s} time_to_1e-8={ttt:10.0f}  "
                  f"floor={floor:.2e}")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run(device=args.device)


if __name__ == "__main__":
    main()
