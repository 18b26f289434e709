"""Quickstart: the paper's convex experiment on the port.

LT-ADMM-CC on the logistic task (ring N=10, n=5, m=100, |B|=1, SAGA,
8-bit compressed messages): ||grad F(x̄_k)||² falls linearly to float32
precision.  ``--solver`` takes any registered solver; LT-ADMM-CC gets the
paper's SAGA estimator, the gossip baselines plain SGD (their noise
floor), as in the reference's quickstart.  Runs on the card by default:

    PYTHONPATH=src python -m repro_torch.quickstart
    PYTHONPATH=src python -m repro_torch.quickstart --device cpu
    PYTHONPATH=src python -m repro_torch.quickstart \
        --solver 'lead:lr=0.1,compressor=qbit:bits=8'
    PYTHONPATH=src python -m repro_torch.quickstart --device cpu \
        --topology drop:p=0.3,base=complete
    PYTHONPATH=src python -m repro_torch.quickstart --device cpu \
        --solver 'ltadmm:packed=false,compressor=qbit:bits=8'
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import jaxrand, vr
from repro_torch.core.schedule import build_graph
from repro_torch.core.solver import consensus_error, make_solver, solver_entry
from repro_torch.problems.logistic import LogisticProblem


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--solver", default="ltadmm:compressor=qbit:bits=8")
    ap.add_argument("--topology", default="ring",
                    help="static topology or time-varying schedule spec")
    ap.add_argument("--topology-schedule", default=None,
                    help="time-varying graph spec (cycle:..., drop:..., "
                         "gossip:...); overrides --topology")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--rounds", type=int, default=1001)
    args = ap.parse_args(argv)

    prob = LogisticProblem()
    graph, ex = build_graph(args.topology_schedule or args.topology,
                            prob.n_agents)
    est = (vr.SagaTable(sample_grads=prob.sample_grads, m=prob.m)
           if solver_entry(args.solver).estimator == "vr"
           else vr.PlainSgd(batch_grad=prob.batch_grad))
    solver = make_solver(args.solver, graph, ex, est, device=args.device)
    data = prob.make_data(0, device=solver.device)
    state = solver.init(torch.zeros((prob.n_agents, prob.n)))

    print(f"device {solver.device}")
    print("round   ||gradF(xbar)||^2    consensus_err")
    for r in range(args.rounds):
        state = solver.step(state, data, jaxrand.key(r))
        if r % 100 == 0:
            x = solver.consensus_params(state)
            gn = prob.global_grad_norm_sq(torch.mean(x, dim=0), data)
            print(f"{r:5d}   {float(gn):15.3e}    "
                  f"{float(consensus_error(x)):12.3e}")


if __name__ == "__main__":
    main()
