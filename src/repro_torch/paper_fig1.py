"""Paper Fig. 1 on the port: LT-ADMM-CC with different unbiased
compressors (port of ``benchmarks/paper_fig1.py``).

The claim: exact (machine-precision) linear convergence of ||grad
F(x̄_k)||² for both the b-bit quantizer (C1) and RandK (C2), at a
compressor-dependent rate.  Paper settings: ring N=10, n=5, m=100,
|B|=1, tau=5, rho=0.1, beta=0.2, gamma=0.3, r=1; 1500 rounds sampled
every 50.  Every variant is one registry spec string.  Runs on the card
by default (RandK uniform there takes K6/K7, the quantizer K1/K5):

    PYTHONPATH=src python -m repro_torch.paper_fig1
    PYTHONPATH=src python -m repro_torch.paper_fig1 --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.bench import (linear_rate, make_problem, rounds_to_tol,
                               run_solver, saga, with_impl)
from repro_torch.core.solver import make_solver

ROUNDS = 1500
EVERY = 50
TOL = 1e-8

# name -> ltadmm solver spec (randk needs the smaller EF rate eta = 0.5,
# cf. Theorem 1's step-size conditions)
SPECS = {
    "q8": "ltadmm:compressor=qbit:bits=8",
    "q4": "ltadmm:compressor=qbit:bits=4",
    "randk_k3": "ltadmm:eta=0.5,compressor=randk:fraction=0.6",
    "identity": "ltadmm:compressor=identity",
}


def variant(name, rounds=ROUNDS, every=EVERY, device=None, impl=None):
    """One variant's run: ``(idx, gradnorm_sq, wire_bytes_per_round)``."""
    prob, data, topo, ex = make_problem()
    solver = make_solver(with_impl(SPECS[name], impl), topo, ex, saga(prob),
                         device=device)
    idx, gns = run_solver(prob, data, solver, rounds, metric_every=every)
    return idx, gns, solver.wire_bytes(np.zeros((prob.n,), np.float32))


def run(print_rows=True, rounds=ROUNDS, every=EVERY, device=None,
        impl=None):
    """Rows ``(f"fig1/{name}", final, rate_per_round, wire_bytes)``, as
    the reference's."""
    rows = []
    for name in SPECS:
        idx, gns, wire = variant(name, rounds, every, device, impl)
        rows.append((f"fig1/{name}", float(gns[-1]), linear_rate(idx, gns),
                     wire))
        if print_rows:
            traj = " ".join(f"{int(i)}:{float(g):.1e}" for i, g in
                            list(zip(idx, gns))[::max(1, len(idx) // 6)])
            print(f"# fig1 {name:10s} rounds_to_tol="
                  f"{rounds_to_tol(idx, gns, TOL)} traj {traj}")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    for r in run(device=args.device):
        print(r)


if __name__ == "__main__":
    main()
