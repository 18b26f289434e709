"""Convergence of LT-ADMM-CC across agent-graph families (port of
``benchmarks/topology_sweep.py``).

Theorem 1 holds for any connected undirected graph; the paper shows the
ring.  This sweep runs the paper-scale convex problem (N = 10 agents,
8-bit quantizer, SAGA) over several graph families and reports the
linear rate, the final gradient-norm floor and the busiest agent's wire
bytes a round (complete mixes fastest but costs ~N x the bytes).  Runs
on the card by default:

    PYTHONPATH=src python -m repro_torch.topology_sweep \
        --topologies ring star complete erdos:p=0.4 --rounds 600
"""
from __future__ import annotations

import argparse

from repro_torch.bench import convergence_sweep

DEFAULT_TOPOLOGIES = (
    "ring",
    "star",
    "complete",
    "erdos:p=0.4,seed=0",
    "smallworld:k=4,p=0.2,seed=0",
)


def run(topologies=DEFAULT_TOPOLOGIES, rounds=1200, print_rows=True,
        device=None, impl=None):
    return convergence_sweep(topologies, rounds, "topology",
                             print_rows=print_rows, device=device, impl=impl)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--topologies", nargs="+",
                    default=list(DEFAULT_TOPOLOGIES))
    ap.add_argument("--rounds", type=int, default=1200)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run(args.topologies, rounds=args.rounds, device=args.device)


if __name__ == "__main__":
    main()
