"""Every harness's rows as one CSV (the counterpart of
``benchmarks/run.py``'s full run): ``name,us_per_call,derived``, with
us_per_call blank for the convergence rows, whose cost is in simulated
(t_g, t_c) units.

    PYTHONPATH=src python -m repro_torch.run                # on the card
    PYTHONPATH=src python -m repro_torch.run --device cpu

The reference's ``--perf-smoke`` lane is ``repro_torch.perf_smoke``.
The roofline rows come from the port's dry-run records
(``repro_torch.roofline`` reads ``results/torch_dryrun*.jsonl``, written
by ``python -m repro_torch.launch.dryrun``); without records the CSV ends
with one comment line that names that command.
"""
from __future__ import annotations

import argparse
import sys
import time

from repro_torch.roofline import NO_RECORDS as ROOFLINE_NOTE


def full_csv(device=None) -> None:
    """Prints the rows of Fig. 1, Fig. 2, the topology and schedule
    sweeps, Table I, the fault sweep, the personalization sweep and the
    kernels, in the reference's order and formats."""
    from repro_torch import (fault_sweep, kernels_bench, paper_fig1,
                             paper_fig2, paper_table1, personalization_sweep,
                             roofline, schedule_sweep, topology_sweep)

    t0 = time.time()
    print("name,us_per_call,derived")
    for name, final, rate, wire in paper_fig1.run(print_rows=False,
                                                  device=device):
        print(f"{name},,final_gradnorm2={final:.3e};rate_per_round={rate:.4f}"
              f";wire_bytes_per_round={wire}")
    for name, ttt, floor in paper_fig2.run(print_rows=False, device=device):
        print(f"{name},,time_to_1e-8={ttt:.0f};floor={floor:.3e}")
    sweep_rows = (topology_sweep.run(print_rows=False, device=device)
                  + schedule_sweep.run(print_rows=False, device=device))
    for name, final, rate, wire, t_round in sweep_rows:
        print(f"{name},,final_gradnorm2={final:.3e};rate_per_round={rate:.4f}"
              f";wire_bytes_per_round={wire};t_per_round={t_round:.1f}")
    for name, val in paper_table1.run(print_rows=False):
        print(f"{name},,cost={val}")
    for name, r2t, final, ov in fault_sweep.run(print_rows=False,
                                                device=device):
        print(f"{name},,rounds_to_tol={r2t};final_gradnorm2={final:.3e}"
              f";recovery_overhead={ov:.2f}")
    for name, cons, dd, p, r in personalization_sweep.run(print_rows=False,
                                                          device=device):
        print(f"{name},,consensus_test_loss={cons:.4f}"
              f";dada_test_loss={dd:.4f}"
              f";edge_precision={p:.2f};edge_recall={r:.2f}")
    for name, us, derived in kernels_bench.run(print_rows=False,
                                               device=device):
        print(f"{name},{us:.0f},{derived}")
    roof = roofline.run(print_rows=False)
    for name, t_comp, dom in roof:
        print(f"{name},,t_compute_s={t_comp:.4f};dominant={dom}")
    if not roof:
        print(ROOFLINE_NOTE)
    print(f"# total benchmark wall time: {time.time() - t0:.0f}s",
          file=sys.stderr)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    full_csv(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
