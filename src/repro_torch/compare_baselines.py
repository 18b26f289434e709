"""Fig.-2-style comparison on the port (port of
``examples/compare_baselines.py``): LT-ADMM-CC against LEAD, CEDAS, COLD
and DPDC under the paper's time model (t_c = 10 t_g, 8-bit quantizer,
|B| = 1), then the personalization table: on the planted-cluster task
(``problems.clusters``) the ``dada:`` solver learns per-agent models and a
sparse collaboration graph, and beats the single consensus model once the
clusters' optima differ (``personalization_sweep``).  Runs on the card by
default:

    PYTHONPATH=src python -m repro_torch.compare_baselines
    PYTHONPATH=src python -m repro_torch.compare_baselines --device cpu
"""
from __future__ import annotations

import argparse

from repro_torch import paper_fig2, personalization_sweep


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    print("methods (solver registry spec strings):")
    for name, (spec, est) in paper_fig2.METHODS.items():
        print(f"  {name:12s} make_solver({spec!r}) + {est} gradients")
    print(f"  {'dada':12s} make_solver("
          f"{personalization_sweep.DADA_SPEC!r}) + sgd gradients")
    print()
    rows = paper_fig2.run(print_rows=False, device=args.device)
    print(f"{'algorithm':20s} {'sim. time to 1e-8':>18s} {'floor':>12s}")
    for name, ttt, floor in rows:
        t = f"{ttt:.0f}" if ttt != float("inf") else "never"
        print(f"{name.split('/')[-1]:20s} {t:>18s} {floor:>12.2e}")
    print("\nonly LT-ADMM-CC reaches exactness with stochastic gradients; "
          "the exact full-gradient baselines pay ~m x more compute per "
          "communication round.")

    print("\npersonalization (planted clusters, 16 agents / 4 tasks): "
          "mean per-agent test loss")
    print(f"{'separation':12s} {'ltadmm consensus':>17s} "
          f"{'dada personalized':>18s} {'edge P/R':>10s}")
    for sep in (0.0, 3.0):
        r = personalization_sweep.compare_at(sep, device=args.device)
        print(f"{sep:<12g} {r['consensus_test_loss']:17.4f} "
              f"{r['dada_test_loss']:18.4f} "
              f"{r['edge_precision']:5.2f}/{r['edge_recall']:4.2f}")
    print("\nidentical tasks (sep 0): consensus is optimal and dada ties; "
          "distinct tasks: one compromise model cannot fit 4 optima, "
          "while dada's learned graph routes averaging within clusters "
          "only.")


if __name__ == "__main__":
    main()
