"""Paper Table I on the port: the algorithms' computation time over tau
iterations in (t_g, t_c) units, and the wire bytes per round of a
1M-parameter model on a ring of 10 (port of
``benchmarks/paper_table1.py``; pure accounting, no device work):

    PYTHONPATH=src python -m repro_torch.paper_table1
"""
from __future__ import annotations

from repro_torch.core import admm, compression
from repro_torch.core.costmodel import CostModel
from repro_torch.core.topology import Ring


def run(print_rows=True):
    cm = CostModel(t_g=1.0, t_c=10.0)
    m, tau = 100, 5
    rows = [
        ("table1/lead", cm.lead(tau)),
        ("table1/cedas", cm.cedas(tau)),
        ("table1/cold_dpdc_sgd", cm.cold_dpdc_sgd(tau)),
        ("table1/cold_dpdc_full", cm.cold_dpdc_full(tau, m)),
        ("table1/lt-admm-cc", cm.lt_admm_cc(m, tau)),
    ]
    params = {"w": compression.Spec((1_000_000,))}
    topo = Ring(10)
    for name, comp in [
        ("f32", compression.Identity()),
        ("q8", compression.BBitQuantizer(8)),
        ("q4", compression.BBitQuantizer(4)),
        ("randk25", compression.RandK(fraction=0.25, sampler="block")),
    ]:
        cfg = admm.LTADMMConfig(compressor_x=comp, compressor_z=comp)
        rows.append((f"table1/wire_bytes_{name}",
                     admm.wire_bytes_per_round(cfg, topo, params)))
    if print_rows:
        for r in rows:
            print(f"# table1 {r[0]:28s} {r[1]}")
    return rows


if __name__ == "__main__":
    run()
