"""Roofline table: reads the port's dry-run records
(``results/torch_dryrun*.jsonl``) and prints per (arch x shape x mesh)
the three roofline terms on the H100, the dominant bottleneck and the
useful-FLOP fraction: the counterpart of ``benchmarks/roofline.py``.  It
traces nothing itself (run ``repro_torch.launch.dryrun`` first); the
reference's records (``results/dryrun*.jsonl``) are never read.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        --multi-pod both --out results/torch_dryrun.jsonl
    PYTHONPATH=src python -m repro_torch.roofline
"""
from __future__ import annotations

import glob
import json
import os

DEFAULT_PATH = os.path.join("results", "torch_dryrun*.jsonl")
NO_RECORDS = ("# roofline: no dry-run records yet (python -m "
              "repro_torch.launch.dryrun --all --out "
              "results/torch_dryrun.jsonl)")


def load(path=DEFAULT_PATH):
    records = []
    for fn in sorted(glob.glob(path)):
        with open(fn) as f:
            records.extend(json.loads(line) for line in f if line.strip())
    return records


def rows(records):
    out = []
    for r in records:
        rl = r["roofline"]
        out.append({
            "name": f"roofline/{r['arch']}/{r['shape']}/{r['mesh']}",
            "t_comp": rl["t_compute_s"],
            "t_mem": rl["t_memory_s"],
            "t_coll": rl["t_collective_s"],
            "dominant": rl["dominant"],
            "useful": r.get("useful_fraction"),
            "bytes_per_dev": r["bytes_per_device"]["total_live"],
        })
    return out


def run(print_rows=True, path=DEFAULT_PATH):
    table = rows(load(path))
    if print_rows:
        if not table:
            print(NO_RECORDS)
        for t in table:
            u = f"{t['useful']:.2f}" if t["useful"] else "n/a"
            print(
                f"# {t['name']:55s} comp={t['t_comp']:8.3f}s "
                f"mem={t['t_mem']:8.1f}s coll={t['t_coll']:7.2f}s "
                f"dom={t['dominant']:10s} useful={u} "
                f"dev_bytes={t['bytes_per_dev'] / 1e9:.1f}GB"
            )
    return [(t["name"], t["t_comp"], t["dominant"]) for t in table]


if __name__ == "__main__":
    run()
