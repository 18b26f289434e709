"""The perf-smoke run: a small fixed-seed recipe -> BENCH JSON (port of
``benchmarks/run.py --perf-smoke``).

    PYTHONPATH=src python -m repro_torch.perf_smoke BENCH.json
    PYTHONPATH=src python -m repro_torch.perf_smoke BENCH.json --device cpu

One static and two time-varying runs of the paper-scale convex problem
(N = 10, 8-bit quantizer, SAGA), each telemetry-wrapped
(``obs.telemetry``), so every row carries its measured counters; each
run twice, cold (the kernels' first build and launch) and warm, inside a
``Tracer`` span that synchronises the card before it closes, so the
span's wall time is the run's.  Then the learned-graph row
(``personalization_sweep.perf_row``: dada on the planted-cluster
problem, no telemetry, as the reference's), the combined-fault row
(``fault_sweep.smoke_row``) and the communication kernels' rows
(``kernels_bench.run(fast=True)``).  The JSON has the reference's BENCH
schema, with ``torch``, ``"backend": "cuda"``, the card's name and its
power limit where the reference names jax and its device; the spans go
to ``<out>.trace.jsonl`` (``python -m repro_torch.obs.summary`` reads
it).
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch import fault_sweep, kernels_bench, personalization_sweep
from repro_torch.bench import (SWEEP_SPEC, make_problem, rounds_to_tol,
                               run_solver, saga, with_impl)
from repro_torch.core.solver import make_solver
from repro_torch.device import resolve_device
from repro_torch.obs import telemetry, trace

PERF_SMOKE_SPECS = ("ring", "drop:p=0.3,base=complete,seed=0",
                    "churn:p=0.2,base=complete,seed=0")
PERF_SMOKE_TOL = 1e-8
PERF_SMOKE_ROUNDS = 600


def telemetry_dict(tel) -> dict:
    """A BENCH row's ``telemetry``: the busiest agent's bytes, totals for
    the rest, from ``telemetry.counters``."""
    return {
        "tx_bytes_max_agent": int(np.max(tel["tx_bytes"])),
        "tx_msgs_total": int(np.sum(tel["tx_msgs"])),
        "rx_dropped_total": int(np.sum(tel["rx_dropped"])),
        "naks_total": int(np.sum(tel["naks"])),
        "participations_total": int(np.sum(tel["participations"])),
        "rounds": int(tel["rounds"]),
    }


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def smoke_row(spec, tracer=trace.NULL, rounds=PERF_SMOKE_ROUNDS,
              device=None, impl=None):
    """One perf-smoke row (the reference's keys): the wrapped run cold,
    then warm; the warm run's counters and trajectory."""
    dev = resolve_device(device)
    prob, data, graph, ex = make_problem(seed=0, topology=spec)
    solver = telemetry.with_telemetry(make_solver(
        with_impl(SWEEP_SPEC, impl), graph, ex, saga(prob), device=dev))

    def once(label):
        with tracer.span(label, spec=spec):
            t0 = time.perf_counter()
            out = run_solver(prob, data, solver, rounds, metric_every=10,
                             return_state=True)
            _sync(dev)
            return (time.perf_counter() - t0,) + out

    cold_s = once("cold")[0]
    warm_s, idx, gns, st = once("warm")
    return {
        "name": f"admm/{graph.name}/q8+saga",
        "spec": spec,
        "rounds": rounds,
        "cold_wall_s": round(cold_s, 3),
        "warm_wall_s": round(warm_s, 3),
        "rounds_to_tol": rounds_to_tol(idx, gns, PERF_SMOKE_TOL),
        "tol": PERF_SMOKE_TOL,
        "final_gradnorm_sq": float(gns[-1]),
        "wire_bytes_per_round": solver.wire_bytes(
            {"x": np.zeros((prob.n,), np.float32)}),
        # measured counters over the whole warm run
        "telemetry": telemetry_dict(telemetry.counters(st)),
    }


def card(dev) -> dict:
    """``device`` and ``power_limit`` of the BENCH JSON: the card's name
    and nvidia-smi's power limit (the CPU: "cpu", None)."""
    if dev.type != "cuda":
        return {"device": "cpu", "power_limit": None}
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", f"--id={dev.index or 0}"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = None
    return {"device": torch.cuda.get_device_name(dev),
            "power_limit": limit}


def perf_smoke(out_path: str, device=None, impl=None,
               rounds=PERF_SMOKE_ROUNDS, kernel_iters=20) -> dict:
    """Run the recipe and write its BENCH JSON to ``out_path``; returns
    the payload."""
    dev = resolve_device(device)
    tracer = trace.Tracer(os.path.splitext(out_path)[0] + ".trace.jsonl")
    try:
        results = [smoke_row(spec, tracer, rounds, dev, impl)
                   for spec in PERF_SMOKE_SPECS]
        with tracer.span("dada"):
            results.append(personalization_sweep.perf_row(device=dev))
        with tracer.span("faults"):
            results.append(fault_sweep.smoke_row(rounds, device=dev,
                                                 impl=impl))
            _sync(dev)
        with tracer.span("kernels"):
            kernel_rows = kernels_bench.run(print_rows=False, fast=True,
                                            device=dev, iters=kernel_iters)
    finally:
        tracer.close()
    payload = {
        "schema": 1,
        "bench": "perf-smoke",
        "seed": 0,
        "torch": torch.__version__,
        "python": platform.python_version(),
        "backend": dev.type,
        **card(dev),
        "results": results,
        "kernels": [{"name": name, "us_per_call": round(us, 1),
                     "derived": derived}
                    for name, us, derived in kernel_rows],
    }
    with open(out_path, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")
    return payload


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", help="the BENCH JSON to write")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print(json.dumps(perf_smoke(args.out, device=args.device), indent=2))
    print(f"# BENCH JSON written to {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
