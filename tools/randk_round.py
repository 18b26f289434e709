#!/usr/bin/env python3
"""Device time of LT-ADMM-CC's RandK-stride round at n = 2^20.

    python3 tools/randk_round.py [--src PATH] [--rounds 5]

The round is ``chip_smoke.py``'s wide spec ``randk-stride`` (ring of 10
agents, SAGA, ``randk:fraction=0.6,sampler=stride``, eta 0.5): two K2
and four K3 launches a round.  After two warm-up rounds it profiles
``--rounds`` rounds with torch.profiler and prints the round time (host
clock), the device's busy time and idle share, and the time of the
RandK plane kernels (K2/K3: the port's ``csrc/randk_plane.cu`` kernels).
``--src`` imports the port from another tree (a parent commit unpacked
with ``git archive``), so that two versions can be compared in one call
on one card.  Needs a CUDA card and nvcc; prints one JSON object as its
last line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = "ltadmm:eta=0.5,compressor=randk:fraction=0.6,sampler=stride"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import jaxrand
    from repro_torch.core.schedule import build_graph
    from repro_torch.core.solver import make_solver
    from repro_torch.kernels import _build
    from repro_torch.paper_fig2 import _estimator
    from repro_torch.problems.logistic import LogisticProblem

    if not torch.cuda.is_available():
        print("randk_round: CUDA is not available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _build.build()
    dev = torch.device("cuda")
    prob = LogisticProblem(n=2 ** 20)
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((prob.n_agents, prob.m, prob.n), generator=g, device=dev)
    a /= torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    u = torch.rand((prob.n_agents, prob.m), generator=g, device=dev)
    data = {"a": a, "b": torch.where(u < 0.5, 1.0, -1.0)}
    graph, ex = build_graph("ring", prob.n_agents)
    solver = make_solver(SPEC, graph, ex, _estimator("saga", prob),
                         device="cuda")
    st = solver.init(torch.zeros((prob.n_agents, prob.n), device=dev))
    base = jaxrand.key(12345)
    for i in range(2):
        st = solver.step(st, data, jaxrand.fold_in(base, i))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(2, 2 + args.rounds):
            st = solver.step(st, data, jaxrand.fold_in(base, i))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    # the RandK plane kernels: the port's own (anonymous-namespace) gather,
    # scatter and claim kernels; no other port kernel runs in this round
    randk = [e for e in kernels if "(anonymous namespace)::" in e.name
             and any(t in e.name for t in ("gather", "scatter", "claim"))]
    randk_ms = sum(e.time_range.elapsed_us() for e in randk) / 1e3
    r = args.rounds
    res = {"src": args.src, "card": card, "round_ms": wall * 1e3 / r,
           "device_busy_ms": busy / r, "idle_share": 1 - busy / (wall * 1e3),
           "randk_ms": randk_ms / r, "randk_launches": len(randk) / r,
           "randk_share_of_busy": randk_ms / busy}
    print(f"[round] {args.src}: round {res['round_ms']:.3f} ms, device busy "
          f"{res['device_busy_ms']:.3f} ms, idle share "
          f"{res['idle_share']:.3f}; K2/K3 {res['randk_ms']:.4f} ms in "
          f"{res['randk_launches']:.0f} launches a round "
          f"({res['randk_share_of_busy']:.1%} of busy) [{card}]", flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
