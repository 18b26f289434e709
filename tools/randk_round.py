#!/usr/bin/env python3
"""Device time of one of the wide runs' rounds at n = 2^20.

    python3 tools/randk_round.py [--spec randk-stride] [--src PATH]
                                 [--rounds 5]

``--spec`` names one of ``chip_smoke.py``'s wide specs over 10 agents
(``WIDE_SPECS``, built by its ``wide_solver``), among them
``randk-stride`` (LT-ADMM-CC, SAGA, ``randk:fraction=0.6,sampler=stride``,
eta 0.5, on the ring: two K2 and four K3 launches a round),
``randk-uniform`` (the same with the uniform sampler: two K6 and four K7
launches a round), ``choco-topk`` (CHOCO-SGD with ``topk:fraction=0.25``:
one K6 and one K7 an iteration), ``qbit8`` (LT-ADMM-CC, SAGA,
``qbit:bits=8``: two K1 launches a round), ``drop-qbit8`` (the same on
the drop0.3 schedule over the complete graph: two K1 launches a round on
[10, 15, 2^20] planes), ``lead-qbit8`` (LEAD: one K4 and one K5 an
iteration) and ``ring-tree-qbit8`` (LT-ADMM-CC on the two-leaf tree:
four K4 and eight K5 a round).  After two warm-up rounds it profiles
``--rounds`` rounds with torch.profiler and prints the round time (host
clock), the device's busy time and idle share, and the time of the
port's own kernels that the round runs (K1-K7, by their CUDA kernel
names, either tree's design; a tree whose K1 or K4 takes its scale from
a PyTorch pass, or whose plane route dequantises in PyTorch, counts those
passes under the library's kernels).
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
# CUDA kernel names of K2/K3 and K6/K7 (both designs)
OWN_KERNELS = ("randk_gather_pull_kernel", "randk_gather_push_kernel",
               "randk_scatter_pull_kernel", "randk_scatter_push_kernel",
               "randk_claim_kernel", "gather_kernel", "claim_kernel",
               "scatter_kernel", "bin_kernel", "fill_kernel",
               "quantize_rows", "quantize8_kernel", "quantize4_kernel",
               "quantize8_leaf", "quantize4_leaf",
               "dequantize8_leaf", "dequantize4_leaf", "dequantize_rows")


def main(argv=None):
    sys.path.insert(0, ROOT)
    import chip_smoke

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spec", choices=[w[0] for w in chip_smoke.WIDE_SPECS],
                    default="randk-stride")
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    # after chip_smoke's own path, so that --src's port is the one imported
    sys.path.insert(0, os.path.abspath(args.src))

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import jaxrand
    from repro_torch.kernels import _build
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
    data = chip_smoke.wide_data(prob, dev)
    solver, x0, _, _, _ = chip_smoke.wide_solver(args.spec, prob, dev)
    st = solver.init(x0)
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
    # the port's own kernels that these rounds run: K1 (quantize_plane.cu),
    # K2/K3 (randk_plane.cu), K4/K5 (quantize_leaf.cu) and K6/K7
    # (gather_scatter.cu), this tree's and the first designs', by their
    # CUDA kernel names
    def base(name):
        return name.split("<")[0].split("::")[-1].split("(")[0]

    own = [e for e in kernels if ("(anonymous namespace)::" in e.name
                                  or "repro::" in e.name)
           and base(e.name) in OWN_KERNELS]
    own_ms = sum(e.time_range.elapsed_us() for e in own) / 1e3
    by_name = {}
    for e in own:
        by_name[base(e.name)] = (by_name.get(base(e.name), 0.0)
                                 + e.time_range.elapsed_us() / 1e3
                                 / args.rounds)
    r = args.rounds
    res = {"spec": args.spec, "src": args.src, "card": card,
           "round_ms": wall * 1e3 / r, "device_busy_ms": busy / r,
           "idle_share": 1 - busy / (wall * 1e3),
           "kernels_ms": own_ms / r, "kernel_launches": len(own) / r,
           "kernels_share_of_busy": own_ms / busy, "by_kernel_ms": by_name}
    print(f"[round] {args.spec} {args.src}: round {res['round_ms']:.3f} ms, "
          f"device busy {res['device_busy_ms']:.3f} ms, idle share "
          f"{res['idle_share']:.3f}; the port's kernels "
          f"{res['kernels_ms']:.4f} ms in {res['kernel_launches']:.0f} "
          f"launches a round ({res['kernels_share_of_busy']:.1%} of busy): "
          f"{ {k: round(v, 4) for k, v in by_name.items()} } [{card}]",
          flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
