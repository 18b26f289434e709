#!/usr/bin/env python3
"""Host time of K4's shard form over one message tree, for one checkout.

    python3 tools/k4_tree_host.py [--root DIR] [--label NAME]

Imports the port (and its ``chip_smoke.py`` helpers) from DIR, this
checkout by default, so that another checkout unpacked with
``git archive`` can be timed in turns beside this one: run root A, B, B,
A in one call.  On rank 0's shards (2 ranks, 2 messages, host keys) of
qwen3-0.6b cut to one layer (13 leaves, the tp phase's tree) and at its
full depth, prints one JSON line: the mean host ms of the wrappers
(``tree_absmax`` + ``quantize_tree``, no all-reduce) from an idle card
and back to back, and of one ``shard_plan`` lookup.  Needs a CUDA card.
"""

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time


def tree_times(cs, n_layers):
    """The host times of one tree of ``n_layers`` (None: all)."""
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.core import jaxrand
    from repro_torch.kernels.quantize import ops
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps, train

    arch = ARCHS[cs.TP_TRAIN_ARCH]
    cfg = train.train_config(arch, smoke=False)
    cfg = dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers)
    lays = tuple(shd.shard_layouts(cs._StandIn(2, 0), "admm",
                                   steps.model_specs(arch, cfg)))
    m, dev = 2, torch.device("cuda")
    xs = [torch.randn((m, math.prod(lay.local_shape)), device=dev)
          for lay in lays]
    keys = jaxrand.split(jaxrand.split(jaxrand.key(5), m), len(lays))

    def grouped():
        w = ops.tree_absmax(xs, lays)
        return ops.quantize_tree(keys, xs, w, lays, bits=8)

    grouped()
    ops.shard_plan(lays, m, dev)
    n, t = 1000, time.perf_counter()
    for _ in range(n):
        ops.shard_plan(lays, m, dev)
    lookup = (time.perf_counter() - t) / n * 1e3
    out = {"leaves": len(lays), "elements": sum(x.numel() for x in xs),
           "idle_host_ms": cs.idle_host_ms(grouped),
           "host_ms": cs.host_ms(grouped), "plan_lookup_ms": lookup}
    del xs
    torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default=None)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    import torch

    if not torch.cuda.is_available():
        print("k4_tree_host: CUDA is not available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()[:1]
    print(json.dumps({"label": args.label or root, "card": card,
                      "cut": tree_times(cs, cs.TP_TRAIN_LAYERS),
                      "full": tree_times(cs, None)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
