#!/usr/bin/env python3
"""Time K10's wrapper (``kernels/flash_attention/ops.flash_attention``)
against its bare tensor-core launch, for one or more checkouts of the
port, in turns, so that the wrapper's host cost per call can be compared
between versions within one run on one card.

    python3 tools/k10_wrapper_probe.py [--turns N] [ROOT ...]

Each ROOT is a directory holding ``src/repro_torch`` (default: this
checkout); its K10 is built into ROOT's own ``build/``.  Every (turn,
root) runs in a process of its own, the roots in order and then in
reverse, so a drift of the card or the host over the run falls on every
root alike.  In each process, at the bf16 shapes of the served prefills
that reach K10 with no ``OpCounter`` active:

* seamless-m4t-medium's encoder, q/k/v [2, 512, 16, 64], non-causal;
* its decoder, [2, 2048, 16, 64], causal;
* qwen3-0.6b, q [4, 2048, 16, 128], k/v 8 heads, causal;

the wrapper's output is held equal, bit for bit, to the bare launch's on
the same inputs (drawn from seed 0), then each is timed by CUDA events
over 200 back-to-back calls after 20 warm-up calls (the events' span
includes any wait of the card for the host, which is what a wrapper's
host cost adds).  Needs a CUDA card and nvcc; prints the card's name and
power limit, one line a (turn, root), and one JSON object as its last
line.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (label, (B, T, H, Dh), kv heads, causal)
SHAPES = (("seamless encoder", (2, 512, 16, 64), 16, False),
          ("seamless decoder", (2, 2048, 16, 64), 16, True),
          ("qwen3 prefill", (4, 2048, 16, 128), 8, True))
ITERS, WARMUP = 200, 20


def events_ms(fn):
    import torch

    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def measure(root):
    """One process's rows for the port under ``root``."""
    sys.path.insert(0, os.path.join(root, "src"))
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops

    assert os.path.samefile(os.path.dirname(ops.__file__), os.path.join(
        root, "src", "repro_torch", "kernels", "flash_attention"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for label, (b, t, h, dh), kh, causal in SHAPES:
        q = torch.randn((b, t, h, dh), device="cuda", dtype=torch.bfloat16,
                        generator=gen)
        k, v = (torch.randn((b, t, kh, dh), device="cuda",
                            dtype=torch.bfloat16, generator=gen)
                for _ in range(2))
        out = torch.empty_like(q)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                t, t, h, kh, dh, int(causal), 0, 1.0 / math.sqrt(dh))
        got = ops.flash_attention(q, k, v, causal=causal)
        _build.launch("flash_attention_tc", *args)
        if ops.route(q, k, v) != "tc" or not torch.equal(got, out):
            raise AssertionError(f"{label}: the wrapper's output is not "
                                 f"the bare tc launch's")
        rows.append({
            "shape": label,
            "wrapper_ms": events_ms(
                lambda: ops.flash_attention(q, k, v, causal=causal)),
            "bare_ms": events_ms(
                lambda: _build.launch("flash_attention_tc", *args))})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", default=[HERE])
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        print(json.dumps(measure(args.child)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("k10_wrapper_probe: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    roots = [os.path.abspath(r) for r in args.roots]
    runs = []
    for turn in range(args.turns):
        for root in roots + roots[::-1]:
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", root],
                capture_output=True, text=True, check=True).stdout
            rows = json.loads(out.strip().splitlines()[-1])
            runs.append({"turn": turn, "root": root, "rows": rows})
            print(json.dumps(runs[-1]), flush=True)
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
