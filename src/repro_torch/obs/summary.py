"""Trace summary CLI: per-phase / per-counter report from Tracer JSONL
(port of ``repro/obs/summary.py``; the same text for the same events).

    PYTHONPATH=src python -m repro_torch.obs.summary out.json

Aggregates the Chrome-trace events written by ``obs.trace.Tracer``:
complete events ("X") are grouped by span name (count, total/mean/max
wall ms); counter events ("C") report their last sampled values; instant
events ("i") are listed with their timestamps.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.obs.trace import load_events


def summarize(events: list[dict]) -> str:
    spans: dict[str, list[float]] = {}
    counters: dict[str, dict] = {}
    instants: list[tuple[float, str, dict]] = []
    for ev in events:
        ph = ev.get("ph")
        if ph == "X":
            spans.setdefault(ev["name"], []).append(
                float(ev.get("dur", 0.0)) / 1e3)
        elif ph == "C":
            counters[ev["name"]] = ev.get("args", {})
        elif ph == "i":
            instants.append((float(ev.get("ts", 0.0)) / 1e3, ev["name"],
                             ev.get("args", {})))
    out = []
    if spans:
        out.append(f"{'span':40s} {'count':>6s} {'total ms':>11s} "
                   f"{'mean ms':>10s} {'max ms':>10s}")
        for name in sorted(spans, key=lambda n: -sum(spans[n])):
            ds = spans[name]
            out.append(f"{name:40s} {len(ds):6d} {sum(ds):11.1f} "
                       f"{sum(ds) / len(ds):10.1f} {max(ds):10.1f}")
    if counters:
        out.append("")
        out.append(f"{'counter':40s} last value")
        for name in sorted(counters):
            vals = ", ".join(f"{k}={v}"
                             for k, v in sorted(counters[name].items()))
            out.append(f"{name:40s} {vals}")
    if instants:
        out.append("")
        out.append(f"{'t ms':>10s}  instant")
        for ts, name, args in instants:
            extra = (" " + ", ".join(f"{k}={v}" for k, v in sorted(
                args.items()))) if args else ""
            out.append(f"{ts:10.1f}  {name}{extra}")
    return "\n".join(out) if out else "(no events)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="JSONL file written by obs.trace.Tracer")
    args = ap.parse_args(argv)
    print(summarize(load_events(args.trace)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
