"""Wall-clock trace layer: Chrome-trace/Perfetto JSONL spans (port of
``repro/obs/trace.py``).

``Tracer`` appends one JSON event per line (after a leading ``[``), which
is at once a valid unterminated Chrome trace (load it in
``chrome://tracing`` or Perfetto) and line-parseable by ``python -m
repro_torch.obs.summary out.json``.  ``profile_dir`` attaches
``torch.profiler`` over the same window and exports its Chrome trace into
that directory on ``close()``.

Spans are host wall time.  CUDA work is queued, so a span around it
measures how long the host took to enqueue it unless the caller
synchronises inside the span (``torch.cuda.synchronize()`` before the
block ends), as ``repro_torch.perf_smoke`` does.

Also home of the shared ``timeit`` helper.
"""
from __future__ import annotations

import contextlib
import json
import os
import time

import torch


def _sync(out) -> None:
    for t in (out if isinstance(out, (tuple, list)) else [out]):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


def timeit(fn, *args, iters=5):
    """us per call of ``fn(*args)``: one untimed warm-up call, then the
    mean wall time of ``iters`` back-to-back calls, synchronised once on
    the output's device (``torch.cuda.synchronize`` on the card)."""
    _sync(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _sync(out)
    return (time.perf_counter() - t0) / iters * 1e6  # us


class Tracer:
    """Chrome-trace JSONL writer (one event per line, flushed eagerly so a
    crashed run still leaves a loadable trace)."""

    def __init__(self, path: str, profile_dir: str | None = None):
        self.path = path
        self._t0 = time.perf_counter()
        self._f = open(path, "w")
        self._f.write("[\n")
        self._f.flush()
        self._prof = None
        self._profile_dir = profile_dir
        if profile_dir:
            os.makedirs(profile_dir, exist_ok=True)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _event(self, ev: dict) -> None:
        if self._f.closed:
            return
        self._f.write(json.dumps(ev) + ",\n")
        self._f.flush()

    @contextlib.contextmanager
    def span(self, name: str, **args):
        """Complete-event ("ph": "X") span around the with-block."""
        ts = self._now_us()
        try:
            yield self
        finally:
            self._event({
                "name": name, "ph": "X", "pid": 0, "tid": 0,
                "ts": round(ts, 1),
                "dur": round(self._now_us() - ts, 1),
                "args": args,
            })

    def instant(self, name: str, **args) -> None:
        self._event({
            "name": name, "ph": "i", "s": "g", "pid": 0, "tid": 0,
            "ts": round(self._now_us(), 1), "args": args,
        })

    def counter(self, name: str, **values) -> None:
        self._event({
            "name": name, "ph": "C", "pid": 0, "tid": 0,
            "ts": round(self._now_us(), 1), "args": values,
        })

    def close(self) -> None:
        if self._prof is not None:
            prof, self._prof = self._prof, None
            prof.stop()
            prof.export_chrome_trace(
                os.path.join(self._profile_dir, "torch_trace.json"))
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _NullTracer:
    """API-compatible no-op, the default when no trace is asked for, so
    call sites never branch."""

    @contextlib.contextmanager
    def span(self, name: str, **args):
        yield self

    def instant(self, name: str, **args) -> None:
        pass

    def counter(self, name: str, **values) -> None:
        pass

    def close(self) -> None:
        pass


NULL = _NullTracer()


def load_events(path: str) -> list[dict]:
    """Parse a Tracer JSONL file back into a list of event dicts
    (tolerates the leading ``[``, trailing commas, and a torn tail)."""
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip().rstrip(",")
            if not line or line in "[]":
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # torn tail line of a crashed run
    return events
