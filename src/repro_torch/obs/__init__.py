"""Observability: telemetry counters beside the solver state and
wall-clock span tracing (port of ``repro/obs``).

* ``obs.telemetry``: a typed counter tuple that rides beside a wrapped
  solver's state (no host syncs, no trajectory changes); solvers opt in
  through ``with_telemetry(solver)``.
* ``obs.trace``: wall-clock spans written as Chrome-trace/Perfetto JSONL
  (``Tracer``), and the shared ``timeit`` helper.
  ``python -m repro_torch.obs.summary out.json`` prints a per-phase
  report.
"""
from repro_torch.obs.telemetry import (  # noqa: F401
    Telemetry,
    TelemetryState,
    counters,
    with_telemetry,
)
from repro_torch.obs.trace import Tracer, timeit  # noqa: F401
