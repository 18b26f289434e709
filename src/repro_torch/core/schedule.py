"""Graph construction from spec strings (static graphs only).

Port of ``make_graph``/``build_graph`` of ``repro/core/schedule.py``.  The
time-varying schedules (``cycle:``, ``drop:``, ``gossip:``, ``churn:``,
``burst:``, ``sample:``) are not ported yet and raise.
"""
from __future__ import annotations

from repro_torch.core.topology import Exchange, make_topology

SCHEDULES = ("cycle", "drop", "gossip", "churn", "burst", "sample")


def make_graph(spec: str, n_agents: int):
    """Static ``Topology`` from a spec string."""
    if spec.partition(":")[0] in SCHEDULES:
        raise NotImplementedError(
            f"time-varying schedule {spec!r} is not ported yet: ROADMAP "
            "Queue 1 item 9")
    return make_topology(spec, n_agents)


def build_graph(spec: str, n_agents: int):
    """``(graph, exchange)`` from one spec string."""
    graph = make_graph(spec, n_agents)
    return graph, Exchange(graph)
