"""Time-cost accounting of the paper's Table I (port of
``repro/core/costmodel.py``).

The paper charges t_g per component-gradient evaluation and t_c per
communication round.  ``round_cost`` hooks on the solvers return the cost
of ONE outer round in these units; for the single-loop baselines an outer
round is one iteration, so Fig.-2-style comparisons advance a baseline
tau iterations per LT-ADMM-CC round.

Degree awareness: t_c is calibrated on the paper's ring (degree 2).  On a
general graph an agent serialises one message per incident edge, so a
communication round costs ``t_c * mean_degree / 2``
(``CostModel.for_topology``).  Participation: a graph with a
``participation()`` method (the reference's node schedules, not ported
yet) charges ``t_g * participation`` per gradient evaluation; a static
graph charges full participation.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CostModel:
    t_g: float = 1.0
    t_c: float = 10.0  # paper Fig. 2 regime: t_c = 10 t_g
    mean_degree: float = 2.0  # ring default; see for_topology
    participation: float = 1.0  # fraction of nodes computing per round

    @classmethod
    def for_topology(cls, topo, t_g: float = 1.0, t_c: float = 10.0):
        """Degree- and participation-aware cost model of ``topo``."""
        return cls(t_g=t_g, t_c=t_c,
                   mean_degree=float(np.mean(topo.degrees())),
                   participation=float(
                       getattr(topo, "participation", lambda: 1.0)()))

    @classmethod
    def for_learned_graph(cls, topo, degree_cap: int, t_g: float = 1.0,
                          t_c: float = 10.0):
        """A solver that learns its graph under a per-row degree cap
        charges ``min(degree, degree_cap)`` messages per agent."""
        base = cls.for_topology(topo, t_g=t_g, t_c=t_c)
        capped = float(np.mean(np.minimum(topo.degrees(), degree_cap)))
        return dataclasses.replace(base, mean_degree=capped)

    @property
    def t_comm(self) -> float:
        """Cost of one communication round on this graph."""
        return self.t_c * self.mean_degree / 2.0

    @property
    def t_grad(self) -> float:
        """Mean per-agent cost of one component-gradient evaluation."""
        return self.t_g * self.participation

    def lt_admm_cc(self, m: int, tau: int) -> float:
        """(m + tau - 1) t_g + 2 t_c, Table I's last row: the SAGA table
        reset (m evaluations), tau - 1 single evaluations, and the x- and
        z-messages."""
        return (m + tau - 1) * self.t_grad + 2 * self.t_comm

    def lead(self, tau: int) -> float:
        return tau * (self.t_grad + self.t_comm)

    def cedas(self, tau: int) -> float:
        return tau * (self.t_grad + 2 * self.t_comm)

    def cold_dpdc_sgd(self, tau: int) -> float:
        return tau * (self.t_grad + self.t_comm)

    def cold_dpdc_full(self, tau: int, m: int) -> float:
        return tau * (m * self.t_grad + self.t_comm)

    def dsgd(self, tau: int) -> float:
        return tau * (self.t_grad + self.t_comm)
