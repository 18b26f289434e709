"""Time-varying agent graphs: a schedule of topologies, one per round
(port of ``repro/core/schedule.py``; see its docstring for the
asynchronous-ADMM semantics).

A ``TopologySchedule`` fixes one union topology, whose slots carry the
exchange, and a periodic ``[T, A, S]`` stack of per-round slot masks
(plus an optional ``[T, A]`` node-participation layer, already merged
into the slot masks).  Round ``k`` uses ``masks[k % T]``.  The masks are
host numpy, drawn with the reference's ``np.random.RandomState`` calls in
the reference's order, so both packages build equal arrays; the solvers
read a round's mask from a copy of the stack kept once per device, so no
round syncs to the host.

Spec strings (``make_graph`` / ``build_graph``): ``cycle:ring|star``,
``drop:p=0.2,base=complete``, ``gossip:edges=2,base=ring``,
``churn:p=0.1,base=complete``, ``burst:fail=0.1,recover=0.5``,
``sample:frac=0.25,base=complete``, or any static topology spec.
"""
from __future__ import annotations

import dataclasses
from math import gcd
from typing import Any

import numpy as np
import torch

from repro_torch.core.topology import (Exchange, GraphTopology, edge_set,
                                       make_topology, metropolis_weights,
                                       validate)


def _undirected(edges):
    return {(min(i, j), max(i, j)) for (i, j) in edges}


@dataclasses.dataclass(frozen=True, eq=False)
class TopologySchedule:
    """Periodic sequence of graphs over a fixed union topology.

    ``masks``: ``[T, A, S]`` bool round activity per (agent, slot), a
    subset of ``union.slot_mask()`` and symmetric per edge.
    ``node_masks``: optional ``[T, A]`` bool participation; an inactive
    node's slots are already off in ``masks``, and the solvers also
    freeze its x (``round_node_mask``)."""

    union: Any
    masks: np.ndarray
    name: str = "schedule"
    node_masks: np.ndarray | None = None
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def period(self) -> int:
        return self.masks.shape[0]

    @property
    def n_agents(self) -> int:
        return self.union.n_agents

    @property
    def n_slots(self) -> int:
        return self.union.n_slots

    # ---- host-side views ---------------------------------------------------

    def round_mask_host(self, t: int) -> np.ndarray:  # [A, S] bool
        return self.masks[t % self.period]

    def round_degrees(self, t: int) -> np.ndarray:  # [A] int
        return self.round_mask_host(t).sum(axis=1).astype(np.int64)

    def degrees(self) -> np.ndarray:
        """Period-mean active degree per agent (``[A]`` float): what the
        cost model and the wire accounting charge per round."""
        return self.masks.sum(axis=2).mean(axis=0)

    def round_node_mask_host(self, t: int) -> np.ndarray:  # [A] bool
        if self.node_masks is None:
            return np.ones((self.n_agents,), dtype=bool)
        return self.node_masks[t % self.period]

    def participation(self) -> float:
        """Period-mean fraction of participating nodes (1.0 without a
        node layer)."""
        if self.node_masks is None:
            return 1.0
        return float(self.node_masks.mean())

    def topology_at(self, t: int) -> GraphTopology:
        """The round-``t`` graph as a standalone ``GraphTopology``."""
        nbr, m = self.union.neighbor_table(), self.round_mask_host(t)
        edges = {
            (min(i, int(nbr[i, s])), max(i, int(nbr[i, s])))
            for i in range(self.n_agents)
            for s in range(self.n_slots)
            if m[i, s]
        }
        return GraphTopology.from_edges(
            self.n_agents, edges, name=f"{self.name}@{t % self.period}")

    # ---- device view: one index into the stack kept on the device ----------

    def _stack(self, what: str, device, rows=None):
        """The ``[T, A, ...]`` stack ``what`` on ``device``, kept; only the
        agents ``rows`` (a range of global ids; all when None)."""
        device = torch.device(device)
        key = (what, device, rows)
        t = self._cache.get(key)
        if t is None:
            host = getattr(self, what)
            if rows is not None:
                host = host[:, rows.start:rows.stop]
            t = torch.as_tensor(np.ascontiguousarray(host), device=device)
            self._cache[key] = t
        return t

    def round_mask(self, k: int, device="cpu", rows=None) -> torch.Tensor:
        """``[A, S]`` bool activity mask of round ``k`` on ``device`` (the
        agents ``rows`` only, where given: a mesh rank's)."""
        return self._stack("masks", device, rows)[k % self.period]

    def round_degrees_device(self, k: int, device="cpu",
                             rows=None) -> torch.Tensor:
        """``[A]`` int64 active degrees of round ``k`` on ``device`` (a row
        of the ``[T, A]`` stack kept there: no launch, no copy)."""
        return self._stack("_degree_stack", device, rows)[k % self.period]

    @property
    def _degree_stack(self) -> np.ndarray:  # [T, A] int64
        return self.masks.sum(axis=2).astype(np.int64)

    def round_node_mask(self, k: int, device="cpu",
                        rows=None) -> torch.Tensor | None:
        """``[A]`` bool participation of round ``k``, or None when the
        schedule has no node layer."""
        if self.node_masks is None:
            return None
        return self._stack("node_masks", device, rows)[k % self.period]


def static_schedule(topo) -> TopologySchedule:
    """A static ``Topology`` as a period-1 schedule (identity on
    schedules)."""
    if isinstance(topo, TopologySchedule):
        return topo
    masks = np.asarray(topo.slot_mask())[None].copy()
    return TopologySchedule(
        union=topo, masks=masks,
        name=f"static:{getattr(topo, 'name', type(topo).__name__)}")


def validate_schedule(sched: TopologySchedule) -> None:
    """Structural invariants on top of ``topology.validate(union)``."""
    validate(sched.union)
    um = sched.union.slot_mask()
    nbr = sched.union.neighbor_table()
    a, s_ = sched.n_agents, sched.n_slots
    assert sched.masks.shape == (sched.period, a, s_), sched.masks.shape
    assert sched.masks.dtype == np.bool_
    assert not (sched.masks & ~um[None]).any(), (
        "round mask activates a slot outside the union graph")
    for t in range(sched.period):
        m = sched.masks[t]
        for i in range(a):
            for s in range(s_):
                if not m[i, s]:
                    continue
                j, rs = int(nbr[i, s]), sched.union.reverse_slot[s]
                assert m[j, rs], (
                    f"round {t}: edge ({i},{j}) active at {i} but not {j}")
    ever = sched.masks.any(axis=0)
    assert (ever == um).all(), (
        "some union edge is never active — joint connectivity violated")
    if sched.node_masks is not None:
        nm = sched.node_masks
        assert nm.shape == (sched.period, a), nm.shape
        assert nm.dtype == np.bool_
        assert not (sched.masks & ~nm[:, :, None]).any(), (
            "edge mask active on an inactive node")
        assert nm.any(axis=0).all(), (
            "some node never participates — persistent node activation "
            "violated")


# ---------------------------------------------------------------------------
# Builders (the reference's RandomState draws, in the reference's order)
# ---------------------------------------------------------------------------


def _slot_of_edge(union):
    """{(i, j) undirected -> (s_i, s_j)}: the slot naming the edge at
    each endpoint."""
    nbr, um = union.neighbor_table(), union.slot_mask()
    out = {}
    for i in range(union.n_agents):
        for s in range(union.n_slots):
            j = int(nbr[i, s])
            if um[i, s] and i < j:
                out[(i, j)] = (s, union.reverse_slot[s])
    return out


def _masks_from_edge_rounds(union, round_edges):
    """``[T, A, S]`` masks from per-round undirected edge sets."""
    slots = _slot_of_edge(union)
    masks = np.zeros((len(round_edges), union.n_agents, union.n_slots),
                     dtype=bool)
    for t, es in enumerate(round_edges):
        for (i, j) in _undirected(es):
            s_i, s_j = slots[(i, j)]
            masks[t, i, s_i] = masks[t, j, s_j] = True
    return masks


def _force_coverage(round_edges, all_edges, rng):
    """Persistent activation: an edge absent from every round is spliced
    into one seeded-random round."""
    ever = set().union(*round_edges) if round_edges else set()
    for e in sorted(all_edges - ever):
        round_edges[rng.randint(len(round_edges))].add(e)
    return round_edges


def cycle_schedule(topos, name: str = "cycle") -> TopologySchedule:
    """Round k uses ``topos[k % T]``; the union is the edge union."""
    topos = list(topos)
    assert topos, "cycle_schedule needs at least one topology"
    a = topos[0].n_agents
    assert all(t.n_agents == a for t in topos), "mixed n_agents in cycle"
    round_edges = [_undirected(edge_set(t)) for t in topos]
    union = GraphTopology.from_edges(a, set().union(*round_edges), name=name)
    return TopologySchedule(
        union=union, masks=_masks_from_edge_rounds(union, round_edges),
        name=f"{name}:" + ",".join(getattr(t, "name", "?") for t in topos))


def drop_schedule(base, p: float = 0.2, seed: int = 0,
                  period: int = 16) -> TopologySchedule:
    """Seeded i.i.d. link failures over ``base`` (its own slots), each
    edge dropping with probability ``p`` per round."""
    assert 0.0 <= p < 1.0, p
    rng = np.random.RandomState(seed)
    edges = sorted(_undirected(edge_set(base)))
    round_edges = [{e for e in edges if rng.rand() >= p}
                   for _ in range(period)]
    round_edges = _force_coverage(round_edges, set(edges), rng)
    return TopologySchedule(
        union=base, masks=_masks_from_edge_rounds(base, round_edges),
        name=f"drop{p}:{getattr(base, 'name', '?')}")


def gossip_schedule(base, edges_per_round: int = 2, seed: int = 0,
                    period: int = 32) -> TopologySchedule:
    """Each round activates ``edges_per_round`` edges of ``base``,
    sampled without replacement."""
    assert edges_per_round >= 1, (
        f"gossip needs edges_per_round >= 1, got {edges_per_round} "
        f"(0 would activate nothing — use the static base instead)")
    rng = np.random.RandomState(seed)
    edges = sorted(_undirected(edge_set(base)))
    k = min(edges_per_round, len(edges))
    round_edges = [
        {edges[i] for i in rng.choice(len(edges), size=k, replace=False)}
        for _ in range(period)]
    round_edges = _force_coverage(round_edges, set(edges), rng)
    return TopologySchedule(
        union=base, masks=_masks_from_edge_rounds(base, round_edges),
        name=f"gossip{edges_per_round}:{getattr(base, 'name', '?')}")


def node_participation_schedule(base, node_masks, name: str = "nodes",
                                seed: int = 0) -> TopologySchedule:
    """Layer a ``[T, A]`` node mask over ``base`` (a static topology or
    an edge-only schedule; periods combine by lcm).  An inactive node
    switches off all its slots; an edge whose endpoints are never up
    together gets both spliced up in one seeded-random round."""
    node_masks = np.asarray(node_masks, dtype=bool)
    assert node_masks.ndim == 2, node_masks.shape
    rng = np.random.RandomState(seed)
    if isinstance(base, TopologySchedule):
        assert base.node_masks is None, (
            "base schedule already carries a node layer — merge the "
            "node masks before layering")
        union = base.union
        tn = node_masks.shape[0]
        t_all = base.period * tn // gcd(base.period, tn)
        edge_m = np.tile(base.masks, (t_all // base.period, 1, 1))
        node_m = np.tile(node_masks, (t_all // tn, 1))
    else:
        union = base
        t_all = node_masks.shape[0]
        um = union.slot_mask()
        edge_m = np.broadcast_to(um[None], (t_all,) + um.shape).copy()
        node_m = node_masks.copy()
    assert node_m.shape[1] == union.n_agents, node_m.shape
    nbr = union.neighbor_table()

    def merge():
        return edge_m & node_m[:, :, None] & node_m[:, nbr]

    merged = merge()
    for (i, j), (s_i, _) in sorted(_slot_of_edge(union).items()):
        if merged[:, i, s_i].any():
            continue
        live = np.nonzero(edge_m[:, i, s_i])[0]
        t = int(live[rng.randint(len(live))])
        node_m[t, i] = node_m[t, j] = True
    merged = merge()
    return TopologySchedule(union=union, masks=merged, name=name,
                            node_masks=node_m)


def churn_schedule(base, p: float = 0.1, seed: int = 0,
                   period: int = 16) -> TopologySchedule:
    """Seeded i.i.d. node dropout: each node inactive with probability
    ``p`` per round."""
    assert 0.0 <= p < 1.0, p
    rng = np.random.RandomState(seed)
    node = rng.rand(period, base.n_agents) >= p
    return node_participation_schedule(
        base, node, name=f"churn{p}:{getattr(base, 'name', '?')}",
        seed=rng.randint(2 ** 31 - 1))


def burst_schedule(base, fail: float = 0.1, recover: float = 0.5,
                   seed: int = 0, period: int = 32) -> TopologySchedule:
    """Bursty node failures: a seeded 2-state Markov chain per node (up
    -> down w.p. ``fail``, down -> up w.p. ``recover``)."""
    assert 0.0 <= fail < 1.0, fail
    assert 0.0 < recover <= 1.0, recover
    rng = np.random.RandomState(seed)
    up = np.ones(base.n_agents, dtype=bool)
    rows = []
    for _ in range(period):
        r = rng.rand(base.n_agents)
        up = np.where(up, r >= fail, r < recover)
        rows.append(up)
    return node_participation_schedule(
        base, np.stack(rows),
        name=f"burst{fail}-{recover}:{getattr(base, 'name', '?')}",
        seed=rng.randint(2 ** 31 - 1))


def sample_schedule(base, frac: float = 0.25, seed: int = 0,
                    period: int = 32) -> TopologySchedule:
    """Partial participation: each round a sampled subset of
    ``max(1, round(frac * A))`` agents computes and communicates."""
    assert 0.0 < frac <= 1.0, frac
    a = base.n_agents
    k = max(1, int(round(frac * a)))
    rng = np.random.RandomState(seed)
    node = np.zeros((period, a), dtype=bool)
    for t in range(period):
        node[t, rng.choice(a, size=k, replace=False)] = True
    return node_participation_schedule(
        base, node, name=f"sample{frac}:{getattr(base, 'name', '?')}",
        seed=rng.randint(2 ** 31 - 1))


# ---------------------------------------------------------------------------
# Spec parsing (the reference's grammar and messages)
# ---------------------------------------------------------------------------

SCHEDULES = ("cycle", "drop", "gossip", "churn", "burst", "sample")

# name -> (default base, builder, {param: (cast, default)})
_SPECS = {
    "drop": ("ring", drop_schedule,
             {"p": (float, 0.2), "seed": (int, 0), "period": (int, 16)}),
    "gossip": ("ring", gossip_schedule,
               {"edges": (int, 2), "seed": (int, 0), "period": (int, 32)}),
    "churn": ("complete", churn_schedule,
              {"p": (float, 0.1), "seed": (int, 0), "period": (int, 16)}),
    "burst": ("complete", burst_schedule,
              {"fail": (float, 0.1), "recover": (float, 0.5),
               "seed": (int, 0), "period": (int, 32)}),
    "sample": ("complete", sample_schedule,
               {"frac": (float, 0.25), "seed": (int, 0),
                "period": (int, 32)}),
}


def _parse_kw(rest: str) -> dict:
    kw = {}
    if rest:
        for item in rest.split(","):
            k, _, v = item.partition("=")
            kw[k.strip()] = v.strip()
    return kw


def _base_spec(kw: dict, default: str) -> str:
    """``base=erdos|p=0.4|seed=1`` -> ``erdos:p=0.4,seed=1``."""
    raw = kw.pop("base", default)
    name, _, params = raw.partition("|")
    return name + (":" + params.replace("|", ",") if params else "")


def make_schedule(spec: str, n_agents: int) -> TopologySchedule:
    """A schedule from a spec string (the reference's grammar; see the
    module docstring)."""
    name, _, rest = spec.partition(":")
    if name == "cycle":
        if "|" in rest:
            subs = rest.split("|")
        else:
            subs = rest.split(",")
            if any(":" in s or "=" in s for s in subs):
                raise ValueError(
                    f"cycle phases with parameters must be separated by "
                    f"'|' (commas belong to the sub-spec): got {spec!r}, "
                    f"e.g. cycle:ring|erdos:p=0.4,seed=1")
        subs = [s for s in (x.strip() for x in subs) if s]
        if not subs:
            raise ValueError(f"cycle schedule needs phases: {spec!r}")
        return cycle_schedule([make_topology(s, n_agents) for s in subs])
    if name not in _SPECS:
        raise ValueError(
            f"unknown schedule {spec!r}; choose from {SCHEDULES}")
    default_base, builder, params = _SPECS[name]
    kw = _parse_kw(rest)
    base = make_topology(_base_spec(kw, default_base), n_agents)
    unknown = set(kw) - set(params)
    if unknown:
        raise ValueError(
            f"{name} schedule got unknown params {sorted(unknown)}")
    args = {("edges_per_round" if k == "edges" else k):
            cast(kw[k]) if k in kw else default
            for k, (cast, default) in params.items()}
    return builder(base, **args)


def make_graph(spec: str, n_agents: int):
    """A static ``Topology`` or a ``TopologySchedule``, by the spec's
    prefix."""
    if spec.partition(":")[0] in SCHEDULES:
        return make_schedule(spec, n_agents)
    return make_topology(spec, n_agents)


def union_topology(graph):
    """The static topology carrying the exchange: ``graph.union`` for a
    schedule, ``graph`` itself otherwise."""
    return graph.union if isinstance(graph, TopologySchedule) else graph


def build_graph(spec: str, n_agents: int, axis=None, mesh=None):
    """``(graph, exchange)`` from one spec string; the exchange runs over
    the union graph's slots (in one process when ``axis`` is None, else
    between the ranks of ``mesh``'s axis ``axis``)."""
    graph = make_graph(spec, n_agents)
    return graph, Exchange(union_topology(graph), axis=axis, mesh=mesh)


# ---------------------------------------------------------------------------
# Per-round gossip weights for the baselines
# ---------------------------------------------------------------------------


def metropolis_schedule(sched: TopologySchedule) -> np.ndarray:
    """``[T, A, A]`` Metropolis-Hastings weights per round (float64, each
    doubly stochastic for that round's graph), built once per
    schedule."""
    w = sched._cache.get("metropolis")
    if w is None:
        w = np.stack([metropolis_weights(sched.topology_at(t))
                      for t in range(sched.period)])
        sched._cache["metropolis"] = w
    return w
