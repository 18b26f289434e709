"""Learned collaboration graphs: personalized models trained jointly with a
sparse graph (port of ``repro/core/graphlearn.py``), in the style of Dada
(Zantedeschi, Bellet & Tommasi, AISTATS 2020).

Each agent trains its own model ``x_i`` (no exact consensus) and learns
per-edge collaboration weights of capped sparsity::

    min_{x, W}  sum_i f_i(x_i) + (mu / 2) sum_{ij} W_ij ||x_i - x_j||^2
                + lambda_g * entropic regularizer on each weight row,
    every row on the probability simplex with at most ``degree_cap``
    nonzeros inside the candidate graph.

``DadaSolver`` alternates behind the ``Solver`` protocol:

* **model rounds**: each agent descends its loss plus the coupling pull
  ``mu * sum_s c[i, s] (x_i - xhat_j)`` toward the mirrored models of its
  learned peers;
* **a graph round every ``graph_every`` rounds** (round 0 first): each
  row keeps its ``degree_cap`` nearest candidates by the mirror distance
  ``d[i, s] = ||xhat_i - xhat_j||^2`` and puts ``softmax(-mu d / (2
  lambda_g))`` on them; one scalar per edge over the same ``Exchange``
  then gives the coupling ``c[i, s] = (w_ij + w_ji) / 2`` where both
  endpoints chose the edge, 0 elsewhere (symmetric, within the cap).

The exchange always moves every candidate slot; the learned sparsity
only zeroes dead edges out of the math, while ``wire_bytes`` and
``round_cost`` charge the effective degree ``min(degree, degree_cap)``.

State (a dict, ``GossipSolverMixin`` conventions)::

    x     [A, ...]   personalized params (packed: the [A, N] plane)
    xhat  [A, ...]   compression mirrors (== x under the identity)
    w     [A, S]     learned row weights, each row on the simplex
    c     [A, S]     symmetric coupling, mutual support, <= cap a row
    k     int        round counter

The round counter is a Python int, so a model round skips the graph
round's work: the reference computes it every round and discards it
there (``where(do_graph, ...)``), which leaves ``w`` and ``c`` exactly as
they were.  Round 0's distances are all 0 (x0 = xhat = 0), so its support
comes from tie order alone: ``jax.lax.top_k`` takes the lowest slots, and
so does the stable descending sort here, on either device.

Spec: ``dada:lambda_g=0.1,mu=0.5,graph_every=5,degree_cap=3`` (and
``lr, batch_size, compressor, packed, faults``) through ``make_solver``.
A compressed round compresses through the per-message route
(``GossipSolverMixin._compress``): with qbit on the card one K4 and one
K5 launch a round.

On a mesh exchange a rank holds its agent rows (``exchange.rows``) of the
state, the data and every mask, keys fold the global agent ids, the
mirrors and the edge weights travel through the exchange's all-to-alls,
and the views over all agents (``learned_weights``, ``live_degrees``,
``personalized_grad_norm_sq``) gather the rows first: rank p's round
equals rows ``exchange.rows`` of the one-process round bit for bit.
"""
from __future__ import annotations

import dataclasses
import functools
import operator
from typing import Any

import numpy as np
import torch

from repro_torch.common.trees import (first_leaf, meta_like, tree_add,
                                      tree_flatten, tree_map, tree_sub,
                                      tree_zeros_like)
from repro_torch.core import compression, faults as faults_mod, jaxrand
from repro_torch.core import packing
from repro_torch.core.baselines import GossipSolverMixin, _cache_field
from repro_torch.core.schedule import TopologySchedule, union_topology
from repro_torch.core.topology import Exchange
from repro_torch.obs import telemetry

# ---------------------------------------------------------------------------
# The closed-form graph update
# ---------------------------------------------------------------------------


def row_simplex_weights(dist, cand_mask, mu, lambda_g, degree_cap):
    """Closed-form row update from pairwise distances: over the
    probability simplex restricted to each row's ``degree_cap`` nearest
    candidates, the minimiser of ``(mu / 2) <w_i, d_i> + lambda_g <w_i,
    log w_i>``, i.e. ``softmax(-mu d / (2 lambda_g))`` on that support.

    ``dist`` ``[A, S]`` squared distances, ``cand_mask`` ``[A, S]`` bool.
    Returns ``(w, keep)``: each row of ``w`` sums to 1 over at most
    ``degree_cap`` nonzeros (a row without candidates is all zero), and
    ``keep`` is the chosen support.  Ties go to the lower slot, as
    ``jax.lax.top_k`` breaks them."""
    a, s = dist.shape
    neg = torch.where(cand_mask, -dist, -torch.inf)
    k = min(int(degree_cap), s)
    vals, idx = torch.sort(neg, dim=1, descending=True, stable=True)
    keep = torch.zeros((a, s), dtype=torch.bool, device=dist.device)
    # a row with fewer candidates than the cap picks -inf slots: not kept
    keep = keep.scatter(1, idx[:, :k], vals[:, :k] > -torch.inf)
    logits = torch.where(keep, -dist * (mu / (2.0 * lambda_g)), -torch.inf)
    # softmax over an all -inf row is nan; such rows have no candidate
    # and are zeroed here
    w = torch.softmax(logits, dim=1)
    has = keep.any(dim=1, keepdim=True)
    return torch.where(has & keep, w, 0.0), keep


def pairwise_dist_sq(xhat, xhat_nbr):
    """``[A, S]`` squared distances ``||xhat_i - xhat_j||^2`` from the
    mirrors (leaves ``[A, ...]``) and their slot-gathered view (``[A, S,
    ...]``), mirror to mirror, so both ends of an edge derive the same
    value from what travelled.  The difference form, as the reference's:
    ``|a|^2 + |b|^2 - 2<a, b>`` gives other numbers."""
    def one(a, b):
        diff = b - a[:, None]
        return torch.sum(diff * diff, dim=tuple(range(2, diff.dim())))

    return functools.reduce(operator.add,
                            tree_flatten(tree_map(one, xhat, xhat_nbr))[0])


def _edge_scale(cw, leaf_nbr):
    """``[A, S]`` edge weights broadcast over a ``[A, S, ...]`` leaf."""
    return cw.reshape(tuple(cw.shape) + (1,) * (leaf_nbr.dim() - 2))


def _pull(cw, x, x_nbr):
    """``sum_s cw[i, s] (x_i - x_nbr[i, s])`` per leaf."""
    return tree_map(
        lambda xl, nl: torch.sum(_edge_scale(cw, nl) * (xl[:, None] - nl),
                                 dim=1), x, x_nbr)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# ---------------------------------------------------------------------------
# Dense views and graph-quality metrics (host side)
# ---------------------------------------------------------------------------


def dense_weights(topo, edge_w) -> np.ndarray:
    """``[A, A]`` float64 matrix from per-slot weights ``edge_w`` ``[A,
    S]`` over the static candidate topology ``topo`` (a schedule's
    union); masked slots contribute nothing."""
    w = _host(edge_w)
    nbr, mask = topo.neighbor_table(), np.asarray(topo.slot_mask())
    a, s = w.shape
    out = np.zeros((a, a), dtype=np.float64)
    for j in range(s):
        live = mask[:, j]
        out[np.arange(a)[live], nbr[live, j]] = w[live, j]
    return out


def edge_precision_recall(w, true_edges, tol=0.0):
    """Precision and recall of the learned support ``{(i, j): W_ij > tol
    or W_ji > tol}`` against undirected ground-truth edges."""
    a = w.shape[0]
    pred = {(i, j) for i in range(a) for j in range(i + 1, a)
            if w[i, j] > tol or w[j, i] > tol}
    true = {(min(i, j), max(i, j)) for (i, j) in true_edges}
    tp = len(pred & true)
    return (tp / len(pred) if pred else 1.0,
            tp / len(true) if true else 1.0)


def personalized_grad_norm_sq(solver, state, grad_fn, data):
    """Mean over agents of the squared norm of the personalized
    objective's gradient ``grad f_i(x_i) + mu sum_s c[i, s] (x_i - x_j)``
    at the current coupling: the stationarity measure of the joint
    objective.  ``grad_fn(x, data)`` is the batched full local gradient
    (``[A, ...]``).  A 0-d tensor on the state's device (no sync); on a
    mesh the mean over every rank's rows."""
    x = solver.consensus_params(state)
    g = grad_fn(x, data)
    pull = _pull(state["c"], x, solver.exchange.gather_batched(x))
    total = tree_map(lambda gl, pl: gl + solver.mu * pl, g, pull)
    sq = functools.reduce(operator.add, [
        torch.sum(leaf * leaf, dim=tuple(range(1, leaf.dim())))
        for leaf in tree_flatten(total)[0]])
    return torch.mean(solver.exchange.gather_rows(sq))


# ---------------------------------------------------------------------------
# The solver
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DadaSolver(GossipSolverMixin):
    """Personalized models and a sparse collaboration graph, learned
    jointly (module docstring).  ``consensus_params`` returns the
    per-agent models: there is no exact consensus."""

    topo: Any  # Topology | TopologySchedule (candidates = the union)
    exchange: Exchange = None
    lr: float = 0.05
    mu: float = 0.5
    lambda_g: float = 0.1
    graph_every: int = 5
    degree_cap: int = 2
    batch_size: int = 1
    compressor: Any = None  # None: exact broadcast (identity wire)
    grad_est: Any = None
    packed: bool = True
    faults: Any = None  # core.faults.FaultPlane | None (oracle darkness)
    name: str = "dada"
    device: torch.device = torch.device("cpu")
    _cache: dict = _cache_field()

    state_fields = ("x", "xhat", "w", "c")

    # one f32 weight per charged edge travels in a graph round (the row
    # weight being symmetrised); distances come from the model exchange
    GRAPH_MSG_BYTES = 4

    def __post_init__(self):
        if self.exchange is None:
            raise ValueError("dada needs the Exchange over its candidate "
                             "graph (make_solver passes it)")
        if self.graph_every < 1 or self.degree_cap < 1:
            raise ValueError(f"dada: graph_every={self.graph_every} and "
                             f"degree_cap={self.degree_cap} must be >= 1")
        if not self.lambda_g > 0.0:
            raise ValueError(f"dada: lambda_g={self.lambda_g} must be > 0")

    # ---- candidate structure ------------------------------------------------

    @property
    def _union(self):
        return union_topology(self.topo)

    def _cand_mask(self, device) -> torch.Tensor:
        """``[A, S]`` bool candidate slots on ``device``, kept."""
        key = ("cand", torch.device(device))
        m = self._cache.get(key)
        if m is None:
            m = torch.as_tensor(
                self._my_rows(np.asarray(self._union.slot_mask())),
                device=device)
            self._cache[key] = m
        return m

    def _capped_degrees(self, k: int, device) -> torch.Tensor:
        """``[A]`` int64 ``min(live degree, degree_cap)`` of round k: a
        row of a stack kept on ``device`` (no launch, no copy)."""
        key = ("capped", torch.device(device))
        d = self._cache.get(key)
        if d is None:
            masks = (self.topo.masks if isinstance(self.topo,
                                                   TopologySchedule)
                     else np.asarray(self._union.slot_mask())[None])
            capped = np.minimum(masks.sum(axis=2), self.degree_cap)
            r = self._rows
            if r is not None:
                capped = capped[:, r.start:r.stop]
            d = torch.as_tensor(capped.astype(np.int64), device=device)
            self._cache[key] = d
        return d[k % d.shape[0]]

    # ---- init and one round ---------------------------------------------

    def _init(self, x0):
        union = self._union
        mask = np.asarray(union.slot_mask())
        nbr = union.neighbor_table()
        deg = np.maximum(mask.sum(axis=1), 1)
        # the uniform row simplex over the candidates and its exact
        # symmetrisation (replaced at round 0, a graph round), in float64
        # as the reference builds them
        w0 = np.where(mask, 1.0 / deg[:, None], 0.0)
        rs = np.asarray(union.reverse_slot)
        c0 = np.where(mask, 0.5 * (w0 + w0[nbr, rs[None, :]]), 0.0)
        dev = first_leaf(x0).device
        return {"x": x0, "xhat": tree_zeros_like(x0),
                "w": torch.as_tensor(self._my_rows(w0), dtype=torch.float32,
                                     device=dev),
                "c": torch.as_tensor(self._my_rows(c0), dtype=torch.float32,
                                     device=dev)}

    def _step(self, state, data, key, k, est):
        x, xhat, w, c = state["x"], state["xhat"], state["w"], state["c"]
        dev = first_leaf(x).device
        g = self._sample(est, x, data, key)

        # broadcast: advance the mirrors by one compressed innovation,
        # then read every candidate's mirror (one slot-batched exchange)
        q = self._compress(jaxrand.fold_in(key, 1), tree_sub(x, xhat))
        xhat = tree_add(xhat, q)
        xhat_nbr = self.exchange.gather_batched(xhat)

        # live candidate slots: a schedule masks its round's links
        am = self._cand_mask(dev)
        rows = self._rows
        if isinstance(self.topo, TopologySchedule):
            am = am & self.topo.round_mask(k, dev, rows)
        fp = self.faults
        if fp is not None and fp.active:
            # no per-edge payload wire: darkness comes from the oracle,
            # one pinned copy a round; crashed agents also hold all their
            # state (GossipSolverMixin.step)
            am = am & self._my_rows(fp.edge_ok(k, self._union, dev))

        if k % self.graph_every == 0:
            # graph round: the closed-form rows, then one scalar per edge
            # over the same exchange (my slot-s weight of edge (i, j)
            # meets j's reverse-slot weight of it)
            w_new, _ = row_simplex_weights(pairwise_dist_sq(xhat, xhat_nbr),
                                           am, self.mu, self.lambda_g,
                                           self.degree_cap)
            w_rev = self.exchange.exchange_batched(w_new)
            mutual = (w_new > 0) & (w_rev > 0)
            # the whole coupling row is renegotiated: dark edges are
            # suspended until a graph round sees them live; a w row with
            # no live candidate keeps its previous simplex row
            c = torch.where(mutual, 0.5 * (w_new + w_rev), 0.0)
            w = torch.where(am.any(dim=1, keepdim=True), w_new, w)

        # model round: the personalized weighted-consensus step; dead and
        # dark edges carry no pull
        pull = _pull(torch.where(am, c, 0.0), x, xhat_nbr)
        x = tree_map(lambda xl, gl, pl: xl - self.lr * (gl + self.mu * pl),
                     x, g, pull)
        return {"x": x, "xhat": xhat, "w": w, "c": c}

    # ---- telemetry tap: learned-degree accounting ------------------------

    def _emit_telemetry(self, state, data, k: int, node_mask):
        """The learned graph's wire contract (``wire_bytes(params, t)``):
        the model message on at most ``degree_cap`` live candidate edges
        an agent, plus one ``GRAPH_MSG_BYTES`` weight per charged edge in
        a graph round; fault darkness refines the receives, never the
        transmission charge.  Device terms only, no host sync."""
        dev = first_leaf(state["x"]).device
        deg = self._capped_degrees(k, dev)
        per_msg = telemetry.message_nbytes(
            self._wire_compressor(),
            compression.like_per_message(state["x"]))
        do_graph = int(k % self.graph_every == 0)
        m = next(iter(data.values())).shape[1]
        evals = telemetry.round_grad_evals(self.grad_est, m, self.batch_size)
        counters = dict(
            tx_bytes=(deg, per_msg + do_graph * self.GRAPH_MSG_BYTES),
            tx_msgs=(deg, 1 + do_graph),
            participations=1 if node_mask is None else node_mask,
            grad_evals=evals if node_mask is None else (node_mask, evals))
        if do_graph:
            counters["graph_rounds"] = 1
        fp = self.faults
        if fp is not None and fp.active:
            # candidates only
            dark = self._my_rows(fp.edge_dark(k, self._union, dev))
            if isinstance(self.topo, TopologySchedule):
                dark = dark & self.topo.round_mask(k, dev, self._rows)
            counters["rx_dropped"] = dark.sum(dim=1)
        telemetry.emit(**counters)

    # ---- sharding: w and c are edge-shaped ---------------------------------

    def _abstract_fields(self, x):
        edge = meta_like((first_leaf(x).shape[0], self._union.n_slots),
                         torch.float32)
        return {"x": x, "xhat": x, "w": edge, "c": edge}

    def state_sharding(self, x_ps, edge_ps, scalar_ps):
        return {"x": x_ps, "xhat": x_ps, "w": edge_ps, "c": edge_ps,
                "k": scalar_ps}

    # ---- learned-graph views ----------------------------------------------

    def learned_weights(self, state) -> np.ndarray:
        """``[A, A]`` dense symmetric coupling of ``state`` (every rank's
        rows on a mesh)."""
        return dense_weights(self._union,
                             self.exchange.gather_rows(state["c"]))

    def live_degrees(self, state) -> np.ndarray:
        """``[A]`` learned degree per agent: the support of ``c`` (every
        rank's rows on a mesh)."""
        return (_host(self.exchange.gather_rows(state["c"])) > 0).sum(
            axis=1)

    # ---- accounting: dead edges are never charged ------------------------

    def _deg_eff(self, t=None) -> float:
        """The busiest agent's effective degree: the candidate degree (a
        schedule's round-t, or period-mean, active degree) clamped at
        ``degree_cap``."""
        topo = self.topo
        if t is not None and hasattr(topo, "round_degrees"):
            deg = topo.round_degrees(t)
        else:
            deg = topo.degrees()
        return float(np.max(np.minimum(deg, self.degree_cap)))

    def _per_edge(self, params) -> int:
        if self.packed:
            params = packing.abstract_plane(params)
        return compression.tree_wire_bytes(self._wire_compressor(), params)

    def wire_bytes(self, params, t: int | None = None) -> int:
        """The busiest agent's tx bytes a round over live edges only: the
        (compressed) model message per live edge every round, plus the
        4-byte weight per live edge in graph rounds (``t=None``: amortised
        as ``1 / graph_every`` a round)."""
        per_edge = self._per_edge(params)
        if t is not None:
            nb = self._deg_eff(t) * per_edge
            if t % self.graph_every == 0:
                nb += self._deg_eff(t) * self.GRAPH_MSG_BYTES
            return int(round(nb))
        return int(round(self._deg_eff() * (
            per_edge + self.GRAPH_MSG_BYTES / self.graph_every)))

    def live_wire_bytes(self, state, params) -> int:
        """The busiest agent's model-message bytes on the current learned
        graph: only edges with ``c > 0`` carry a payload."""
        return int(np.max(self.live_degrees(state))) * self._per_edge(params)

    def round_cost(self, cost_model, m: int) -> float:
        """(t_g, t_c) cost of a round: one stochastic gradient step, one
        communication round on the live graph and the amortised graph
        round; pair with ``CostModel.for_learned_graph``."""
        del m
        return (cost_model.t_grad
                + (1.0 + 1.0 / self.graph_every) * cost_model.t_comm)


# ---------------------------------------------------------------------------
# Registry factory (registered by core.solver)
# ---------------------------------------------------------------------------

DADA_PARAMS = ("lr", "mu", "lambda_g", "graph_every", "degree_cap",
               "batch_size", "compressor", "packed", "faults")


def make_dada(graph, exchange, grad_est, device, **kw):
    comp = kw.pop("compressor", None)
    if isinstance(comp, str):
        comp = compression.get_compressor(comp)
    fp = faults_mod.get_faults(kw.pop("faults", None))
    kw = {k: compression.coerce_param(v) for k, v in kw.items()}
    return DadaSolver(topo=graph, exchange=exchange, grad_est=grad_est,
                      compressor=comp, faults=fp, device=device, **kw)
