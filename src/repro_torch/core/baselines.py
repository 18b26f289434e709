"""The gossip baselines of the paper's Fig. 2 (port of
``repro/core/baselines.py``): DSGD, CHOCO-SGD, and the reconstructions of
LEAD, COLD, CEDAS and DPDC, on the packed ``[A, N]`` plane or, with
``packed=false``, on the parameter pytree leaf by leaf.

Every baseline mixes with the Metropolis-Hastings matrix W of the same
graph LT-ADMM-CC runs on (``W @ x``, one f32 matrix product over the
agent axis per leaf), and compresses through the per-message route of
``core.compression``: on the card qbit launches K4/K5 once per
compression (per leaf) for all A messages, RandK's block sampler K8/K9,
RandK uniform/stride and TopK K6/K7.  On a ``TopologySchedule`` round k
mixes with that round's Metropolis weights, and an agent that does not
participate in round k (a node schedule's ``round_node_mask``) skips its
step and holds all its state.

    state = solver.init(x0)                # x0: [A, ...] stacked params
    state = solver.step(state, data, key)  # data leaves: [A, m, ...]

Random draws follow the reference's key derivations exactly: minibatch
indices ``randint(fold_in(key, aid), (B,), 0, m)``, compression keys
``fold_in(fold_in(key, 1), aid)`` then the per-leaf ``split``.  The
update formulas keep the reference's expression order (``a - lr * (b +
c)``, ``gamma_mix / (2 * lr)``) so that results stay bit-close.

Faults (``faults``, a ``core.faults.FaultPlane``): the dense gossip has no
per-edge payload wire, so a round's surviving edges come from the oracle
``FaultPlane.edge_ok`` (exactly what LT-ADMM's wire detection gives), and
round k mixes with the Metropolis weights of that surviving graph
(``_metropolis_online``, built on the host from the host masks), so every
round stays doubly stochastic and a fault-isolated agent keeps its own
value.  A crashed agent skips its step and holds its state.

On a mesh exchange (``Exchange(topo, axis, mesh)``, passed by
``make_solver``) a rank holds its agent rows ``exchange.rows``: the state,
the data and the masks are ``[A/W, ...]``, every key is folded with the
global agent id, and ``_mix`` all-gathers each leaf (or the packed plane)
over the agent axis, one collective a leaf, multiplies by the whole W and
keeps the rank's rows, so rank p's round equals rows ``exchange.rows`` of
the one-process round bit for bit (the whole product, not the rank's
``[A/W, A]`` rows of W, which a BLAS may reduce in another order).

Telemetry: while a ``obs.telemetry.with_telemetry`` wrapper steps the
solver, ``_emit_telemetry`` charges each iteration's messages with bytes
measured from the wire compressor's payload, the participation mask of
the hold, and the estimator's gradient evaluations; under faults the
oracle-dark edges count as dropped receives.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.common.trees import (abstract_counter, as_tensor,
                                      first_leaf, meta_like, tree_add,
                                      tree_map, tree_select, tree_sub,
                                      tree_zeros_like)
from repro_torch.core import compression, jaxrand, packing, vr
from repro_torch.core.schedule import TopologySchedule, metropolis_schedule
from repro_torch.core.topology import metropolis_weights
from repro_torch.obs import telemetry


def _metropolis_online(union, act):
    """f32 ``[A, A]`` Metropolis-Hastings weights of the graph whose active
    slots are ``act`` (``[A, S]`` bool numpy, symmetric per edge, a subset
    of the union's real slots), in the reference's f32 arithmetic: equal
    to ``metropolis_weights`` of the induced graph; an isolated agent gets
    the identity row (keeps its own value)."""
    a = union.n_agents
    nbr = union.neighbor_table()
    actf = act.astype(np.float32)
    deg = np.sum(actf, axis=1, dtype=np.float32)
    wslot = actf / (np.float32(1.0) + np.maximum(deg[:, None], deg[nbr]))
    w = np.zeros((a, a), dtype=np.float32)
    np.add.at(w, (np.arange(a)[:, None], nbr), wslot)
    return w + np.diag(np.float32(1.0) - np.sum(w, axis=1, dtype=np.float32))


class GossipSolverMixin:
    """``Solver``-protocol behaviour shared by the gossip baselines.
    Subclasses declare ``state_fields`` (the parameter-shaped entries of
    their state dict, ``"x"`` first) and ``comm_rounds`` (communication
    rounds per iteration, for the wire and cost accounting)."""

    state_fields: tuple = ("x",)
    comm_rounds: int = 1
    estimator: str = "sgd"

    @property
    def graph(self):
        return self.topo

    @property
    def _mesh(self):
        """The mesh exchange the rank's rows run on, or None."""
        ex = getattr(self, "exchange", None)
        return None if ex is None or ex.mesh is None else ex

    @property
    def _rows(self) -> range | None:
        """This rank's global agent rows on a mesh (None: all of them)."""
        ex = self._mesh
        return None if ex is None else ex.rows

    def _my_rows(self, a):
        """The rows of an ``[A, ...]`` array or tensor this process
        holds."""
        r = self._rows
        return a if r is None else a[r.start:r.stop]

    def _agents(self) -> torch.Tensor:
        """The global ids of the agents this process holds (host int64)."""
        return self._my_rows(torch.arange(self.topo.n_agents))

    def _sample(self, est, x, data, key):
        """Every agent's stochastic gradient through the bound
        estimator; agent i's minibatch key is ``fold_in(key, i)``."""
        m = next(iter(data.values())).shape[1]
        keys = jaxrand.fold_in(key, self._agents())
        idx = jaxrand.randint(keys, (self.batch_size,), 0, m).to(
            first_leaf(x).device)
        g, _ = est.estimate((), x, data, idx)
        return g

    def _compress(self, key, x):
        """Compress and decompress every agent's message of ``x`` (the
        EF-style reconstruction); agent i's key is ``fold_in(key, i)``."""
        comp = self._wire_compressor()
        keys = jaxrand.fold_in(key, self._agents())
        p = compression.compress_tree(comp, keys, x, nd=1)
        return compression.decompress_tree(
            comp, keys, p, compression.like_per_message(x), nd=1)

    def _layout(self, state) -> packing.PackedLayout:
        lay = self._cache.get("layout")
        if lay is None:  # a state carried in, init never called
            lay = packing.layout_of(state["x"][0])
            self._cache["layout"] = lay
        return lay

    def _weights(self, k: int, device):
        """Round k's f32 Metropolis-Hastings matrix on ``device`` (as the
        reference's ``jnp.asarray`` of the float64 weights); the static
        matrix, or the schedule's ``[T, A, A]`` stack, is kept per
        device."""
        W = self._cache.get(("W", device))
        if W is None:
            w = (metropolis_schedule(self.topo)
                 if isinstance(self.topo, TopologySchedule)
                 else metropolis_weights(self.topo))
            W = torch.as_tensor(w, dtype=torch.float32, device=device)
            self._cache[("W", device)] = W
        return W[k % self.topo.period] if W.dim() == 3 else W

    def _fault_weights(self, k: int, device):
        """Round k's weights under faults: Metropolis-Hastings of the
        round's edges (the schedule's, or the static graph's) that survive
        ``faults.edge_ok``, one host-to-device copy a round."""
        fp, topo = self.faults, self.topo
        if isinstance(topo, TopologySchedule):
            union = topo.union
            act = topo.round_mask_host(k)
        else:
            union = topo
            act = np.asarray(topo.slot_mask())
        act = act & fp.edge_ok(k, union).numpy()
        w = torch.from_numpy(_metropolis_online(union, act))
        if torch.device(device).type == "cpu":
            return w
        if torch.device(device).type != "cuda":  # a meta trace
            return w.to(device)
        return w.pin_memory().to(device, non_blocking=True)

    def _mix(self, x, k: int):
        """Gossip: ``W @ x`` over the agent axis of every ``[A, ...]``
        leaf.  A plain f32 product: PyTorch's default matmul precision
        ("highest", no TF32) keeps it so on the card.  On a mesh each leaf
        is all-gathered first and the rank keeps its rows of the
        product."""
        dev = first_leaf(x).device
        if self.faults is not None and self.faults.active:
            W = self._fault_weights(k, dev)
        else:
            W = self._weights(k, dev)
        ex = self._mesh
        full = x if ex is None else ex.gather_rows(x)
        out = tree_map(
            lambda t: torch.matmul(W, t.reshape(t.shape[0], -1))
            .reshape(t.shape), full)
        if ex is None:
            return out
        lo, hi = ex.rows.start, ex.rows.stop
        return tree_map(lambda t: t[lo:hi], out)

    def init(self, x0):
        """x0: stacked ``[A, ...]`` params (tensors or numpy arrays)."""
        x0 = tree_map(lambda t: as_tensor(t).to(self.device), x0)
        if self.packed:
            lay = packing.layout_of_stacked(x0)
            self._cache["layout"] = lay
            x0 = packing.pack(lay, x0)
        st = self._init(x0)
        st["k"] = 0
        return st

    def step(self, state, data, key):
        if self.grad_est is None:
            raise ValueError(
                f"{self.name}: bind a gradient estimator at construction "
                "(make_solver(..., grad_est=...))")
        est = (packing.PackedEstimator(self.grad_est, self._layout(state))
               if self.packed else self.grad_est)
        k = state["k"]
        st = self._step({f: state[f] for f in self.state_fields}, data, key,
                        k, est)
        # an agent out of round k skips its step and holds its state
        x0 = first_leaf(state["x"])
        rows = self._rows
        nm = (self.topo.round_node_mask(k, x0.device, rows)
              if isinstance(self.topo, TopologySchedule) else None)
        fp = self.faults
        if fp is not None and fp.crash > 0:
            # crashed agents hold like non-participating ones; their edges
            # are already dark through the edge_ok oracle
            alive = self._my_rows(~fp.crash_mask(k, self.topo.n_agents,
                                                 x0.device))
            nm = alive if nm is None else nm & alive
        if nm is not None:
            st = {f: tree_select(nm, st[f], state[f])
                  for f in self.state_fields}
        if telemetry.active():
            self._emit_telemetry(state, data, k, nm)
        st["k"] = k + 1
        return st

    def _emit_telemetry(self, state, data, k: int, node_mask):
        """One iteration's telemetry (only while a ``with_telemetry``
        wrapper steps): one message per active incident edge per
        communication round, its bytes measured from the payload the wire
        compressor emits; the oracle-dark edges of a faulted round as
        dropped receives.  Device terms only, no host sync: the degrees
        are a row of a stack kept on the device, the dark edges one
        pinned copy."""
        dev = first_leaf(state["x"]).device
        topo, rows = self.topo, self._rows
        if isinstance(topo, TopologySchedule):
            deg, union = topo.round_degrees_device(k, dev, rows), topo.union
        else:
            deg, union = self._cache.get(("degrees", dev)), topo
            if deg is None:
                deg = torch.as_tensor(
                    self._my_rows(np.asarray(topo.slot_mask()).sum(1)),
                    dtype=torch.int64, device=dev)
                self._cache[("degrees", dev)] = deg
        per_msg = telemetry.message_nbytes(
            self._wire_compressor(),
            compression.like_per_message(state["x"]))
        m = next(iter(data.values())).shape[1]
        evals = telemetry.round_grad_evals(self.grad_est, m, self.batch_size)
        counters = dict(
            tx_bytes=(deg, self.comm_rounds * per_msg),
            tx_msgs=(deg, self.comm_rounds),
            participations=1 if node_mask is None else node_mask,
            grad_evals=evals if node_mask is None else (node_mask, evals))
        fp = self.faults
        if fp is not None and fp.active:
            dark = self._my_rows(fp.edge_dark(k, union, dev))  # real slots
            if isinstance(topo, TopologySchedule):
                dark = dark & topo.round_mask(k, dev, rows)
            counters["rx_dropped"] = dark.sum(dim=1)
        telemetry.emit(**counters)

    def consensus_params(self, state):
        if self.packed:
            return packing.unpack(self._layout(state), state["x"])
        return state["x"]

    # ---- sharding / lowering hooks ----------------------------------------

    def abstract_state(self, x_sds):
        """The state's ``meta`` tree from stacked ``[A, ...]`` ``meta``
        params, derived from ``state_fields`` (``init`` is not run): the
        packed plane ``[A, N]`` where packed, an int32 counter."""
        if self.packed:
            a = first_leaf(x_sds).shape[0]
            lay = packing.layout_of_stacked(x_sds)
            self._cache["layout"] = lay
            x_sds = meta_like((a, lay.size), lay.dtype)
        st = self._abstract_fields(x_sds)
        st["k"] = abstract_counter()
        return st

    def _abstract_fields(self, x):
        return {f: x for f in self.state_fields}

    def state_sharding(self, x_ps, edge_ps, scalar_ps):
        """Every parameter-shaped field shards like the stacked params;
        the round counter is replicated (``edge_ps`` is unused here)."""
        del edge_ps
        out = {f: x_ps for f in self.state_fields}
        out["k"] = scalar_ps
        return out

    def _wire_compressor(self):
        """What moves per neighbour message: the configured compressor,
        or full precision for the uncompressed methods."""
        return getattr(self, "compressor", None) or compression.Identity()

    def wire_bytes(self, params, t: int | None = None) -> int:
        """Bytes the busiest agent transmits per iteration: one message
        (one per leaf when not packed) per incident edge per
        communication round; the period-mean active degree of a schedule,
        or round ``t``'s exact degree."""
        if self.packed:
            params = packing.abstract_plane(params)
        per_edge = compression.tree_wire_bytes(
            self._wire_compressor(), params) * self.comm_rounds
        if t is not None:
            deg = (self.topo.round_degrees(t)
                   if hasattr(self.topo, "round_degrees")
                   else self.topo.degrees())
            return int(np.max(deg)) * per_edge
        return int(round(float(np.max(self.topo.degrees())) * per_edge))

    def round_cost(self, cost_model, m: int) -> float:
        """(t_g, t_c) cost of one iteration: ``vr.FullGrad`` sweeps all m
        components, the other estimators one; ``comm_rounds`` rounds."""
        n_grad = m if isinstance(self.grad_est, vr.FullGrad) else 1
        return (n_grad * cost_model.t_grad
                + self.comm_rounds * cost_model.t_comm)


def _cache_field():
    return dataclasses.field(default_factory=dict, compare=False, repr=False)


@dataclasses.dataclass(frozen=True)
class DSGD(GossipSolverMixin):
    """Decentralized SGD with gossip averaging (uncompressed)."""

    topo: Any
    lr: float = 0.05
    batch_size: int = 1
    grad_est: Any = None
    packed: bool = True
    faults: Any = None
    # a mesh exchange (make_solver's): the rank's rows; None or a host
    # exchange: every agent in this process
    exchange: Any = dataclasses.field(default=None, compare=False,
                                      repr=False)
    name: str = "dsgd"
    device: torch.device = torch.device("cpu")
    _cache: dict = _cache_field()

    def _init(self, x0):
        return {"x": x0}

    def _step(self, state, data, key, k, est):
        g = self._sample(est, state["x"], data, key)
        x = self._mix(state["x"], k)
        return {"x": tree_map(lambda a, b: a - self.lr * b, x, g)}


@dataclasses.dataclass(frozen=True)
class ChocoSGD(GossipSolverMixin):
    """CHOCO-SGD (Koloskova et al.): compressed gossip through tracked
    copies x̂ with error feedback."""

    topo: Any
    lr: float = 0.05
    gossip_lr: float = 0.8
    compressor: Any = compression.Identity()
    batch_size: int = 1
    grad_est: Any = None
    packed: bool = True
    faults: Any = None
    # a mesh exchange (make_solver's): the rank's rows; None or a host
    # exchange: every agent in this process
    exchange: Any = dataclasses.field(default=None, compare=False,
                                      repr=False)
    name: str = "choco"
    device: torch.device = torch.device("cpu")
    _cache: dict = _cache_field()

    state_fields = ("x", "xhat")

    def _init(self, x0):
        return {"x": x0, "xhat": tree_zeros_like(x0)}

    def _step(self, state, data, key, k, est):
        x, xhat = state["x"], state["xhat"]
        g = self._sample(est, x, data, key)
        x = tree_map(lambda a, b: a - self.lr * b, x, g)
        q = self._compress(jaxrand.fold_in(key, 1), tree_sub(x, xhat))
        xhat = tree_add(xhat, q)
        mix = tree_sub(self._mix(xhat, k), xhat)
        x = tree_map(lambda a, b: a + self.gossip_lr * b, x, mix)
        return {"x": x, "xhat": xhat}


@dataclasses.dataclass(frozen=True)
class LEAD(GossipSolverMixin):
    """LEAD (reconstruction): primal-dual, compresses y-innovations."""

    topo: Any
    lr: float = 0.05  # eta
    alpha: float = 0.5  # EF state EMA
    gamma_mix: float = 0.8
    compressor: Any = compression.Identity()
    batch_size: int = 1
    grad_est: Any = None
    packed: bool = True
    faults: Any = None
    # a mesh exchange (make_solver's): the rank's rows; None or a host
    # exchange: every agent in this process
    exchange: Any = dataclasses.field(default=None, compare=False,
                                      repr=False)
    name: str = "lead"
    device: torch.device = torch.device("cpu")
    _cache: dict = _cache_field()

    state_fields = ("x", "h", "d")

    def _init(self, x0):
        return {"x": x0, "h": tree_zeros_like(x0), "d": tree_zeros_like(x0)}

    def _step(self, state, data, key, k, est):
        x, h, d = state["x"], state["h"], state["d"]
        g = self._sample(est, x, data, key)
        y = tree_map(lambda a, b, c: a - self.lr * (b + c), x, g, d)
        q = self._compress(jaxrand.fold_in(key, 1), tree_sub(y, h))
        yhat = tree_add(h, q)
        diff = tree_sub(yhat, self._mix(yhat, k))
        h = tree_map(lambda a, b: (1 - self.alpha) * a + self.alpha * b,
                     h, yhat)
        d = tree_map(lambda a, b: a + self.gamma_mix / (2 * self.lr) * b,
                     d, diff)
        x = tree_map(lambda a, b: a - self.gamma_mix / 2 * b, y, diff)
        return {"x": x, "h": h, "d": d}


@dataclasses.dataclass(frozen=True)
class COLD(GossipSolverMixin):
    """COLD (reconstruction): LEAD's skeleton with the innovation state
    h <- ŷ (alpha = 1)."""

    topo: Any
    lr: float = 0.05
    gamma_mix: float = 0.8
    compressor: Any = compression.Identity()
    batch_size: int = 1
    grad_est: Any = None
    packed: bool = True
    faults: Any = None
    # a mesh exchange (make_solver's): the rank's rows; None or a host
    # exchange: every agent in this process
    exchange: Any = dataclasses.field(default=None, compare=False,
                                      repr=False)
    name: str = "cold"
    device: torch.device = torch.device("cpu")
    _cache: dict = _cache_field()

    state_fields = ("x", "h", "d")

    def _init(self, x0):
        return {"x": x0, "h": tree_zeros_like(x0), "d": tree_zeros_like(x0)}

    def _step(self, state, data, key, k, est):
        x, h, d = state["x"], state["h"], state["d"]
        g = self._sample(est, x, data, key)
        y = tree_map(lambda a, b, c: a - self.lr * (b + c), x, g, d)
        q = self._compress(jaxrand.fold_in(key, 1), tree_sub(y, h))
        yhat = tree_add(h, q)  # innovation state: h <- yhat
        diff = tree_sub(yhat, self._mix(yhat, k))
        d = tree_map(lambda a, b: a + self.gamma_mix / (2 * self.lr) * b,
                     d, diff)
        x = tree_map(lambda a, b: a - self.gamma_mix / 2 * b, y, diff)
        return {"x": x, "h": yhat, "d": d}


@dataclasses.dataclass(frozen=True)
class CEDAS(GossipSolverMixin):
    """CEDAS (reconstruction): exact diffusion with CHOCO-style compressed
    gossip; two communication rounds per iteration (Table I)."""

    topo: Any
    lr: float = 0.05
    gossip_lr: float = 0.5
    compressor: Any = compression.Identity()
    batch_size: int = 1
    grad_est: Any = None
    packed: bool = True
    faults: Any = None
    # a mesh exchange (make_solver's): the rank's rows; None or a host
    # exchange: every agent in this process
    exchange: Any = dataclasses.field(default=None, compare=False,
                                      repr=False)
    name: str = "cedas"
    device: torch.device = torch.device("cpu")
    _cache: dict = _cache_field()

    state_fields = ("x", "psi_prev", "xhat")
    comm_rounds = 2

    def _init(self, x0):
        return {"x": x0, "psi_prev": x0, "xhat": tree_zeros_like(x0)}

    def _step(self, state, data, key, k, est):
        x, psi_prev, xhat = state["x"], state["psi_prev"], state["xhat"]
        g = self._sample(est, x, data, key)
        psi = tree_map(lambda a, b: a - self.lr * b, x, g)
        mix_in = tree_map(lambda p, a, pp: p + a - pp, psi, x, psi_prev)
        q = self._compress(jaxrand.fold_in(key, 1), tree_sub(mix_in, xhat))
        xhat = tree_add(xhat, q)
        # (I + W) / 2 mixing applied through the tracked copies
        half_mix = tree_map(lambda a, b: 0.5 * (a + b), xhat,
                            self._mix(xhat, k))
        x = tree_map(lambda mi, hm, xh: mi + self.gossip_lr * (hm - xh),
                     mix_in, half_mix, xhat)
        return {"x": x, "psi_prev": psi, "xhat": xhat}


@dataclasses.dataclass(frozen=True)
class DPDC(GossipSolverMixin):
    """DPDC (reconstruction of Alg. 1): primal-dual with compressed
    copies."""

    topo: Any
    lr: float = 0.05
    dual_lr: float = 0.1
    penalty: float = 0.5
    compressor: Any = compression.Identity()
    batch_size: int = 1
    grad_est: Any = None
    packed: bool = True
    faults: Any = None
    # a mesh exchange (make_solver's): the rank's rows; None or a host
    # exchange: every agent in this process
    exchange: Any = dataclasses.field(default=None, compare=False,
                                      repr=False)
    name: str = "dpdc"
    device: torch.device = torch.device("cpu")
    _cache: dict = _cache_field()

    state_fields = ("x", "v", "xhat")

    def _init(self, x0):
        return {"x": x0, "v": tree_zeros_like(x0),
                "xhat": tree_zeros_like(x0)}

    def _step(self, state, data, key, k, est):
        x, v, xhat = state["x"], state["v"], state["xhat"]
        g = self._sample(est, x, data, key)
        q = self._compress(jaxrand.fold_in(key, 1), tree_sub(x, xhat))
        xhat = tree_add(xhat, q)
        lap = tree_sub(xhat, self._mix(xhat, k))  # (I - W) x̂
        v_new = tree_map(lambda a, b: a + self.dual_lr * b, v, lap)
        x = tree_map(lambda a, gg, vv, ll: a
                     - self.lr * (gg + vv + self.penalty * ll),
                     x, g, v_new, lap)
        return {"x": x, "v": v_new, "xhat": xhat}


ALL_BASELINES = {
    "dsgd": DSGD,
    "choco": ChocoSGD,
    "lead": LEAD,
    "cold": COLD,
    "cedas": CEDAS,
    "dpdc": DPDC,
}
