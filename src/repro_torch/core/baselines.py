"""The gossip baselines of the paper's Fig. 2 (port of
``repro/core/baselines.py``): DSGD, CHOCO-SGD, and the reconstructions of
LEAD, COLD, CEDAS and DPDC, on the packed ``[A, N]`` plane.

Every baseline mixes with the Metropolis-Hastings matrix W of the same
static ``Topology`` LT-ADMM-CC runs on (``W @ x``, one f32 matrix product
over the agent axis), and compresses through the per-message route of
``core.compression``: on the card qbit launches K4/K5 once per
compression for all A messages, RandK (uniform, stride) and TopK K6/K7.

    state = solver.init(x0)                # x0: [A, ...] stacked params
    state = solver.step(state, data, key)  # data leaves: [A, m, ...]

Random draws follow the reference's key derivations exactly: minibatch
indices ``randint(fold_in(key, aid), (B,), 0, m)``, compression keys
``fold_in(fold_in(key, 1), aid)`` then the per-leaf ``split``.  The
update formulas keep the reference's expression order (``a - lr * (b +
c)``, ``gamma_mix / (2 * lr)``) so that results stay bit-close.  Not
ported yet: time-varying schedules (ROADMAP Queue 1 item 9), faults
(item 11), telemetry taps (item 12) and the pytree path (item 14).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.common.trees import as_tensor, tree_map
from repro_torch.core import compression, jaxrand, packing, vr
from repro_torch.core.topology import metropolis_weights


def _like(x) -> compression.Spec:
    """One agent's message: the plane without its agent axis."""
    return compression.Spec(tuple(x.shape[1:]), x.dtype)


def _compress_stacked(comp, key, x, like):
    """Compress and decompress every agent's message (the EF-style
    reconstruction); agent i's key is ``fold_in(key, i)``."""
    keys = jaxrand.fold_in(key, torch.arange(x.shape[0]))
    p = compression.compress_tree(comp, keys, x, nd=1)
    return compression.decompress_tree(comp, keys, p, like, nd=1)


def _sample_grads(est, x, data, key, batch_size):
    """Every agent's stochastic gradient through the bound estimator."""
    m = next(iter(data.values())).shape[1]
    keys = jaxrand.fold_in(key, torch.arange(x.shape[0]))
    idx = jaxrand.randint(keys, (batch_size,), 0, m).to(x.device)
    g, _ = est.estimate((), x, data, idx)
    return g


class GossipSolverMixin:
    """``Solver``-protocol behaviour shared by the gossip baselines.
    Subclasses declare ``state_fields`` (the plane-shaped entries of their
    state dict, ``"x"`` first) and ``comm_rounds`` (communication rounds
    per iteration, for the wire and cost accounting)."""

    state_fields: tuple = ("x",)
    comm_rounds: int = 1
    estimator: str = "sgd"

    def __post_init__(self):
        if self.faults is not None:
            raise NotImplementedError(
                "fault injection is not ported yet: ROADMAP Queue 1 item 11")
        if not self.packed:
            raise NotImplementedError(
                "the pytree (packed=false) path is not ported yet: ROADMAP "
                "Queue 1 item 14")
        if hasattr(self.topo, "round_mask"):
            raise NotImplementedError(
                "time-varying schedules are not ported yet: ROADMAP Queue 1 "
                "item 9")

    @property
    def graph(self):
        return self.topo

    def _layout(self, state) -> packing.PackedLayout:
        lay = self._cache.get("layout")
        if lay is None:  # a state carried in, init never called
            lay = packing.layout_of(state["x"][0])
            self._cache["layout"] = lay
        return lay

    def _mix(self, x):
        """Gossip: ``W @ x`` over the agent axis of ``x [A, N]``, W the
        Metropolis-Hastings weights of the graph in f32 (as the
        reference's ``jnp.asarray`` of them), kept per device.  A plain
        f32 product: PyTorch's default matmul precision ("highest", no
        TF32) keeps it so on the card."""
        W = self._cache.get(("W", x.device))
        if W is None:
            W = torch.as_tensor(metropolis_weights(self.topo),
                                dtype=x.dtype, device=x.device)
            self._cache[("W", x.device)] = W
        return torch.matmul(W, x)

    def init(self, x0):
        """x0: stacked ``[A, ...]`` params (tensors or numpy arrays)."""
        x0 = tree_map(lambda t: as_tensor(t).to(self.device), x0)
        lay = packing.layout_of_stacked(x0)
        self._cache["layout"] = lay
        st = self._init(packing.pack(lay, x0))
        st["k"] = 0
        return st

    def step(self, state, data, key):
        if self.grad_est is None:
            raise ValueError(
                f"{self.name}: bind a gradient estimator at construction "
                "(make_solver(..., grad_est=...))")
        est = packing.PackedEstimator(self.grad_est, self._layout(state))
        st = self._step({f: state[f] for f in self.state_fields}, data, key,
                        est)
        st["k"] = state["k"] + 1
        return st

    def consensus_params(self, state):
        return packing.unpack(self._layout(state), state["x"])

    def _wire_compressor(self):
        """What moves per neighbour message: the configured compressor,
        or full precision for the uncompressed methods."""
        return getattr(self, "compressor", None) or compression.Identity()

    def wire_bytes(self, params, t: int | None = None) -> int:
        """Bytes the busiest agent transmits per iteration: one whole-plane
        message per incident edge per communication round (constant on a
        static graph, so ``t`` changes nothing)."""
        per_edge = compression.tree_wire_bytes(
            self._wire_compressor(), packing.abstract_plane(params)
        ) * self.comm_rounds
        if t is not None:
            return int(np.max(self.topo.degrees())) * per_edge
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
    name: str = "dsgd"
    device: torch.device = torch.device("cpu")
    _cache: dict = _cache_field()

    def _init(self, x0):
        return {"x": x0}

    def _step(self, state, data, key, est):
        g = _sample_grads(est, state["x"], data, key, self.batch_size)
        x = self._mix(state["x"])
        return {"x": x - self.lr * g}


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
    name: str = "choco"
    device: torch.device = torch.device("cpu")
    _cache: dict = _cache_field()

    state_fields = ("x", "xhat")

    def _init(self, x0):
        return {"x": x0, "xhat": torch.zeros_like(x0)}

    def _step(self, state, data, key, est):
        x, xhat = state["x"], state["xhat"]
        g = _sample_grads(est, x, data, key, self.batch_size)
        x = x - self.lr * g
        q = _compress_stacked(self.compressor, jaxrand.fold_in(key, 1),
                              x - xhat, _like(x))
        xhat = xhat + q
        mix = self._mix(xhat) - xhat
        return {"x": x + self.gossip_lr * mix, "xhat": xhat}


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
    name: str = "lead"
    device: torch.device = torch.device("cpu")
    _cache: dict = _cache_field()

    state_fields = ("x", "h", "d")

    def _init(self, x0):
        return {"x": x0, "h": torch.zeros_like(x0), "d": torch.zeros_like(x0)}

    def _step(self, state, data, key, est):
        x, h, d = state["x"], state["h"], state["d"]
        g = _sample_grads(est, x, data, key, self.batch_size)
        y = x - self.lr * (g + d)
        q = _compress_stacked(self.compressor, jaxrand.fold_in(key, 1),
                              y - h, _like(x))
        yhat = h + q
        diff = yhat - self._mix(yhat)
        h = (1 - self.alpha) * h + self.alpha * yhat
        d = d + self.gamma_mix / (2 * self.lr) * diff
        return {"x": y - self.gamma_mix / 2 * diff, "h": h, "d": d}


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
    name: str = "cold"
    device: torch.device = torch.device("cpu")
    _cache: dict = _cache_field()

    state_fields = ("x", "h", "d")

    def _init(self, x0):
        return {"x": x0, "h": torch.zeros_like(x0), "d": torch.zeros_like(x0)}

    def _step(self, state, data, key, est):
        x, h, d = state["x"], state["h"], state["d"]
        g = _sample_grads(est, x, data, key, self.batch_size)
        y = x - self.lr * (g + d)
        q = _compress_stacked(self.compressor, jaxrand.fold_in(key, 1),
                              y - h, _like(x))
        yhat = h + q
        diff = yhat - self._mix(yhat)
        d = d + self.gamma_mix / (2 * self.lr) * diff
        return {"x": y - self.gamma_mix / 2 * diff, "h": yhat, "d": d}


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
    name: str = "cedas"
    device: torch.device = torch.device("cpu")
    _cache: dict = _cache_field()

    state_fields = ("x", "psi_prev", "xhat")
    comm_rounds = 2

    def _init(self, x0):
        return {"x": x0, "psi_prev": x0, "xhat": torch.zeros_like(x0)}

    def _step(self, state, data, key, est):
        x, psi_prev, xhat = state["x"], state["psi_prev"], state["xhat"]
        g = _sample_grads(est, x, data, key, self.batch_size)
        psi = x - self.lr * g
        mix_in = psi + x - psi_prev
        q = _compress_stacked(self.compressor, jaxrand.fold_in(key, 1),
                              mix_in - xhat, _like(x))
        xhat = xhat + q
        # (I + W) / 2 mixing applied through the tracked copies
        half_mix = 0.5 * (xhat + self._mix(xhat))
        x = mix_in + self.gossip_lr * (half_mix - xhat)
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
    name: str = "dpdc"
    device: torch.device = torch.device("cpu")
    _cache: dict = _cache_field()

    state_fields = ("x", "v", "xhat")

    def _init(self, x0):
        return {"x": x0, "v": torch.zeros_like(x0),
                "xhat": torch.zeros_like(x0)}

    def _step(self, state, data, key, est):
        x, v, xhat = state["x"], state["v"], state["xhat"]
        g = _sample_grads(est, x, data, key, self.batch_size)
        q = _compress_stacked(self.compressor, jaxrand.fold_in(key, 1),
                              x - xhat, _like(x))
        xhat = xhat + q
        lap = xhat - self._mix(xhat)  # (I - W) x̂
        v_new = v + self.dual_lr * lap
        x = x - self.lr * (g + v_new + self.penalty * lap)
        return {"x": x, "v": v_new, "xhat": xhat}


ALL_BASELINES = {
    "dsgd": DSGD,
    "choco": ChocoSGD,
    "lead": LEAD,
    "cold": COLD,
    "cedas": CEDAS,
    "dpdc": DPDC,
}
