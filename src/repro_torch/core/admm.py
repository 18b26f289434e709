"""LT-ADMM-CC (paper Algorithm 1) on the packed plane: port of the static
packed path of ``repro/core/admm.py``.

State at the top of round k (per agent i, slot s naming edge {i, j}):
x = x_i, x_hat = x̂_i, u = u_i, z[:, s] = z_ij, s_[:, s] = s_ij,
s_tilde = mirror of s_ji, x_hat_nbr = x̂_j, u_nbr = mirror of u_j.  Agent
state is ``[A, N]``, edge state ``[A, S, N]``.

Round k (see the reference's module docstring for the audit against the
paper):
  1. local phase: tau variance-reduced steps per agent -> x_{k+1}
  2. u_{k+1} = (1 - eta) u_k + eta x̂_k
  3-4. m_x = C(x_{k+1} - u_{k+1}); x̂_{k+1} = u_{k+1} + m_x
  5-6. m_z = C(z - s); ẑ = s + m_z; s <- ẑ
  7. receiver mirrors of u, x̂, ẑ_ji, s̃
  8. z_{k+1} = ½(ẑ_ij - ẑ_ji) + rρ x_{k+1} - rρ (x̂_i - x̂_j)

Every random draw folds the reference's salts into the round key with
``core.jaxrand``, so the port follows the reference's draws.  Round keys
and all key derivation live on the host; the plane compression runs on
the state's device.  Not ported yet: the pytree path (ROADMAP Queue 1
item 14), time-varying schedules (item 9), faults (item 11) and
telemetry taps (item 12).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.common.trees import consensus_error as _consensus_error
from repro_torch.common.trees import tree_lerp
from repro_torch.core import compression, jaxrand
from repro_torch.core.compression import Spec


@dataclasses.dataclass(frozen=True)
class LTADMMConfig:
    """Hyper-parameters of Algorithm 1 (defaults = paper §III)."""

    rho: float = 0.1
    beta: float = 0.2
    gamma: float = 0.3
    r: float = 1.0
    eta: float = 1.0
    tau: int = 5
    batch_size: int = 1
    compressor_x: Any = compression.Identity()
    compressor_z: Any = compression.Identity()
    faults: Any = None

    def __post_init__(self):
        if self.faults is not None:
            raise NotImplementedError(
                "fault injection is not ported yet: ROADMAP Queue 1 item 11")

    @property
    def lean(self) -> bool:
        return self.eta == 1.0


class LTADMMState(NamedTuple):
    x: Any  # [A, N]
    x_hat: Any  # [A, N]
    u: Any  # [A, N] | None (lean)
    z: Any  # [A, S, N]
    s: Any  # [A, S, N]
    s_tilde: Any  # [A, S, N]
    x_hat_nbr: Any  # [A, S, N]
    u_nbr: Any  # [A, S, N] | None (lean)
    k: int


@dataclasses.dataclass(frozen=True)
class RoundIds:
    """The round's constant per-message ids: host int64 tensors for key
    derivation, device int32 copies for the kernels, the per-agent
    degrees and the ``[A, S, 1]`` slot mask (None when every slot is
    active)."""

    agent: torch.Tensor  # [A] host
    aid2: torch.Tensor  # [A, S] host
    nbr: torch.Tensor  # [A, S] host
    agent_d: torch.Tensor  # [A] device int32
    aid2_d: torch.Tensor  # [A, S] device int32
    nbr_d: torch.Tensor  # [A, S] device int32
    degrees: torch.Tensor  # [A] device, state dtype
    mask3: torch.Tensor | None  # [A, S, 1] device bool

    @classmethod
    def build(cls, topo, device, dtype=torch.float32):
        a, s = topo.n_agents, topo.n_slots
        agent = torch.arange(a, dtype=torch.int64)
        aid2 = agent[:, None].expand(a, s).contiguous()
        nbr = torch.as_tensor(np.asarray(topo.neighbor_table(), np.int64))
        mask = np.asarray(topo.slot_mask())
        return cls(
            agent=agent, aid2=aid2, nbr=nbr,
            agent_d=agent.to(device, torch.int32),
            aid2_d=aid2.to(device, torch.int32),
            nbr_d=nbr.to(device, torch.int32),
            degrees=torch.as_tensor(topo.degrees(), dtype=dtype,
                                    device=device),
            mask3=None if mask.all() else
            torch.as_tensor(mask, device=device)[:, :, None],
        )


def init(cfg: LTADMMConfig, topo, exchange, x0):
    """x0: packed ``[A, N]`` plane on its device.  u_0 = x̂_0 = x_0,
    z = s = s̃ = 0."""
    if hasattr(topo, "round_mask"):
        raise NotImplementedError(
            "time-varying schedules are not ported yet: ROADMAP Queue 1 "
            "item 9")
    _check_packed(x0)
    zeros_edge = torch.zeros((x0.shape[0], topo.n_slots) + x0.shape[1:],
                             dtype=x0.dtype, device=x0.device)
    x_hat_nbr = exchange.gather_batched(x0)
    return LTADMMState(
        x=x0, x_hat=x0, u=None if cfg.lean else x0,
        z=zeros_edge, s=zeros_edge, s_tilde=zeros_edge,
        x_hat_nbr=x_hat_nbr, u_nbr=None if cfg.lean else x_hat_nbr, k=0,
    )


def _check_packed(x):
    if not isinstance(x, torch.Tensor) or x.dim() != 2:
        raise NotImplementedError(
            "only the packed [A, N] plane is ported; the pytree path is "
            "ROADMAP Queue 1 item 14")


# ---------------------------------------------------------------------------
# Message keys (host): sender and receiver derive identical keys
# ---------------------------------------------------------------------------


def _key_x(round_key, sender):
    return jaxrand.fold_in(jaxrand.fold_in(round_key, 11), sender)


def _key_z(round_key, sender, receiver):
    k = jaxrand.fold_in(round_key, 13)
    return jaxrand.fold_in(jaxrand.fold_in(k, sender), receiver)


def _key_batch(round_key, agent, t):
    k = jaxrand.fold_in(round_key, 7)
    return jaxrand.fold_in(jaxrand.fold_in(k, agent), t)


def batch_indices(cfg: LTADMMConfig, round_key, n_agents: int, m: int):
    """Every local step's minibatch indices, ``[A, tau, batch_size]``
    (host int64): ``randint(_key_batch(round_key, agent, t), (bs,), 0,
    m)`` for all agents and steps in one batched derivation."""
    agent = torch.arange(n_agents, dtype=torch.int64)[:, None]
    t = torch.arange(cfg.tau, dtype=torch.int64)[None, :]
    keys = _key_batch(round_key, agent, t)
    return jaxrand.randint(keys, (cfg.batch_size,), 0, m)


def local_phase(cfg: LTADMMConfig, ids: RoundIds, vr_est, x, z, data,
                round_key):
    """Lines 2-8: tau variance-reduced steps per agent -> x_{k+1}."""
    m = next(iter(data.values())).shape[1]
    d = ids.degrees[:, None]
    corr = cfg.beta * (cfg.r ** 2 * cfg.rho * d * x
                       - cfg.r * torch.sum(z, dim=1))
    idx = batch_indices(cfg, round_key, x.shape[0], m).to(x.device)
    vr_state = vr_est.reset(x, data)
    phi = x
    for t in range(cfg.tau):
        g, vr_state = vr_est.estimate(vr_state, phi, data, idx[:, t])
        phi = phi - cfg.gamma * g - corr
    return phi


def _masked(arr, mask3):
    return arr if mask3 is None else torch.where(mask3, arr, 0.0)


def step(cfg: LTADMMConfig, topo, exchange, vr_est, state: LTADMMState,
         data, round_key, ids: RoundIds | None = None):
    """One outer round.  ``data`` leaves ``[A, m, ...]`` on the state's
    device; ``round_key`` a host key (``core.jaxrand``); ``ids`` the
    cached ``RoundIds`` (built here when not given)."""
    if hasattr(topo, "round_mask"):
        raise NotImplementedError(
            "time-varying schedules are not ported yet: ROADMAP Queue 1 "
            "item 9")
    _check_packed(state.x)
    if ids is None:
        ids = RoundIds.build(topo, state.x.device, state.x.dtype)
    return _step_packed(cfg, exchange, vr_est, state, data, round_key, ids)


def _step_packed(cfg, exchange, vr_est, state, data, round_key, ids):
    """Slot-batched round on the packed plane (``admm.py:466``)."""
    like = Spec(tuple(state.x.shape[1:]), state.x.dtype)
    cx, cz = cfg.compressor_x, cfg.compressor_z
    mask3 = ids.mask3
    # fused-route base seeds: the salts of _key_x/_key_z, folded once here
    # and per (sender, receiver) inside the kernels
    bx = jaxrand.fold_in(round_key, 11)
    bz = jaxrand.fold_in(round_key, 13)

    # ---- 1. local training
    x_new = local_phase(cfg, ids, vr_est, state.x, state.z, data, round_key)

    # ---- 2-4. sender-side error feedback for x (one payload per sender)
    u_new = (state.x_hat if cfg.lean
             else tree_lerp(state.u, state.x_hat, cfg.eta))
    m_x, dx = compression.plane_compress(
        cx, lambda: _key_x(round_key, ids.agent), bx,
        ids.agent_d, None, x_new - u_new, like)
    x_hat_new = u_new + dx

    # ---- 5-6. sender-side error feedback for z (all slots at once)
    m_z, rec_z = compression.plane_compress(
        cz, lambda: _key_z(round_key, ids.aid2, ids.nbr), bz,
        ids.aid2_d, ids.nbr_d, state.z - state.s, like)
    z_hat_own = _masked(state.s + rec_z, mask3)

    # ---- the only cross-agent communication
    recv_x = exchange.gather_batched(m_x)
    recv_z = exchange.exchange_batched(m_z)

    # ---- 7. receiver-side mirrors
    u_nbr_new = (state.x_hat_nbr if cfg.lean
                 else tree_lerp(state.u_nbr, state.x_hat_nbr, cfg.eta))
    x_hat_nbr_new = u_nbr_new + compression.plane_decompress(
        cx, lambda: _key_x(round_key, ids.nbr), bx,
        ids.nbr_d, None, recv_x, like, nd=2)
    z_hat_nbr = _masked(
        state.s_tilde + compression.plane_decompress(
            cz, lambda: _key_z(round_key, ids.nbr, ids.aid2), bz,
            ids.nbr_d, ids.aid2_d, recv_z, like, nd=2),
        mask3)

    # ---- 8. z update, eq. (4)
    rrho = cfg.r * cfg.rho
    z_new = _masked(
        0.5 * (z_hat_own - z_hat_nbr)
        + rrho * x_new[:, None]
        - rrho * (x_hat_new[:, None] - x_hat_nbr_new),
        mask3)

    return LTADMMState(
        x=x_new, x_hat=x_hat_new, u=None if cfg.lean else u_new,
        z=z_new, s=z_hat_own, s_tilde=z_hat_nbr,
        x_hat_nbr=x_hat_nbr_new, u_nbr=None if cfg.lean else u_nbr_new,
        k=state.k + 1,
    )


# ---------------------------------------------------------------------------
# Diagnostics and wire accounting
# ---------------------------------------------------------------------------


def consensus_mean(state: LTADMMState):
    return torch.mean(state.x, dim=0)


def consensus_error(state: LTADMMState):
    return _consensus_error(state.x)


def _edge_payload_bytes(cfg: LTADMMConfig, params) -> int:
    return (compression.tree_wire_bytes(cfg.compressor_x, params)
            + compression.tree_wire_bytes(cfg.compressor_z, params))


def wire_bytes_per_round(cfg: LTADMMConfig, topo, params) -> int:
    """Bytes the busiest agent transmits per round: an x-message to every
    neighbor and a z-message per incident edge."""
    return int(round(float(np.max(topo.degrees()))
                     * _edge_payload_bytes(cfg, params)))


def wire_bytes_total(cfg: LTADMMConfig, topo, params) -> int:
    """Aggregate bytes on the wire per round, summed over agents."""
    return int(round(float(np.sum(topo.degrees()))
                     * _edge_payload_bytes(cfg, params)))


def wire_bytes_at(cfg: LTADMMConfig, topo, params, t: int) -> int:
    """Exact busiest-agent bytes at round ``t`` (constant on a static
    graph)."""
    del t
    return int(np.max(topo.degrees())) * _edge_payload_bytes(cfg, params)
