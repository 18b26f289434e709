"""LT-ADMM-CC (paper Algorithm 1): port of ``repro/core/admm.py``, the
static and the time-varying round, on the packed plane and on pytrees.

State at the top of round k (per agent i, slot s naming edge {i, j}):
x = x_i, x_hat = x̂_i, u = u_i, z[:, s] = z_ij, s_[:, s] = s_ij,
s_tilde = mirror of s_ji, x_hat_nbr = x̂_j, u_nbr = mirror of u_j.  Agent
state is ``[A, ...]``, edge state ``[A, S, ...]``: single tensors on the
packed plane (``[A, N]``, ``[A, S, N]``), or trees of such leaves on the
pytree path (``packed=false``).

Round k (see the reference's module docstring for the audit against the
paper):
  1. local phase: tau variance-reduced steps per agent -> x_{k+1}
  2. u_{k+1} = (1 - eta) u_k + eta x̂_k
  3-4. m_x = C(x_{k+1} - u_{k+1}); x̂_{k+1} = u_{k+1} + m_x
  5-6. m_z = C(z - s); ẑ = s + m_z; s <- ẑ
  7. receiver mirrors of u, x̂, ẑ_ji, s̃
  8. z_{k+1} = ½(ẑ_ij - ẑ_ji) + rρ x_{k+1} - rρ (x̂_i - x̂_j)

One implementation serves both state kinds: every update is a
``tree_map`` (a tensor is a one-leaf tree), and every message class is
ONE compression call batched over all its senders and slots, where the
reference loops over slots in Python.  Every message's key derives from
(round key, sender, receiver), so batching changes no draw.  A single
plane may take the fused plane kernels (K1-K3); a pytree takes the
per-message route leaf by leaf (K4/K5, K6-K9), as the reference's tree
path does.

Time-varying graphs (``schedule.TopologySchedule``): round k activates
the union-graph slots of ``round_mask(k)``; inactive edges hold all edge
state, inactive nodes freeze x, and x̂ (and u) are kept per edge, as in
the reference's asynchronous-ADMM round.

On a mesh exchange (``Exchange(topo, axis, mesh)``) the state, the data
and every message hold the rank's agent rows ``exchange.rows`` only, and
every key and kernel id is the global agent id, so rank p's round equals
rows ``exchange.rows`` of the one-process round bit for bit.

Faults (``cfg.faults``, a ``core.faults.FaultPlane``) run on the packed
time-varying round (``make_solver`` wraps a static graph in
``schedule.static_schedule``): both message planes are sealed (crc +
round tag), routed through the fault-armed exchange, verified; a crashed
agent freezes its x, and an edge advances only where both endpoints
received both messages cleanly (NAK symmetrisation), else it holds as an
inactive edge does.

Every random draw folds the reference's salts into the round key with
``core.jaxrand``, so the port follows the reference's draws.  Round keys
and all key derivation live on the host; compression runs on the
state's device.

Telemetry: while a ``obs.telemetry.with_telemetry`` wrapper steps the
solver, both rounds charge their measured wire bytes, messages,
participation and gradient evaluations (and, on a faulted round, the
receive verdicts) through one tap, ``_emit_round_telemetry``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.common.trees import (first_leaf, tree_add,
                                      tree_consensus_error, tree_flatten,
                                      tree_lerp,
                                      tree_map, tree_select, tree_sub,
                                      tree_zeros_like)
from repro_torch.core import compression, jaxrand
from repro_torch.obs import telemetry


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
    # core.faults.FaultPlane | None: payloads are sealed (crc + round tag)
    # and faulted messages hold their edge for the round
    faults: Any = None

    @property
    def lean(self) -> bool:
        return self.eta == 1.0


class LTADMMState(NamedTuple):
    x: Any  # [A, ...]
    x_hat: Any  # [A, ...]
    u: Any  # [A, ...] | None (lean)
    z: Any  # [A, S, ...]
    s: Any  # [A, S, ...]
    s_tilde: Any  # [A, S, ...]
    x_hat_nbr: Any  # [A, S, ...]
    u_nbr: Any  # [A, S, ...] | None (lean)
    k: int


# the dims in front of each ``LTADMMState`` field's parameter shape: the
# agent, and the neighbour slot of an edge's field
STATE_LEAD = {"x": 1, "x_hat": 1, "u": 1, "z": 2, "s": 2, "s_tilde": 2,
              "x_hat_nbr": 2, "u_nbr": 2}


class LTADMMScheduleState(NamedTuple):
    """State of the time-varying round: x̂ and u are kept per edge
    (``x_hat_edge[:, s]`` is the sender-side estimate that the slot-s
    neighbor mirrors), advanced only on rounds the edge is active."""

    x: Any  # [A, ...]
    x_hat_edge: Any  # [A, S, ...]
    u_edge: Any  # [A, S, ...] | None (lean)
    z: Any  # [A, S, ...]
    s: Any  # [A, S, ...]
    s_tilde: Any  # [A, S, ...]
    x_hat_nbr: Any  # [A, S, ...] mirror of the neighbor's x_hat_edge
    u_nbr: Any  # [A, S, ...] | None (lean)
    k: int


@dataclasses.dataclass(frozen=True)
class RoundIds:
    """The round's constant per-message ids: host int64 tensors for key
    derivation, device int32 copies for the kernels, the per-agent
    degrees (in the state's dtype, and as int64 for the telemetry tap)
    and the ``[A, S]`` slot mask (None when every slot is active) of a
    static topology (a schedule's union).  ``rows`` (a range of global
    agent ids, all when None) keeps a mesh rank's rows: the ids stay
    global."""

    agent: torch.Tensor  # [A] host
    aid2: torch.Tensor  # [A, S] host
    nbr: torch.Tensor  # [A, S] host
    agent_d: torch.Tensor  # [A] device int32
    aid2_d: torch.Tensor  # [A, S] device int32
    nbr_d: torch.Tensor  # [A, S] device int32
    degrees: torch.Tensor  # [A] device, state dtype
    mask: torch.Tensor | None  # [A, S] device bool
    degrees_i64: torch.Tensor  # [A] device int64

    @classmethod
    def build(cls, topo, device, dtype=torch.float32, rows=None):
        rows = range(topo.n_agents) if rows is None else rows
        lo, hi = rows.start, rows.stop
        s = topo.n_slots
        agent = torch.arange(lo, hi, dtype=torch.int64)
        aid2 = agent[:, None].expand(hi - lo, s).contiguous()
        nbr = torch.as_tensor(np.asarray(topo.neighbor_table(),
                                         np.int64)[lo:hi])
        mask = np.asarray(topo.slot_mask())[lo:hi]
        return cls(
            agent=agent, aid2=aid2, nbr=nbr,
            agent_d=agent.to(device, torch.int32),
            aid2_d=aid2.to(device, torch.int32),
            nbr_d=nbr.to(device, torch.int32),
            degrees=torch.as_tensor(topo.degrees()[lo:hi], dtype=dtype,
                                    device=device),
            mask=None if mask.all() else torch.as_tensor(mask, device=device),
            degrees_i64=torch.as_tensor(mask.sum(axis=1), dtype=torch.int64,
                                        device=device),
        )


# ---------------------------------------------------------------------------
# Tree helpers: leaves carry the agent (and slot) axes in front
# ---------------------------------------------------------------------------


def _select_agents(node_mask, on_tree, off_tree):
    """Per-agent select: agent i advances where ``node_mask[i]``, holds
    otherwise; ``node_mask is None`` (no node layer) keeps ``on_tree``."""
    if node_mask is None:
        return on_tree
    return tree_select(node_mask, on_tree, off_tree)


def _masked(tree, mask):
    """Zero the edge state of inactive slots (``mask`` None: all
    active)."""
    if mask is None:
        return tree
    return tree_map(lambda t: torch.where(
        mask.reshape(mask.shape + (1,) * (t.dim() - 2)), t, 0.0), tree)


def _per_edge(tree, n_slots):
    """``[A, ...]`` leaves seen as ``[A, S, ...]`` (a view, no copy)."""
    return tree_map(
        lambda x: x[:, None].expand((x.shape[0], n_slots) + x.shape[1:]),
        tree)


def _zeros_edge(tree, n_slots):
    return tree_zeros_like(_per_edge(tree, n_slots))


def init(cfg: LTADMMConfig, topo, exchange, x0):
    """x0: ``[A, ...]`` params (a plane or a tree) on their device.  u_0 =
    x̂_0 = x_0, z = s = s̃ = 0.  A ``schedule.TopologySchedule`` as
    ``topo`` gives the time-varying state (``init_schedule``)."""
    if hasattr(topo, "round_mask"):
        return init_schedule(cfg, topo, exchange, x0)
    zeros_edge = _zeros_edge(x0, topo.n_slots)
    x_hat_nbr = exchange.gather_batched(x0)
    return LTADMMState(
        x=x0, x_hat=x0, u=None if cfg.lean else x0,
        z=zeros_edge, s=zeros_edge, s_tilde=zeros_edge,
        x_hat_nbr=x_hat_nbr, u_nbr=None if cfg.lean else x_hat_nbr, k=0,
    )


def init_schedule(cfg: LTADMMConfig, sched, exchange, x0):
    """The time-varying state: x̂ and u per edge start at x_0."""
    s = sched.n_slots
    zeros_edge = _zeros_edge(x0, s)
    x_edge = _per_edge(x0, s)
    x_hat_nbr = exchange.gather_batched(x0)
    return LTADMMScheduleState(
        x=x0, x_hat_edge=x_edge, u_edge=None if cfg.lean else x_edge,
        z=zeros_edge, s=zeros_edge, s_tilde=zeros_edge,
        x_hat_nbr=x_hat_nbr, u_nbr=None if cfg.lean else x_hat_nbr, k=0,
    )


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


def _key_xe(round_key, sender, receiver):
    """Per-edge x-message key of the time-varying round (salt 17)."""
    k = jaxrand.fold_in(round_key, 17)
    return jaxrand.fold_in(jaxrand.fold_in(k, sender), receiver)


def batch_indices(cfg: LTADMMConfig, round_key, agents, m: int):
    """Every local step's minibatch indices, ``[A, tau, batch_size]``
    (host int64): ``randint(_key_batch(round_key, agent, t), (bs,), 0,
    m)`` for all agents and steps in one batched derivation; ``agents``
    the host int64 global ids (``RoundIds.agent``)."""
    agent = agents[:, None]
    t = torch.arange(cfg.tau, dtype=torch.int64)[None, :]
    keys = _key_batch(round_key, agent, t)
    return jaxrand.randint(keys, (cfg.batch_size,), 0, m)


def agent_rows(vr_est, data) -> int:
    """An agent's m_local: the rank's rows of ``data`` times the parts an
    estimator over rows cut over ranks says they are (``row_shards``,
    FSDP), so the batch is drawn over the agent's whole rows."""
    return (next(iter(data.values())).shape[1]
            * getattr(getattr(vr_est, "est", vr_est), "row_shards", 1))


def local_phase(cfg: LTADMMConfig, ids: RoundIds, vr_est, x, z, data,
                round_key):
    """Lines 2-8: tau variance-reduced steps per agent -> x_{k+1}.  The
    degrees are the (union) topology's; ``z`` is zero on masked slots."""
    m = agent_rows(vr_est, data)
    x0 = first_leaf(x)
    corr = tree_map(
        lambda xs, zs: cfg.beta * (cfg.r ** 2 * cfg.rho
                                   * ids.degrees.reshape(
                                       (-1,) + (1,) * (xs.dim() - 1)) * xs
                                   - cfg.r * torch.sum(zs, dim=1)), x, z)
    idx = batch_indices(cfg, round_key, ids.agent, m).to(x0.device)
    vr_state = vr_est.reset(x, data)
    phi = x
    for t in range(cfg.tau):
        g, vr_state = vr_est.estimate(vr_state, phi, data, idx[:, t])
        phi = tree_map(lambda p, gg, c: p - cfg.gamma * gg - c, phi, g, corr)
    return phi


def step(cfg: LTADMMConfig, topo, exchange, vr_est, state: LTADMMState,
         data, round_key, ids: RoundIds | None = None):
    """One outer round.  ``data`` leaves ``[A, m, ...]`` on the state's
    device; ``round_key`` a host key (``core.jaxrand``); ``ids`` the
    cached ``RoundIds`` of the (union) topology (built here when not
    given).  A schedule as ``topo`` runs ``step_schedule``."""
    if hasattr(topo, "round_mask"):
        return step_schedule(cfg, topo, exchange, vr_est, state, data,
                             round_key, ids)
    if cfg.faults is not None:
        raise ValueError(
            "cfg.faults requires a TopologySchedule (the hold semantics "
            "live on the schedule path); wrap static graphs with "
            "schedule.static_schedule — make_solver does this "
            "automatically")
    if ids is None:
        x0 = first_leaf(state.x)
        ids = RoundIds.build(topo, x0.device, x0.dtype, exchange.rows)
    return _step_static(cfg, exchange, vr_est, state, data, round_key, ids)


def _step_static(cfg, exchange, vr_est, state, data, round_key, ids):
    """The static round (reference ``_step_packed`` :466 on a plane,
    ``_step_tree`` :318 on a tree), slot-batched."""
    like = compression.like_per_message(state.x)
    cx, cz = cfg.compressor_x, cfg.compressor_z
    mask = ids.mask
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
        ids.agent_d, None, tree_sub(x_new, u_new), like)
    x_hat_new = tree_add(u_new, dx)
    # each plane-sized temporary goes as soon as it is used: the round
    # holds two states at once (a full-width model's plane is GBs)
    del dx

    # ---- 5-6. sender-side error feedback for z (all slots at once)
    m_z, rec_z = compression.plane_compress(
        cz, lambda: _key_z(round_key, ids.aid2, ids.nbr), bz,
        ids.aid2_d, ids.nbr_d, tree_sub(state.z, state.s), like)
    z_hat_own = _masked(tree_add(state.s, rec_z), mask)
    del rec_z

    # ---- the only cross-agent communication
    recv_x = exchange.gather_batched(m_x)
    recv_z = exchange.exchange_batched(m_z)
    if telemetry.active():
        # one x-message per sender to every neighbour, one z-message per
        # edge; masked union slots carry placeholders and are not charged
        per_msg = (compression.message_nbytes(cx, m_x, nd=1)
                   + compression.message_nbytes(cz, m_z, nd=2))
        _emit_round_telemetry(cfg, vr_est, data, ids.degrees_i64, per_msg,
                              None)
    del m_x, m_z

    # ---- 7. receiver-side mirrors
    u_nbr_new = (state.x_hat_nbr if cfg.lean
                 else tree_lerp(state.u_nbr, state.x_hat_nbr, cfg.eta))
    x_hat_nbr_new = tree_add(u_nbr_new, compression.plane_decompress(
        cx, lambda: _key_x(round_key, ids.nbr), bx,
        ids.nbr_d, None, recv_x, like))
    del recv_x
    z_hat_nbr = _masked(tree_add(state.s_tilde, compression.plane_decompress(
        cz, lambda: _key_z(round_key, ids.nbr, ids.aid2), bz,
        ids.nbr_d, ids.aid2_d, recv_z, like)), mask)
    del recv_z

    # ---- 8. z update, eq. (4)
    z_new = _masked(_eq4(cfg, z_hat_own, z_hat_nbr, x_new, x_hat_new,
                         x_hat_nbr_new, x_hat_per_agent=True), mask)

    return LTADMMState(
        x=x_new, x_hat=x_hat_new, u=None if cfg.lean else u_new,
        z=z_new, s=z_hat_own, s_tilde=z_hat_nbr,
        x_hat_nbr=x_hat_nbr_new, u_nbr=None if cfg.lean else u_nbr_new,
        k=state.k + 1,
    )


def _eq4(cfg, z_hat_own, z_hat_nbr, x_new, x_hat, x_hat_nbr,
         x_hat_per_agent):
    """z_{k+1} = ½(ẑ_ij - ẑ_ji) + rρ x_{k+1} - rρ (x̂_i - x̂_j), with
    x̂_i per agent (static round) or per edge (time-varying round)."""
    rrho = cfg.r * cfg.rho

    def one(zo, zn, xn, xh, xhj):
        if x_hat_per_agent:
            xh = xh[:, None]
        # 0.5 * (zo - zn) + rrho * xn - rrho * (xh - xhj), each step of
        # that expression in place on two [A, S, ...] buffers (the same
        # roundings, half the temporaries)
        out = (zo - zn).mul_(0.5)
        out.add_(rrho * xn[:, None])
        return out.sub_((xh - xhj).mul_(rrho))

    return tree_map(one, z_hat_own, z_hat_nbr, x_new, x_hat, x_hat_nbr)


# ---------------------------------------------------------------------------
# Time-varying topologies (schedule.TopologySchedule)
# ---------------------------------------------------------------------------


def step_schedule(cfg: LTADMMConfig, sched, exchange, vr_est,
                  state: LTADMMScheduleState, data, round_key,
                  ids: RoundIds | None = None):
    """One outer round over a time-varying topology (reference
    ``_step_schedule_packed`` :818 on a plane, ``_step_schedule_tree``
    :670 on a tree).  Every union slot moves a payload; round k's
    ``[A, S]`` mask (read from the stack kept on the device) selects
    per agent and slot whether the advanced or the held state is kept,
    and the node mask freezes the x of inactive agents."""
    x0 = first_leaf(state.x)
    rows = None if exchange.mesh is None else exchange.rows
    if ids is None:
        ids = RoundIds.build(sched.union, x0.device, x0.dtype, rows)
    like = compression.like_per_message(state.x)
    cx, cz = cfg.compressor_x, cfg.compressor_z
    act = sched.round_mask(state.k, x0.device, rows)  # [A, S]
    node_k = sched.round_node_mask(state.k, x0.device, rows)  # [A] | None
    fp = cfg.faults
    if fp is not None:
        if not isinstance(state.x, torch.Tensor):
            raise NotImplementedError(
                "fault injection runs on the packed schedule path only "
                "(packed=true); the tree path has no sealed wire format")
        # a crashed agent is inert for the round: x frozen (node hold),
        # every incident edge dark (folded into ok below); "restart"
        # resumes from the held state, the async-ADMM recovery
        alive = fp.node_alive(state.k, sched.union, x0.device, rows)
        node_k = alive if node_k is None else node_k & alive
    # fused-route base seeds (salts of _key_xe/_key_z)
    bxe = jaxrand.fold_in(round_key, 17)
    bz = jaxrand.fold_in(round_key, 13)

    # ---- 1. local training: union degrees + the full held dual sum;
    # an inactive node freezes its x
    x_new = local_phase(cfg, ids, vr_est, state.x, state.z, data, round_key)
    x_new = _select_agents(node_k, x_new, state.x)

    # ---- 2-4. per-edge sender-side error feedback for x
    xh = state.x_hat_edge
    u_adv = xh if cfg.lean else tree_lerp(state.u_edge, xh, cfg.eta)
    m_x, rec_x = compression.plane_compress(
        cx, lambda: _key_xe(round_key, ids.aid2, ids.nbr), bxe,
        ids.aid2_d, ids.nbr_d,
        tree_map(lambda xn, u: xn[:, None] - u, x_new, u_adv), like)

    # ---- 5-6. sender-side error feedback for z (gated below)
    m_z, rec_z = compression.plane_compress(
        cz, lambda: _key_z(round_key, ids.aid2, ids.nbr), bz,
        ids.aid2_d, ids.nbr_d, tree_sub(state.z, state.s), like)
    z_hat_own = tree_add(state.s, rec_z)

    # ---- the only cross-agent communication (all slots, every round)
    if fp is None:
        recv_x = exchange.exchange_batched(m_x)
        recv_z = exchange.exchange_batched(m_z)
        verdicts = None
    else:
        recv_x, recv_z, verdicts = sealed_exchange(fp, exchange, m_x, m_z,
                                                   state.k, alive)
    if telemetry.active():
        # charged on the schedule's active slots, before the faults
        # refine them (a dropped message was still sent), per edge for
        # both messages: the sealed planes' bytes on a faulted round
        per_msg = (compression.message_nbytes(cx, m_x, nd=2)
                   + compression.message_nbytes(cz, m_z, nd=2)
                   if verdicts is None else verdicts.sealed_nbytes)
        _emit_round_telemetry(
            cfg, vr_est, data,
            sched.round_degrees_device(state.k, x0.device, rows),
            per_msg, node_k,
            None if verdicts is None else _fault_counters(act, verdicts))
    if verdicts is not None:
        act = act & verdicts.edge_ok
    x_hat_edge_new = tree_select(act, tree_add(u_adv, rec_x), xh)
    u_edge_new = (None if cfg.lean
                  else tree_select(act, u_adv, state.u_edge))

    # ---- 7. receiver-side mirrors, gated by the same mask
    xhn = state.x_hat_nbr
    un_adv = xhn if cfg.lean else tree_lerp(state.u_nbr, xhn, cfg.eta)
    xhn_adv = tree_add(un_adv, compression.plane_decompress(
        cx, lambda: _key_xe(round_key, ids.nbr, ids.aid2), bxe,
        ids.nbr_d, ids.aid2_d, recv_x, like))
    x_hat_nbr_new = tree_select(act, xhn_adv, xhn)
    u_nbr_new = (None if cfg.lean
                 else tree_select(act, un_adv, state.u_nbr))
    z_hat_nbr = tree_add(state.s_tilde, compression.plane_decompress(
        cz, lambda: _key_z(round_key, ids.nbr, ids.aid2), bz,
        ids.nbr_d, ids.aid2_d, recv_z, like))

    # ---- 8. z / s / s̃ advance on active edges only (held elsewhere)
    z_eq4 = _eq4(cfg, z_hat_own, z_hat_nbr, x_new, x_hat_edge_new,
                 x_hat_nbr_new, x_hat_per_agent=False)
    return LTADMMScheduleState(
        x=x_new, x_hat_edge=x_hat_edge_new, u_edge=u_edge_new,
        z=tree_select(act, z_eq4, state.z),
        s=tree_select(act, z_hat_own, state.s),
        s_tilde=tree_select(act, z_hat_nbr, state.s_tilde),
        x_hat_nbr=x_hat_nbr_new, u_nbr=u_nbr_new, k=state.k + 1,
    )


class WireVerdicts(NamedTuple):
    """A faulted round's receiver-side verdicts, ``[A, S]`` bool each: per
    message kind the checksum, tag and combined checks; ``ok`` (both kinds
    clean and the receiver alive) and ``edge_ok`` (``ok`` at both
    endpoints).  Schedule-inactive slots carry placeholders: count them on
    the round's active slots.  ``sealed_nbytes``: the bytes of one x- and
    one z-message as sealed (measured on the sealed planes' leaves)."""

    crc_x: torch.Tensor
    tag_x: torch.Tensor
    ok_x: torch.Tensor
    crc_z: torch.Tensor
    tag_z: torch.Tensor
    ok_z: torch.Tensor
    ok: torch.Tensor
    edge_ok: torch.Tensor
    sealed_nbytes: int


def sealed_exchange(fp, exchange, m_x, m_z, k: int, alive):
    """Seal both message planes with round tag ``k``, route them through
    the fault-armed exchange and verify them: ``(recv_x, recv_z,
    WireVerdicts)``.  Both payloads of a round share the link, so one ok
    mask covers x and z; an edge advances only when BOTH endpoints
    received cleanly (NAK symmetrisation over the reliable control
    plane), else duals and mirrors hold on both sides in lockstep."""
    armed = exchange.armed(fp)
    tx_x = compression.seal_plane(m_x, k, nd=2)
    tx_z = compression.seal_plane(m_z, k, nd=2)
    recv_x, ok_x, crc_x, tag_x = compression.verify_plane_kinds(
        armed.exchange_batched(tx_x, round_index=k), k)
    recv_z, ok_z, crc_z, tag_z = compression.verify_plane_kinds(
        armed.exchange_batched(tx_z, round_index=k), k)
    ok = ok_x & ok_z & alive[:, None]
    edge_ok = ok & exchange.exchange_batched(ok)
    nbytes = (telemetry.payload_nbytes(tx_x, nd=2)
              + telemetry.payload_nbytes(tx_z, nd=2))
    return recv_x, recv_z, WireVerdicts(crc_x, tag_x, ok_x, crc_z, tag_z,
                                        ok_z, ok, edge_ok, nbytes)


# ---------------------------------------------------------------------------
# Telemetry tap (only reached while a with_telemetry wrapper steps)
# ---------------------------------------------------------------------------


def _emit_round_telemetry(cfg, vr_est, data, deg, per_msg: int, node_k,
                          fault_counters=None):
    """The tap shared by both rounds: charge each agent its active-degree
    x+z message pairs (``per_msg`` measured bytes a pair), its
    participation and the local phase's gradient evaluations; ``deg``
    ``[A]`` int64 on the device, ``node_k`` ``[A]`` bool or None (every
    agent participates).  Terms only: the wrapper folds them, one add
    each, and nothing is read back to the host."""
    m = agent_rows(vr_est, data)
    evals = telemetry.local_phase_evals(vr_est, m, cfg.tau, cfg.batch_size)
    telemetry.emit(
        tx_bytes=(deg, per_msg), tx_msgs=(deg, 2),
        participations=1 if node_k is None else node_k,
        grad_evals=evals if node_k is None else (node_k, evals),
        **(fault_counters or {}))


def _fault_counters(act, v: WireVerdicts) -> dict:
    """Receiver-side verdict counts on the schedule-active slots ``act``,
    summed over both message kinds: checksum rejects, tag rejects (crc
    ok, tag wrong: ``ok = crc & tag``, so they are the dropped less the
    checksum rejects), dropped, and NAK'd clean receives."""
    miss = (act & ~torch.stack((v.crc_x, v.crc_z, v.ok_x, v.ok_z))).sum(
        dim=2)
    crc, dropped = miss[0] + miss[1], miss[2] + miss[3]
    return {"rx_crc_rejects": crc, "rx_tag_rejects": dropped - crc,
            "rx_dropped": dropped,
            "naks": (act & v.ok & ~v.edge_ok).sum(dim=1)}


# ---------------------------------------------------------------------------
# Diagnostics and wire accounting
# ---------------------------------------------------------------------------


def consensus_mean(state, exchange=None):
    """Mean of x over all agents; on a mesh exchange the rank's rows are
    summed and ``all_reduce``d over the agent axis."""
    if exchange is None or exchange.mesh is None:
        return tree_map(lambda x: torch.mean(x, dim=0), state.x)
    n = exchange.topo.n_agents
    return tree_map(lambda t: t / n, exchange.agent_sum(state.x))


def consensus_error(state, exchange=None, layouts=None):
    """Total squared deviation of the agents' x from their mean (over
    every leaf); global over the mesh as ``consensus_mean`` is.

    ``layouts``: x's leaves are a rank's shards over the ambient mesh's
    "model" axis (tensor parallelism) and "data" axis (FSDP), laid out as
    these ``ShardLayout``s (flatten order): the sum also runs over both
    axes, each element counted once (a piece held whole over "model" by
    the axis's rank 0, a leaf that "data" does not cut by that axis's
    rank 0)."""
    if layouts is None:
        if exchange is None or exchange.mesh is None:
            return tree_consensus_error(state.x)
        mean = consensus_mean(state, exchange)
        sq = tree_map(lambda x, m: ((x - m) ** 2).reshape(x.shape[0], -1)
                      .sum(dim=1), state.x, mean)
        return sum(tree_flatten(exchange.agent_sum(sq))[0])
    import torch.distributed as dist

    from repro_torch.launch import fsdp, tp
    from repro_torch.launch.mesh import (agent_axis_for, axes_of,
                                         current_mesh, group_of)

    mean = consensus_mean(state, exchange)
    mesh = current_mesh()
    agents = agent_axis_for(mesh)
    # "data" cuts the leaves where it is not the agent axis (multi-pod)
    first_m = tp.rank() == 0
    first_d = agents == fsdp.AXIS or fsdp.rank() == 0
    leaves, means = tree_flatten(state.x)[0], tree_flatten(mean)[0]
    total = None
    for x, m, lay in zip(leaves, means, layouts):
        d = ((x - m) ** 2).reshape(x.shape[0], -1)
        if not first_d and not lay.cut_over(fsdp.AXIS):
            d = d * 0
        if not first_m:
            d = (d * ~lay.whole_mask(x.device) if lay.cut_over(tp.AXIS)
                 else d * 0)
        s = d.sum()
        total = s if total is None else total + s
    if exchange is not None and exchange.mesh is not None:
        total = exchange.agent_sum(total[None])
    ax = axes_of(mesh)
    axes = tuple(a for a in ax.axis_names if a != agents and ax.shape[a] > 1)
    total = total.clone()
    if axes:
        dist.all_reduce(total, group=group_of(mesh, axes))
    return total


def _edge_payload_bytes(cfg: LTADMMConfig, params) -> int:
    # sealed payloads (fault detection) carry crc + tag on both messages
    seal = 2 * compression.SEAL_BYTES if cfg.faults is not None else 0
    return (compression.tree_wire_bytes(cfg.compressor_x, params)
            + compression.tree_wire_bytes(cfg.compressor_z, params) + seal)


def wire_bytes_per_round(cfg: LTADMMConfig, topo, params) -> int:
    """Bytes the busiest agent transmits per round: an x-message to every
    neighbor and a z-message per incident edge.  On a schedule,
    ``degrees()`` is the period-mean active degree."""
    return int(round(float(np.max(topo.degrees()))
                     * _edge_payload_bytes(cfg, params)))


def wire_bytes_total(cfg: LTADMMConfig, topo, params) -> int:
    """Aggregate bytes on the wire per round, summed over agents."""
    return int(round(float(np.sum(topo.degrees()))
                     * _edge_payload_bytes(cfg, params)))


def wire_bytes_at(cfg: LTADMMConfig, graph, params, t: int) -> int:
    """Exact busiest-agent bytes at round ``t``: only the links active
    that round carry payloads (constant on a static graph)."""
    deg = (graph.round_degrees(t) if hasattr(graph, "round_degrees")
           else graph.degrees())
    return int(np.max(deg)) * _edge_payload_bytes(cfg, params)
