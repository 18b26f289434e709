"""Telemetry counters measured from the running rounds (port of
``repro/obs/telemetry.py``).

The cost claims are otherwise only predicted (``core.costmodel``, the
analytic ``wire_bytes`` contracts).  This module measures them: a typed
counter tuple (``Telemetry``) rides beside a wrapped solver's state,
accumulated by taps inside the round functions (``core.admm``,
``core.baselines``).  The reference's taps run once, while jax traces the
round; the port's run every round, eagerly, so a tap is a few small
tensor operations on ``[A]`` / ``[A, S]`` masks on the state's device and
never reads a value back to the host.

Opt-in is a wrapper, not a flag::

    solver = with_telemetry(make_solver(spec, graph, ex, est))
    state  = solver.init(x0)            # TelemetryState(inner, telemetry)
    state  = solver.step(state, data, key)
    counts = counters(state)            # host numpy dict, uint32

The taps check ``active()`` first, so an unwrapped solver runs not one
extra operation.

Counting conventions (as the reference's):

* ``tx_bytes[i]`` charges agent ``i`` for every message the wire
  contract bills: one payload per schedule-active incident edge (the
  mask BEFORE fault refinement: a dropped message was still sent), with
  per-message bytes measured from the payload leaves (``payload_nbytes``),
  so sealed payloads cost ``SEAL_BYTES`` more.  Masked union slots move
  self-addressed placeholders and are not charged.
* fault counters are receiver-side, on the same schedule mask:
  ``rx_crc_rejects`` (checksum mismatch: drops, corruption),
  ``rx_tag_rejects`` (checksum-consistent stale rounds), ``rx_dropped``
  (any failed verification), ``naks`` (clean receives held because the
  peer NAK'd the edge).
* ``grad_evals`` counts component-gradient evaluations from the bound
  estimator's recipe, charged only to participating agents.
* the counters are int64 on the device (torch has no uint32 add);
  ``counters`` masks them to uint32, so totals and per-round differences
  wrap mod 2^32 exactly as the reference's do.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.common.trees import first_leaf, tree_flatten

_U32 = 0xFFFFFFFF


class Telemetry(NamedTuple):
    """Per-agent counter vectors ``[A]`` and two scalar counters, int64
    on the solver's device, cumulative."""

    tx_bytes: Any  # [A] bytes transmitted (measured on the wire format)
    tx_msgs: Any  # [A] messages transmitted
    rx_dropped: Any  # [A] received messages failing seal verification
    rx_crc_rejects: Any  # [A]   ... of which checksum mismatches
    rx_tag_rejects: Any  # [A]   ... of which stale round tags (crc ok)
    naks: Any  # [A] clean receives held because the peer NAK'd the edge
    participations: Any  # [A] rounds the agent participated in
    grad_evals: Any  # [A] component-gradient evaluations
    graph_rounds: Any  # [] learned-graph (dada) graph rounds
    rounds: Any  # [] rounds stepped through the wrapper

    @classmethod
    def zeros(cls, n_agents: int, device="cpu") -> "Telemetry":
        vec = torch.zeros((8, n_agents), dtype=torch.int64, device=device)
        sca = torch.zeros((2,), dtype=torch.int64, device=device)
        return cls(*vec.unbind(0), *sca.unbind(0))


# ---------------------------------------------------------------------------
# The collector: how the taps inside the round functions reach the wrapper.
# Thread-local, as in the reference, so concurrent solvers cannot cross-talk.
# ---------------------------------------------------------------------------

_LOCAL = threading.local()


def active() -> bool:
    """True while a ``with_telemetry`` step runs: the taps guard on this,
    so an unwrapped solver pays nothing."""
    return getattr(_LOCAL, "collector", None) is not None


def emit(**counters) -> None:
    """Add a round's contributions to the active collector (no-op when
    inactive).  Names must be ``Telemetry`` fields; a value is a tensor
    (bool or integer, ``[A]`` or scalar), a Python int (added to every
    agent), or ``(tensor, c)`` for ``c * tensor``.  Nothing is computed
    here: the wrapper folds each term into its counter with one
    ``torch.add`` (``alpha=c``)."""
    col = getattr(_LOCAL, "collector", None)
    if col is None:
        return
    for name, value in counters.items():
        if name not in Telemetry._fields:
            raise ValueError(f"unknown telemetry counter {name!r}")
        if isinstance(value, tuple):
            term = (value[0], int(value[1]))
        elif isinstance(value, torch.Tensor):
            term = (value, 1)
        else:
            term = (None, int(value))
        col.setdefault(name, []).append(term)


@contextlib.contextmanager
def _collect():
    prev = getattr(_LOCAL, "collector", None)
    _LOCAL.collector = {}
    try:
        yield _LOCAL.collector
    finally:
        _LOCAL.collector = prev


def _fold(total, terms):
    for t, c in terms:
        total = total + c if t is None else torch.add(total, t, alpha=c)
    return total


# ---------------------------------------------------------------------------
# Measured message sizes
# ---------------------------------------------------------------------------


def payload_nbytes(payload, nd: int) -> int:
    """Wire bytes of ONE message of a batched payload tree whose leaves
    carry ``nd`` leading batch dims (``[A, S, ...]`` -> nd=2): a Python
    int from the leaf shapes and dtypes.  Counts every leaf: compressed
    values, scales, explicit indices, and the crc/tag words of sealed
    payloads."""
    return int(sum(math.prod(leaf.shape[nd:]) * leaf.element_size()
                   for leaf in tree_flatten(payload)[0]))


@functools.lru_cache(maxsize=64)
def _message_nbytes(comp, specs: tuple) -> int:
    from repro_torch.core import compression, jaxrand

    zeros = [torch.zeros((1,) + tuple(shape), dtype=dtype)
             for shape, dtype in specs]
    keys = jaxrand.key(0)[None]
    return payload_nbytes(compression.compress_tree(comp, keys, zeros, nd=1),
                          nd=1)


def message_nbytes(comp, like) -> int:
    """Wire bytes of one compressed message of a ``like``-shaped tree
    (per-message ``compression.Spec`` leaves), measured from the payload
    the compressor emits for a zero message on the CPU (the kernels'
    plain versions there), once per (compressor, leaf shapes)."""
    specs = tuple((tuple(s.shape), s.dtype) for s in tree_flatten(like)[0])
    return _message_nbytes(comp, specs)


# ---------------------------------------------------------------------------
# Gradient-evaluation recipes (per the estimators of core.vr)
# ---------------------------------------------------------------------------


def _est_name(est) -> str:
    # unwrap the packed-plane adapter (core.packing.PackedEstimator)
    return type(getattr(est, "est", est)).__name__


def local_phase_evals(est, m: int, tau: int, batch_size: int) -> int:
    """Component-gradient evaluations of ONE agent's LT-ADMM local phase
    (reset + tau estimator steps)."""
    name = _est_name(est)
    if name == "SagaTable":  # reset sweeps the table, steps refresh a batch
        return m + tau * batch_size
    if name == "SvrgAnchor":  # reset anchors a full grad, steps cost 2x
        return m + 2 * tau * batch_size
    if name == "FullGrad":  # every step is a full sweep
        return tau * m
    return tau * batch_size  # PlainSgd


def round_grad_evals(est, m: int, batch_size: int) -> int:
    """Component-gradient evaluations of one gossip-baseline iteration
    (a single stateless estimate per agent)."""
    name = _est_name(est)
    if name == "FullGrad":
        return m
    if name == "SvrgAnchor":
        return 2 * batch_size
    return batch_size


# ---------------------------------------------------------------------------
# The opt-in wrapper
# ---------------------------------------------------------------------------


class TelemetryState(NamedTuple):
    inner: Any  # the wrapped solver's state, untouched
    telemetry: Telemetry


@dataclasses.dataclass(frozen=True)
class TelemetrySolver:
    """``Solver``-protocol wrapper that carries a ``Telemetry`` beside the
    wrapped solver's state.  ``step`` installs the collector, runs the
    inner step (whose taps add their round's terms) and folds the terms
    into new counter tensors: one ``torch.add`` a term, no host sync."""

    solver: Any

    def __getattr__(self, name):
        # graph, cfg, device, ... delegate
        return getattr(object.__getattribute__(self, "solver"), name)

    # the protocol's members, spelled out: ``isinstance(w, Solver)`` looks
    # them up statically, past ``__getattr__``
    @property
    def name(self) -> str:
        return self.solver.name

    def wire_bytes(self, params, t: int | None = None) -> int:
        return self.solver.wire_bytes(params, t)

    def round_cost(self, cost_model, m: int) -> float:
        return self.solver.round_cost(cost_model, m)

    def init(self, x0):
        inner = self.solver.init(x0)
        return TelemetryState(inner, Telemetry.zeros(
            first_leaf(x0).shape[0], self.solver.device))

    def step(self, state, data, key):
        with _collect() as col:
            inner = self.solver.step(state.inner, data, key)
        tel = state.telemetry
        upd = {k: _fold(getattr(tel, k), terms) for k, terms in col.items()}
        upd["rounds"] = tel.rounds + 1
        return TelemetryState(inner, tel._replace(**upd))

    def consensus_params(self, state):
        return self.solver.consensus_params(state.inner)

    def abstract_state(self, x_sds):
        """The wrapped solver's abstract state beside ``meta`` counters:
        ``[A]`` per agent, two scalars, int64 as the port keeps them."""
        a = first_leaf(x_sds).shape[0]
        vec = [torch.empty((a,), dtype=torch.int64, device="meta")] * 8
        sca = [torch.empty((), dtype=torch.int64, device="meta")] * 2
        return TelemetryState(self.solver.abstract_state(x_sds),
                              Telemetry(*vec, *sca))

    def state_sharding(self, x_ps, edge_ps, scalar_ps):
        """The wrapped solver's specs; the counters are tiny and
        replicated."""
        inner = self.solver.state_sharding(x_ps, edge_ps, scalar_ps)
        return TelemetryState(inner, Telemetry(
            *([scalar_ps] * len(Telemetry._fields))))


def with_telemetry(solver) -> TelemetrySolver:
    """Wrap any registered solver with the telemetry counters
    (idempotent)."""
    if isinstance(solver, TelemetrySolver):
        return solver
    return TelemetrySolver(solver)


def counters(state) -> dict[str, np.ndarray]:
    """Host numpy view of the cumulative counters as the reference's
    uint32 (masked mod 2^32): one device-to-host copy; call it at sample
    points, never inside the loop."""
    tel = state.telemetry if isinstance(state, TelemetryState) else state
    a = tel.tx_bytes.shape[0]
    flat = torch.cat([torch.stack(tel[:8]).reshape(-1),
                      torch.stack(tel[8:])]).cpu().numpy()
    flat = (flat & _U32).astype(np.uint32)
    out = {f: flat[i * a:(i + 1) * a]
           for i, f in enumerate(Telemetry._fields[:8])}
    out["graph_rounds"] = np.asarray(flat[8 * a])
    out["rounds"] = np.asarray(flat[8 * a + 1])
    return out
