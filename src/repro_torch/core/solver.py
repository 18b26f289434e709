"""The solvers behind the reference's ``Solver`` protocol and spec-string
registry (port of ``repro/core/solver.py``): ``ltadmm:``, the six
gossip baselines of ``core.baselines`` and ``dada:`` (``core.graphlearn``,
learned collaboration graphs).

    solver = make_solver("ltadmm:compressor=qbit:bits=8", graph, ex, est)
    solver = make_solver("lead:lr=0.1,compressor=qbit:bits=8", graph, ex,
                         est)
    state = solver.init(x0)                 # stacked [A, ...] params
    state = solver.step(state, data, key)   # data leaves [A, m, ...]
    x = solver.consensus_params(state)

``graph`` is a static ``Topology`` or a ``schedule.TopologySchedule``
(``build_graph`` gives either from a spec string).  ``packed`` (default
true) runs on the packed ``[A, N]`` plane; ``packed=false`` keeps the
parameters a pytree, compressed leaf by leaf.  ``make_solver`` takes
``device=`` (default the card) and raises without CUDA unless
``device="cpu"``.  ``faults=`` (a nested ``core.faults`` spec, ``|`` for
``,``) arms seeded fault injection on every solver; LT-ADMM then runs the
packed time-varying round (a static graph becomes a period-1 schedule).

An exchange on a mesh axis (``Exchange(topo, axis, mesh)``) runs every
registered solver with each rank holding its agent rows: ``init`` takes
and the state holds ``[A/W, ...]`` rows.  LT-ADMM-CC and dada route their
messages through the exchange's all-to-alls; the gossip baselines
all-gather each leaf and mix with the whole ``[A, A]`` matrix.

The sharding hooks: ``abstract_state(x)`` maps stacked ``[A, ...]``
``meta`` tensors to the state's shapes and dtypes without allocating,
and ``state_sharding(x_ps, edge_ps, scalar_ps)`` lays the given specs out
in the state's structure.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Protocol, runtime_checkable

import torch

from repro_torch.common.trees import (abstract_counter, as_tensor,
                                      first_leaf, meta_like,
                                      tree_consensus_error,
                                      tree_consensus_mean, tree_map)
from repro_torch.core import (admm, baselines, compression, faults,
                              graphlearn, packing)
from repro_torch.core.admm import LTADMMConfig
from repro_torch.core.schedule import (TopologySchedule, static_schedule,
                                       union_topology)
from repro_torch.core.topology import Exchange
from repro_torch.device import resolve_device

@runtime_checkable
class Solver(Protocol):
    """What the launch and bench layers require of a distributed method
    (the reference's protocol), with its two sharding hooks."""

    name: str

    def init(self, x0) -> Any: ...

    def step(self, state, data, key) -> Any: ...

    def consensus_params(self, state) -> Any: ...

    def wire_bytes(self, params, t: int | None = None) -> int: ...

    def round_cost(self, cost_model, m: int) -> float: ...

    def abstract_state(self, x_sds) -> Any: ...

    def state_sharding(self, x_ps, edge_ps, scalar_ps) -> Any: ...


# consensus diagnostics over stacked [A, ...] params: one definition in
# common.trees, under the names the reference's solver module gives it
consensus_mean = tree_consensus_mean
consensus_error = tree_consensus_error


@dataclasses.dataclass(frozen=True)
class LTADMMSolver:
    """Paper Algorithm 1 on ``device``: on the packed ``[A, N]`` plane, or
    on the parameter pytree when ``packed`` is False; over a static graph
    or a ``TopologySchedule``."""

    graph: Any
    exchange: Exchange
    grad_est: Any
    cfg: LTADMMConfig = LTADMMConfig()
    packed: bool = True
    device: torch.device = torch.device("cpu")
    name: str = "ltadmm"
    # tensor parallelism (``steps.build_train`` with a mesh): the rank's
    # ``ShardLayout`` of each leaf of the pytree state, flatten order
    tp_layouts: tuple | None = None
    _cache: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    estimator = "vr"

    @property
    def is_schedule(self) -> bool:
        return isinstance(self.graph, TopologySchedule)

    def _layout(self, state) -> packing.PackedLayout:
        lay = self._cache.get("layout")
        if lay is None:
            lay = packing.layout_of(state.x[0])
            self._cache["layout"] = lay
        return lay

    def _ids(self, x) -> admm.RoundIds:
        x = first_leaf(x)
        ids = self._cache.get(("ids", x.device))
        if ids is None:
            ids = admm.RoundIds.build(union_topology(self.graph), x.device,
                                      x.dtype, self.exchange.rows)
            self._cache[("ids", x.device)] = ids
        return ids

    def init(self, x0):
        """x0: stacked ``[A, ...]`` params (tensors or numpy arrays)."""
        x0 = tree_map(lambda t: as_tensor(t).to(self.device), x0)
        if self.packed:
            lay = packing.layout_of_stacked(x0)
            self._cache["layout"] = lay
            x0 = packing.pack(lay, x0)
        if self.is_schedule:
            return admm.init_schedule(self.cfg, self.graph, self.exchange, x0)
        return admm.init(self.cfg, self.graph, self.exchange, x0)

    def step(self, state, data, key):
        est = self.grad_est
        if self.packed:
            est = packing.PackedEstimator(est, self._layout(state))
        run = admm.step_schedule if self.is_schedule else admm.step
        return run(self.cfg, self.graph, self.exchange, est, state, data,
                   key, ids=self._ids(state.x))

    def consensus_params(self, state):
        if self.packed:
            return packing.unpack(self._layout(state), state.x)
        return state.x

    def wire_bytes(self, params, t: int | None = None) -> int:
        """Busiest-agent TX bytes per round (the period-mean active degree
        of a schedule; an explicit ``t`` charges that round exactly).  On
        the packed plane a message is ONE compressed plane of all the
        parameters, on the pytree path one per leaf."""
        if self.packed:
            params = packing.abstract_plane(params)
        if t is not None:
            return admm.wire_bytes_at(self.cfg, self.graph, params, t)
        return admm.wire_bytes_per_round(self.cfg, self.graph, params)

    def round_cost(self, cost_model, m: int) -> float:
        """(t_g, t_c) cost of one outer round, Table I's last row."""
        return cost_model.lt_admm_cc(m, self.cfg.tau)

    # ---- sharding / lowering hooks ----------------------------------------

    def state_tree(self, x_leaf, edge_leaf, k_leaf):
        """State-shaped tree from representative leaves: every per-agent
        field gets ``x_leaf``, every per-edge field ``edge_leaf`` (the u
        fields None when lean); the state class follows the graph kind."""
        u_edge = None if self.cfg.lean else edge_leaf
        if self.is_schedule:
            return admm.LTADMMScheduleState(
                x=x_leaf, x_hat_edge=edge_leaf, u_edge=u_edge, z=edge_leaf,
                s=edge_leaf, s_tilde=edge_leaf, x_hat_nbr=edge_leaf,
                u_nbr=u_edge, k=k_leaf)
        return admm.LTADMMState(
            x=x_leaf, x_hat=x_leaf, u=None if self.cfg.lean else x_leaf,
            z=edge_leaf, s=edge_leaf, s_tilde=edge_leaf, x_hat_nbr=edge_leaf,
            u_nbr=u_edge, k=k_leaf)

    def abstract_state(self, x_sds):
        """The state's ``meta`` tree from stacked ``[A, ...]`` ``meta``
        params: the packed plane ``[A, N]`` (its layout kept for
        ``step``), edge leaves ``[A, S, ...]``, an int32 counter."""
        if self.packed:
            a = first_leaf(x_sds).shape[0]
            lay = packing.layout_of_stacked(x_sds)
            self._cache["layout"] = lay
            x_sds = meta_like((a, lay.size), lay.dtype)
        n_slots = self.graph.n_slots
        edge = tree_map(lambda t: meta_like(
            (t.shape[0], n_slots) + tuple(t.shape[1:]), t.dtype), x_sds)
        return self.state_tree(x_sds, edge, abstract_counter())

    def state_sharding(self, x_ps, edge_ps, scalar_ps):
        return self.state_tree(x_ps, edge_ps, scalar_ps)


@dataclasses.dataclass(frozen=True)
class SolverEntry:
    name: str
    factory: Callable
    params: frozenset
    nested: frozenset
    estimator: str
    doc: str = ""


SOLVERS: dict[str, SolverEntry] = {}


def register_solver(name, factory, params, nested=(), estimator="sgd",
                    doc=""):
    SOLVERS[name] = SolverEntry(name=name, factory=factory,
                                params=frozenset(params),
                                nested=frozenset(nested),
                                estimator=estimator, doc=doc)


def solver_entry(spec: str) -> SolverEntry:
    name = spec.partition(":")[0]
    if name not in SOLVERS:
        raise ValueError(
            f"unknown solver {name!r}; choose from {sorted(SOLVERS)}")
    return SOLVERS[name]


def parse_solver_spec(spec: str):
    """``name[:k=v,...]`` -> (entry, params).  A ``k=v`` item whose key
    the solver does not know, right after a nested key (a compressor or
    ``faults``), is folded into that spec; any other unknown key raises.
    Nested specs are validated here, naming the valid params."""
    entry = solver_entry(spec)
    kw: dict = {}
    last_nested = None
    for item in spec.partition(":")[2].split(","):
        item = item.strip()
        if not item:
            continue
        k, eq, v = item.partition("=")
        k = k.strip()
        if k in entry.params and eq:
            kw[k] = v.strip()
            last_nested = k if k in entry.nested else None
        elif last_nested is not None:
            kw[last_nested] += "," + item
        else:
            raise ValueError(
                f"solver {entry.name!r} got unknown param {item!r} "
                f"(accepted: {sorted(entry.params)})")
    for k in entry.nested & kw.keys():
        if k == "faults":
            faults.validate_spec(kw[k])
        else:
            compression.validate_spec(kw[k])
    return entry, kw


def make_solver(spec: str, graph, exchange=None, grad_est=None,
                defaults=None, device=None):
    """Solver from a registry spec string, on ``device`` (default the
    card; raises without CUDA unless ``device="cpu"``)."""
    dev = resolve_device(device)
    entry, kw = parse_solver_spec(spec)
    merged = {k: v for k, v in (defaults or {}).items() if k in entry.params}
    merged.update(kw)
    if exchange is None:
        exchange = Exchange(union_topology(graph))
    return entry.factory(graph, exchange, grad_est, device=dev, **merged)


def _as_compressor(v):
    return compression.get_compressor(v) if isinstance(v, str) else v


_LTADMM_CFG_FIELDS = tuple(f.name for f in dataclasses.fields(LTADMMConfig)
                           if not f.name.startswith("compressor"))


def _make_ltadmm(graph, exchange, grad_est, device, **kw):
    comp = kw.pop("compressor", None)
    packed = compression.coerce_param(kw.pop("packed", True))
    fp = faults.get_faults(kw.pop("faults", None))
    if comp is not None:
        comp = _as_compressor(comp)
        kw.setdefault("compressor_x", comp)
        kw.setdefault("compressor_z", comp)
    for key in ("compressor_x", "compressor_z"):
        if key in kw:
            kw[key] = _as_compressor(kw[key])
    cfg = LTADMMConfig(
        **{k: compression.coerce_param(v) for k, v in kw.items()},
        faults=fp)
    if fp is not None:
        if not packed:
            raise ValueError(
                "ltadmm faults= requires packed=true (the sealed wire "
                "format lives on the packed plane)")
        # faults need the per-edge EF/hold machinery of the schedule
        # path; identity on inputs that are already schedules
        graph = static_schedule(graph)
    return LTADMMSolver(graph=graph, exchange=exchange, grad_est=grad_est,
                        cfg=cfg, packed=packed, device=device)


register_solver(
    "ltadmm", _make_ltadmm,
    params=_LTADMM_CFG_FIELDS + ("compressor", "compressor_x",
                                 "compressor_z", "packed"),
    nested=("compressor", "compressor_x", "compressor_z", "faults"),
    estimator="vr",
    doc="LT-ADMM-CC (paper Alg. 1): local VR training + compressed "
        "x/z exchanges; exact convergence (Theorem 1); packed=false "
        "restores the per-leaf pytree path",
)


# ---- gossip baselines -----------------------------------------------------

_BASELINE_DOCS = {
    "dsgd": "decentralized SGD with uncompressed gossip averaging",
    "choco": "CHOCO-SGD: compressed gossip with error feedback",
    "lead": "LEAD: primal-dual, compressed y-innovations",
    "cold": "COLD: LEAD skeleton, innovation state (alpha = 1)",
    "cedas": "CEDAS: exact diffusion + compressed gossip",
    "dpdc": "DPDC: primal-dual with compressed copies",
}
# dataclass fields that are not spec params: the reference's three, and
# the port's device, exchange and per-instance cache
_NOT_PARAMS = ("topo", "grad_est", "name", "device", "exchange", "_cache")


def _baseline_factory(cls):
    def factory(graph, exchange, grad_est, device, **kw):
        # the baselines gossip through a dense mixing matrix; a mesh
        # exchange gives the rank's rows and the all-gather of each leaf
        if "compressor" in kw:
            kw["compressor"] = _as_compressor(kw["compressor"])
        if "faults" in kw:
            kw["faults"] = faults.get_faults(kw["faults"])
        kw = {k: compression.coerce_param(v) for k, v in kw.items()}
        return cls(topo=graph, grad_est=grad_est, device=device,
                   exchange=exchange, **kw)

    return factory


for _name, _cls in baselines.ALL_BASELINES.items():
    _fields = tuple(f.name for f in dataclasses.fields(_cls)
                    if f.name not in _NOT_PARAMS)
    register_solver(
        _name, _baseline_factory(_cls), params=_fields,
        nested=tuple(k for k in ("compressor", "faults") if k in _fields),
        estimator="sgd", doc=_BASELINE_DOCS[_name],
    )


# ---- dada: learned collaboration graph --------------------------------------

register_solver(
    "dada", graphlearn.make_dada, params=graphlearn.DADA_PARAMS,
    nested=("compressor", "faults"), estimator="sgd",
    doc="Dada: jointly learned personalized models + sparse "
        "collaboration graph (alternating model/graph rounds; "
        "lambda_g entropic weight, mu coupling, graph_every cadence, "
        "degree_cap live-edge sparsity)",
)
