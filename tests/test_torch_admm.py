"""LT-ADMM-CC in the port against the reference.

* one ``_step_packed`` round from the same state (carried across with
  ``state_from_numpy``) agrees within rtol 1e-5 / atol 1e-6: the random
  draws and payload bits are identical, float32 sums are reassociated;
* the ``admm/ring/q8+saga`` run of ``benchmarks/BENCH_BASELINE.json``:
  rounds_to_tol 100 at tol 1e-8, 36 B/round, and log10 ||grad F||² within
  0.05 of the live reference at every sample where it is >= 1e-12;
* the kernel route (plain versions on the CPU) against ``impl=pallas``
  (interpret mode) over 20 rounds: the fused plane route (qbit8, RandK
  block) and the packed fallback's per-message route (TopK, RandK
  uniform);
* topology tables, the device rule, the faulted specs that build and
  step and those refused as the reference refuses them, and the mesh
  exchange in a one-rank gloo world (LT-ADMM-CC and dada build and step
  there, each round bit-equal to the host round).
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks.common import make_problem  # noqa: E402
from benchmarks.common import run_solver as jrun_solver  # noqa: E402
from repro.checkpoint.store import save_checkpoint  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.core import vr as jvr  # noqa: E402
from repro.core.solver import make_solver as jmake_solver  # noqa: E402
from repro_torch.bench import rounds_to_tol, run_solver  # noqa: E402
from repro_torch.checkpoint.reference import (  # noqa: E402
    data_from_numpy, state_from_numpy)
from repro_torch.core import jaxrand, topology, vr  # noqa: E402
from repro_torch.core.faults import FaultPlane  # noqa: E402
from repro_torch.core.schedule import (  # noqa: E402
    TopologySchedule, build_graph)
from repro_torch.core.solver import make_solver  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, world  # noqa: E402
from repro_torch.problems.logistic import LogisticProblem  # noqa: E402

JPROB, JDATA, JGRAPH, JEX = make_problem(seed=0)
DATA_NP = jax.tree.map(np.asarray, JDATA)
PROB = LogisticProblem()


def _ref_solver(spec):
    return jmake_solver(spec, JGRAPH, JEX,
                        jvr.SagaTable(sample_grad=JPROB.sample_grad,
                                      m=JPROB.m))


def _port_solver(spec):
    graph, ex = build_graph("ring", PROB.n_agents)
    return make_solver(spec, graph, ex,
                       vr.SagaTable(sample_grads=PROB.sample_grads,
                                    m=PROB.m), device="cpu")


ROUND_CASES = [
    ("ltadmm:compressor=qbit:bits=8,impl=jnp",
     "ltadmm:compressor=qbit:bits=8,impl=torch"),
    ("ltadmm:compressor=qbit:bits=8,impl=pallas",
     "ltadmm:compressor=qbit:bits=8,impl=kernel"),
    ("ltadmm:eta=0.5,compressor=randk:fraction=0.6,sampler=stride,"
     "impl=pallas",
     "ltadmm:eta=0.5,compressor=randk:fraction=0.6,sampler=stride,"
     "impl=kernel"),
    ("ltadmm:eta=0.5,compressor=randk:fraction=0.6,sampler=uniform,impl=jnp",
     "ltadmm:eta=0.5,compressor=randk:fraction=0.6,sampler=uniform,"
     "impl=torch"),
]


@pytest.mark.parametrize("ref_spec,port_spec", ROUND_CASES)
def test_one_round_matches_reference(ref_spec, port_spec, tmp_path):
    js = _ref_solver(ref_spec)
    step = jax.jit(lambda s, k: js.step(s, JDATA, k))
    st = js.init(jnp.zeros((PROB.n_agents, PROB.n)))
    for i in range(3):  # a state with nonzero duals and mirrors
        st = step(st, jax.random.fold_in(jax.random.key(1), i))
    want = jax.tree.map(np.asarray, step(st, jax.random.fold_in(
        jax.random.key(1), 3)))

    # carry the state across through a reference checkpoint on disk
    save_checkpoint(tmp_path / "ck", st, step=3)
    with np.load(tmp_path / "ck" / "arrays.npz") as z:
        arrays = dict(z)
    with open(tmp_path / "ck" / "manifest.json") as f:
        manifest = json.load(f)
    ts = _port_solver(port_spec)
    tst = state_from_numpy(arrays, ts.cfg, device="cpu",
                           step=manifest["step"])
    got = ts.step(tst, data_from_numpy(DATA_NP, "cpu"),
                  jaxrand.fold_in(jaxrand.key(1), 3))
    assert got.k == 4
    for f in got._fields[:-1]:
        w, g = getattr(want, f), getattr(got, f)
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6,
                                   err_msg=f)


@pytest.mark.parametrize("sampler", ["stride", "block"])
def test_fig1_randk_rows_match_reference(sampler):
    """Fig. 1's RandK rows (eta 0.5, fraction 0.6) through the plane
    route's kernels' plain versions: rounds_to_tol 100 at 48 B/round, as
    the reference's Pallas route gives (chip_smoke.py holds the card to
    these numbers)."""
    spec = f"ltadmm:eta=0.5,compressor=randk:fraction=0.6,sampler={sampler}"
    idx, g = jrun_solver(JPROB, JDATA, _ref_solver(spec + ",impl=pallas"),
                         110)
    ts = _port_solver(spec + ",impl=kernel")
    tidx, tg = run_solver(PROB, DATA_NP, ts, 110)
    np.testing.assert_array_equal(tidx, np.asarray(idx))
    assert rounds_to_tol(tidx, tg, 1e-8) == 100 == rounds_to_tol(
        idx, np.asarray(g), 1e-8)
    assert ts.wire_bytes({"x": np.zeros(5, np.float32)}) == 48


def test_state_from_numpy_takes_the_state_tuple():
    js = _ref_solver("ltadmm:eta=0.5,compressor=qbit:bits=8,impl=jnp")
    st = jax.tree.map(np.asarray, js.init(jnp.ones((PROB.n_agents, PROB.n))))
    ts = _port_solver("ltadmm:eta=0.5,compressor=qbit:bits=8")
    tst = state_from_numpy(st, ts.cfg, device="cpu")
    assert tst.k == 0
    np.testing.assert_array_equal(tst.u_nbr.numpy(), st.u_nbr)
    np.testing.assert_array_equal(
        tst.x_hat_nbr.numpy(), ts.init(torch.ones(10, 5)).x_hat_nbr.numpy())


def test_q8_saga_run_matches_reference_trajectory():
    spec = "ltadmm:compressor=qbit:bits=8"
    idx, g = jrun_solver(JPROB, JDATA, _ref_solver(spec + ",impl=jnp"), 200)
    g = np.asarray(g)
    ts = _port_solver(spec + ",impl=torch")
    tidx, tg = run_solver(PROB, DATA_NP, ts, 200)
    np.testing.assert_array_equal(tidx, np.asarray(idx))
    keep = g >= 1e-12
    assert keep.sum() >= 15
    assert np.max(np.abs(np.log10(tg[keep]) - np.log10(g[keep]))) < 0.05
    assert rounds_to_tol(tidx, tg, 1e-8) == 100 == rounds_to_tol(idx, g, 1e-8)
    assert ts.wire_bytes({"x": np.zeros(5, np.float32)}) == 36
    with open(os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                           "BENCH_BASELINE.json")) as f:
        row = json.load(f)["results"][0]
    assert row["name"] == "admm/ring/q8+saga" and row["rounds_to_tol"] == 100
    assert row["wire_bytes_per_round"] == 36


@pytest.mark.parametrize("spec,wire", [
    ("compressor=qbit:bits=8", 36),
    ("eta=0.5,compressor=randk:fraction=0.6,sampler=block", 48),
    # not plane-ready: the packed fallback's per-message route (K6/K7)
    ("compressor=topk:fraction=0.25", 32),
    ("compressor=randk:fraction=0.25", 16)],
    ids=["qbit:bits=8-36", "randk:fraction=0.6,sampler=block-48",
         "topk:fraction=0.25-32", "randk:fraction=0.25-16"])
def test_kernel_route_matches_pallas_interpret(spec, wire):
    js = _ref_solver(f"ltadmm:{spec},impl=pallas")
    idx, g = jrun_solver(JPROB, JDATA, js, 20, metric_every=5)
    ts = _port_solver(f"ltadmm:{spec},impl=kernel")
    tidx, tg = run_solver(PROB, DATA_NP, ts, 20, metric_every=5)
    np.testing.assert_array_equal(tidx, np.asarray(idx))
    np.testing.assert_allclose(np.log10(tg), np.log10(np.asarray(g)),
                               atol=0.05)
    params = {"x": np.zeros(5, np.float32)}
    assert ts.wire_bytes(params) == wire == js.wire_bytes(params)


@pytest.mark.parametrize("spec", [
    "ring", "grid2d:rows=3", "star", "complete", "erdos:p=0.4,seed=1",
    "smallworld:k=4,p=0.2"])
def test_topology_tables_match(spec):
    n = 9 if spec.startswith("grid2d") else 10
    jt, tt = jtopo.make_topology(spec, n), topology.make_topology(spec, n)
    assert tt.n_slots == jt.n_slots and tt.reverse_slot == jt.reverse_slot
    np.testing.assert_array_equal(tt.neighbor_table(), jt.neighbor_table())
    np.testing.assert_array_equal(tt.slot_mask(), jt.slot_mask())
    np.testing.assert_array_equal(tt.degrees(), jt.degrees())
    np.testing.assert_array_equal(topology.metropolis_weights(tt),
                                  jtopo.metropolis_weights(jt))
    topology.validate(tt)
    ex, jex = topology.Exchange(tt), jtopo.Exchange(jt)
    a, s = tt.n_agents, tt.n_slots
    x = np.arange(a * s * 3, dtype=np.float32).reshape(a, s, 3)
    np.testing.assert_array_equal(
        ex.exchange_batched(torch.from_numpy(x)).numpy(),
        np.asarray(jex.exchange_batched(jnp.asarray(x))))
    np.testing.assert_array_equal(
        ex.gather_batched(torch.from_numpy(x[:, 0])).numpy(),
        np.asarray(jex.gather_batched(jnp.asarray(x[:, 0]))))
    for got, want in zip(ex.gather_from_neighbors(torch.from_numpy(x[:, 0])),
                         jex.gather_from_neighbors(jnp.asarray(x[:, 0]))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_make_solver_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the rule on a machine without CUDA")
    graph, ex = build_graph("ring", 10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_solver("ltadmm:compressor=qbit:bits=8", graph, ex, None)


@pytest.mark.parametrize("spec,mesh,item", [
    ("dada:lr=0.1", {"axis": "data"}, "item 15"),
    ("ltadmm:compressor=qbit:bits=8", {"axis": "data"}, None)])
def test_unported_solver_paths_raise(spec, mesh, item, tmp_path):
    """A solver over the multi-process exchange (the "data" axis of a
    one-rank gloo world) builds, and its round equals the host round bit
    for bit: LT-ADMM-CC, and dada (ROADMAP ``item``, whose gossip and
    dada rounds over ranks ``make_solver`` once refused)."""
    del item
    graph, host_ex = build_graph("ring", 10)
    est = (vr.PlainSgd(batch_grad=PROB.batch_grad) if spec.startswith(
        "dada") else vr.SagaTable(sample_grads=PROB.sample_grads, m=PROB.m))
    with world("gloo", str(tmp_path / "store")):
        ex = topology.Exchange(graph, mesh=make_host_mesh(), **mesh)
        s = make_solver(spec, graph, ex, est, device="cpu")
        assert s.exchange is ex and ex.rows == range(10) and ex.world == 1
        data = data_from_numpy(DATA_NP, "cpu")
        x0 = torch.zeros((PROB.n_agents, PROB.n))
        got = s.step(s.init(x0), data, jaxrand.key(3))
    h = make_solver(spec, graph, host_ex, est, device="cpu")
    want = h.step(h.init(x0), data, jaxrand.key(3))
    if isinstance(got, dict):
        got, want = (tuple(st.items()) for st in (got, want))
    else:
        got, want = (tuple(zip(st._fields, st)) for st in (got, want))
    assert [f for f, _ in got] == [f for f, _ in want]
    for (f, g), (_, w) in zip(got, want):
        if isinstance(g, torch.Tensor):
            assert torch.equal(g, w), f


FAULTED_SPECS = [
    ("dsgd:faults=faults:drop=0.1", "ring"),
    ("ltadmm:faults=faults:drop=0.1", "ring"),
    ("ltadmm:faults=faults:drop=0.1", "drop:p=0.3,base=complete,seed=0"),
    ("choco:faults=faults:drop=0.1", "drop:p=0.3,base=complete,seed=0"),
]


@pytest.mark.parametrize("spec,gspec", FAULTED_SPECS)
def test_faulted_specs_build_and_step(spec, gspec):
    """The specs that raised before faults were ported now build (LT-ADMM
    on a period-1 schedule over a static graph) and step."""
    graph, ex = build_graph(gspec, 10)
    est = (vr.SagaTable(sample_grads=PROB.sample_grads, m=PROB.m)
           if spec.startswith("ltadmm") else
           vr.PlainSgd(batch_grad=PROB.batch_grad))
    s = make_solver(spec, graph, ex, est, device="cpu")
    ltadmm = spec.startswith("ltadmm")
    assert (s.cfg.faults if ltadmm else s.faults) == FaultPlane(drop=0.1)
    assert not ltadmm or s.is_schedule
    st = s.init(torch.zeros(10, 5))
    for r in range(2):
        st = s.step(st, data_from_numpy(DATA_NP, "cpu"), jaxrand.key(r))
    assert bool(torch.isfinite(s.consensus_params(st)).all())


@pytest.mark.parametrize("case", ["packed-false-ring", "packed-false-drop",
                                  "static-step", "tree-step"])
def test_faults_refused_as_the_reference_refuses(case):
    """What the reference refuses, the port refuses with its exception
    type and words: ``packed=false`` with faults (ValueError, from
    ``make_solver``), a faulted config on the static round (ValueError),
    and on the tree path of the schedule round (NotImplementedError, as
    the reference's ``step_schedule`` raises)."""
    from repro_torch.core import admm, schedule

    if case.startswith("packed-false"):
        gspec = "ring" if case.endswith("ring") else "drop:p=0.3,base=ring"
        graph, ex = build_graph(gspec, 10)
        with pytest.raises(ValueError, match="requires packed=true"):
            make_solver("ltadmm:packed=false,faults=faults:crash=0.01",
                        graph, ex, None, device="cpu")
        with pytest.raises(ValueError, match="requires packed=true"):
            jmake_solver("ltadmm:packed=false,faults=faults:crash=0.01",
                         JGRAPH, JEX, None)
        return
    topo = topology.Ring(10)
    s = make_solver("ltadmm:faults=faults:drop=0.1", topo, None,
                    vr.SagaTable(sample_grads=PROB.sample_grads, m=PROB.m),
                    device="cpu")
    if case == "static-step":
        st = admm.init(s.cfg, topo, s.exchange, torch.zeros(10, 5))
        with pytest.raises(ValueError, match="requires a TopologySchedule"):
            admm.step(s.cfg, topo, s.exchange, s.grad_est, st,
                      data_from_numpy(DATA_NP, "cpu"), jaxrand.key(0))
        return
    sched = schedule.static_schedule(topo)
    st = admm.init(s.cfg, sched, s.exchange, {"w": torch.zeros(10, 5)})
    with pytest.raises(NotImplementedError, match="packed schedule path"):
        admm.step(s.cfg, sched, s.exchange, s.grad_est, st,
                  data_from_numpy(DATA_NP, "cpu"), jaxrand.key(0))


def test_unported_graph_paths_raise(tmp_path):
    """Schedules are ported (item 9): ``build_graph`` gives one with the
    exchange over its union graph, on a mesh axis too (item 15); an axis
    without its mesh, or agents that do not split over the axis, raise."""
    graph, ex = build_graph("drop:p=0.2,base=complete", 10)
    assert isinstance(graph, TopologySchedule)
    assert ex.topo is graph.union and graph.period == 16
    with pytest.raises(ValueError, match="mesh"):
        topology.Exchange(topology.Ring(4), axis="data")
    with world("gloo", str(tmp_path / "store")):
        mesh = make_host_mesh()
        graph, ex = build_graph("drop:p=0.2,base=complete", 10, axis="data",
                                mesh=mesh)
        assert ex.topo is graph.union and ex.mesh is mesh
        assert (ex.axis, ex.world, ex.position, ex.rows) == (
            "data", 1, 0, range(10))
        with pytest.raises(ValueError, match="no 'agents'"):
            topology.Exchange(graph.union, axis="agents", mesh=mesh)
