"""The gossip baselines, the cost model and the Fig.-2 runner in the port
against the reference.

* one iteration of each baseline (qbit8 messages; DSGD uncompressed) from
  the same state, carried across through a reference checkpoint with
  ``baseline_state_from_numpy``: rtol 1e-5 / atol 1e-6, since the random
  draws and payload bits are identical and only f32 sums are reassociated
  (the gossip product and the gradient's matmul);
* 20 iterations of each: log10 ||grad F||² within 1e-3 of the reference
  at every sample, the torch route against ``impl=jnp`` and the kernel
  route (K4/K5 plain versions on the CPU) against ``impl=pallas`` in
  interpret mode.  Identical draws keep the runs within ~1e-6; the
  tolerance leaves room for a rounding decision flipped by a reassociated
  sum;
* wire bytes, round costs, the cost model, the registry and the Fig.-2
  runner's methods equal to the reference's;
* the device rule, and ``faults=`` on a baseline spec.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks import paper_fig2 as jfig2  # noqa: E402
from benchmarks.common import make_problem  # noqa: E402
from benchmarks.common import run_solver as jrun_solver  # noqa: E402
from repro.checkpoint.store import save_checkpoint  # noqa: E402
from repro.core import costmodel as jcost  # noqa: E402
from repro.core import solver as jsolver  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.core import vr as jvr  # noqa: E402
from repro_torch import paper_fig2  # noqa: E402
from repro_torch.bench import run_solver  # noqa: E402
from repro_torch.checkpoint.reference import (  # noqa: E402
    baseline_state_from_numpy, data_from_numpy)
from repro_torch.core import costmodel, jaxrand, solver, topology  # noqa: E402
from repro_torch.core.baselines import ALL_BASELINES  # noqa: E402
from repro_torch.core.schedule import build_graph  # noqa: E402
from repro_torch.problems.logistic import LogisticProblem  # noqa: E402

JPROB, JDATA, JGRAPH, JEX = make_problem(seed=0)
DATA_NP = jax.tree.map(np.asarray, JDATA)
PROB = LogisticProblem()
ROUTES = [("jnp", "torch"), ("pallas", "kernel")]


def _specs(name, route):
    if name == "dsgd":  # uncompressed: one route
        return "dsgd:lr=0.1", "dsgd:lr=0.1"
    tail = "lr=0.1,compressor=qbit:bits=8,impl="
    return f"{name}:{tail}{route[0]}", f"{name}:{tail}{route[1]}"


def _ref_est(kind):
    if kind == "full":
        return jvr.FullGrad(full_grad=JPROB.full_grad)
    if kind == "saga":
        return jvr.SagaTable(sample_grad=JPROB.sample_grad, m=JPROB.m)
    return jvr.PlainSgd(batch_grad=JPROB.batch_grad)


def _pair(ref_spec, port_spec, kind="sgd", topo="ring"):
    jg, jex = (JGRAPH, JEX) if topo == "ring" else (
        jtopo.make_topology(topo, 10), None)
    graph, ex = build_graph(topo, PROB.n_agents)
    return (jsolver.make_solver(ref_spec, jg, jex, _ref_est(kind)),
            solver.make_solver(port_spec, graph, ex,
                               paper_fig2._estimator(kind, PROB),
                               device="cpu"))


@pytest.mark.parametrize("route", ROUTES, ids=["torch", "kernel"])
@pytest.mark.parametrize("name", list(ALL_BASELINES))
def test_one_iteration_matches_reference(name, route, tmp_path):
    js, ts = _pair(*_specs(name, route))
    step = jax.jit(lambda s, k: js.step(s, JDATA, k))
    st = js.init(jnp.zeros((PROB.n_agents, PROB.n)))
    for i in range(3):  # a state with nonzero duals and copies
        st = step(st, jax.random.fold_in(jax.random.key(1), i))
    want = jax.tree.map(np.asarray, step(st, jax.random.fold_in(
        jax.random.key(1), 3)))
    save_checkpoint(tmp_path / "ck", st, step=3)
    with np.load(tmp_path / "ck" / "arrays.npz") as z:
        arrays = dict(z)
    with open(tmp_path / "ck" / "manifest.json") as f:
        step_no = json.load(f)["step"]
    tst = baseline_state_from_numpy(arrays, ts, device="cpu", step=step_no)
    got = ts.step(tst, data_from_numpy(DATA_NP, "cpu"),
                  jaxrand.fold_in(jaxrand.key(1), 3))
    assert got["k"] == 4 == int(want["k"])
    assert sorted(got) == sorted(want)
    for f in ts.state_fields:
        np.testing.assert_allclose(got[f].numpy(), want[f], rtol=1e-5,
                                   atol=1e-6, err_msg=f)


TRAJECTORY_CASES = [(n, r, "sgd") for n in ALL_BASELINES for r in ROUTES] + [
    ("cold", ROUTES[1], "full"), ("dpdc", ROUTES[1], "full")]


@pytest.mark.parametrize("name,route,kind", TRAJECTORY_CASES,
                         ids=[f"{n}-{r[1]}-{k}"
                              for n, r, k in TRAJECTORY_CASES])
def test_trajectory_matches_reference(name, route, kind):
    js, ts = _pair(*_specs(name, route), kind=kind)
    idx, g = jrun_solver(JPROB, JDATA, js, 20, metric_every=5, seed=999)
    tidx, tg, tst = run_solver(PROB, DATA_NP, ts, 20, metric_every=5,
                               seed=999, return_state=True)
    np.testing.assert_array_equal(tidx, np.asarray(idx))
    np.testing.assert_allclose(np.log10(tg), np.log10(np.asarray(g)),
                               atol=1e-3)
    assert tst["k"] == 20


def test_state_from_numpy_takes_the_state_dict():
    js, ts = _pair(*_specs("cedas", ROUTES[0]))
    st = jax.tree.map(np.asarray, js.init(jnp.ones((PROB.n_agents, PROB.n))))
    tst = baseline_state_from_numpy(st, ts, device="cpu")
    assert tst["k"] == 0 and sorted(tst) == sorted(st)
    np.testing.assert_array_equal(tst["psi_prev"].numpy(), st["psi_prev"])
    with pytest.raises(KeyError, match="xhat"):
        baseline_state_from_numpy({"x": st["x"], "k": 0}, ts, device="cpu")


ACCOUNTING = [spec_kind for spec_kind in jfig2.METHODS.values()] + [
    ("dsgd", "sgd"), ("choco:compressor=topk:fraction=0.4", "sgd"),
    ("lead:compressor=randk:fraction=0.4", "sgd"),
    ("choco:compressor=qbit:bits=4", "sgd")]


@pytest.mark.parametrize("topo", ["ring", "erdos:p=0.4,seed=1"])
@pytest.mark.parametrize("spec,kind", ACCOUNTING)
def test_wire_bytes_and_round_cost_match(spec, kind, topo):
    js, ts = _pair(spec, spec, kind=kind, topo=topo)
    jg = jtopo.make_topology(topo, 10)
    tg = topology.make_topology(topo, 10)
    for params in ({"x": np.zeros(5, np.float32)},
                   {"w": np.zeros((3, 4), np.float32),
                    "b": np.zeros(7, np.float32)}):
        assert ts.wire_bytes(params) == js.wire_bytes(params)
        assert ts.wire_bytes(params, t=3) == js.wire_bytes(params, t=3)
    for tc, jc in ((costmodel.CostModel(), jcost.CostModel()),
                   (costmodel.CostModel.for_topology(tg, t_c=3.0),
                    jcost.CostModel.for_topology(jg, t_c=3.0))):
        assert ts.round_cost(tc, PROB.m) == js.round_cost(jc, JPROB.m)


@pytest.mark.parametrize("topo", ["ring", "star", "complete",
                                  "grid2d:rows=3", "smallworld:k=4,p=0.2"])
def test_cost_model_matches(topo):
    n = 9 if topo.startswith("grid2d") else 10
    tg, jg = topology.make_topology(topo, n), jtopo.make_topology(topo, n)
    pairs = [(costmodel.CostModel(), jcost.CostModel()),
             (costmodel.CostModel.for_topology(tg, t_g=2.0, t_c=7.0),
              jcost.CostModel.for_topology(jg, t_g=2.0, t_c=7.0)),
             (costmodel.CostModel.for_learned_graph(tg, 2),
              jcost.CostModel.for_learned_graph(jg, 2))]
    for t, j in pairs:
        assert (t.t_g, t.t_c, t.mean_degree, t.participation) == (
            j.t_g, j.t_c, j.mean_degree, j.participation)
        assert (t.t_comm, t.t_grad) == (j.t_comm, j.t_grad)
        assert t.lt_admm_cc(100, 5) == j.lt_admm_cc(100, 5)
        assert t.lead(5) == j.lead(5) and t.cedas(5) == j.cedas(5)
        assert t.cold_dpdc_sgd(5) == j.cold_dpdc_sgd(5)
        assert t.cold_dpdc_full(5, 100) == j.cold_dpdc_full(5, 100)
        assert t.dsgd(5) == j.dsgd(5)


@pytest.mark.parametrize("name", list(ALL_BASELINES))
def test_registry_matches_reference(name):
    t, j = solver.SOLVERS[name], jsolver.SOLVERS[name]
    assert (t.params, t.nested, t.estimator, t.doc) == (
        j.params, j.nested, j.estimator, j.doc)
    assert name not in solver.UNPORTED


def test_fig2_runner_matches_reference():
    assert paper_fig2.METHODS == jfig2.METHODS
    assert (paper_fig2.THRESHOLD, paper_fig2.TAU, paper_fig2.ADMM_ROUNDS,
            paper_fig2.BASELINE_ITERS) == (jfig2.THRESHOLD, jfig2.TAU,
                                           jfig2.ADMM_ROUNDS,
                                           jfig2.BASELINE_ITERS)
    times, gns = np.arange(6) * 11.0, [1.0, 1e-3, 1e-9, 1e-7, 1e-10, 1e-12]
    assert paper_fig2.time_to_threshold(times, gns) == \
        jfig2.time_to_threshold(times, gns) == 22.0
    assert paper_fig2.time_to_threshold(times, [1.0] * 6) == float("inf")
    rows = paper_fig2.run(print_rows=False, device="cpu", admm_rounds=110,
                          baseline_iters=100)
    assert [r[0] for r in rows] == [f"fig2/{m}" for m in jfig2.METHODS]
    assert all(np.isfinite(r[2]) for r in rows)
    # on the reference's data only LT-ADMM-CC reaches 1e-8 here, at round
    # 100 (t = 124 a round): the reference's own time, 12400
    assert rows[0][1] == 100 * 124.0
    assert all(r[1] == float("inf") for r in rows[1:])


def test_make_solver_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the rule on a machine without CUDA")
    graph, ex = build_graph("ring", 10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solver.make_solver("lead:compressor=qbit:bits=8", graph, ex, None)
    s = solver.make_solver("lead:compressor=qbit:bits=8", graph, ex, None,
                           device="cpu")
    assert s.device == torch.device("cpu")


@pytest.mark.parametrize("spec", ["choco:faults=faults:drop=0.1",
                                  "lead:compressor=qbit:bits=8,"
                                  "faults=faults:crash=0.2|seed=1"])
def test_baseline_specs_take_faults(spec):
    """``faults=`` nests in a baseline spec (``|`` for ``,``): the solver
    holds the reference's FaultPlane fields and its wire bytes stay the
    unfaulted ones (the dense gossip seals nothing)."""
    from repro.core import faults as jfaults

    graph, ex = build_graph("ring", 10)
    s = solver.make_solver(spec, graph, ex, None, device="cpu")
    js = jsolver.make_solver(spec, JGRAPH, JEX, None)
    assert all(getattr(s.faults, f) == getattr(js.faults, f)
               for f in jfaults.fault_entry("faults").params | {"name"})
    assert isinstance(js.faults, jfaults.FaultPlane)
    plain = solver.make_solver(spec.split("faults=")[0].rstrip(","), graph,
                               ex, None, device="cpu")
    x = {"x": np.zeros(5, np.float32)}
    assert s.wire_bytes(x) == plain.wire_bytes(x) == js.wire_bytes(x)
