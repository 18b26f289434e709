"""The paper's harnesses in the port against the reference.

* ``core/reference.py``: the port's LT-ADMM (Identity compressor,
  ``vr.FullGrad``, 5 rounds, x0 from ``normal(key(1))``) within 1e-5 of
  its dense oracle on the ring and on Star(4), as the reference's
  ``tests/test_admm.py:36`` / ``tests/test_topology.py:145`` hold the
  reference; the port's oracle within 1e-6 of the reference's;
* Table I equal, row for row;
* Fig. 1's four variants at 300 rounds sampled every 50: rounds_to_tol
  and wire bytes equal to the live reference's, log10 ||grad F||² within
  0.02 at every sample above the f32 floor (1e-13);
* one topology- and one schedule-sweep row (star at 100 rounds, churn0.2
  at 15, both above the floor there): wire bytes
  and t/round equal, log10 of the final ||grad F||² within 0.02 and the
  rate within 1 %;
* ``perf_smoke``'s JSON and row keys against the reference's BENCH
  schema (``benchmarks/BENCH_BASELINE.json``), at 20 rounds, and its
  trace read back through ``load_events`` / ``summarize``;
* ``kernels_bench``'s row names and ``derived`` strings.
"""
import ast
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from benchmarks import common as jcommon  # noqa: E402
from benchmarks import paper_fig1 as jfig1  # noqa: E402
from benchmarks import paper_table1 as jtable1  # noqa: E402
from repro.core import vr as jvr  # noqa: E402
from repro.core.reference import DenseLTADMM as JDense  # noqa: E402
from repro.core.solver import make_solver as jmake_solver  # noqa: E402
from repro.problems.logistic import LogisticProblem as JProblem  # noqa: E402
from repro_torch import (kernels_bench, paper_fig1, paper_table1,  # noqa: E402
                         perf_smoke, schedule_sweep, topology_sweep)
from repro_torch.bench import rounds_to_tol  # noqa: E402
from repro_torch.core import jaxrand, solver, topology, vr  # noqa: E402
from repro_torch.core.reference import DenseLTADMM, ring_edges  # noqa: E402
from repro_torch.obs import summary, trace  # noqa: E402
from repro_torch.problems.logistic import LogisticProblem  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(ROOT, "benchmarks", "BENCH_BASELINE.json")
FLOOR = 1e-13  # below it ||grad F||^2 is f32 noise in either package
LOG_TOL = 0.02


# ---- the dense oracle -------------------------------------------------------


def _oracle_grads(prob, data, i):
    return lambda x: prob.full_grad(
        x[None], {k: v[i:i + 1] for k, v in data.items()})[0]


@pytest.mark.parametrize("topo_name,n_agents", [("ring", 10), ("star", 4)])
def test_admm_matches_the_dense_oracle(topo_name, n_agents):
    prob = LogisticProblem(n_agents=n_agents)
    data = prob.make_data(0)
    topo = (topology.Ring(n_agents) if topo_name == "ring"
            else topology.Star(n_agents))
    s = solver.make_solver("ltadmm:compressor=identity", topo,
                           topology.Exchange(topo),
                           vr.FullGrad(full_grad=prob.full_grad),
                           device="cpu")
    x0 = jaxrand.normal(jaxrand.key(1), (n_agents, prob.n))
    st = s.init(x0)
    for i in range(5):
        st = s.step(st, data, jaxrand.key(i))
    edges = (ring_edges(n_agents) if topo_name == "ring"
             else sorted(topology.edge_set(topo)))
    oracle = DenseLTADMM([_oracle_grads(prob, data, i)
                          for i in range(n_agents)], edges)
    xo, zo = oracle.init(list(x0))
    for _ in range(5):
        xo, zo = oracle.step(xo, zo)
    assert float((st.x - torch.stack(xo)).abs().max()) < 1e-5

    # the port's oracle against the reference's, on the same inputs
    jprob = JProblem(n_agents=n_agents)
    jdata = jprob.make_data(jax.random.key(0))
    jgrads = [(lambda i: (lambda x: jprob.full_grad(
        x, jax.tree.map(lambda t: t[i], jdata))))(i)
        for i in range(n_agents)]
    jx0 = jax.random.normal(jax.random.key(1), (n_agents, prob.n))
    np.testing.assert_allclose(x0.numpy(), np.asarray(jx0), rtol=0,
                               atol=1e-6)
    _, _, hist = oracle.run(list(x0), 5)
    _, _, jhist = JDense(jgrads, edges).run(list(jx0), 5)
    for a, b in zip(hist, jhist):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)


# ---- Table I ----------------------------------------------------------------


def test_table1_equals_the_reference():
    assert paper_table1.run(print_rows=False) == \
        jtable1.run(print_rows=False)


# ---- Fig. 1 -----------------------------------------------------------------


def _close_logs(got, want, label):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    keep = (got > FLOOR) & (want > FLOOR)
    d = np.abs(np.log10(got[keep]) - np.log10(want[keep]))
    assert d.size and d.max() < LOG_TOL, (label, d.max() if d.size else None)


@pytest.mark.parametrize("name", sorted(paper_fig1.SPECS))
def test_fig1_variant_follows_the_reference(name):
    assert paper_fig1.SPECS == jfig1.SPECS
    idx, gns, wire = paper_fig1.variant(name, rounds=300, every=50,
                                        device="cpu")
    prob, data, topo, ex = jcommon.make_problem()
    jsaga = jvr.SagaTable(sample_grad=prob.sample_grad, m=prob.m)
    js = jmake_solver(jfig1.SPECS[name], topo, ex, jsaga)
    jidx, jgns = jcommon.run_solver(prob, data, js, 300, metric_every=50)
    np.testing.assert_array_equal(idx, np.asarray(jidx))
    assert rounds_to_tol(idx, gns, paper_fig1.TOL) == rounds_to_tol(
        np.asarray(jidx), np.asarray(jgns), paper_fig1.TOL)
    assert wire == js.wire_bytes(np.zeros((prob.n,), np.float32))
    _close_logs(gns, jgns, name)


# ---- the sweeps ---------------------------------------------------------------


@pytest.mark.parametrize("module,jname,spec,rounds", [
    (topology_sweep, "topology", "star", 100),
    # churn over the complete graph reaches the floor within ~30 rounds
    (schedule_sweep, "schedule", "churn:p=0.2,base=complete,seed=0", 15),
])
def test_sweep_row_follows_the_reference(module, jname, spec, rounds):
    (name, final, rate, wire, t_round), = module.run(
        (spec,), rounds=rounds, print_rows=False, device="cpu")
    (jn, jfinal, jrate, jwire, jt), = jcommon.convergence_sweep(
        (spec,), rounds, jname, print_rows=False)
    assert (name, wire, t_round) == (jn, jwire, jt)
    assert final > FLOOR and jfinal > FLOOR
    assert abs(np.log10(final) - np.log10(jfinal)) < LOG_TOL
    assert rate == pytest.approx(jrate, rel=1e-2)


def test_participation_sweep_row_follows_the_reference():
    from benchmarks.schedule_sweep import participation_sweep

    (spec, part, rtt, t_round, wire, final), = \
        schedule_sweep.participation_sweep((0.5,), rounds=30, tol=1e-3,
                                           print_rows=False, device="cpu")
    (jspec, jpart, jrtt, jt, jwire, jfinal), = participation_sweep(
        (0.5,), rounds=30, tol=1e-3, print_rows=False)
    assert (spec, part, rtt, t_round, wire) == (jspec, jpart, jrtt, jt, jwire)
    assert abs(np.log10(final) - np.log10(jfinal)) < LOG_TOL


# ---- perf-smoke and kernels_bench --------------------------------------------


def test_perf_smoke_writes_the_reference_schema(tmp_path):
    with open(BASELINE) as f:
        ref = json.load(f)
    out = tmp_path / "bench.json"
    payload = perf_smoke.perf_smoke(str(out), device="cpu", rounds=20,
                                    kernel_iters=1)
    with open(out) as f:
        assert json.load(f) == payload
    assert set(payload) == set(ref) - {"jax"} | {"torch", "power_limit"}
    assert payload["backend"] == "cpu" and payload["device"] == "cpu"
    ref_rows = {r["name"]: r for r in ref["results"]}
    names = [r["name"] for r in payload["results"]]
    # every reference row but the learned graph's (dada, item 13)
    assert names == [n for n in ref_rows if not n.startswith("dada/")]
    for row in payload["results"]:
        assert sorted(row) == sorted(ref_rows[row["name"]]), row["name"]
        if "telemetry" in row:
            assert sorted(row["telemetry"]) == sorted(
                ref_rows[row["name"]]["telemetry"])
            assert row["telemetry"]["rounds"] == 20
        assert row["wire_bytes_per_round"] == \
            ref_rows[row["name"]]["wire_bytes_per_round"]
    assert [k["name"] for k in payload["kernels"]] == \
        [k["name"] for k in ref["kernels"]]
    assert all(sorted(k) == sorted(ref["kernels"][0])
               for k in payload["kernels"])
    events = trace.load_events(str(tmp_path / "bench.trace.jsonl"))
    assert [e["name"] for e in events] == ["cold", "warm"] * 3 + [
        "faults", "kernels"]
    report = summary.summarize(events)
    assert "warm" in report and "kernels" in report


def _reference_kernel_rows():
    """The "kernel/..." row names and derived-string literals of the
    reference's ``benchmarks/kernels_bench.py``."""
    with open(os.path.join(ROOT, "benchmarks", "kernels_bench.py")) as f:
        tree = ast.parse(f.read())
    return sorted(n.value for n in ast.walk(tree)
                  if isinstance(n, ast.Constant) and isinstance(n.value, str)
                  and n.value.startswith("kernel/"))


def test_kernels_bench_row_names_and_derived():
    rows = kernels_bench.cases(torch.device("cpu"), fast=False)
    assert sorted(r[0] for r in rows) == _reference_kernel_rows()
    derived = {r[0]: r[2] for r in rows}
    assert derived["kernel/quantize8_64k"] == "wire_ratio=4.00"
    assert derived["kernel/quantize4_64k"] == "wire_ratio=8.00"
    assert derived["kernel/fused_quant8_plane_8x16k"] == \
        "wire_ratio=4.00 launches=1"
    assert derived["kernel/flash_512"] == "causal_flops=1.34e+08"
    fast = [r[0] for r in kernels_bench.cases(torch.device("cpu"), True)]
    with open(BASELINE) as f:
        assert fast == [k["name"] for k in json.load(f)["kernels"]]
