"""The two LT-ADMM rows on schedules of ``benchmarks/BENCH_BASELINE.json``
(the reference's CI gate: q8 + SAGA on the paper problem, 600 rounds,
drop0.3 and churn0.2 over the complete graph) in the port, packed and
with ``packed=false`` (the tree schedule round on ``{"w": [A, 5]}``,
whose messages are the packed plane's):

* rounds_to_tol 20 at tol 1e-8, as the row and the live reference give;
* ``wire_bytes_per_round`` 118 / 126 exactly (Python ``round`` of the
  period-mean active degree times the 2 x 9-byte q8 payload);
* log10 ||grad F||² within 0.05 of the live reference's run at every
  sample >= 1e-12, as the ring row in ``test_torch_admm.py``.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks.common import make_problem  # noqa: E402
from benchmarks.common import run_solver as jrun_solver  # noqa: E402
from repro.core import solver as jsolver  # noqa: E402
from repro.core import vr as jvr  # noqa: E402
from repro_torch.bench import rounds_to_tol, run_solver  # noqa: E402
from repro_torch.core import schedule, solver, vr  # noqa: E402
from repro_torch.problems.logistic import LogisticProblem  # noqa: E402

JPROB, JDATA, _, _ = make_problem(seed=0)
PROB = LogisticProblem()
A, N = PROB.n_agents, PROB.n
BENCH = {"admm/drop0.3:complete/q8+saga": ("drop:p=0.3,base=complete", 118),
         "admm/churn0.2:complete/q8+saga": ("churn:p=0.2,base=complete",
                                            126)}


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's 600-round q8 + SAGA run on each BENCH schedule."""
    out = {}
    for name, (gspec, _) in BENCH.items():
        _, _, jg, jex = make_problem(seed=0, topology=gspec)
        js = jsolver.make_solver(
            "ltadmm:compressor=qbit:bits=8,impl=jnp", jg, jex,
            jvr.SagaTable(sample_grad=JPROB.sample_grad, m=JPROB.m))
        idx, g = jrun_solver(JPROB, JDATA, js, 600)
        out[name] = (np.asarray(idx), np.asarray(g))
    return out


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "tree"])
@pytest.mark.parametrize("name", sorted(BENCH))
def test_bench_schedule_row(name, packed, reference_runs):
    gspec, wire = BENCH[name]
    graph, ex = schedule.build_graph(gspec, A)
    if packed:
        est = vr.SagaTable(sample_grads=PROB.sample_grads, m=PROB.m)
        x0, params = None, {"x": np.zeros(N, np.float32)}
    else:
        est = vr.SagaTable(sample_grads=lambda p, b: {
            "w": PROB.sample_grads(p["w"], b)}, m=PROB.m)
        x0, params = {"w": torch.zeros((A, N))}, {"w": np.zeros(N,
                                                               np.float32)}
    ts = solver.make_solver(
        f"ltadmm:packed={str(packed).lower()},compressor=qbit:bits=8,"
        "impl=torch", graph, ex, est, device="cpu")
    tidx, tg, st = run_solver(PROB, {k: np.asarray(v) for k, v in
                                     JDATA.items()}, ts, 600,
                              return_state=True, x0=x0)
    assert isinstance(st.x, torch.Tensor) == packed
    idx, g = reference_runs[name]
    with open(os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                           "BENCH_BASELINE.json")) as f:
        row = {r["name"]: r for r in json.load(f)["results"]}[name]
    np.testing.assert_array_equal(tidx, idx)
    keep = g >= 1e-12
    assert keep.sum() >= 2
    assert np.max(np.abs(np.log10(tg[keep]) - np.log10(g[keep]))) < 0.05
    assert rounds_to_tol(tidx, tg, 1e-8) == row["rounds_to_tol"] == 20
    assert rounds_to_tol(idx, g, 1e-8) == 20
    assert ts.wire_bytes(params) == row["wire_bytes_per_round"] == wire
    assert np.isfinite(tg[-1]) and tg[-1] < 1e-14
