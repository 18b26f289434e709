"""Learned collaboration graphs in the port against the reference
(``repro.core.graphlearn``, ``repro.problems.clusters``,
``benchmarks/personalization_sweep.py``).

* the planted-cluster data of seeds 0-2: labels bit-equal, features and
  separators within 1e-6;
* ``row_simplex_weights`` on the reference's closed-form case, seeded
  random rows, the all-zero row at S = 15 (round 0: ties, where
  ``jax.lax.top_k`` keeps slots 0, 1, 2), rows with fewer candidates than
  the cap and empty rows: ``keep`` bit-equal, ``w`` within 1e-6;
* dada trajectories round by round: the support of ``w`` and ``c`` equal
  every round and ``x``, ``xhat``, ``w``, ``c`` within atol 1e-5 (the
  reference's draws, float32 sums reassociated), on complete16, drop0.3,
  churn0.4 (the frozen rows bit-equal), ``packed=false``, the ring with
  qbit8 and the ring under faults;
* lockstep: the reference's state at round 100 carried in, then one
  graph round and one model round, each within the same tolerance;
* a dada checkpoint crosses both ways;
* the accounting (``wire_bytes`` by round, ``live_wire_bytes``,
  ``live_degrees``, ``round_cost``, ``CostModel.for_learned_graph``) equal
  to the reference's; the perf row (rounds_to_tol 190, 62 B; the metric
  within 1e-3 relative at every sample) and ``compare_at(3.0)`` (losses
  within 2e-3, P = R = 1.00) against the live reference.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks import personalization_sweep as jsweep  # noqa: E402
from repro.checkpoint import store as jstore  # noqa: E402
from repro.core import graphlearn as jgl  # noqa: E402
from repro.core import vr as jvr  # noqa: E402
from repro.core.costmodel import CostModel as JCostModel  # noqa: E402
from repro.core.schedule import build_graph as jbuild_graph  # noqa: E402
from repro.core.solver import make_solver as jmake_solver  # noqa: E402
from repro.problems.clusters import \
    ClusteredLogisticProblem as JClusters  # noqa: E402
from repro.problems.logistic import LogisticProblem as JLogistic  # noqa: E402
from repro_torch import personalization_sweep as sweep  # noqa: E402
from repro_torch.checkpoint import (load_checkpoint,  # noqa: E402
                                    save_checkpoint)
from repro_torch.checkpoint.reference import (  # noqa: E402
    baseline_state_from_numpy, data_from_numpy)
from repro_torch.common.trees import tree_flatten  # noqa: E402
from repro_torch.core import graphlearn, jaxrand, vr  # noqa: E402
from repro_torch.core.costmodel import CostModel  # noqa: E402
from repro_torch.core.schedule import build_graph  # noqa: E402
from repro_torch.core.solver import make_solver  # noqa: E402
from repro_torch.problems.clusters import \
    ClusteredLogisticProblem  # noqa: E402
from repro_torch.problems.logistic import LogisticProblem  # noqa: E402

DADA_SPEC = sweep.DADA_SPEC
# tests/test_solver.py's round-trip spec (the obs and faults tests' dada)
RING_SPEC = ("dada:lr=0.1,mu=0.5,lambda_g=0.1,graph_every=2,degree_cap=2,"
             "compressor=qbit:bits=8")
FAULTS = "faults=faults:drop=0.15|stale=0.05|crash=0.1|seed=3"
ATOL = 1e-5  # one state field after a round, either package

JCL, CL = JClusters(), ClusteredLogisticProblem()
JTRAIN, JTEST = JCL.make_split(jax.random.key(0))
TRAIN = data_from_numpy(jax.tree.map(np.asarray, JTRAIN), "cpu")
JLOG, LOG = JLogistic(), LogisticProblem()
JDATA = JLOG.make_data(jax.random.key(0))
DATA = data_from_numpy(jax.tree.map(np.asarray, JDATA), "cpu")


def test_reference_agrees_with_the_live_draws():
    assert (sweep.DADA_SPEC, sweep.LTADMM_SPEC, sweep.SEPARATIONS,
            sweep.ROUNDS) == (jsweep.DADA_SPEC, jsweep.LTADMM_SPEC,
                              jsweep.SEPARATIONS, jsweep.ROUNDS)
    assert graphlearn.DADA_PARAMS == jgl.DADA_PARAMS
    assert CL.intra_cluster_edges() == JCL.intra_cluster_edges()
    np.testing.assert_array_equal(CL.cluster_of(), JCL.cluster_of())


# ---- data --------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_make_split_draws_the_reference_data(seed):
    jp, p = JClusters(separation=3.0), ClusteredLogisticProblem(
        separation=3.0)
    for want, got in zip(jp.make_split(jax.random.key(seed)),
                         p.make_split(seed)):
        np.testing.assert_array_equal(got["b"].numpy(), np.asarray(want["b"]))
        np.testing.assert_allclose(got["a"].numpy(), np.asarray(want["a"]),
                                   rtol=0, atol=1e-6)
    kw = jax.random.fold_in(jax.random.key(seed), 7)
    np.testing.assert_allclose(
        p.separators(jaxrand.fold_in(jaxrand.key(seed), 7)).numpy(),
        np.asarray(jp.separators(kw)), rtol=0, atol=1e-6)
    x = np.random.default_rng(seed).normal(size=(16, 5)).astype(np.float32)
    test_j, test_p = jp.make_split(jax.random.key(seed))[1], \
        p.make_split(seed)[1]
    np.testing.assert_allclose(
        p.per_agent_test_loss(torch.from_numpy(x), test_p).numpy(),
        np.asarray(jp.per_agent_test_loss(jnp.asarray(x), test_j)),
        rtol=1e-6, atol=1e-6)
    assert p.mean_test_loss(torch.from_numpy(x[0]), test_p) == \
        pytest.approx(jp.mean_test_loss(jnp.asarray(x[0]), test_j),
                      rel=1e-6)


# ---- the closed-form row update ------------------------------------------------


def _rows(case):
    rng = np.random.default_rng(3)
    if case == "closed-form":  # tests/test_graphlearn.py:114
        dist = [[1.0, 2.0, 3.0, 0.5], [5.0, 5.0, 5.0, 5.0],
                [1.0, 1.0, 1.0, 1.0]]
        cand = [[True] * 4, [True, False, True, False], [False] * 4]
        return np.float32(dist), np.array(cand), 1.0, 0.5, 2
    if case == "random":
        return (rng.exponential(size=(16, 15)).astype(np.float32),
                rng.random((16, 15)) < 0.7, 0.5, 0.05, 3)
    if case == "all-zero":  # round 0 at S = 15: ties alone
        return np.zeros((16, 15), np.float32), np.ones((16, 15), bool), \
            0.5, 0.05, 3
    if case == "ties":
        return (rng.integers(0, 3, size=(12, 15)).astype(np.float32),
                rng.random((12, 15)) < 0.8, 0.5, 0.1, 4)
    if case == "few-candidates":  # fewer candidates than the cap
        cand = np.zeros((8, 15), bool)
        for i in range(8):
            cand[i, rng.choice(15, size=i % 3, replace=False)] = True
        return rng.exponential(size=(8, 15)).astype(np.float32), cand, \
            0.5, 0.05, 3
    return rng.exponential(size=(4, 6)).astype(np.float32), \
        np.zeros((4, 6), bool), 0.5, 0.1, 2  # empty rows


@pytest.mark.parametrize("case", ["closed-form", "random", "all-zero", "ties",
                                  "few-candidates", "empty"])
def test_row_simplex_weights_matches_reference(case):
    dist, cand, mu, lam, cap = _rows(case)
    jw, jkeep = jgl.row_simplex_weights(jnp.asarray(dist), jnp.asarray(cand),
                                        mu, lam, cap)
    w, keep = graphlearn.row_simplex_weights(
        torch.from_numpy(dist), torch.from_numpy(cand), mu, lam, cap)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    assert bool(torch.isfinite(w).all())
    if case == "all-zero":
        assert (torch.nonzero(keep[0]).flatten().tolist() == [0, 1, 2])


def test_pairwise_dist_sq_difference_form():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(6, 7)).astype(np.float32)
    nbr = rng.normal(size=(6, 3, 7)).astype(np.float32)
    got = graphlearn.pairwise_dist_sq(torch.from_numpy(a),
                                      torch.from_numpy(nbr))
    want = jgl.pairwise_dist_sq(jnp.asarray(a), jnp.asarray(nbr))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# ---- trajectories ----------------------------------------------------------------


def _split(f, cat):
    def g(p, b):
        full = f(cat([p["w1"], p["w2"]], -1), b)
        return {"w1": full[..., :3], "w2": full[..., 3:]}
    return g


def _pair(spec, gspec, paper=False, tree=False):
    """(reference solver, port solver, reference data, port data, x0s)."""
    jp, p = (JLOG, LOG) if paper else (JCL, CL)
    jdata, data = (JDATA, DATA) if paper else (JTRAIN, TRAIN)
    if tree:
        jest = jvr.PlainSgd(batch_grad=_split(jp.batch_grad, jnp.concatenate))
        est = vr.PlainSgd(batch_grad=_split(p.batch_grad, torch.cat))
        jx0 = {"w1": jnp.zeros((p.n_agents, 3)),
               "w2": jnp.zeros((p.n_agents, 2))}
        x0 = {"w1": torch.zeros(p.n_agents, 3),
              "w2": torch.zeros(p.n_agents, 2)}
    else:
        jest = jvr.PlainSgd(batch_grad=jp.batch_grad)
        est = vr.PlainSgd(batch_grad=p.batch_grad)
        jx0, x0 = jnp.zeros((p.n_agents, p.n)), torch.zeros(p.n_agents, p.n)
    jg, jex = jbuild_graph(gspec, p.n_agents)
    g, ex = build_graph(gspec, p.n_agents)
    js = jmake_solver(spec, jg, jex, jest)
    s = make_solver(spec, g, ex, est, device="cpu")
    return js, s, jdata, data, jx0, x0


def _close(st, jst, label):
    for f in ("x", "xhat", "w", "c"):
        got = tree_flatten(st[f])[0]
        want = jax.tree.leaves(jst[f])
        for g, w in zip(got, want):
            w = np.asarray(w)
            if f in ("w", "c"):
                np.testing.assert_array_equal(g.numpy() > 0, w > 0,
                                              err_msg=f"{label} {f} support")
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL,
                                       err_msg=f"{label} {f}")
    assert st["k"] == int(jst["k"])


TRAJECTORIES = {
    # name -> (spec, graph, rounds, paper problem, tree x0, key stream)
    "complete16": (DADA_SPEC, "complete", 30, False, False, 1),
    "drop0.3": (DADA_SPEC, "drop:p=0.3,base=complete,seed=0", 20, False,
                False, 1),
    "churn0.4": (DADA_SPEC, "churn:p=0.4,base=complete,seed=1,period=8", 4,
                 False, False, 1),
    "packed-false": (DADA_SPEC + ",packed=false", "complete", 12, False,
                     True, 1),
    "ring-qbit8": (RING_SPEC, "ring", 12, True, False, 0),
    "ring-faults": (RING_SPEC + "," + FAULTS, "ring", 8, True, False, 1000),
}


@pytest.mark.parametrize("name", list(TRAJECTORIES))
def test_dada_trajectory_matches_reference(name):
    spec, gspec, rounds, paper, tree, stream = TRAJECTORIES[name]
    js, s, jdata, data, jx0, x0 = _pair(spec, gspec, paper, tree)
    jstep = jax.jit(lambda st, k: js.step(st, jdata, k))
    jst, st = js.init(jx0), s.init(x0)
    frozen = 0
    for i in range(rounds):
        if stream == 1000:  # tests/test_faults.py's key stream
            jkey, key = jax.random.key(1000 + i), jaxrand.key(1000 + i)
        else:
            jkey = jax.random.fold_in(jax.random.key(stream), i)
            key = jaxrand.fold_in(jaxrand.key(stream), i)
        prev = st
        jst, st = jstep(jst, jkey), s.step(st, data, key)
        _close(st, jst, f"{name} round {i}")
        if name == "churn0.4":  # an inactive node holds all its state
            nm = s.graph.round_node_mask_host(i)
            frozen += int((~nm).sum())
            for f in ("x", "xhat", "w", "c"):
                assert torch.equal(st[f][~nm], prev[f][~nm]), (i, f)
        for leaf in tree_flatten(s.consensus_params(st))[0]:
            assert bool(torch.isfinite(leaf).all())
    assert name != "churn0.4" or frozen > 0
    if name == "ring-faults":
        assert s.faults is not None and s.faults.crash == 0.1


def test_lockstep_from_the_reference_state_at_round_100():
    """The reference's state after 100 rounds carried in; then a graph
    round (k = 100) and a model round (k = 101) from the same state."""
    js, s, jdata, data, jx0, _ = _pair(DADA_SPEC, "complete")
    base = jax.random.key(1)

    def body(st, i):
        return js.step(st, jdata, jax.random.fold_in(base, i)), None

    jst, _ = jax.jit(lambda st: jax.lax.scan(body, st, jnp.arange(100)))(
        js.init(jx0))
    jstep = jax.jit(lambda st, k: js.step(st, jdata, k))
    for k in (100, 101):
        st = baseline_state_from_numpy(jax.tree.map(np.asarray, jst), s,
                                       "cpu")
        assert st["k"] == k
        jst = jstep(jst, jax.random.fold_in(base, k))
        _close(s.step(st, data, jaxrand.fold_in(jaxrand.key(1), k)), jst,
               f"lockstep round {k}")


def test_dada_checkpoint_crosses_both_ways(tmp_path):
    js, s, jdata, data, jx0, x0 = _pair(DADA_SPEC, "complete")
    jstep = jax.jit(lambda st, k: js.step(st, jdata, k))
    keys = [(jax.random.fold_in(jax.random.key(1), i),
             jaxrand.fold_in(jaxrand.key(1), i)) for i in range(6)]
    jst = js.init(jx0)
    for i in range(5):
        jst = jstep(jst, keys[i][0])
    jstore.save_checkpoint(tmp_path / "ref", jst, step=5)
    st, manifest = load_checkpoint(tmp_path / "ref", like_tree=s.init(x0))
    assert manifest["step"] == 5 == st["k"]
    _close(s.step(st, data, keys[5][1]), jstep(jst, keys[5][0]),
           "reference -> port")

    st = s.init(x0)
    for i in range(5):
        st = s.step(st, data, keys[i][1])
    save_checkpoint(tmp_path / "port", st, step=5)
    restored, manifest = jstore.load_checkpoint(
        tmp_path / "port", like_tree=jax.eval_shape(js.init, jx0))
    assert manifest["step"] == 5
    _close(s.step(st, data, keys[5][1]),
           jstep(jax.tree.map(jnp.asarray, restored), keys[5][0]),
           "port -> reference")


# ---- accounting and the paper's numbers ------------------------------------------


@pytest.mark.parametrize("gspec", ["complete", "ring",
                                   "drop:p=0.3,base=complete,seed=0",
                                   "churn:p=0.4,base=complete,seed=1"])
def test_accounting_matches_reference(gspec):
    js, s, jdata, data, jx0, x0 = _pair(DADA_SPEC, gspec)
    params = np.zeros((CL.n,), np.float32)
    assert [s.wire_bytes(params, t=t) for t in range(10)] == \
        [js.wire_bytes(params, t=t) for t in range(10)]
    assert s.wire_bytes(params) == js.wire_bytes(params)
    jstep = jax.jit(lambda st, k: js.step(st, jdata, k))
    jst, st = js.init(jx0), s.init(x0)
    for i in range(7):
        jst = jstep(jst, jax.random.fold_in(jax.random.key(1), i))
        st = s.step(st, data, jaxrand.fold_in(jaxrand.key(1), i))
    np.testing.assert_array_equal(s.live_degrees(st), js.live_degrees(jst))
    # an agent out of round 0 (churn) keeps the initial, uncapped coupling
    assert gspec.startswith("churn") or (
        s.live_degrees(st) <= s.degree_cap).all()
    assert s.live_wire_bytes(st, params) == js.live_wire_bytes(jst, params)
    np.testing.assert_allclose(s.learned_weights(st),
                               js.learned_weights(jst), rtol=0, atol=ATOL)
    graph, _ = build_graph(gspec, CL.n_agents)
    jgraph, _ = jbuild_graph(gspec, CL.n_agents)
    cm = CostModel.for_learned_graph(graph, degree_cap=3)
    jcm = JCostModel.for_learned_graph(jgraph, degree_cap=3)
    assert (cm.mean_degree, cm.participation) == (jcm.mean_degree,
                                                  jcm.participation)
    assert s.round_cost(cm, CL.m) == js.round_cost(jcm, CL.m)
    if gspec == "complete":
        assert cm.mean_degree == 3.0 and s.wire_bytes(params) == 62


def _reference_perf_trajectory(rounds=400, every=10):
    """The reference's ``perf_row`` run (its scan of chunks), once."""
    graph, ex = jbuild_graph("complete", JCL.n_agents)
    js = jmake_solver(DADA_SPEC, graph, ex,
                      jvr.PlainSgd(batch_grad=JCL.batch_grad))
    base = jax.random.key(1)

    def body(st, i):
        return js.step(st, JTRAIN, jax.random.fold_in(base, i)), None

    def chunk(st, c):
        st, _ = jax.lax.scan(body, st, c * every + jnp.arange(every))
        return st, jgl.personalized_grad_norm_sq(js, st, JCL.full_grad,
                                                 JTRAIN)

    _, g = jax.jit(lambda st: jax.lax.scan(
        chunk, st, jnp.arange(rounds // every)))(
        js.init(jnp.zeros((JCL.n_agents, JCL.n))))
    return np.asarray(g)


def test_perf_row_matches_the_live_reference():
    """rounds_to_tol 190 (the live reference's; the BENCH file's 200 is
    jax's older Threefry mode) at 62 B, the metric within 1e-3 relative
    at every sample."""
    want = _reference_perf_trajectory()
    _, idx, got, _ = sweep.perf_trajectory(device="cpu")
    np.testing.assert_array_equal(idx, np.arange(10, 401, 10))
    np.testing.assert_allclose(got, want, rtol=1e-3)
    row = sweep.perf_row(device="cpu")
    assert (row["rounds_to_tol"], row["wire_bytes_per_round"]) == (190, 62)
    assert idx[np.nonzero(want <= 2e-3)[0][0]] == 190
    assert row["final_gradnorm_sq"] == pytest.approx(float(want[-1]),
                                                     rel=1e-3)
    assert sorted(row) == sorted(["name", "spec", "rounds", "cold_wall_s",
                                  "warm_wall_s", "rounds_to_tol", "tol",
                                  "final_gradnorm_sq",
                                  "wire_bytes_per_round"])


def test_compare_at_matches_the_live_reference():
    want = jsweep.compare_at(3.0)
    got = sweep.compare_at(3.0, device="cpu")
    assert got["separation"] == want["separation"] == 3.0
    for k in ("consensus_test_loss", "dada_test_loss"):
        assert abs(got[k] - want[k]) < 2e-3, k
    assert got["edge_precision"] == got["edge_recall"] == 1.0
    assert (want["edge_precision"], want["edge_recall"]) == (1.0, 1.0)
    assert got["dada_test_loss"] < got["consensus_test_loss"]


def test_entry_points_print_the_tables(monkeypatch, capsys):
    """``python -m repro_torch.personalization_sweep`` and ``python -m
    repro_torch.compare_baselines`` on the CPU, at a few rounds (the
    Fig. 2 budget cut to 20 / 20)."""
    import functools

    from repro_torch import compare_baselines, paper_fig2

    monkeypatch.setattr(sweep, "run", functools.partial(sweep.run, rounds=20))
    monkeypatch.setattr(sweep, "compare_at",
                        functools.partial(sweep.compare_at, rounds=20))
    sweep.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].split() == ["sweep", "point", "consensus", "dada",
                              "edge", "P", "edge", "R"]
    assert [line.split()[0] for line in out[1:]] == [
        "personalization/sep=0", "personalization/sep=1",
        "personalization/sep=3"]
    monkeypatch.setattr(paper_fig2, "run", functools.partial(
        paper_fig2.run, admm_rounds=20, baseline_iters=20))
    compare_baselines.main(["--device", "cpu"])
    out = capsys.readouterr().out
    for name in list(paper_fig2.METHODS) + ["dada"]:
        assert f"  {name:12s} make_solver(" in out
    assert "lt-admm-cc" in out and "edge P/R" in out
    rows = [line.split() for line in out.splitlines()
            if line[:1] in ("0", "3")]
    assert [r[0] for r in rows] == ["0", "3"]
