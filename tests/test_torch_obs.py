"""Observability in the port against the reference (``repro.obs``).

* every counter field of a ``with_telemetry`` run equals the reference's,
  round by round, as uint32: the 8 solvers on the ring, drop0.3
  and churn0.2, and with every fault kind nested on drop0.3 (4 rounds);
  the busiest agent's per-round tx bytes equal ``wire_bytes(params, t)``
  bit for bit (the reference's ``tests/test_obs.py:85`` / ``:96``);
* ``packed=false`` (a two-leaf tree, one message per leaf) on the ring
  for LT-ADMM and LEAD, against the reference's tree round;
* the fault-kind partition, stale-only and corrupt-only runs,
  participation and grad-eval recipes (the reference's ``:108-:155``);
* the wrapped trajectory is bit-identical to the unwrapped one; counters
  wrap mod 2^32 from a preloaded 2^32 - 5;
* ``message_nbytes`` against the compressors' wire contracts and the
  reference's measurement; sealed payloads measure ``SEAL_BYTES`` more;
* the Tracer's JSONL read by the reference's ``load_events``, and
  ``summarize`` giving the reference's text; the torn tail, ``NULL``;
* the three perf-smoke rows' BENCH ``telemetry`` dicts over 600 wrapped
  rounds (``benchmarks/BENCH_BASELINE.json``).

The reference runs eagerly (no jit) except the unfaulted LT-ADMM steps:
that is the cheaper of the two on the CPU for these few rounds.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import compression as jcomp  # noqa: E402
from repro.core import solver as jsolver  # noqa: E402
from repro.core import vr as jvr  # noqa: E402
from repro.core.schedule import build_graph as jbuild_graph  # noqa: E402
from repro.obs import summary as jsummary  # noqa: E402
from repro.obs import telemetry as jtel  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro.problems.logistic import LogisticProblem as JProblem  # noqa: E402
from repro_torch import perf_smoke  # noqa: E402
from repro_torch.bench import run_solver  # noqa: E402
from repro_torch.core import compression, jaxrand, solver, vr  # noqa: E402
from repro_torch.core.schedule import build_graph  # noqa: E402
from repro_torch.obs import summary, telemetry, trace  # noqa: E402
from repro_torch.obs.telemetry import counters, with_telemetry  # noqa: E402
from repro_torch.problems.logistic import LogisticProblem  # noqa: E402

JPROB = JProblem()
JDATA = JPROB.make_data(jax.random.key(0))
PROB = LogisticProblem()
DATA = PROB.make_data(0)
A, N = PROB.n_agents, PROB.n
PARAMS = {"w": np.zeros((N,), np.float32)}

# every solver (the reference's SOLVER_SPECS, tests/test_obs.py:40)
SOLVER_SPECS = {
    "ltadmm": "ltadmm:tau=3,compressor=qbit:bits=8",
    "dsgd": "dsgd:lr=0.1",
    "choco": "choco:lr=0.1,compressor=qbit:bits=8",
    "lead": "lead:lr=0.1,compressor=qbit:bits=8",
    "cold": "cold:lr=0.1,compressor=randk:fraction=0.5,sampler=block",
    "cedas": "cedas:lr=0.1,compressor=qbit:bits=4",
    "dpdc": "dpdc:lr=0.1,compressor=qbit:bits=8",
    "dada": "dada:lr=0.1,mu=0.5,lambda_g=0.1,graph_every=2,degree_cap=2,"
            "compressor=qbit:bits=8",
}
GRAPH_SPECS = {
    "static": "ring",
    "drop": "drop:p=0.3,base=complete,seed=0",
    "churn": "churn:p=0.2,base=complete,seed=0",
}
FAULTS = "faults:drop=0.1|corrupt=5e-3|stale=0.05|crash=0.02|seed=0"


def _is_vr(spec):
    return solver.solver_entry(spec).estimator == "vr"


def _ref_run(spec, gspec, rounds=4, x0=None, est=None):
    graph, ex = jbuild_graph(gspec, A)
    if est is None:
        est = (jvr.SagaTable(sample_grad=JPROB.sample_grad, m=JPROB.m)
               if _is_vr(spec) else jvr.PlainSgd(batch_grad=JPROB.batch_grad))
    s = jtel.with_telemetry(jsolver.make_solver(spec, graph, ex, est))
    st = s.init(jnp.zeros((A, N)) if x0 is None else x0)
    step = (jax.jit(s.step) if _is_vr(spec) and "faults=" not in spec
            else s.step)
    snaps = [jtel.counters(st)]
    for t in range(rounds):
        st = step(st, JDATA, jax.random.key(t))
        snaps.append(jtel.counters(st))
    return s, snaps


def _port_est(spec):
    if _is_vr(spec):
        return vr.SagaTable(sample_grads=PROB.sample_grads, m=PROB.m)
    return vr.PlainSgd(batch_grad=PROB.batch_grad)


def _port_run(spec, gspec, rounds=4, x0=None, est=None):
    """-> (wrapped solver, graph, per-round host counter snapshots)."""
    graph, ex = build_graph(gspec, A)
    s = with_telemetry(solver.make_solver(
        spec, graph, ex, _port_est(spec) if est is None else est,
        device="cpu"))
    st = s.init(torch.zeros((A, N)) if x0 is None else x0)
    snaps = [counters(st)]
    for t in range(rounds):
        st = s.step(st, DATA, jaxrand.key(t))
        snaps.append(counters(st))
    return s, graph, snaps


def _round_delta(snaps, t, field):
    return snaps[t + 1][field] - snaps[t][field]  # uint32, wraps exactly


def _assert_same_counters(got, want, label):
    assert len(got) == len(want)
    for t, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w)
        for f in w:
            wf = np.asarray(w[f])
            assert g[f].dtype == wf.dtype == np.uint32, (label, t, f)
            np.testing.assert_array_equal(g[f], wf, err_msg=f"{label} {t} {f}")


CASES = ([(s, g) for s in SOLVER_SPECS for g in GRAPH_SPECS]
         + [(s, "drop+faults") for s in SOLVER_SPECS])


@pytest.mark.parametrize("sname,gname", CASES)
def test_counters_match_reference_round_by_round(sname, gname):
    """Every counter field equal to the reference's ``with_telemetry``
    run after every round, and the busiest agent's measured tx bytes a
    round equal to ``wire_bytes(params, t)``, bit for bit."""
    spec = SOLVER_SPECS[sname]
    if gname.endswith("+faults"):
        spec += f",faults={FAULTS}"
    gspec = GRAPH_SPECS[gname.split("+")[0]]
    js, want = _ref_run(spec, gspec)
    s, _, got = _port_run(spec, gspec)
    _assert_same_counters(got, want, f"{sname}/{gname}")
    for t in range(len(got) - 1):
        measured = int(_round_delta(got, t, "tx_bytes").max())
        assert measured == s.wire_bytes(PARAMS, t=t) \
            == js.wire_bytes(PARAMS, t=t), (sname, gname, t)
    if gname.endswith("+faults") and sname == "ltadmm":
        assert int(got[-1]["rx_dropped"].sum()) > 0


def test_specs_cover_every_ported_solver():
    assert set(SOLVER_SPECS) == set(solver.SOLVERS)


# ---- packed=false: one message per leaf -------------------------------------


def _split(f, cat):
    def g(p, b):
        full = f(cat([p["w1"], p["w2"]], -1), b)
        return {"w1": full[..., :3], "w2": full[..., 3:]}
    return g


@pytest.mark.parametrize("spec", [
    "ltadmm:packed=false,compressor=qbit:bits=8",
    "lead:packed=false,lr=0.1,compressor=qbit:bits=8",
])
def test_tree_path_measures_one_message_per_leaf(spec):
    if _is_vr(spec):
        jest = jvr.SagaTable(sample_grad=_split(JPROB.sample_grad,
                                                jnp.concatenate), m=JPROB.m)
        est = vr.SagaTable(sample_grads=_split(PROB.sample_grads, torch.cat),
                           m=PROB.m)
    else:
        jest = jvr.PlainSgd(batch_grad=_split(JPROB.batch_grad,
                                              jnp.concatenate))
        est = vr.PlainSgd(batch_grad=_split(PROB.batch_grad, torch.cat))
    js, want = _ref_run(spec, "ring", rounds=3, est=jest, x0={
        "w1": jnp.zeros((A, 3)), "w2": jnp.zeros((A, 2))})
    s, _, got = _port_run(spec, "ring", rounds=3, est=est, x0={
        "w1": torch.zeros((A, 3)), "w2": torch.zeros((A, 2))})
    _assert_same_counters(got, want, spec)
    tree = {"w1": np.zeros(3, np.float32), "w2": np.zeros(2, np.float32)}
    for t in range(3):
        assert int(_round_delta(got, t, "tx_bytes").max()) \
            == s.wire_bytes(tree, t=t) == js.wire_bytes(tree, t=t)


# ---- fault kinds, participation, recipes (port only) ------------------------


def test_fault_kind_counters_split():
    """Every kind at once: every receiver-side kind fires, and the kinds
    partition the dropped receives."""
    spec = f"ltadmm:compressor=qbit:bits=8,faults={FAULTS}"
    _, _, snaps = _port_run(spec, "ring", rounds=8)
    last = snaps[-1]
    crc, tag = int(last["rx_crc_rejects"].sum()), int(
        last["rx_tag_rejects"].sum())
    dropped = int(last["rx_dropped"].sum())
    assert crc > 0 and tag > 0 and dropped == crc + tag
    assert int(last["naks"].sum()) > 0


@pytest.mark.parametrize("kind,field,other", [
    ("stale=0.5", "rx_tag_rejects", "rx_crc_rejects"),
    ("corrupt=0.05", "rx_crc_rejects", "rx_tag_rejects"),
])
def test_single_fault_kind_rejects_by_its_check(kind, field, other):
    spec = f"ltadmm:compressor=qbit:bits=8,faults=faults:{kind}|seed=0"
    _, _, snaps = _port_run(spec, "ring", rounds=6)
    last = snaps[-1]
    assert int(last[field].sum()) > 0
    assert int(last[other].sum()) == 0
    assert int(last["rx_dropped"].sum()) == int(last[field].sum())


def test_participation_counts_follow_node_schedule():
    """Churn: each round's participation increment is the schedule's node
    mask; grad evals are charged only to participating agents."""
    s, sched, snaps = _port_run(SOLVER_SPECS["ltadmm"],
                                GRAPH_SPECS["churn"], rounds=5)
    per_agent = PROB.m + s.cfg.tau * s.cfg.batch_size
    for t in range(len(snaps) - 1):
        mask = sched.round_node_mask_host(t).astype(np.uint32)
        np.testing.assert_array_equal(
            _round_delta(snaps, t, "participations"), mask)
        np.testing.assert_array_equal(
            _round_delta(snaps, t, "grad_evals"), np.uint32(per_agent) * mask)


def test_grad_eval_recipes_pinned():
    s, _, snaps = _port_run(SOLVER_SPECS["ltadmm"], "ring", rounds=2)
    np.testing.assert_array_equal(
        _round_delta(snaps, 0, "grad_evals"),
        np.full((A,), PROB.m + s.cfg.tau * s.cfg.batch_size, np.uint32))
    s2, _, snaps2 = _port_run(SOLVER_SPECS["dsgd"], "ring", rounds=2)
    np.testing.assert_array_equal(
        _round_delta(snaps2, 0, "grad_evals"),
        np.full((A,), s2.batch_size, np.uint32))
    for est, jest, want in (
            (vr.FullGrad(full_grad=PROB.full_grad),
             jvr.FullGrad(full_grad=JPROB.full_grad), 3 * PROB.m),
            (vr.SvrgAnchor(batch_grad=PROB.batch_grad,
                           full_grad=PROB.full_grad),
             jvr.SvrgAnchor(batch_grad=JPROB.batch_grad,
                            full_grad=JPROB.full_grad), PROB.m + 2 * 3)):
        assert telemetry.local_phase_evals(est, PROB.m, 3, 1) == want \
            == jtel.local_phase_evals(jest, PROB.m, 3, 1)
        assert telemetry.round_grad_evals(est, PROB.m, 1) \
            == jtel.round_grad_evals(jest, PROB.m, 1)


@pytest.mark.parametrize("gspec", ["drop:p=0.3,base=complete,seed=0",
                                   f"ring+{FAULTS}"])
def test_wrapper_preserves_trajectory_bitwise(gspec):
    spec = SOLVER_SPECS["ltadmm"]
    if "+" in gspec:
        gspec, fl = gspec.split("+")
        spec += f",faults={fl}"
    graph, ex = build_graph(gspec, A)
    plain = solver.make_solver(spec, graph, ex, _port_est(spec), device="cpu")
    wrapped = with_telemetry(solver.make_solver(spec, graph, ex,
                                                _port_est(spec),
                                                device="cpu"))
    st_p = plain.init(torch.zeros((A, N)))
    st_w = wrapped.init(torch.zeros((A, N)))
    for t in range(3):
        st_p = plain.step(st_p, DATA, jaxrand.key(t))
        st_w = wrapped.step(st_w, DATA, jaxrand.key(t))
    for f in st_p._fields:
        a, b = getattr(st_p, f), getattr(st_w.inner, f)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f
        else:
            assert a == b, f


def test_counters_wrap_mod_2_32():
    graph, ex = build_graph("ring", A)
    s = with_telemetry(solver.make_solver("ltadmm:compressor=qbit:bits=8",
                                          graph, ex, _port_est("ltadmm"),
                                          device="cpu"))
    st = s.init(torch.zeros((A, N)))
    start = 2 ** 32 - 5
    tel = st.telemetry._replace(
        tx_bytes=torch.full((A,), start, dtype=torch.int64),
        rounds=torch.tensor(start, dtype=torch.int64))
    st = telemetry.TelemetryState(st.inner, tel)
    before = counters(st)
    st = s.step(st, DATA, jaxrand.key(0))
    after = counters(st)
    assert int(before["tx_bytes"][0]) == start
    np.testing.assert_array_equal(after["tx_bytes"],
                                  np.full((A,), (start + 36) % 2 ** 32))
    assert int(after["rounds"]) == start + 1
    assert int((after["tx_bytes"] - before["tx_bytes"]).max()) == 36


def test_wrapper_passthrough_and_inactive_taps():
    graph, ex = build_graph("ring", A)
    inner = solver.make_solver("ltadmm:tau=3,compressor=qbit:bits=8", graph,
                               ex, _port_est("ltadmm"), device="cpu")
    s = with_telemetry(inner)
    assert with_telemetry(s) is s
    assert s.name == "ltadmm" and s.cfg.tau == 3
    assert s.wire_bytes(PARAMS) == inner.wire_bytes(PARAMS)
    assert not telemetry.active()
    telemetry.emit(tx_bytes=1)  # no collector: a no-op
    with pytest.raises(ValueError, match="unknown telemetry counter"):
        with telemetry._collect():
            telemetry.emit(bogus=1)


# ---- measured message sizes ------------------------------------------------


@pytest.mark.parametrize("spec", [
    "identity", "qbit:bits=8", "qbit:bits=4",
    "randk:fraction=0.5,sampler=block", "randk:fraction=0.5",
    "topk:fraction=0.25",
])
def test_message_nbytes_matches_compressor_contract(spec):
    comp = compression.get_compressor(spec)
    like = {"w": compression.Spec((257,)), "b": compression.Spec((3, 4))}
    tree = {"w": torch.zeros(257), "b": torch.zeros(3, 4)}
    got = telemetry.message_nbytes(comp, like)
    assert got == compression.tree_wire_bytes(comp, tree)
    jlike = {"w": jax.ShapeDtypeStruct((257,), jnp.float32),
             "b": jax.ShapeDtypeStruct((3, 4), jnp.float32)}
    assert got == jtel.message_nbytes(jcomp.get_compressor(spec), jlike)


def test_payload_nbytes_counts_seal_words():
    comp = compression.get_compressor("qbit:bits=8")
    keys = jaxrand.split(jaxrand.key(0), 12).reshape(4, 3, 2)
    payload = compression.compress_tree(comp, keys, torch.zeros((4, 3, 64)),
                                        nd=2)
    raw = telemetry.payload_nbytes(payload, nd=2)
    assert raw == 64 + 4
    sealed = compression.seal_plane(payload, 0, nd=2)
    assert telemetry.payload_nbytes(sealed, nd=2) == \
        raw + compression.SEAL_BYTES


# ---- trace layer -------------------------------------------------------------


def _write_trace(path):
    with trace.Tracer(path) as tr:
        with tr.span("chunk", rounds=4, cold=True):
            pass
        with tr.span("chunk", rounds=4, cold=False):
            pass
        with tr.span("warm", spec="ring"):
            pass
        tr.instant("watchdog-rollback", round=7)
        tr.counter("telemetry", tx_bytes=123, rounds=600)


def test_tracer_jsonl_reads_as_the_reference_and_summarises_alike(tmp_path):
    path = str(tmp_path / "out.json")
    _write_trace(path)
    events = trace.load_events(path)
    assert events == jtrace.load_events(path)
    assert [e["ph"] for e in events] == ["X", "X", "X", "i", "C"]
    assert sorted(events[0]) == ["args", "dur", "name", "ph", "pid", "tid",
                                 "ts"]
    assert sorted(events[3]) == ["args", "name", "ph", "pid", "s", "tid",
                                 "ts"]
    assert all(e["ts"] >= 0 for e in events)
    with open(path) as f:
        assert f.readline().strip() == "["
    report = summary.summarize(events)
    assert report == jsummary.summarize(events)
    assert "chunk" in report and "tx_bytes=123" in report
    assert summary.main([path]) == 0


def test_load_events_tolerates_torn_tail(tmp_path):
    path = str(tmp_path / "torn.json")
    tr = trace.Tracer(path)
    tr.instant("ok")
    tr.close()
    with open(path, "a") as f:
        f.write('{"name": "torn", "ph":')
    assert [e["name"] for e in trace.load_events(path)] == ["ok"]
    assert trace.load_events(path) == jtrace.load_events(path)


def test_null_tracer_timeit_and_empty_summary(tmp_path, capsys):
    with trace.NULL.span("x", a=1):
        trace.NULL.instant("y")
        trace.NULL.counter("z", v=2)
    trace.NULL.close()
    assert trace.timeit(lambda x: x + 1, torch.zeros(8), iters=2) > 0
    path = str(tmp_path / "empty.json")
    trace.Tracer(path).close()
    assert summary.main([path]) == 0
    assert "(no events)" in capsys.readouterr().out


def test_tracer_profile_dir_exports_a_chrome_trace(tmp_path):
    path, prof = str(tmp_path / "t.json"), tmp_path / "prof"
    with trace.Tracer(path, profile_dir=str(prof)) as tr:
        with tr.span("add"):
            torch.ones(4) + 1
    with open(prof / "torch_trace.json") as f:
        assert "traceEvents" in json.load(f)
    assert [e["name"] for e in trace.load_events(path)] == ["add"]


# ---- the perf-smoke rows' BENCH telemetry ------------------------------------


@pytest.fixture
def one_thread():
    """600 eager rounds of 5-float ops: extra threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("gspec,want", [
    ("ring", (21600, 24000, 6000)),
    ("drop:p=0.3,base=complete,seed=0", (70884, 73932, 6000)),
    ("churn:p=0.2,base=complete,seed=0", (75546, 70264, 4797)),
])
def test_bench_telemetry_dicts_over_600_rounds(gspec, want):
    graph, ex = build_graph(gspec, A)
    s = with_telemetry(solver.make_solver(
        "ltadmm:compressor=qbit:bits=8", graph, ex, _port_est("ltadmm"),
        device="cpu"))
    _, _, st = run_solver(PROB, DATA, s, 600, metric_every=100,
                          return_state=True)
    got = perf_smoke.telemetry_dict(counters(st))
    assert (got["tx_bytes_max_agent"], got["tx_msgs_total"],
            got["participations_total"]) == want
    assert got["rx_dropped_total"] == got["naks_total"] == 0
    assert got["rounds"] == 600
    json.dumps(got)
