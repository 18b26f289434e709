"""Time-varying graphs in the port against the reference.

* every schedule builder: the ``[T, A, S]`` masks, the node masks,
  ``degrees()``, ``participation()``, ``round_degrees(t)``, the union's
  tables and ``metropolis_schedule`` are equal arrays (the builders make
  the reference's ``RandomState`` draws in its order);
* ``validate_schedule`` and the spec parser give the reference's
  messages;
* the per-slot edge exchange, wire bytes and round costs on schedules;
* one packed schedule round (LT-ADMM, reference ``_step_schedule_packed``)
  and one iteration of each gossip baseline on
  ``drop:p=0.3,base=complete,seed=0`` from the same state: rtol 1e-5 /
  atol 1e-6 (identical draws and payload bits, reassociated f32 sums),
  the torch route against ``impl=jnp`` and the kernel route (plain
  versions on the CPU) against ``impl=pallas`` in interpret mode.

The reference's CI rows on schedules are in ``test_torch_bench_rows.py``.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks.common import make_problem  # noqa: E402
from repro.checkpoint.store import save_checkpoint  # noqa: E402
from repro.core import costmodel as jcost  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.core import solver as jsolver  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.core import vr as jvr  # noqa: E402
from repro_torch.checkpoint.reference import (  # noqa: E402
    baseline_state_from_numpy, data_from_numpy, state_from_numpy)
from repro_torch.core import (  # noqa: E402
    costmodel, jaxrand, schedule, solver, topology, vr)
from repro_torch.core.baselines import ALL_BASELINES  # noqa: E402
from repro_torch.problems.logistic import LogisticProblem  # noqa: E402

JPROB, JDATA, _, _ = make_problem(seed=0)
DATA_NP = jax.tree.map(np.asarray, JDATA)
PROB = LogisticProblem()
DROP = "drop:p=0.3,base=complete,seed=0"

SPECS = ["cycle:ring|star", DROP, "gossip:edges=2,base=ring",
         "churn:p=0.2,base=complete,seed=0",
         "churn:p=0.3,base=complete,seed=1,period=8",
         "burst:fail=0.2,recover=0.5", "sample:frac=0.5,base=complete",
         "drop:p=0.2,base=erdos|p=0.4"]


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("spec", SPECS)
def test_schedule_tables_match(spec):
    js, ts = jsched.make_graph(spec, 10), schedule.make_graph(spec, 10)
    schedule.validate_schedule(ts)
    assert (ts.name, ts.period, ts.n_slots) == (js.name, js.period,
                                                js.n_slots)
    assert ts.union.reverse_slot == js.union.reverse_slot
    _eq(ts.union.neighbor_table(), js.union.neighbor_table())
    _eq(ts.union.slot_mask(), js.union.slot_mask())
    _eq(ts.masks, js.masks)
    assert (ts.node_masks is None) == (js.node_masks is None)
    if js.node_masks is not None:
        _eq(ts.node_masks, js.node_masks)
    _eq(ts.degrees(), js.degrees())
    assert ts.participation() == js.participation()
    for t in (0, 3, ts.period - 1, ts.period + 2):
        _eq(ts.round_degrees(t), js.round_degrees(t))
        _eq(ts.round_mask(t).numpy(), np.asarray(js.round_mask(t)))
        nm, jnm = ts.round_node_mask(t), js.round_node_mask(t)
        assert (nm is None) == (jnm is None)
        if nm is not None:
            _eq(nm.numpy(), np.asarray(jnm))
        _eq(ts.round_node_mask_host(t), js.round_node_mask_host(t))
    W = schedule.metropolis_schedule(ts)
    assert W.dtype == np.float64
    _eq(W, jsched.metropolis_schedule(js))
    assert schedule.metropolis_schedule(ts) is W  # built once


def test_static_schedule_and_union():
    ring = topology.Ring(10)
    st = schedule.static_schedule(ring)
    jst = jsched.static_schedule(jtopo.Ring(10))
    _eq(st.masks, jst.masks)
    assert st.name == jst.name and st.period == 1
    assert schedule.static_schedule(st) is st
    assert schedule.union_topology(st) is ring
    assert schedule.union_topology(ring) is ring
    assert schedule.make_graph("ring", 10) == ring


def _broken(kind):
    """(port, reference) schedules that break one invariant each."""
    out = []
    for mod, tmod in ((schedule, topology), (jsched, jtopo)):
        base = tmod.Complete(4)
        m = np.broadcast_to(base.slot_mask()[None], (2, 4, 3)).copy()
        node = None
        if kind == "asymmetric":
            m[1, 0, 0] = False
        elif kind == "never":
            m[:, 0, 0] = False
            m[:, int(base.neighbor_table()[0, 0]), base.reverse_slot[0]] = \
                False
        elif kind == "node":
            node = np.ones((2, 4), bool)
            node[0, 2] = False
        elif kind == "shape":
            m = m[:, :, :2]
        out.append(mod.TopologySchedule(union=base, masks=m,
                                        node_masks=node))
    return out


@pytest.mark.parametrize("kind", ["asymmetric", "never", "node", "shape"])
def test_validate_schedule_messages_match(kind):
    ts, js = _broken(kind)
    with pytest.raises(AssertionError) as jerr:
        jsched.validate_schedule(js)
    with pytest.raises(AssertionError) as terr:
        schedule.validate_schedule(ts)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("bad", [
    "drop:q=0.1", "gossip:edges=2,rate=1", "churn:p=0.1,x=2",
    "burst:fail=0.1,up=1", "sample:frac=0.5,k=2", "cycle:ring,erdos:p=0.4",
    "cycle:", "bogus:p=1", "gossip:edges=0", "drop:p=1.5",
    "drop:base=nosuch", "churn:base=erdos|q=1"])
def test_make_schedule_errors_match(bad):
    with pytest.raises((ValueError, AssertionError)) as jerr:
        jsched.make_schedule(bad, 10)
    with pytest.raises((ValueError, AssertionError)) as terr:
        schedule.make_schedule(bad, 10)
    assert type(terr.value) is type(jerr.value)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("spec", ["ring", "complete", "grid2d:rows=3"])
def test_exchange_batched_matches(spec):
    """The batched edge exchange the rounds use routes each slot's
    messages as the reference's per-slot ``exchange_edges`` does."""
    n = 9 if spec.startswith("grid2d") else 10
    tt, jt = topology.make_topology(spec, n), jtopo.make_topology(spec, n)
    x = np.arange(n * tt.n_slots * 3, dtype=np.float32).reshape(
        tt.n_slots, n, 3)
    want = jtopo.Exchange(jt).exchange_edges(
        tuple({"w": jnp.asarray(x[s])} for s in range(tt.n_slots)))
    assert len(want) == tt.n_slots
    got = topology.Exchange(tt).exchange_batched(
        {"w": torch.from_numpy(np.ascontiguousarray(x.transpose(1, 0, 2)))})
    for s, w in enumerate(want):
        _eq(got["w"][:, s].numpy(), w["w"])


ACCOUNTING = ["ltadmm:compressor=qbit:bits=8",
              "ltadmm:packed=false,compressor=randk:fraction=0.6,"
              "sampler=block", "lead:compressor=qbit:bits=4",
              "choco:packed=false,compressor=topk:fraction=0.4", "dsgd"]


@pytest.mark.parametrize("gspec", [DROP, "churn:p=0.2,base=complete,seed=0",
                                   "sample:frac=0.5,base=complete"])
@pytest.mark.parametrize("spec", ACCOUNTING)
def test_wire_bytes_and_costs_on_schedules_match(spec, gspec):
    jg, jex = jsched.build_graph(gspec, 10)
    tg, tex = schedule.build_graph(gspec, 10)
    js = jsolver.make_solver(spec, jg, jex, None)
    ts = solver.make_solver(spec, tg, tex, None, device="cpu")
    assert ts.is_schedule if spec.startswith("ltadmm") else True
    for params in ({"x": np.zeros(5, np.float32)},
                   {"w": np.zeros((3, 4), np.float32),
                    "b": np.zeros(7, np.float32)}):
        assert ts.wire_bytes(params) == js.wire_bytes(params)
        for t in (0, 5):
            assert ts.wire_bytes(params, t=t) == js.wire_bytes(params, t=t)
    tc = costmodel.CostModel.for_topology(tg, t_c=3.0)
    jc = jcost.CostModel.for_topology(jg, t_c=3.0)
    assert (tc.mean_degree, tc.participation) == (jc.mean_degree,
                                                  jc.participation)
    assert ts.round_cost(tc, PROB.m) == js.round_cost(jc, JPROB.m)


# ---------------------------------------------------------------------------
# one packed schedule round from the same state
# ---------------------------------------------------------------------------

JG, JEX = jsched.build_graph(DROP, 10)
ROUTES = [("jnp", "torch"), ("pallas", "kernel")]
COMPRESSORS = ["qbit:bits=8", "randk:fraction=0.6|sampler=block"]


def _spec(name, comp, impl):
    if name == "dsgd":
        return "dsgd:lr=0.1"
    if name == "ltadmm":
        eta = ",eta=0.5" if comp.startswith("randk") else ""
        return f"ltadmm:tau=2{eta},compressor={comp}|impl={impl}"
    return f"{name}:lr=0.1,compressor={comp}|impl={impl}"


def _ref_est(name):
    if name == "ltadmm":
        return jvr.SagaTable(sample_grad=JPROB.sample_grad, m=JPROB.m)
    return jvr.PlainSgd(batch_grad=JPROB.batch_grad)


def _port_est(name):
    if name == "ltadmm":
        return vr.SagaTable(sample_grads=PROB.sample_grads, m=PROB.m)
    return vr.PlainSgd(batch_grad=PROB.batch_grad)


CASES = [(n, c, r) for n in ["ltadmm"] + list(ALL_BASELINES)
         for c in COMPRESSORS for r in ROUTES
         if n != "dsgd" or (c == COMPRESSORS[0] and r == ROUTES[0])]


@pytest.mark.parametrize("name,comp,route", CASES,
                         ids=[f"{n}-{c.split(':')[0]}-{r[1]}"
                              for n, c, r in CASES])
def test_one_packed_schedule_round_matches_reference(name, comp, route,
                                                     tmp_path):
    js = jsolver.make_solver(_spec(name, comp, route[0]), JG, JEX,
                             _ref_est(name))
    tg, tex = schedule.build_graph(DROP, 10)
    ts = solver.make_solver(_spec(name, comp, route[1]), tg, tex,
                            _port_est(name), device="cpu")
    step = jax.jit(lambda s, k: js.step(s, JDATA, k))
    st = js.init(jnp.zeros((PROB.n_agents, PROB.n)))
    for i in range(3):  # nonzero duals, mirrors and held slots
        st = step(st, jax.random.fold_in(jax.random.key(1), i))
    want = jax.tree.map(np.asarray, step(st, jax.random.fold_in(
        jax.random.key(1), 3)))
    if name == "ltadmm":  # through a reference checkpoint on disk
        save_checkpoint(tmp_path / "ck", st, step=3)
        with np.load(tmp_path / "ck" / "arrays.npz") as z:
            arrays = dict(z)
        with open(tmp_path / "ck" / "manifest.json") as f:
            tst = state_from_numpy(arrays, ts.cfg, device="cpu",
                                   step=json.load(f)["step"])
        fields = [f for f in tst._fields if f != "k"]
    else:
        tst = baseline_state_from_numpy(jax.tree.map(np.asarray, st), ts,
                                        device="cpu")
        fields = list(ts.state_fields)
    got = ts.step(tst, data_from_numpy(DATA_NP, "cpu"),
                  jaxrand.fold_in(jaxrand.key(1), 3))
    get = (lambda s, f: getattr(s, f)) if name == "ltadmm" else \
        (lambda s, f: s[f])
    assert get(got, "k") == 4
    for f in fields:
        w, g = get(want, f), get(got, f)
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6,
                                   err_msg=f)
