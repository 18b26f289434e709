"""The pytree round (``packed=false``) in the port against the reference,
and against the port's own packed round.

* one tree round from the same state, carried across through a
  reference checkpoint (keys ``.x/w1``, ``x/w2``): LT-ADMM and each
  gossip baseline on ``churn:p=0.3,base=complete,seed=1,period=8``, whose
  early rounds leave nodes out, so the x-freeze and the held state are
  exercised (reference ``_step_schedule_tree``), and LT-ADMM on the ring
  (``_step_tree``).  The parameters are the two-leaf tree ``{"w1": [A,
  3], "w2": [A, 2]}``, compressed leaf by leaf; qbit8 and RandK block,
  the torch route against ``impl=jnp`` and the kernel route (K4/K5 and
  K8/K9 plain versions on the CPU) against ``impl=pallas`` in interpret
  mode.  rtol 1e-5 / atol 1e-6: identical draws and payload bits,
  reassociated f32 sums;
* the kernel route batches each leaf's messages into one call per
  message class: per round and leaf 2 K8 and 4 K9 (RandK block), 2 K4
  and 4 K5 (qbit); a gossip baseline 1 K8 and 1 K9 per iteration;
* packed against tree inside the port on the torch route (no JAX): every
  ported solver x {identity, q8, q4, randk block, topk} x {ring, drop,
  churn}, 3 rounds, atol = rtol = 1e-6 as in ``tests/test_packing.py``,
  and the two-leaf identity parity of its ``test_packing.py:255``.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks.common import make_problem  # noqa: E402
from repro.checkpoint.store import save_checkpoint  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.core import solver as jsolver  # noqa: E402
from repro.core import vr as jvr  # noqa: E402
from repro_torch.checkpoint.reference import (  # noqa: E402
    baseline_state_from_numpy, data_from_numpy, state_from_numpy)
from repro_torch.common.trees import tree_flatten  # noqa: E402
from repro_torch.core import jaxrand, schedule, solver, vr  # noqa: E402
from repro_torch.core.baselines import ALL_BASELINES  # noqa: E402
from repro_torch.kernels.quantize import ops as q_ops  # noqa: E402
from repro_torch.kernels.sparse_gather import ops as sg_ops  # noqa: E402
from repro_torch.problems.logistic import LogisticProblem  # noqa: E402

JPROB, JDATA, _, _ = make_problem(seed=0)
DATA_NP = jax.tree.map(np.asarray, JDATA)
DATA = data_from_numpy(DATA_NP, "cpu")
PROB = LogisticProblem()
A, N = PROB.n_agents, PROB.n
CHURN = "churn:p=0.3,base=complete,seed=1,period=8"
DROP = "drop:p=0.3,base=complete,seed=0"


# ---- two-leaf parameters {"w1": [.., 3], "w2": [.., 2]} -------------------

def _j_split(f):
    def g(p, b):
        full = f(jnp.concatenate([p["w1"], p["w2"]], -1), b)
        return {"w1": full[..., :3], "w2": full[..., 3:]}
    return g


def _t_split(f):
    def g(p, b):
        full = f(torch.cat([p["w1"], p["w2"]], -1), b)
        return {"w1": full[..., :3], "w2": full[..., 3:]}
    return g


def _ref_est(name):
    if name == "ltadmm":
        return jvr.SagaTable(sample_grad=_j_split(JPROB.sample_grad),
                             m=JPROB.m)
    return jvr.PlainSgd(batch_grad=_j_split(JPROB.batch_grad))


def _port_est(name, split=_t_split):
    if name == "ltadmm":
        return vr.SagaTable(sample_grads=split(PROB.sample_grads), m=PROB.m)
    return vr.PlainSgd(batch_grad=split(PROB.batch_grad))


def _spec(name, comp, impl):
    if name == "dsgd":
        return "dsgd:lr=0.1,packed=false"
    if name == "ltadmm":
        eta = ",eta=0.5" if comp.startswith("randk") else ""
        return f"ltadmm:tau=2,packed=false{eta},compressor={comp}|impl={impl}"
    return f"{name}:lr=0.1,packed=false,compressor={comp}|impl={impl}"


ROUTES = [("jnp", "torch"), ("pallas", "kernel")]
COMPRESSORS = ["qbit:bits=8", "randk:fraction=0.6|sampler=block"]
CASES = [(n, c, r, g) for n in ["ltadmm"] + list(ALL_BASELINES)
         for c in COMPRESSORS for r in ROUTES for g in (CHURN, "ring")
         if (n != "dsgd" or (c == COMPRESSORS[0] and r == ROUTES[0]))
         and (g == CHURN or n == "ltadmm")]


def _x0(lib):
    return {"w1": lib.zeros((A, 3)), "w2": lib.zeros((A, N - 3))}


def _random_state(js, seed):
    """The reference solver's state structure with every float leaf drawn
    from a seeded normal (nonzero duals, mirrors and held state), at
    round 3: on CHURN agents 0 and 8 sit that round out."""
    st = js.init(_x0(jnp))
    rs = np.random.RandomState(seed)
    st = jax.tree.map(
        lambda t: jnp.asarray(0.1 * rs.standard_normal(t.shape), t.dtype)
        if jnp.issubdtype(t.dtype, jnp.floating) else t, st)
    if isinstance(st, dict):
        return {**st, "k": jnp.asarray(3, jnp.int32)}
    return st._replace(k=jnp.asarray(3, jnp.int32))


@pytest.mark.parametrize("name,comp,route,gspec", CASES,
                         ids=[f"{n}-{c.split(':')[0]}-{r[1]}-{g[:5]}"
                              for n, c, r, g in CASES])
def test_one_tree_round_matches_reference(name, comp, route, gspec,
                                          tmp_path):
    jg, jex = jsched.build_graph(gspec, A)
    js = jsolver.make_solver(_spec(name, comp, route[0]), jg, jex,
                             _ref_est(name))
    tg, tex = schedule.build_graph(gspec, A)
    ts = solver.make_solver(_spec(name, comp, route[1]), tg, tex,
                            _port_est(name), device="cpu")
    st = _random_state(js, len(CASES))
    # one eager reference step: tracing the tree round's per-slot loops
    # for jit costs more than running them once
    want = jax.tree.map(np.asarray, js.step(st, JDATA, jax.random.key(5)))
    save_checkpoint(tmp_path / "ck", st, step=3)
    with np.load(tmp_path / "ck" / "arrays.npz") as z:
        arrays = dict(z)
    assert any("/w1" in k for k in arrays)
    with open(tmp_path / "ck" / "manifest.json") as f:
        step_no = json.load(f)["step"]
    if name == "ltadmm":
        tst = state_from_numpy(arrays, ts.cfg, device="cpu", step=step_no)
        assert type(tst).__name__ == type(want).__name__
        fields = [f for f in tst._fields if f != "k"]
        get = getattr
    else:
        tst = baseline_state_from_numpy(arrays, ts, device="cpu",
                                        step=step_no)
        fields = list(ts.state_fields)
        get = dict.__getitem__
    got = ts.step(tst, DATA, jaxrand.key(5))
    assert get(got, "k") == 4
    for f in fields:
        w, g = get(want, f), get(got, f)
        if w is None:
            assert g is None
            continue
        assert sorted(g) == ["w1", "w2"]
        for leaf in ("w1", "w2"):
            np.testing.assert_allclose(g[leaf].numpy(), w[leaf], rtol=1e-5,
                                       atol=1e-6, err_msg=f"{f}/{leaf}")
    if gspec == CHURN:  # agents 0 and 8 sat round 3 out: x held
        held = ~tg.round_node_mask_host(3)
        assert held.tolist() == [i in (0, 8) for i in range(A)]
        np.testing.assert_array_equal(get(got, "x")["w1"].numpy()[held],
                                      get(tst, "x")["w1"].numpy()[held])


def _counting(monkeypatch, module, names):
    calls = dict.fromkeys(names, 0)
    for fn in names:
        orig = getattr(module, fn)

        def wrapped(*a, _orig=orig, _fn=fn, **kw):
            calls[_fn] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(module, fn, wrapped)
    return calls


@pytest.mark.parametrize("name,comp,gspec,per_leaf", [
    ("ltadmm", "randk:fraction=0.6|sampler=block", CHURN, (2, 4)),
    ("ltadmm", "randk:fraction=0.6|sampler=block", "ring", (2, 4)),
    ("ltadmm", "qbit:bits=8", DROP, (2, 4)),
    ("choco", "randk:fraction=0.6|sampler=block", DROP, (1, 1))])
def test_kernel_route_batches_messages(name, comp, gspec, per_leaf,
                                       monkeypatch):
    """One kernel call per message class and leaf, all agents and slots
    at once (counted on the wrappers; the plain versions run here)."""
    ops = ("cyclic_gather", "cyclic_scatter") if "randk" in comp else (
        "quantize_tensor", "dequantize_tensor")
    calls = _counting(monkeypatch, sg_ops if "randk" in comp else q_ops,
                      ops)
    tg, tex = schedule.build_graph(gspec, A)
    ts = solver.make_solver(_spec(name, comp, "kernel"), tg, tex,
                            _port_est(name), device="cpu")
    st = ts.init(_x0(torch))
    for i in range(3):
        st = ts.step(st, DATA, jaxrand.key(i))
    assert (calls[ops[0]], calls[ops[1]]) == tuple(3 * 2 * c
                                                   for c in per_leaf)


# ---------------------------------------------------------------------------
# packed against tree inside the port (torch route, no JAX)
# ---------------------------------------------------------------------------

PARITY_SOLVERS = {
    "ltadmm": "ltadmm:tau=2,compressor={c}",
    "dsgd": "dsgd:lr=0.1",
    "choco": "choco:lr=0.1,compressor={c}",
    "lead": "lead:lr=0.1,compressor={c}",
    "cold": "cold:lr=0.1,compressor={c}",
    "cedas": "cedas:lr=0.1,compressor={c}",
    "dpdc": "dpdc:lr=0.1,compressor={c}",
}
PARITY_COMPRESSORS = {
    "identity": "identity",
    "q8": "qbit:bits=8",
    "q4": "qbit:bits=4",
    "randk": "randk:fraction=0.6|sampler=block",
    "topk": "topk:fraction=0.6",
}
PARITY_GRAPHS = {"static": "ring", "drop": DROP, "churn": CHURN}


def _one_leaf(f):
    return lambda p, b: {"w": f(p["w"], b)}


def _run(spec, gspec, packed, rounds=3):
    graph, ex = schedule.build_graph(gspec, A)
    name = spec.partition(":")[0]
    est = (vr.SagaTable(sample_grads=_one_leaf(PROB.sample_grads), m=PROB.m)
           if name == "ltadmm"
           else vr.PlainSgd(batch_grad=_one_leaf(PROB.batch_grad)))
    s = solver.make_solver(
        f"{spec}{',' if ':' in spec else ':'}packed={str(packed).lower()}",
        graph, ex, est, device="cpu")
    assert s.packed is packed
    st = s.init({"w": torch.zeros((A, N))})
    for i in range(rounds):
        st = s.step(st, DATA, jaxrand.key(i))
    return s.consensus_params(st)


PARITY = [(n, c, g) for n in sorted(PARITY_SOLVERS)
          for c in sorted(PARITY_COMPRESSORS) for g in sorted(PARITY_GRAPHS)
          if n != "dsgd" or c == "identity"]


@pytest.mark.parametrize("name,comp,graph", PARITY)
def test_packed_matches_tree_path(name, comp, graph):
    spec = PARITY_SOLVERS[name].format(c=PARITY_COMPRESSORS[comp])
    if name == "ltadmm" and comp in ("randk", "topk"):
        spec += ",eta=0.5"  # EF contraction needs eta < 2/p
    x_packed = _run(spec, PARITY_GRAPHS[graph], packed=True)
    x_tree = _run(spec, PARITY_GRAPHS[graph], packed=False)
    np.testing.assert_allclose(x_packed["w"].numpy(), x_tree["w"].numpy(),
                               atol=1e-6, rtol=1e-6)


def test_packed_multileaf_identity_parity():
    """Two leaves through the plane and as a tree: equal under identity
    compression (only lossy compressors see the granularity)."""
    graph, ex = schedule.build_graph("ring", A)
    est = _port_est("ltadmm")
    outs = {}
    for packed in (True, False):
        s = solver.make_solver(f"ltadmm:tau=2,packed={str(packed).lower()}",
                               graph, ex, est, device="cpu")
        st = s.init(_x0(torch))
        for i in range(3):
            st = s.step(st, DATA, jaxrand.key(i))
        outs[packed] = s.consensus_params(st)
    for a, b in zip(tree_flatten(outs[True])[0], tree_flatten(outs[False])[0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                   rtol=1e-6)
