"""The multi-process exchange (ROADMAP item 15) against the port's host
path and the reference.

* One spawned gloo world of 8 CPU ranks on a ``(4 data, 2 model)`` mesh,
  the reference's ``make_host_mesh(8, model=2)``, meeting at a
  ``FileStore`` in ``tmp_path``, runs ``repro_torch.launch.spmd_check``'s
  ``suite``.  Every rank holds its rows of the mesh path bit-equal to
  the host path (the ranks assert it):
  ``gather_from_neighbors``/``gather_batched``/``exchange_batched`` on
  Ring(4), Star(4), Complete(4), ErdosRenyi(4, p=0.5, seed=0) (f32, int8
  and bool leaves); LT-ADMM-CC qbit8 + SAGA (n = 6, m = 20, tau = 3) at
  every state leaf: 3 rounds on Star(4), 4 on ``cycle_schedule([Ring(4),
  Star(4)])``, 4 on ``churn_schedule(Complete(4), p=0.3, seed=1,
  period=4)``, 3 on Ring(8) with 2 agents a rank, one RandK-stride round,
  and 4 on the churn schedule with every fault kind armed, wrapped in
  the telemetry counters (every counter bit-equal too);
  ``shard_like``'s placements (each rank's shard is its slice); the
  sequence-sharded blockwise attention (f32, causal, with and without a
  window, T divisible by the axis and not) within 1e-5 relative of the
  unsharded ``sdpa_blockwise``; the gossip baselines (DSGD, CHOCO qbit8,
  LEAD qbit8, COLD RandK, CEDAS qbit4, DPDC TopK on Ring(4), CHOCO
  ``packed=false`` on drop0.3, LEAD under faults) and dada on
  Complete(4), 3 rounds each, every state leaf.  Here the rows are
  assembled over the data axis, the model replicas must be equal, and the results must lie
  within 1e-5 of the live reference's host-sim run (the tolerance of the
  reference's own SPMD check); the causal no-window attention also
  against the reference's ``sdpa_blockwise``.  The reference runs while
  the world does.
* In process: ``sanitize_spec``, ``param_pspec`` (admm, serve,
  serve_replicated), ``batch_pspec``, ``cache_pspec`` and
  ``train_data_pspec`` for every arch on ``(4, 2)``, ``(16, 16)`` and
  ``(2, 16, 16)`` stand-in meshes equal the reference's specs tuple for
  tuple; ``abstract_state`` shapes and dtypes and ``state_sharding``
  trees of every registered solver (packed and not, static and schedule,
  telemetry-wrapped, dada) and ``abstract_train_state`` equal the
  reference's (the telemetry counters are int64 in the port where the
  reference's are uint32); ``build_train``'s ``state_sharding`` and
  ``build_ddp_train``'s specs with a one-rank gloo mesh equal the
  reference's on its one-device mesh.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs.archs import ARCHS as JARCHS  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.core import solver as jsolver  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.core import vr as jvr  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import sharding as jshd  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.obs import telemetry as jtel  # noqa: E402
from repro.problems.logistic import LogisticProblem as JLogistic  # noqa: E402
from repro_torch.common.trees import tree_flatten  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core import schedule, solver  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.launch import spmd_check as sc  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, world  # noqa: E402
from repro_torch.obs import telemetry  # noqa: E402

WORLD, MODEL = 8, 2
STANDINS = {
    "4x2": types.SimpleNamespace(shape={"data": 4, "model": 2},
                                 axis_names=("data", "model")),
    "16x16": types.SimpleNamespace(shape={"data": 16, "model": 16},
                                   axis_names=("data", "model")),
    "2x16x16": types.SimpleNamespace(
        shape={"pod": 2, "data": 16, "model": 16},
        axis_names=("pod", "data", "model")),
}


# ---------------------------------------------------------------------------
# The reference's side of the world's checks
# ---------------------------------------------------------------------------


def _ref_graph(recipe, n):
    static = {"ring": jtopo.Ring, "star": jtopo.Star,
              "complete": jtopo.Complete}
    kind = recipe[0]
    if kind in static:
        return static[kind](n)
    if kind == "erdos":
        return jtopo.ErdosRenyi(n, p=recipe[1], seed=recipe[2])
    if kind == "cycle":
        return jsched.cycle_schedule([static[k](n) for k in recipe[1:]])
    _, base, p, seed, period = recipe
    return jsched.churn_schedule(static[base](n), p=p, seed=seed,
                                 period=period)


def _inputs():
    """Each LT-ADMM case's (data, x0), numpy, from seeds: the logistic
    problem's features, labels +-1 and x0."""
    out = {}
    n, m = sc.PROBLEM["n"], sc.PROBLEM["m"]
    for case, (_, a, _, _) in sc.ADMM_CASES.items():
        rng = np.random.RandomState(1)
        data = {"a": rng.normal(size=(a, m, n)).astype(np.float32),
                "b": np.where(rng.rand(a, m) < 0.5, 1.0, -1.0).astype(
                    np.float32)}
        x0 = np.random.RandomState(2).normal(size=(a, n)).astype(np.float32)
        out[case] = (data, x0)
    return out


def _ref_admm(case, data_np, x0_np):
    """The reference's host-sim run of one case through its Pallas plane
    route (interpret mode), the route the port's kernels follow."""
    recipe, a, rounds, spec = sc.ADMM_CASES[case]
    graph = _ref_graph(recipe, a)
    prob = JLogistic(n=sc.PROBLEM["n"], n_agents=a, m=sc.PROBLEM["m"])
    est = jvr.SagaTable(sample_grad=prob.sample_grad, m=prob.m)
    union = graph.union if hasattr(graph, "union") else graph
    js = jsolver.make_solver(spec.replace("impl=kernel", "impl=pallas"),
                             graph, jtopo.Exchange(union), est)
    data = jax.tree.map(jnp.asarray, data_np)
    step = jax.jit(lambda s, k: js.step(s, data, k))
    st = js.init(jnp.asarray(x0_np))
    for i in range(rounds):
        st = step(st, jax.random.key(100 + i))
    return st


@pytest.fixture(scope="module")
def world_run(tmp_path_factory):
    """Start the 8-rank world, run the reference meanwhile, collect."""
    d = str(tmp_path_factory.mktemp("mesh_world"))
    inputs = _inputs()
    ctx = sc.start_world("suite", WORLD, d, model=MODEL, admm_inputs=inputs)
    ref = {c: jax.tree.map(np.asarray, _ref_admm(c, *inputs[c]))
           for c in sc.ADMM_CASES}
    ranks = sc.collect_world(ctx, WORLD, d)
    return ranks, ref


def _assemble(ranks, get):
    """``get(rank result)`` over the data axis (model position 0), rows
    joined in data order; the model replicas must be equal."""
    by = {r["coords"]: get(r) for r in ranks}
    for (p, m), v in by.items():
        np.testing.assert_array_equal(v, by[(p, 0)],
                                      err_msg=f"replica {(p, m)}")
    n_data = WORLD // MODEL
    return np.concatenate([by[(p, 0)] for p in range(n_data)], axis=0)


def test_world_runs_every_rank(world_run):
    ranks, _ = world_run
    assert sorted(r["rank"] for r in ranks) == list(range(WORLD))
    assert sorted(r["coords"] for r in ranks) == [
        (p, m) for p in range(WORLD // MODEL) for m in range(MODEL)]
    for r in ranks:
        assert r["admm"]["ring8"]["rows"] == (2 * r["coords"][0],
                                              2 * r["coords"][0] + 2)


@pytest.mark.parametrize("graph", sorted(sc.EXCHANGE_GRAPHS))
def test_mesh_exchange_matches_reference(world_run, graph):
    ranks, _ = world_run
    topo = _ref_graph(sc.EXCHANGE_GRAPHS[graph], 4)
    ex = jtopo.Exchange(topo)
    x = sc.exchange_inputs(4)
    xe = np.stack([x + s for s in range(topo.n_slots)], axis=1)
    for name, want in (
            ("gather_batched", ex.gather_batched(jnp.asarray(x))),
            ("exchange_batched", ex.exchange_batched(jnp.asarray(xe)))):
        got = _assemble(ranks, lambda r: r["exchange"][graph][name])
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)


@pytest.mark.parametrize("case", list(sc.GOSSIP_CASES))
def test_mesh_gossip_matches_host(world_run, case):
    """The gossip baselines and dada over the mesh: every rank holds its
    rows bit-equal to its host run (the ranks assert it); here the rows
    assembled over the data axis equal the host run's whole state, and
    every rank's host run is the same."""
    ranks, _ = world_run
    res = [r["gossip"][case] for r in ranks]
    assert res[0]["state"].keys() == res[0]["host"].keys()
    for f, want in res[0]["host"].items():
        for r in res:
            np.testing.assert_array_equal(r["host"][f], want)
        got = _assemble(ranks, lambda r: r["gossip"][case]["state"][f])
        np.testing.assert_array_equal(got, want, err_msg=f"{case}.{f}")
    n = sc.GOSSIP_CASES[case][1]
    assert res[0]["rows"] == (0, n // 4)


@pytest.mark.parametrize("case", list(sc.ADMM_CASES))
def test_mesh_admm_matches_reference(world_run, case):
    """Every state leaf of the mesh run (bit-equal to the port's host
    run on each rank) within 1e-5 of the reference's host-sim run."""
    ranks, ref = world_run
    want = ref[case]
    fields = ranks[0]["admm"][case]["state"]
    assert set(fields) == {f for f in want._fields
                           if getattr(want, f) is not None} - {"k"}
    for f in fields:
        got = _assemble(ranks, lambda r: r["admm"][case]["state"][f])
        np.testing.assert_allclose(got, getattr(want, f), rtol=1e-5,
                                   atol=1e-5, err_msg=f"{case}.{f}")
    assert int(want.k) == sc.ADMM_CASES[case][2]


def test_shard_like_distributes_each_rank_its_slice(world_run):
    ranks, _ = world_run
    for r in ranks:
        pl = r["shard_like"]["placements"]
        assert pl["a"] == "(Shard(dim=0), Shard(dim=1))", pl
        assert pl["d"] == "(Replicate(), Replicate())", pl


def test_seq_sharded_attention_matches_reference(world_run):
    ranks, _ = world_run
    for r in ranks:
        assert set(r["attention"]) == set(sc.ATTN_CASES)
        # every rank holds the whole gathered output
        np.testing.assert_array_equal(r["attention"][(64, None)],
                                      ranks[0]["attention"][(64, None)])
    q, k, v = sc.attention_inputs(64)
    want = np.asarray(jattn.sdpa_blockwise(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    got = ranks[0]["attention"][(64, None)]
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# Sharding rules (in process, stand-in meshes)
# ---------------------------------------------------------------------------


def _specs_equal(got, want):
    # jax takes a None entry for an empty subtree, the port for a leaf
    gl = [tuple(p) for p in tree_flatten(got, is_leaf=shd.is_pspec)[0]
          if p is not None]
    wl = [tuple(p) for p in jax.tree.leaves(
        want, is_leaf=lambda x: isinstance(x, JP))]
    assert gl == wl


def test_sanitize_spec_matches_reference():
    for name, m in STANDINS.items():
        for shape, spec in (((8, 8), ("model", None)),
                            ((3, 8), ("model", "data")),
                            ((64, 4), (("data", "model"), None)),
                            ((4, 4), (("data", "model"), "model")),
                            ((32, 32, 2), ("data", "data", None)),
                            ((512,), (tuple(m.axis_names[:-1]),))):
            got = shd.sanitize_spec(m, shape, shd.P(*spec))
            want = jshd.sanitize_spec(m, shape, JP(*spec))
            assert tuple(got) == tuple(want), (name, shape, spec)


@pytest.mark.parametrize("mesh_name", sorted(STANDINS))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_batch_cache_specs_match_reference(arch, mesh_name):
    m = STANDINS[mesh_name]
    cfg, jcfg = ARCHS[arch].make(None), JARCHS[arch].make(None)
    specs = steps.model_specs(ARCHS[arch], cfg)
    jspecs = jsteps.model_specs(JARCHS[arch], jcfg)
    for mode in ("admm", "serve", "serve_replicated"):
        _specs_equal(shd.param_pspec(m, mode, specs),
                     jshd.param_pspec(m, mode, jspecs))
        assert shd.param_rules(m, mode) == jshd.param_rules(m, mode)
    _specs_equal(shd.prefix_pspec(shd.param_pspec(m, "admm", specs),
                                  "data", None),
                 jshd.prefix_pspec(jshd.param_pspec(m, "admm", jspecs),
                                   "data", None))
    for shape in ((256, 2048), (1, 524288, 64), (32, 4096, 128), (6, 7),
                  (2, 2048, 8, 128)):
        assert tuple(shd.batch_pspec(m, shape)) == tuple(
            jshd.batch_pspec(m, shape)), shape
    if JARCHS[arch].kind != "encdec":
        jcache = jax.eval_shape(lambda: jtr.init_cache(jcfg, 2, 64))
        cache = jax.tree.map(
            lambda s: torch.empty(s.shape, device="meta"), jcache)
        _specs_equal(shd.cache_pspec(m, cache), jshd.cache_pspec(m, jcache))
    nd = {"tokens": 3, "embeds": 4}
    got = shd.train_data_pspec(m, nd)
    want = jshd.train_data_pspec(m, nd)
    assert {k: tuple(v) for k, v in got.items()} == {
        k: tuple(v) for k, v in want.items()}


def test_partition_specs_and_abstract_params_match_reference():
    from repro.models import common as jcommon
    from repro_torch.models import common

    cfg, jcfg = ARCHS["qwen3-0.6b"].make_smoke(), JARCHS[
        "qwen3-0.6b"].make_smoke()
    specs = steps.model_specs(ARCHS["qwen3-0.6b"], cfg)
    jspecs = jsteps.model_specs(JARCHS["qwen3-0.6b"], jcfg)
    rules = {"heads": "model", "embed": ("pod", "data"), "vocab": "model"}
    _specs_equal(common.partition_specs(specs, rules),
                 jcommon.partition_specs(jspecs, rules))
    got = _walk(common.abstract_params(specs, torch.bfloat16))
    want = _walk(jcommon.abstract_params(jspecs, jnp.bfloat16))
    assert got == want


# ---------------------------------------------------------------------------
# abstract_state / state_sharding (in process)
# ---------------------------------------------------------------------------


def _leaf(x):
    if x is None or isinstance(x, str):
        return x
    return (tuple(x.shape), str(x.dtype).replace("torch.", ""))


def _walk(tree, path=""):
    """``[(path, leaf)]`` over named tuples, dicts and lists."""
    if hasattr(tree, "_fields"):
        return [w for f in tree._fields
                for w in _walk(getattr(tree, f), f"{path}.{f}")]
    if isinstance(tree, dict):
        return [w for k in sorted(tree) for w in _walk(tree[k],
                                                       f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [w for i, t in enumerate(tree) for w in _walk(t,
                                                             f"{path}[{i}]")]
    return [(path, _leaf(tree))]


def _raw_leaves(tree):
    if hasattr(tree, "_fields") or isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _raw_leaves(t)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _raw_leaves(tree[k])]
    return [tree]


A = 4
PARAMS = {"w": (3, 2), "b": (4,)}
SOLVER_CASES = [
    ("ltadmm", "ring"), ("ltadmm:packed=false", "ring"),
    ("ltadmm:eta=0.5", "ring"), ("ltadmm", "drop:p=0.3,base=complete"),
    ("ltadmm:packed=false,eta=0.5", "cycle:ring|star"),
    ("ltadmm:faults=faults:drop=0.1", "ring"),
    ("dada:", "complete"), ("dada:packed=false", "ring"),
    ("telemetry/ltadmm", "ring"), ("telemetry/dada:", "complete"),
    ("telemetry/choco:packed=false", "ring"),
] + [(name, "ring") for name in ("dsgd", "choco", "lead", "cold", "cedas",
                                 "dpdc")] + [
    (f"{name}:packed=false", "drop:p=0.3,base=complete")
    for name in ("dsgd", "choco", "lead", "cold", "cedas", "dpdc")]


def _pair(spec, graph_spec):
    wrap = spec.startswith("telemetry/")
    spec = spec.removeprefix("telemetry/")
    graph, ex = schedule.build_graph(graph_spec, A)
    jgraph, jex = jsched.build_graph(graph_spec, A)
    port = solver.make_solver(spec, graph, ex, None, device="cpu")
    ref = jsolver.make_solver(spec, jgraph, jex, None)
    if wrap:
        port, ref = telemetry.with_telemetry(port), jtel.with_telemetry(ref)
    return port, ref


@pytest.mark.parametrize("spec,graph", SOLVER_CASES)
def test_abstract_state_and_state_sharding_match_reference(spec, graph):
    port, ref = _pair(spec, graph)
    x = {k: torch.empty((A,) + s, device="meta") for k, s in PARAMS.items()}
    jx = {k: jax.ShapeDtypeStruct((A,) + s, jnp.float32)
          for k, s in PARAMS.items()}
    got, want = _walk(port.abstract_state(x)), _walk(ref.abstract_state(jx))
    # the port keeps the telemetry counters in int64 (torch has no uint32
    # add); the reference's are uint32
    want = [(p, (w[0], "int64") if w and w[1] == "uint32" else w)
            for p, w in want]
    assert got == want
    assert _walk(port.state_sharding("X", "E", "K")) == _walk(
        ref.state_sharding("X", "E", "K"))
    # nothing was allocated: every leaf is a meta tensor
    leaves = [t for t in _raw_leaves(port.abstract_state(x))
              if t is not None]
    assert leaves and all(t.device.type == "meta" for t in leaves)


@pytest.mark.parametrize("spec", ["ltadmm", "ltadmm:packed=false", "lead"])
def test_abstract_train_state_matches_reference(spec):
    arch, jarch = ARCHS["qwen3-0.6b"], JARCHS["qwen3-0.6b"]
    cfg, jcfg = arch.make_smoke(), jarch.make_smoke()
    graph, ex = schedule.build_graph("ring", A)
    jgraph, jex = jsched.build_graph("ring", A)
    port = solver.make_solver(spec, graph, ex, None, device="cpu")
    ref = jsolver.make_solver(spec, jgraph, jex, None)
    got = steps.abstract_train_state(arch, cfg, port)
    assert all(t.device.type == "meta" for t in tree_flatten(got)[0]
               if isinstance(t, torch.Tensor))
    assert _walk(got) == _walk(jsteps.abstract_train_state(jarch, jcfg, ref))


@pytest.mark.parametrize("spec", ["ltadmm", "ltadmm:packed=false", "dsgd"])
def test_build_train_and_ddp_specs_on_a_mesh_match_reference(spec,
                                                             tmp_path):
    arch, jarch = ARCHS["qwen3-0.6b"], JARCHS["qwen3-0.6b"]
    cfg, jcfg = arch.make_smoke(), jarch.make_smoke()
    jm = jmesh.make_host_mesh()
    _, jstate_ps, _, _ = jsteps.build_train(jarch, jcfg, jm, spec)
    _, jpps, _ = jsteps.build_ddp_train(jarch, jcfg, jm)
    with world("gloo", str(tmp_path / "store")):
        m = make_host_mesh()
        _, state_ps, _, s = steps.build_train(
            arch, cfg, None, spec, mesh=m, device="cpu")
        assert s.exchange.mesh is m and s.graph.n_agents == 1
        assert _walk_specs(state_ps) == _walk_specs(jstate_ps)
        _, pps, _ = steps.build_ddp_train(arch, cfg, mesh=m)
        _specs_equal(pps, jpps)


def _walk_specs(tree, path=""):
    if isinstance(tree, (shd.PartitionSpec, JP)):
        return [(path, tuple(tree))]
    if hasattr(tree, "_fields"):
        return [w for f in tree._fields
                for w in _walk_specs(getattr(tree, f), f"{path}.{f}")]
    if isinstance(tree, dict):
        return [w for k in sorted(tree)
                for w in _walk_specs(tree[k], f"{path}/{k}")]
    return [(path, tree)]

