"""Checkpoints in the port, in the reference's format, both ways.

* the reference's ``tests/test_checkpoint.py`` on the port's store: a
  round trip, the manifest lists every leaf, a missing or truncated
  arrays file or manifest and a missing leaf raise
  ``CheckpointCorruptError``, an overwrite replaces atomically;
* resume is bitwise exact: k1 rounds, a checkpoint, then k2 rounds from
  the restored state equal k1 + k2 rounds without a stop, for LT-ADMM
  (plain, faulted, and on the pytree path) and each ported baseline;
* across packages: a checkpoint that ``repro.checkpoint.store`` wrote
  restores into a port state (``load_checkpoint(like_tree=...)``), whose
  next round agrees with the reference's within the one-round tolerance
  (rtol 1e-5 / atol 1e-6); the reference's ``load_checkpoint`` reads one
  the port wrote and continues within the same tolerance.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks.common import make_problem  # noqa: E402
from repro.checkpoint import store as jstore  # noqa: E402
from repro.core import solver as jsolver  # noqa: E402
from repro.core import vr as jvr  # noqa: E402
from repro_torch import paper_fig2  # noqa: E402
from repro_torch.checkpoint import (CheckpointCorruptError,  # noqa: E402
                                    load_checkpoint, save_checkpoint)
from repro_torch.checkpoint.reference import data_from_numpy  # noqa: E402
from repro_torch.checkpoint.store import flatten_with_paths  # noqa: E402
from repro_torch.core import jaxrand, solver, topology, vr  # noqa: E402
from repro_torch.problems.logistic import LogisticProblem  # noqa: E402

JPROB, JDATA, JGRAPH, JEX = make_problem(seed=0)
DATA_NP = jax.tree.map(np.asarray, JDATA)
PROB = LogisticProblem()
DATA = data_from_numpy(DATA_NP, "cpu")
HEAVY = "faults:drop=0.2|corrupt=0.2|stale=0.2|crash=0.1|seed=3"


def test_roundtrip(tmp_path):
    tree = {"layer": {"w": torch.arange(12.0).reshape(3, 4),
                      "b": torch.ones(4)},
            "step_scale": torch.tensor(0.5)}
    save_checkpoint(tmp_path / "ckpt", tree, step=7,
                    extra={"arch": "qwen3-0.6b"})
    restored, manifest = load_checkpoint(tmp_path / "ckpt", tree)
    assert manifest["step"] == 7
    assert manifest["extra"]["arch"] == "qwen3-0.6b"
    for k, v in flatten_with_paths(tree).items():
        assert torch.equal(flatten_with_paths(restored)[k], v)


def test_manifest_lists_all_leaves(tmp_path):
    tree = {"a": torch.zeros(2), "nested": {"b": torch.ones(3)}}
    save_checkpoint(tmp_path / "c", tree)
    raw, manifest = load_checkpoint(tmp_path / "c")
    assert sorted(manifest["keys"]) == ["a", "nested/b"] == sorted(raw)
    assert manifest["shapes"]["nested/b"] == [3]
    assert manifest["dtypes"]["a"] == "float32"


def _ckpt(tmp_path, step=0):
    path = str(tmp_path / "c")
    save_checkpoint(path, {"a": torch.arange(4.0)}, step=step)
    return path


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(CheckpointCorruptError, match="missing manifest"):
        load_checkpoint(tmp_path / "nope")
    path = _ckpt(tmp_path)
    os.remove(os.path.join(path, "arrays.npz"))
    with pytest.raises(CheckpointCorruptError, match="missing arrays"):
        load_checkpoint(path)


@pytest.mark.parametrize("name,err", [("arrays.npz", "truncated arrays"),
                                      ("manifest.json",
                                       "truncated manifest")])
def test_truncated_file_raises(tmp_path, name, err):
    path = _ckpt(tmp_path)
    fpath = os.path.join(path, name)
    with open(fpath, "r+b") as f:
        f.truncate(os.path.getsize(fpath) // 2)
    with pytest.raises(CheckpointCorruptError, match=err):
        load_checkpoint(path)


def test_missing_leaf_for_template_raises(tmp_path):
    path = _ckpt(tmp_path)
    with pytest.raises(CheckpointCorruptError, match="lacks leaf"):
        load_checkpoint(path, like_tree={"a": torch.zeros(4),
                                         "extra": torch.zeros(1)})


def test_overwrite_is_atomic_replacement(tmp_path):
    """Saving over a checkpoint swaps the whole directory: the result is
    exactly the new save, with no stale files and no leftover temp or
    doomed siblings."""
    path = _ckpt(tmp_path, step=1)
    save_checkpoint(path, {"a": torch.full((4,), 9.0)}, step=2)
    restored, manifest = load_checkpoint(path, {"a": torch.zeros(4)})
    assert manifest["step"] == 2
    assert torch.equal(restored["a"], torch.full((4,), 9.0))
    assert sorted(os.listdir(path)) == ["arrays.npz", "manifest.json"]
    assert os.listdir(str(tmp_path)) == ["c"]


# ---------------------------------------------------------------------------
# Exact resume
# ---------------------------------------------------------------------------

RESUME_SPECS = {
    "ltadmm": "ltadmm:tau=3,compressor=qbit:bits=8",
    "ltadmm-faulted": "ltadmm:tau=3,compressor=qbit:bits=8,faults=" + HEAVY,
    "ltadmm-tree": "ltadmm:tau=3,packed=false,compressor=qbit:bits=8",
    "dsgd": "dsgd:lr=0.1",
    "choco": "choco:lr=0.1,compressor=qbit:bits=8",
    "lead": "lead:lr=0.1,compressor=qbit:bits=8",
    "cold": "cold:lr=0.1,compressor=randk:fraction=0.5,sampler=block",
    "cedas": "cedas:lr=0.1,compressor=qbit:bits=4",
    "dpdc": "dpdc:lr=0.1,compressor=qbit:bits=8",
}


def _port(spec):
    est = (vr.SagaTable(sample_grads=PROB.sample_grads, m=PROB.m)
           if spec.startswith("ltadmm") else
           paper_fig2._estimator("sgd", PROB))
    return solver.make_solver(spec, topology.Ring(PROB.n_agents), None, est,
                              device="cpu")


def _advance(s, st, first, n):
    for r in range(first, first + n):
        st = s.step(st, DATA, jaxrand.key(1000 + r))
    return st


def _x0():
    return torch.zeros(PROB.n_agents, PROB.n)


@pytest.mark.parametrize("name", list(RESUME_SPECS))
def test_resume_is_bitwise_exact(tmp_path, name):
    """A stop after k1 rounds, a checkpoint, and a fresh solver restoring
    it continue the exact trajectory: round keys are functions of the
    round index and every persistent state lives in the state tree."""
    spec = RESUME_SPECS[name]
    k1, k2 = 3, 2
    whole = _advance(_port(spec), _port(spec).init(_x0()), 0, k1 + k2)
    s = _port(spec)
    st = _advance(s, s.init(_x0()), 0, k1)
    save_checkpoint(tmp_path / "mid", st, step=k1)
    fresh = _port(spec)
    restored, manifest = load_checkpoint(tmp_path / "mid",
                                         like_tree=fresh.init(_x0()))
    assert manifest["step"] == k1
    resumed = _advance(fresh, restored, k1, k2)
    a, b = flatten_with_paths(whole), flatten_with_paths(resumed)
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], int):
            assert a[k] == b[k] == k1 + k2
            continue
        assert a[k].dtype == b[k].dtype
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# Across packages
# ---------------------------------------------------------------------------

CROSS = {
    "ltadmm-faulted": ("ltadmm:compressor=qbit:bits=8,impl={},faults="
                       + HEAVY, ("jnp", "torch")),
    "lead": ("lead:lr=0.1,compressor=qbit:bits=8,impl={}",
             ("jnp", "torch")),
}


def _ref(spec):
    est = (jvr.SagaTable(sample_grad=JPROB.sample_grad, m=JPROB.m)
           if spec.startswith("ltadmm") else
           jvr.PlainSgd(batch_grad=JPROB.batch_grad))
    return jsolver.make_solver(spec, JGRAPH, JEX, est)


def _close(got, want, what):
    """Port tree against reference tree, leaf by leaf, by path."""
    g = flatten_with_paths(got)
    w = jstore._flatten_with_paths(want)[0]
    assert sorted(g) == sorted(w), what
    for k in g:
        if isinstance(g[k], int):
            assert g[k] == int(w[k]), (what, k)
            continue
        np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=f"{what} {k}")


@pytest.mark.parametrize("name", list(CROSS))
def test_checkpoints_cross_both_ways(tmp_path, name):
    spec, (jimpl, impl) = CROSS[name]
    js, ts = _ref(spec.format(jimpl)), _port(spec.format(impl))
    jstep = jax.jit(lambda s, k: js.step(s, JDATA, k))
    x0 = jnp.zeros((PROB.n_agents, PROB.n))

    # the reference writes after 3 rounds; the port resumes from it
    jst = js.init(x0)
    for r in range(3):
        jst = jstep(jst, jax.random.key(1000 + r))
    jstore.save_checkpoint(tmp_path / "ref", jst, step=3)
    tst, manifest = load_checkpoint(tmp_path / "ref",
                                    like_tree=ts.init(_x0()))
    k = tst["k"] if isinstance(tst, dict) else tst.k
    assert manifest["step"] == 3 == k
    got = ts.step(tst, DATA, jaxrand.key(1003))
    _close(got, jstep(jst, jax.random.key(1003)), "reference -> port")

    # the port writes after 3 rounds of its own; the reference resumes
    pst = _advance(ts, ts.init(_x0()), 0, 3)
    save_checkpoint(tmp_path / "port", pst, step=3)
    restored, manifest = jstore.load_checkpoint(
        tmp_path / "port", like_tree=jax.eval_shape(js.init, x0))
    assert manifest["step"] == 3
    want = jstep(jax.tree.map(jnp.asarray, restored), jax.random.key(1003))
    _close(ts.step(pst, DATA, jaxrand.key(1003)), want, "port -> reference")
