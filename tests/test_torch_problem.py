"""The port's problem, estimators and packed plane against the reference
on the reference's data: sample/batch/global gradients, SAGA, SVRG,
full-gradient and plain-SGD estimates, Newton's x*, and pack/unpack.
Float32 sums are reassociated, so gradients agree within rtol 1e-5 /
atol 1e-6; integer layouts are equal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import packing as jpacking  # noqa: E402
from repro.core import vr as jvr  # noqa: E402
from repro.problems.logistic import LogisticProblem as JProblem  # noqa: E402
from repro_torch.core import packing, vr  # noqa: E402
from repro_torch.problems.logistic import LogisticProblem  # noqa: E402

JPROB, PROB = JProblem(), LogisticProblem()
JDATA = JPROB.make_data(jax.random.key(0))
DATA = {k: torch.from_numpy(np.array(v)) for k, v in JDATA.items()}
X = np.random.RandomState(0).standard_normal((10, 5)).astype(np.float32)
PHI = X + np.float32(0.01)
IDX = np.random.RandomState(1).randint(0, 100, size=(10, 3))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_gradients_match():
    per_sample = jax.vmap(lambda x, d: jax.vmap(
        lambda s: JPROB.sample_grad(x, s))(d))(jnp.asarray(X), JDATA)
    _close(PROB.sample_grads(torch.from_numpy(X), DATA), per_sample)
    batch = jax.vmap(JPROB.batch_grad)(jnp.asarray(X), JDATA)
    _close(PROB.batch_grad(torch.from_numpy(X), DATA), batch)
    x0 = X[0]
    _close(PROB.global_grad_norm_sq(torch.from_numpy(x0), DATA),
           JPROB.global_grad_norm_sq(jnp.asarray(x0), JDATA))
    _close(PROB.global_loss(torch.from_numpy(x0), DATA),
           JPROB.global_loss(jnp.asarray(x0), JDATA))


def test_solve_opt_matches():
    xs, _ = PROB.solve_opt(DATA)
    jxs, _ = JPROB.solve_opt(JDATA)
    np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), atol=1e-5)
    assert float(PROB.global_grad_norm_sq(xs, DATA)) < 1e-12


ESTIMATORS = {
    "saga": (lambda: jvr.SagaTable(sample_grad=JPROB.sample_grad, m=100),
             lambda: vr.SagaTable(sample_grads=PROB.sample_grads, m=100)),
    "svrg": (lambda: jvr.SvrgAnchor(batch_grad=JPROB.batch_grad,
                                    full_grad=JPROB.full_grad),
             lambda: vr.SvrgAnchor(batch_grad=PROB.batch_grad,
                                   full_grad=PROB.full_grad)),
    "full": (lambda: jvr.FullGrad(full_grad=JPROB.full_grad),
             lambda: vr.FullGrad(full_grad=PROB.full_grad)),
    "sgd": (lambda: jvr.PlainSgd(batch_grad=JPROB.batch_grad),
            lambda: vr.PlainSgd(batch_grad=PROB.batch_grad)),
}


@pytest.mark.parametrize("name", sorted(ESTIMATORS))
def test_estimators_match(name):
    jest, test_ = (f() for f in ESTIMATORS[name])

    def one(x, phi, d, idx):
        st = jest.reset(x, d)
        g1, st = jest.estimate(st, phi, d, idx[:1])
        g2, _ = jest.estimate(st, phi * 2, d, idx)
        return g1, g2

    jg1, jg2 = jax.vmap(one)(jnp.asarray(X), jnp.asarray(PHI), JDATA,
                             jnp.asarray(IDX))
    st = test_.reset(torch.from_numpy(X), DATA)
    idx = torch.from_numpy(IDX)
    g1, st = test_.estimate(st, torch.from_numpy(PHI), DATA, idx[:, :1])
    g2, _ = test_.estimate(st, torch.from_numpy(PHI) * 2, DATA, idx)
    _close(g1, jg1)
    _close(g2, jg2)


def test_pack_unpack_match_reference():
    tree = {"w": np.arange(24, dtype=np.float32).reshape(2, 3, 4),
            "b": np.ones((2, 5), np.float32),
            "c": [np.full((2, 2), 3.0, np.float32)]}
    ttree = jax.tree.map(torch.from_numpy, tree)
    lay = packing.layout_of_stacked(ttree)
    jlay = jpacking.layout_of_stacked(jax.tree.map(jnp.asarray, tree))
    assert lay.size == jlay.size == 19 and not lay.is_trivial
    flat = packing.pack(lay, ttree)
    np.testing.assert_array_equal(
        flat.numpy(), np.asarray(jpacking.pack(jlay, jax.tree.map(
            jnp.asarray, tree))))
    back = packing.unpack(lay, flat)
    for k in ("w", "b"):
        np.testing.assert_array_equal(back[k].numpy(), tree[k])
    np.testing.assert_array_equal(back["c"][0].numpy(), tree["c"][0])
    assert packing.layout_of(torch.zeros(7)).is_trivial


def test_make_data_matches():
    """``make_data`` is the reference's ``make_data``: labels bit for
    bit, features within 1e-6 (``jaxrand.normal``'s few ulp)."""
    got = PROB.make_data(0)
    np.testing.assert_array_equal(got["b"].numpy(), np.asarray(JDATA["b"]))
    np.testing.assert_allclose(got["a"].numpy(), np.asarray(JDATA["a"]),
                               rtol=0, atol=1e-6)
