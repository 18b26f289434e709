"""The port's MoE block (``repro_torch.models.moe``) and granite-moe-1b-a400m
against the reference (``src/repro/models/moe.py``), on the same numpy
inputs in f32:

* ``_capacity`` and top-k's order: values descending, equal values to the
  lower expert, as ``jax.lax.top_k`` breaks ties (a router of zeros makes
  every probability equal: the first top_k experts are picked);
* ``moe_forward`` with and without shared experts, at the default
  capacity and at one so small that most pairs are dropped: y within
  1e-6 of the reference's relative to its largest (the reference's
  fan-in init over the expert axis makes y ~100; measured ~4e-7), aux
  within 1e-6 (measured 0), and every gradient of ``sum(y * w) + aux``
  within 1e-5 of ``jax.grad``'s relative to the leaf's largest
  (measured ~1e-7);
* granite's init, prefill, decode and greedy serving are held in
  tests/test_torch_models.py, whose SERVED list holds it.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402
from repro.models.common import init_params as jinit  # noqa: E402
from repro_torch.common.trees import tree_flatten, tree_map  # noqa: E402
from repro_torch.models import moe  # noqa: E402

# see tests/test_torch_ssd.py: torch 2.13.0+cpu's first exp of a process
torch.exp(torch.linspace(-20.0, 20.0, 50_000))


def _pair(cfg):
    return jmoe.MoEConfig(**dataclasses.asdict(cfg)), cfg


def _weights(jcfg, seed):
    """Reference-initialised weights (jax tree, numpy tree)."""
    p = jinit(jax.random.key(seed), jmoe.moe_specs(jcfg))
    return p, jax.tree.map(np.asarray, p)


@pytest.mark.parametrize("n,e,k,cf", [(32, 4, 2, 1.25), (7, 32, 8, 1.25),
                                      (4096, 32, 8, 1.25), (5, 8, 8, 0.1)])
def test_capacity_matches_reference(n, e, k, cf):
    jcfg, cfg = _pair(moe.MoEConfig(64, e, k, 32, capacity_factor=cf))
    assert moe._capacity(n, cfg) == jmoe._capacity(n, jcfg)


def test_top_k_breaks_ties_as_jax():
    rng = np.random.default_rng(0)
    # few distinct values: many ties in every row
    p = rng.integers(0, 4, (64, 16)).astype(np.float32)
    wv, wi = jax.lax.top_k(jnp.asarray(p), 5)
    gv, gi = moe.top_k(torch.from_numpy(p), 5)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_equal_router_probs_pick_the_first_experts():
    jcfg, cfg = _pair(moe.MoEConfig(16, 8, 3, 8))
    _, np_p = _weights(jcfg, 1)
    np_p = dict(np_p, router=np.zeros_like(np_p["router"]))
    x = np.random.default_rng(2).standard_normal((2, 5, 16), np.float32)
    want_y, want_aux = jax.jit(lambda p, xx: jmoe.moe_forward(p, jcfg, xx))(
        jax.tree.map(jnp.asarray, np_p), jnp.asarray(x))
    got_y, got_aux = moe.moe_forward(tree_map(torch.from_numpy, np_p), cfg,
                                     torch.from_numpy(x))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=1e-5,
                               rtol=0)
    assert abs(float(got_aux) - float(want_aux)) <= 1e-6


CASES = {
    "granite-smoke": dict(d_model=128, n_experts=4, top_k=2, d_ff_expert=64),
    "shared-experts": dict(d_model=64, n_experts=8, top_k=3, d_ff_expert=32,
                           n_shared=2),
    "drops": dict(d_model=64, n_experts=8, top_k=2, d_ff_expert=32,
                  capacity_factor=0.25),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_forward_and_grads_match_reference(case):
    jcfg, cfg = _pair(moe.MoEConfig(**CASES[case]))
    jp, np_p = _weights(jcfg, 3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, cfg.d_model), np.float32)
    w = rng.standard_normal((2, 16, cfg.d_model), np.float32)
    if case == "drops":
        cap = moe._capacity(32, cfg)
        assert cap < 32 * cfg.top_k // cfg.n_experts  # some pairs drop

    def jloss(p, xx):
        y, aux = jmoe.moe_forward(p, jcfg, xx)
        return jnp.sum(y * w) + aux, (y, aux)

    (_, (want_y, want_aux)), (jg, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    tp = tree_map(lambda a: torch.from_numpy(a.copy()).requires_grad_(),
                  np_p)
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = moe.moe_forward(tp, cfg, tx)
    want_y = np.asarray(want_y)
    np.testing.assert_allclose(y.detach().numpy(), want_y,
                               atol=1e-6 * np.abs(want_y).max(), rtol=0)
    assert aux.dtype == torch.float32
    assert abs(float(aux) - float(want_aux)) <= 1e-6
    leaves = tree_flatten(tp)[0] + [tx]
    grads = torch.autograd.grad(torch.sum(y * torch.from_numpy(w)) + aux,
                                leaves)
    for g, want in zip(grads, jax.tree.leaves(jg) + [jgx]):
        want = np.asarray(want)
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(g.numpy() - want).max()) <= 1e-5 * scale
