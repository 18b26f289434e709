"""``repro_torch.core.jaxrand`` against ``jax.random`` (threefry,
``jax_threefry_partitionable=True``): keys, fold_in, split, bits,
randint, uniform, bernoulli and permutation are bit-equal, single and
batched."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.core import jaxrand as jr  # noqa: E402

SEEDS = [0, 7, 12345, -1]
SHAPES = [(), (7,), (3, 5)]


def test_mode_is_partitionable():
    # the mode the port reproduces; the reference runs in the default
    assert jax.config.jax_threefry_partitionable


def _kd(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split(seed):
    jk, tk = jax.random.key(seed), jr.key(seed)
    np.testing.assert_array_equal(tk.numpy(), _kd(jk))
    for d in (0, 3, 2 ** 31 + 1, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            jr.fold_in(tk, d).numpy(), _kd(jax.random.fold_in(jk,
                                                             np.uint32(d))))
    np.testing.assert_array_equal(jr.split(tk, 5).numpy(),
                                  _kd(jax.random.split(jk, 5)))
    assert jr.key_seed(tk) == tuple(int(w) for w in _kd(jk))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_uniform_bernoulli(seed, shape):
    jk, tk = jax.random.key(seed), jr.key(seed)
    np.testing.assert_array_equal(
        jr.bits(tk, shape).numpy(),
        np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64))
    np.testing.assert_array_equal(jr.uniform(tk, shape).numpy(),
                                  np.asarray(jax.random.uniform(jk, shape)))
    np.testing.assert_array_equal(
        jr.bernoulli(tk, 0.5, shape).numpy(),
        np.asarray(jax.random.bernoulli(jk, 0.5, shape)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("bounds", [(0, 100), (0, 5), (-3, 1_000_003),
                                    (4, 4), (0, 1_000_006)])
def test_randint(seed, bounds):
    jk, tk = jax.random.key(seed), jr.key(seed)
    for shape in SHAPES:
        np.testing.assert_array_equal(
            jr.randint(tk, shape, *bounds).numpy(),
            np.asarray(jax.random.randint(jk, shape, *bounds)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 5, 100, 3000])
def test_permutation(seed, n):
    np.testing.assert_array_equal(
        jr.permutation(jr.key(seed), n).numpy(),
        np.asarray(jax.random.permutation(jax.random.key(seed), n)))


def test_batched_keys_match_vmap():
    ids = jnp.arange(4)
    ks = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(3), i))(ids)
    tks = jr.fold_in(jr.key(3), torch.arange(4))
    np.testing.assert_array_equal(tks.numpy(), _kd(ks))
    np.testing.assert_array_equal(
        jr.uniform(tks, (6,)).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (6,)))(ks)))
    np.testing.assert_array_equal(
        jr.randint(tks, (2,), 0, 100).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.randint(k, (2,), 0, 100))(
            ks)))
    np.testing.assert_array_equal(
        jr.permutation(tks, 9).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.permutation(k, 9))(ks)))
    np.testing.assert_array_equal(
        jr.split(tks, 3).numpy(),
        _kd(jax.vmap(lambda k: jax.random.split(k, 3))(ks)))


@pytest.mark.parametrize("seed", [0, 7])
def test_normal_within_a_few_ulp(seed):
    """``normal``'s uniform draw is bit-exact; XLA's erf_inv polynomial is
    repeated, and XLA may contract its multiply-adds: at most 8 ulp
    apart, most values equal."""
    shape = (10, 100, 5)
    want = np.asarray(jax.random.normal(jax.random.key(seed), shape,
                                        jnp.float32))
    got = jr.normal(jr.key(seed), shape).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    ulp = np.abs(got.view(np.int32).astype(np.int64)
                 - want.view(np.int32).astype(np.int64))
    assert ulp.max() <= 8
    assert (ulp == 0).mean() > 0.9
