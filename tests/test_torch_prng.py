"""The port's Threefry counter PRNG (``repro_torch.kernels.prng``) against
the reference (``repro.kernels.prng``) and the independent pure-Python
model of ``tests/test_prng_properties.py``, bit for bit, over the full
uint32 range."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import prng as jprng  # noqa: E402
from repro_torch.kernels import prng  # noqa: E402

RNG = np.random.RandomState(0)
# full uint32 range, with the edges and values >= 2^31 the reference's
# Python-int path rejects
WORDS = np.concatenate([
    np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 1, 2 ** 32 - 1],
             dtype=np.uint32),
    RNG.randint(0, 2 ** 32, size=250, dtype=np.uint64).astype(np.uint32),
])


def _quad(shift):
    return [np.roll(WORDS, shift * i) for i in range(4)]


def _np(t):
    return np.asarray(t).astype(np.int64)


def _model():
    try:
        from test_prng_properties import _np_threefry2x32
    except ImportError:  # the model's module needs hypothesis
        pytest.skip("the independent Python model needs hypothesis")
    return _np_threefry2x32


@pytest.mark.parametrize("path", ["host", "torch"])
def test_threefry_bit_equal_to_reference_and_model(path):
    k0, k1, c0, c1 = _quad(7)
    fn = prng.threefry2x32 if path == "host" else prng.threefry2x32_torch
    args = [torch.from_numpy(a.astype(np.int64)) for a in (k0, k1, c0, c1)]
    got0, got1 = fn(*args)
    want0, want1 = jprng.threefry2x32(k0, k1, c0, c1)  # uint32 arrays
    np.testing.assert_array_equal(got0.numpy(), _np(want0))
    np.testing.assert_array_equal(got1.numpy(), _np(want1))
    model = _model()
    for i in range(0, len(WORDS), 5):
        w = model(int(k0[i]), int(k1[i]), int(c0[i]), int(c1[i]))
        assert (int(got0[i]), int(got1[i])) == w


def test_threefry_accepts_python_ints_past_int32():
    model = _model()
    got = prng.threefry2x32(3_000_000_000, 2 ** 32 - 1, 2 ** 31, 7)
    assert tuple(int(t) for t in got) == model(3_000_000_000, 2 ** 32 - 1,
                                               2 ** 31, 7)


def test_derivations_bit_equal_to_reference():
    s0, s1, a, b = _quad(3)
    seed_t = (torch.from_numpy(s0.astype(np.int64)),
              torch.from_numpy(s1.astype(np.int64)))
    ids = (torch.from_numpy(a.astype(np.int64)),
           torch.from_numpy(b.astype(np.int64)))
    es = prng.fold(seed_t, *ids)
    jes = jprng.fold((s0, s1), a, b)
    for g, w in zip(es, jes):
        np.testing.assert_array_equal(g.numpy(), _np(w))
    jbc = jprng.message_seed((s0, s1), a)
    for g, w in zip(prng.message_seed(seed_t, ids[0]), jbc):
        np.testing.assert_array_equal(g.numpy(), _np(w))
    ctr = np.arange(len(WORDS), dtype=np.uint32) * np.uint32(2654435761)
    bits = prng.random_bits(es, torch.from_numpy(ctr.astype(np.int64)))
    jbits = jprng.random_bits(jes, ctr)
    np.testing.assert_array_equal(bits.numpy(), _np(jbits))
    np.testing.assert_array_equal(prng.uniform01(bits).numpy(),
                                  np.asarray(jprng.uniform01(jbits)))
    for n in (1, 5, 1_000_003, 2 ** 20):
        np.testing.assert_array_equal(prng.derive_offset(es, n).numpy(),
                                      _np(jprng.derive_offset(jes, n)))
        np.testing.assert_array_equal(
            prng.derive_stride_slot(es, 64).numpy(),
            _np(jprng.derive_stride_slot(jes, 64)))


def test_uniform01_rounds_to_one_like_xla():
    top = np.array([2 ** 32 - 1, 2 ** 32 - 128, 2 ** 32 - 129, 0],
                   dtype=np.uint32)
    got = prng.uniform01(torch.from_numpy(top.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, np.asarray(jprng.uniform01(top)))
    assert got[0] == 1.0 and got[1] == 1.0 and got[2] < 1.0


@pytest.mark.parametrize("n", [1, 2, 5, 97, 1024, 1_000_003, 2 ** 20])
def test_coprime_strides_equal(n):
    assert prng.coprime_strides(n) == jprng.coprime_strides(n)


@pytest.mark.parametrize("n,k", [(3000, 1100), (1_000_000, 100_000)])
def test_affine_indices_equal_reference_including_int32_wrap(n, k):
    strides = prng.coprime_strides(n)
    wrapped = 0
    for s in range(4):
        seed = (np.uint32(1000 + s), np.uint32(77 * s))
        want = np.asarray(jprng.affine_indices(seed, n, k, strides))
        got = prng.affine_indices((int(seed[0]), int(seed[1])), n, k,
                                  strides).numpy()
        np.testing.assert_array_equal(got, want)
        off = int(jprng.derive_offset(seed, n))
        st = strides[int(jprng.derive_stride_slot(seed, len(strides)))]
        exact = (off + np.arange(k, dtype=np.int64) * st) % n
        wrapped += int((exact != got).any())
    if n == 1_000_000:
        assert wrapped == 4  # the int32 wrap is exercised, and reproduced


def test_threefry_bits_plain_path_is_the_composition():
    seed = (123, 2 ** 32 - 5)
    sids = prng.u32([0, 2 ** 31 + 3, 9]).to(torch.int32)
    rids = prng.u32([prng.BROADCAST, 4, 2 ** 32 - 2]).to(torch.int32)
    ctr = prng.u32([0, 1, 2 ** 31, 2 ** 32 - 1]).to(torch.int32)
    bits, off, slot = prng.threefry_bits(seed, sids, rids, ctr, n=1_000_003,
                                         n_strides=64)
    for b in range(3):
        es = jprng.fold((np.uint32(seed[0]), np.uint32(seed[1])),
                        np.uint32(int(sids[b]) & prng.MASK),
                        np.uint32(int(rids[b]) & prng.MASK))
        jctr = (ctr.numpy().astype(np.int64) & prng.MASK).astype(np.uint32)
        np.testing.assert_array_equal(bits[b].numpy(),
                                      _np(jprng.random_bits(es, jctr)))
        assert int(off[b]) == int(jprng.derive_offset(es, 1_000_003))
        assert int(slot[b]) == int(jprng.derive_stride_slot(es, 64))
