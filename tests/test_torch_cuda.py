"""The port's CUDA kernels against their plain PyTorch versions on the
card, bit for bit, and the paper problem through them.  These tests need
an sm_90 card and nvcc; elsewhere they skip (decided in the ``h100``
fixture, so every pytest worker collects the same tests).  On the card
(``--noconftest``: the suite's conftest imports JAX, which the port's
machine need not have):

    PYTHONPATH=src python -m pytest -q -m needs_h100 --noconftest \
        tests/test_torch_cuda.py
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import jaxrand  # noqa: E402
from repro_torch.kernels import prng  # noqa: E402
from repro_torch.kernels.quantize import ops as q_ops  # noqa: E402
from repro_torch.kernels.quantize import ref as q_ref  # noqa: E402
from repro_torch.kernels.sparse_gather import ops as sg_ops  # noqa: E402
from repro_torch.kernels.sparse_gather import ref as sg_ref  # noqa: E402
from repro_torch.kernels.tolerance import bf16_ulps  # noqa: E402

pytestmark = pytest.mark.needs_h100

SEED = jaxrand.key_seed(jaxrand.fold_in(jaxrand.key(7), 13))


@pytest.fixture(scope="module")
def h100():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs an sm_90 card")
    from repro_torch.kernels import _build

    try:
        _build.nvcc()
    except RuntimeError as e:
        pytest.skip(str(e))
    _build.build()
    return torch.device("cuda")


def _ids(dev, a=10, s=2):
    sid = torch.arange(a, device=dev)[:, None].expand(a, s).reshape(-1)
    rid = (sid + 1 + torch.arange(s, device=dev).repeat(a)) % a
    return sid.to(torch.int32), rid.to(torch.int32)


def test_threefry_bits(h100):
    sids = prng.u32([0, 2 ** 31, 2 ** 32 - 1, 77], h100).to(torch.int32)
    rids = prng.u32([prng.BROADCAST, 1, 2 ** 31 + 9, 3], h100).to(torch.int32)
    ctr = ((torch.arange(65536, device=h100) * 7919 + 2 ** 31)
           & prng.MASK).to(torch.int32)
    got = prng.threefry_bits(SEED, sids, rids, ctr, n=1_000_003, n_strides=64)
    want = prng._threefry_bits_ref(SEED, sids, rids, ctr, 1_000_003, 64)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _same_scale(got, want):
    """Scales bit for bit, a NaN matching a NaN whatever its payload."""
    nan = torch.isnan(want)
    return (torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan].view(torch.int32),
                            want[~nan].view(torch.int32)))


def _plant_k1_saturation(x, sid, rid, levels, first):
    """Rows from ``first`` on: the row's max |x| (a power of two) at the
    first element whose kappa lifts ``levels`` to ``levels + 1``."""
    n = x.shape[1]
    es = prng.fold(SEED, prng.u32(sid), prng.u32(rid))
    kappa = prng.uniform01(prng.random_bits(
        (es[0][:, None], es[1][:, None]),
        torch.arange(n, device=x.device)[None]))
    hit = (torch.tensor(float(levels), device=x.device) + kappa) == levels + 1
    hit[:first] = False
    rows = torch.nonzero(hit.any(dim=1)).reshape(-1)
    cols = torch.argmax(hit.to(torch.int8), dim=1)[rows]
    x[rows, cols] = 2.0 ** math.ceil(math.log2(2 * float(
        x[first:].abs().max())))
    return rows


def _k1_ids(m, dev):
    sid = (torch.arange(m, device=dev) // 2).to(torch.int32)
    rid = ((torch.arange(m, device=dev) * 7 + 1) % 15).to(torch.int32)
    return sid, rid


QUANT_N = [5, 4096, 8191, 8193, 1_000_003, 2 ** 20]


@pytest.mark.parametrize("m", [1, 20, 150])
@pytest.mark.parametrize("n", QUANT_N)
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_plane(h100, n, m, bits):
    """The fused K1 (scale and levels in one launch) bit-equal to its
    plain version, q and scale, per-edge and broadcast receivers, and
    ``dequantize_plane`` (K5's division form) on its output: the
    quantiser's edge rows (``ref.EDGE_ROWS``: subnormals, a max below 127
    tiny, +-0, NaN, +-inf, the max last; for m = 1 the max-last row), and
    saturating elements planted in the other rows."""
    sid, rid = _k1_ids(m, h100)
    x = torch.randn((m, n), generator=torch.Generator(h100).manual_seed(n),
                    device=h100)
    if m == 1:
        x[0, -1] = 2 * float(x.abs().max())
    else:
        q_ref.edge_rows(x)
    first = len(q_ref.EDGE_ROWS) if m > 1 else 0
    _plant_k1_saturation(x, sid, rid, 2 ** (bits - 1) - 1, first)
    for rids in (rid, None):
        before = q_ops.quantize_plane.launches
        q, sc = q_ops.quantize_plane(SEED, sid, rids, x, bits=bits)
        assert q_ops.quantize_plane.launches == before + 1
        qw, scw = q_ref.quantize_plane_ref(SEED, sid, rids, x, bits=bits)
        assert torch.equal(q, qw) and _same_scale(sc, scw)
    # the plane route's dequantiser: K5's kernel in its division form
    before = q_ops.dequantize_plane.launches
    out = q_ops.dequantize_plane(q, sc, n=n, bits=bits)
    assert q_ops.dequantize_plane.launches == before + 1
    want = q_ref.dequantize_plane_ref(q, sc, n=n, bits=bits)
    assert _same_scale(out.reshape(-1), want.reshape(-1))


def test_quantize_plane_calls_and_streams(h100):
    """Ten back-to-back K1 calls on one stream (each call's scratch zeroed
    anew), then calls on two streams at once (a scratch per call), each
    output bit-equal to the plain version."""
    m, n = 20, 2 ** 20
    sid, rid = _k1_ids(m, h100)
    g = torch.Generator(h100).manual_seed(5)
    xs = [torch.randn((m, n), generator=g, device=h100) for _ in range(10)]
    outs = [q_ops.quantize_plane(SEED, sid, rid, x, bits=8) for x in xs]
    torch.cuda.synchronize()
    for x, (q, sc) in zip(xs, outs):
        qw, scw = q_ref.quantize_plane_ref(SEED, sid, rid, x, bits=8)
        assert torch.equal(q, qw) and torch.equal(sc, scw)
    streams = [torch.cuda.Stream() for _ in range(2)]
    torch.cuda.synchronize()
    outs = []
    for i, x in enumerate(xs[:6]):
        with torch.cuda.stream(streams[i % 2]):
            outs.append(q_ops.quantize_plane(SEED, sid, rid, x,
                                             bits=4 if i % 3 else 8))
    torch.cuda.synchronize()
    for i, (x, (q, sc)) in enumerate(zip(xs, outs)):
        qw, scw = q_ref.quantize_plane_ref(SEED, sid, rid, x,
                                           bits=4 if i % 3 else 8)
        assert torch.equal(q, qw) and torch.equal(sc, scw)


@pytest.mark.parametrize("m", [1, 257])
def test_quantize_tensor_host_keys(h100, m):
    """K4 with host keys (copied to the card through pinned memory without
    a wait for the stream), bit-equal to the plain version."""
    keys = jaxrand.split(jaxrand.key(m), m)
    x = torch.randn((m, 3000), device=h100)
    q, sc = q_ops.quantize_tensor(keys, x, bits=8)
    qw, scw = q_ref.quantize_tensor_ref(keys, x, bits=8)
    assert torch.equal(q, qw) and torch.equal(sc, scw)


def _shard_tree_layouts(n_leaves):
    """Rank 1 of 2's layouts of a tree of ``n_leaves`` leaves cycling over
    every index class of K4's shard form and a leaf held whole."""
    from repro_torch.launch import sharding as shd

    plans = (((6, 10), shd.LeafPlan(0, ((6, True),))),
             ((7,), shd.LeafPlan(None)),
             ((5, 12), shd.LeafPlan(1, ((12, True),))),
             ((4, 6, 3), shd.LeafPlan(1, ((6, True),))),
             ((3, 552), shd.LeafPlan(1, ((256, True), (256, True),
                                         (32, False), (8, True)))),
             ((3, 14), shd.LeafPlan(1, ((14, True),))),
             ((2, 9000), shd.LeafPlan(1, ((9000, True),))))
    return tuple(shd.leaf_layout(plans[i % len(plans)][1],
                                 plans[i % len(plans)][0], 1, 2)
                 for i in range(n_leaves))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("n_leaves,where", [(7, "cpu"), (7, "cuda"),
                                            (140, "cpu")])
def test_quantize_tree(h100, bits, n_leaves, where):
    """K4's shard form over a tree of every index class (host keys, device
    keys, and a tree past one launch's leaves): each pass bit-equal to
    its plain version, one launch a pass for each ``MAX_LEAVES`` leaves,
    the cut leaves' words from ``reduced``."""
    lays = _shard_tree_layouts(n_leaves)
    m = 3
    g = torch.Generator(device=h100).manual_seed(n_leaves)
    xs = [torch.randn((m, math.prod(lay.local_shape)), generator=g,
                      device=h100) for lay in lays]
    keys = torch.randint(0, 2 ** 32, (m, n_leaves, 2), dtype=torch.int64,
                         generator=g, device=h100).to(where)
    launches = -(-n_leaves // q_ops.MAX_LEAVES)
    before = q_ops.tree_absmax.launches, q_ops.quantize_tree.launches
    words = q_ops.tree_absmax(xs, lays)
    assert torch.equal(words, q_ref.tree_absmax_ref(xs, lays))
    cut = q_ops.cut_rows(lays, m)
    reduced = torch.maximum(words[:cut], words[:cut].flip(0))
    got = q_ops.quantize_tree(keys, xs, words, lays, bits=bits,
                              reduced=reduced)
    want = q_ref.quantize_tree_ref(keys, xs, words, lays, bits=bits,
                                   reduced=reduced)
    torch.cuda.synchronize()
    assert (q_ops.tree_absmax.launches - before[0],
            q_ops.quantize_tree.launches - before[1]) == (launches, launches)
    for (q, sc), (qw, scw) in zip(got, want, strict=True):
        assert torch.equal(q, qw)
        assert torch.equal(sc.view(torch.int32), scw.view(torch.int32))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantizers_misaligned_and_strided_rows(h100, bits):
    """A contiguous row view one float past a 16-byte boundary is read
    correctly (K1 and K4 go element by element there); an odd-strided
    view is refused."""
    m, n = 20, 8192 + 8
    base = torch.randn((m * n + 1,), device=h100)
    x = base[1:].view(m, n)
    assert x.data_ptr() % 16 == 4
    sid, rid = _k1_ids(m, h100)
    q, sc = q_ops.quantize_plane(SEED, sid, rid, x, bits=bits)
    qw, scw = q_ref.quantize_plane_ref(SEED, sid, rid, x, bits=bits)
    assert torch.equal(q, qw) and torch.equal(sc, scw)
    keys = torch.randint(0, 2 ** 32, (m, 2), device=h100)
    q, sc = q_ops.quantize_tensor(keys, x, bits=bits)
    qw, scw = q_ref.quantize_tensor_ref(keys, x, bits=bits)
    assert torch.equal(q, qw) and torch.equal(sc, scw)
    strided = torch.randn((m, 2 * n), device=h100)[:, ::2]
    with pytest.raises(ValueError):
        q_ops.quantize_plane(SEED, sid, rid, strided, bits=bits)
    with pytest.raises(ValueError):
        q_ops.quantize_tensor(keys, strided, bits=bits)


@pytest.mark.parametrize("n", [2 ** 20, 100_003])
@pytest.mark.parametrize("sampler", ["block", "stride"])
def test_randk_plane(h100, n, sampler):
    """K2/K3 bit for bit (-0.0 kept) against their plain versions: the
    pull variant at 2^20 and for the block sampler, the push variant at
    100,003 with the stride sampler, whose int32 sum wraps; each
    variant's counter shows which ran."""
    sid, rid = _ids(h100)
    k = n // 4
    strides = (1,) if sampler == "block" else prng.coprime_strides(n)
    kind = "push" if (n, sampler) == (100_003, "stride") else "pull"
    assert sg_ops.variant(n, k, strides) == kind
    x = torch.randn((20, n), device=h100)
    x[:, ::7] = -0.0
    counts = {(f, a): getattr(f, a) for f in (sg_ops.randk_gather_plane,
                                              sg_ops.randk_scatter_plane)
              for a in ("launches", "launches_pull", "launches_push")}
    v = sg_ops.randk_gather_plane(SEED, sid, rid, x, k=k, strides=strides)
    want_v = sg_ref.randk_gather_plane_ref(SEED, sid, rid, x, k=k,
                                           strides=strides)
    assert torch.equal(v.view(torch.int32), want_v.view(torch.int32))
    assert bool(((v == 0) & torch.signbit(v)).any())  # -0.0 carried
    out = sg_ops.randk_scatter_plane(SEED, sid, rid, v, n=n, gain=n / k,
                                     strides=strides)
    want = sg_ref.randk_scatter_plane_ref(SEED, sid, rid, v, n=n,
                                          gain=n / k, strides=strides)
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))
    for (f, a), c in counts.items():
        ran = a == "launches" or a == f"launches_{kind}"
        assert getattr(f, a) == c + ran, (f.__name__, a)


# raw keys whose jax.random.bits word at element j rounds kappa to 1.0
SATURATING_KEYS = ((543808644, 1486979388, 944), (3917027860, 3836244836, 966),
                   (781517975, 2568259190, 493), (1025103629, 3342442247, 743))


@pytest.mark.parametrize("m", [1, 20, 150])
@pytest.mark.parametrize("n", QUANT_N)
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_tensor(h100, n, m, bits):
    """The fused K4 and K5 bit-equal to their plain versions (q, scale,
    the dequantised message): the quantiser's edge rows (m > 1; for m = 1
    the max-last row), and rows keyed by SATURATING_KEYS with their max
    |x| planted at the element whose kappa is 1.0 (where n allows)."""
    g = torch.Generator(h100).manual_seed(n + bits)
    keys = torch.randint(0, 2 ** 32, (m, 2), generator=g, device=h100)
    x = torch.randn((m, n), generator=g, device=h100)
    if m == 1:
        x[0, -1] = 2 * float(x.abs().max())
    else:
        q_ref.edge_rows(x)
    first = len(q_ref.EDGE_ROWS) if m > 1 else 0
    big = 2.0 ** math.ceil(math.log2(2 * float(x[first:].abs().max())))
    planted = []
    for r, (k0, k1, j) in enumerate(SATURATING_KEYS, start=first):
        if r < m and j < n:
            keys[r] = torch.tensor([k0, k1], device=h100)
            x[r, j] = big if r % 2 == 0 else -big
            planted.append((r, j))
    before = q_ops.quantize_tensor.launches
    q, sc = q_ops.quantize_tensor(keys, x, bits=bits)
    assert q_ops.quantize_tensor.launches == before + 1
    qw, scw = q_ref.quantize_tensor_ref(keys, x, bits=bits)
    assert torch.equal(q, qw) and _same_scale(sc, scw)
    # host keys go to the card through pinned memory
    qh, sch = q_ops.quantize_tensor(keys.cpu(), x, bits=bits)
    assert torch.equal(qh, qw) and _same_scale(sch, scw)
    for r, j in planted:
        if bits == 8:
            assert int(q[r, j]) == (127 if r % 2 == 0 else -128)
    out = q_ops.dequantize_tensor(q, sc, n=n, bits=bits)
    want = q_ref.dequantize_tensor_ref(q, sc, n=n, bits=bits)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(out), nan)
    assert torch.equal(out[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))


def _hold_k5(q, sc, n, bits):
    """Both of K5's forms (one launch each) bit-equal to their plain
    versions on ``q``, ``sc``."""
    for fn, plain in ((q_ops.dequantize_tensor, q_ref.dequantize_tensor_ref),
                      (q_ops.dequantize_plane, q_ref.dequantize_plane_ref)):
        before = fn.launches
        out = fn(q, sc, n=n, bits=bits)
        assert fn.launches == before + 1
        want = plain(q, sc, n=n, bits=bits)
        assert _same_scale(out.reshape(-1), want.reshape(-1)), fn.__name__


def _misaligned(q, offset):
    """A contiguous copy of ``q`` whose data starts ``offset`` bytes past a
    16-byte boundary."""
    flat = torch.empty(q.numel() + 16, dtype=q.dtype, device=q.device)
    out = flat[offset:offset + q.numel()].view(q.shape)
    out.copy_(q)
    assert out.data_ptr() % 16 == offset
    return out


@pytest.mark.parametrize("m", [1, 3, 7])
@pytest.mark.parametrize("n", [1, 5, 15, 16, 17, 1023, 4097])
@pytest.mark.parametrize("bits", [8, 4])
def test_dequantize_edge_shapes(h100, n, m, bits):
    """K5 in both forms bit-equal to the plain versions where its walk has
    edges: rows shorter than a group, rows straddling groups, odd n at
    b=4 (a pad nibble a row), and q views 1, 4 and 8 bytes past a 16-byte
    boundary (a scalar head, or no group aligned at all); every byte
    value of q and a scale whose levels reach below tiny."""
    g = torch.Generator(h100).manual_seed(n * 8 + m + bits)
    wire = q_ops.wire_len(n, bits)
    q = torch.randint(0, 256, (m, wire), generator=g, device=h100,
                      dtype=torch.int32).to(torch.uint8)
    if bits == 8:
        q = q.view(torch.int8)
    sc = torch.randn((m,), generator=g, device=h100) * 1e3
    sc[0] = 50 * q_ref.TINY
    _hold_k5(q, sc, n, bits)
    for offset in (1, 4, 8):
        _hold_k5(_misaligned(q, offset), sc, n, bits)


@pytest.mark.parametrize("n,bits", [(17, 8), (17, 4), (64, 4), (1, 8)])
def test_dequantize_many_rows(h100, n, bits):
    """M = 70,000 rows, past the 65,535 a 2-D grid's y takes: K5's flat
    walk takes them, both forms bit-equal."""
    m = 70_000
    keys = torch.randint(0, 2 ** 32, (m, 2), device=h100)
    x = torch.randn((m, n), device=h100)
    q, sc = q_ops.quantize_tensor(keys, x, bits=bits)
    _hold_k5(q, sc, n, bits)


@pytest.mark.parametrize("n,kind", [(2 ** 20, "uniform"), (2 ** 20, "topk"),
                                    (1_000_003, "uniform"),
                                    (1_000_003, "stride")])
def test_sparse_gather_scatter(h100, n, kind):
    """K6/K7 on [10, n] messages at k = n / 4 and k = 1 bit-equal to their
    plain versions (signs of zero included): the index rows as int64
    prefixes of [10, n] (read in place) and as int32, -0.0 values planted,
    one index outside [0, n) (K6 gives 0, K7 skips it); K7 through both
    variants, each asserted by its counter.  The stride case at n =
    1,000,003 repeats indices through the int32 wrap, which only the
    claim variant resolves (the last j wins)."""
    x = torch.randn((10, n), device=h100)
    x[:, ::7] = -0.0
    keys = jaxrand.split(jaxrand.key(n), 10).to(h100)
    for k in (n // 4, 1):
        strides = prng.coprime_strides(n)
        if kind == "uniform":
            idx = jaxrand.permutation(keys, n)[..., :k]
        elif kind == "topk":
            idx = torch.sort(x.abs(), dim=-1, descending=True,
                             stable=True).indices[..., :k]
        else:
            idx = prng.affine_indices((keys[:, 0], keys[:, 1]), n, k,
                                      strides)
            if k > 1:
                assert not sg_ops.indices_unique(n, k, strides)
                assert sum(k - torch.unique(r).numel() for r in idx) > 0
        far = idx.clone()
        far[3, k // 2] = n + 5 if k > 1 else -1
        for rows in (idx, idx.to(torch.int32), far):
            v = sg_ops.sparse_gather(x, rows)
            assert torch.equal(v.view(torch.int32),
                               sg_ref.sparse_gather_ref(x, rows)
                               .view(torch.int32))
            vals = v.clone()
            vals[:, ::3] = -0.0
            want = sg_ref.sparse_scatter_ref(vals, rows, n, n / k)
            for unique in ((False,) if kind == "stride" else (True, False)):
                kind7 = sg_ops.scatter_variant(unique)
                before = getattr(sg_ops.sparse_scatter, f"launches_{kind7}")
                out = sg_ops.sparse_scatter(vals, rows, n, n / k,
                                            unique=unique)
                assert getattr(sg_ops.sparse_scatter,
                               f"launches_{kind7}") == before + 1
                assert torch.equal(out.view(torch.int32),
                                   want.view(torch.int32))
        assert float(sg_ops.sparse_gather(x, far)[3, k // 2]) == 0.0


@pytest.mark.parametrize("unique", [True, False])
def test_sparse_scatter_in_windows(h100, unique):
    """A row longer than one window of K7's bin (MAX_SEGS segments) is
    scattered window by window, bit-equal to the plain version; the last
    window holds 3 elements, one index planted there."""
    kind = sg_ops.scatter_variant(unique)
    n = (sg_ops.MAX_SEGS << sg_ops.SEG_LOG[kind]) * 2 + 3
    k = 1 << 16
    g = torch.Generator(device=h100).manual_seed(3)
    idx = torch.stack([torch.randperm(n, generator=g, device=h100)[:k]
                       for _ in range(2)])
    idx[:, 0] = torch.where((idx == n - 1).any(dim=1), idx[:, 0], n - 1)
    v = torch.randn((2, k), generator=g, device=h100)
    v[:, ::5] = -0.0
    assert sg_ops.bin_layout(2, n, k, kind)[1] == 3
    out = sg_ops.sparse_scatter(v, idx, n, n / k, unique=unique)
    want = sg_ref.sparse_scatter_ref(v, idx, n, n / k)
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("n", [2 ** 20, 1_000_003])
def test_cyclic_gather_scatter(h100, n):
    """K8/K9 on [20, n] messages bit-equal to their plain versions (signs
    of zero included) for k = 1, 0.6 n and n, with offsets 0, n - 1 and
    outside [0, n) planted, and one row of -0.0 values."""
    g = torch.Generator(h100).manual_seed(n)
    for k in (1, round(0.6 * n), n):
        x = torch.randn((20, n), generator=g, device=h100)
        v = torch.randn((20, k), generator=g, device=h100)
        v[4] = -0.0
        off = torch.randint(0, n, (20,), generator=g, device=h100)
        off[:4] = torch.tensor([0, n - 1, -3, 3 * n + 1], device=h100)
        got = sg_ops.cyclic_gather(x, off, k)
        assert torch.equal(got.view(torch.int32),
                           sg_ref.cyclic_gather_ref(x, off, k)
                           .view(torch.int32))
        out = sg_ops.cyclic_scatter(v, off, n, n / k)
        want = sg_ref.cyclic_scatter_ref(v, off, n, n / k)
        assert torch.equal(out.view(torch.int32), want.view(torch.int32))
        assert not bool(torch.signbit(out[4]).any())


def test_wrappers_reject_what_the_kernels_do_not_take(h100):
    sid, rid = _ids(h100)
    x = torch.randn((20, 64), device=h100)
    with pytest.raises(TypeError):
        q_ops.quantize_plane(SEED, sid, rid, x.double())
    with pytest.raises(ValueError):
        sg_ops.randk_gather_plane(SEED, sid[:3], rid, x, k=8, strides=(1,))
    with pytest.raises(ValueError):
        sg_ops.randk_scatter_plane(SEED, sid, rid, x[:, ::2], n=64, gain=2.0,
                                   strides=(1,))
    # the pull kernels refuse a plane whose index steps could be inexact
    # (n not a power of two, the int32 sum wraps) or a wrong inverse
    from repro_torch.kernels import _build

    sid32, rid32 = sid.contiguous(), rid.contiguous()
    odd = (3, 2 ** 30 + 1)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.launch("randk_gather_pull", x.data_ptr(), 20, 63, 8, 1, 2,
                      sid32.data_ptr(), rid32.data_ptr(),
                      _build.stride_table(odd), 2, x.data_ptr())
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.launch("randk_scatter_pull", x.data_ptr(), 20, 64, 8, 1.0, 1,
                      2, sid32.data_ptr(), rid32.data_ptr(),
                      _build.stride_table((3,)), _build.stride_table((5,)),
                      1, x.data_ptr())
    keys = jaxrand.split(jaxrand.key(0), 20)
    with pytest.raises(TypeError):
        q_ops.quantize_tensor(keys, x.double())
    with pytest.raises(ValueError):
        q_ops.quantize_tensor(keys[:3], x)
    q, sc = q_ops.quantize_tensor(keys, x)
    with pytest.raises(ValueError):
        q_ops.dequantize_tensor(q, sc, n=65)
    # K5 takes any row count and a misaligned q, but not a strided q, a
    # scale per row of the wrong length or type, or a wire that n does not
    # give
    for fn in (q_ops.dequantize_tensor, q_ops.dequantize_plane):
        with pytest.raises(ValueError):
            fn(torch.cat([q, q], 1)[:, ::2], sc, n=64)
        with pytest.raises(ValueError):
            fn(q, sc[:3], n=64)
        with pytest.raises(TypeError):
            fn(q, sc.double(), n=64)
        with pytest.raises(ValueError):
            fn(q, sc, n=63)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.launch("dequantize_leaf", q.data_ptr(), 20, 64, 4,
                      sc.data_ptr(), x.data_ptr(), 64, 1)
    # K5 and K0's test entry index in 32 bits: their C entries refuse 2^31
    # elements of out and more than 2^32 words (before touching memory)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.launch("dequantize_leaf", q.data_ptr(), 2048, 2 ** 20, 4,
                      sc.data_ptr(), x.data_ptr(), 2 ** 19, 0)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.launch("threefry_bits", 0, 0, sid32.data_ptr(),
                      rid32.data_ptr(), sid32.data_ptr(), 65535, 65538, 64,
                      1, x.data_ptr(), x.data_ptr(), x.data_ptr())
    with pytest.raises(ValueError):
        sg_ops.sparse_gather(x, torch.zeros((3, 8), dtype=torch.int64,
                                            device=h100))
    rows = torch.zeros((20, 16), dtype=torch.int64, device=h100)
    with pytest.raises(TypeError):
        sg_ops.sparse_gather(x, rows.to(torch.int16))
    with pytest.raises(ValueError):  # rows not unit-stride
        sg_ops.sparse_scatter(x[:, :8].contiguous(), rows[:, ::2], 64,
                              unique=True)
    off = torch.zeros((20,), dtype=torch.int64, device=h100)
    with pytest.raises(ValueError):
        sg_ops.cyclic_gather(x, off[:3], 8)
    with pytest.raises(ValueError):
        sg_ops.cyclic_gather(x, off, 65)
    with pytest.raises(ValueError):
        sg_ops.cyclic_scatter(x[:, :8], off, 4)
    with pytest.raises(TypeError):
        sg_ops.cyclic_scatter(x.double(), off, 64)


def test_paper_problem_through_the_kernels(h100):
    from repro_torch.bench import rounds_to_tol, run_solver
    from repro_torch.core import vr
    from repro_torch.core.schedule import build_graph
    from repro_torch.core.solver import make_solver
    from repro_torch.problems.logistic import LogisticProblem

    prob = LogisticProblem()
    graph, ex = build_graph("ring", prob.n_agents)
    solver = make_solver("ltadmm:compressor=qbit:bits=8", graph, ex,
                         vr.SagaTable(sample_grads=prob.sample_grads,
                                      m=prob.m))
    q_ops.quantize_plane.launches = 0
    idx, gns = run_solver(prob, prob.make_data(0), solver, 150)
    assert q_ops.quantize_plane.launches == 300
    assert rounds_to_tol(idx, gns, 1e-8) <= 125
    assert solver.wire_bytes({"x": np.zeros(5, np.float32)}) == 36


def test_baseline_through_the_kernels(h100):
    """LEAD with qbit8 on the paper problem: every iteration launches K4
    and K5 once, and the stochastic run settles at its noise floor."""
    from repro_torch.bench import run_solver
    from repro_torch.core import vr
    from repro_torch.core.schedule import build_graph
    from repro_torch.core.solver import make_solver
    from repro_torch.problems.logistic import LogisticProblem

    prob = LogisticProblem()
    graph, ex = build_graph("ring", prob.n_agents)
    solver = make_solver("lead:lr=0.1,compressor=qbit:bits=8", graph, ex,
                         vr.PlainSgd(batch_grad=prob.batch_grad))
    q_ops.quantize_tensor.launches = q_ops.dequantize_tensor.launches = 0
    idx, gns = run_solver(prob, prob.make_data(0), solver, 300,
                          metric_every=50)
    assert q_ops.quantize_tensor.launches == 300
    assert q_ops.dequantize_tensor.launches == 300
    assert np.all(np.isfinite(gns)) and gns[-1] < 1e-2
    assert solver.wire_bytes({"x": np.zeros(5, np.float32)}) == 18


@pytest.mark.parametrize("bits", [8, 4])
def test_sealed_faulted_exchange_on_the_card(h100, bits):
    """A K1 payload sealed, routed through the fault-armed exchange
    (injection in place on the card, masks copied through pinned memory)
    and verified: every leaf and verdict bit-equal to the same calls on
    the CPU, for every fault kind at once."""
    from repro_torch.core import compression, faults, topology

    topo = topology.Complete(6)
    fp = faults.FaultPlane(drop=0.2, corrupt=0.3, stale=0.2, crash=0.1,
                           seed=5)
    ex = topology.Exchange(topo).armed(fp)
    a, s = topo.n_agents, topo.n_slots
    sid, rid = _ids(h100, a, s)
    x = torch.randn((a, s, 4099), device=h100)
    for k in range(4):
        q, sc = q_ops.quantize_plane(SEED, sid, rid, x.reshape(a * s, -1),
                                     bits=bits)
        p = compression.Payload(q=q.reshape(a, s, -1),
                                scale=sc.reshape(a, s))
        got = compression.verify_plane_kinds(
            ex.exchange_batched(compression.seal_plane(p, k, 2),
                                round_index=k), k)
        pc = compression.Payload(**{n: v.cpu() for n, v in p.items()})
        want = compression.verify_plane_kinds(
            ex.exchange_batched(compression.seal_plane(pc, k, 2),
                                round_index=k), k)
        for n in want[0]:
            assert torch.equal(got[0][n].cpu(), want[0][n]), (k, n)
        for g, w in zip(got[1:], want[1:]):
            assert torch.equal(g.cpu(), w), k


def test_faulted_round_through_the_kernels(h100):
    """The combined-fault row's spec on the paper problem: the faulted
    schedule round launches K1 twice and K5 four times a round and
    converges below 1e-8 at 68 B a round."""
    from repro_torch import fault_sweep
    from repro_torch.bench import rounds_to_tol, run_solver

    prob, data, solver = fault_sweep.solver_for(fault_sweep.SMOKE_FAULTS)
    q_ops.quantize_plane.launches = q_ops.dequantize_plane.launches = 0
    idx, gns = run_solver(prob, data, solver, 150)
    assert q_ops.quantize_plane.launches == 300
    assert q_ops.dequantize_plane.launches == 600
    assert rounds_to_tol(idx, gns, 1e-8) in (110, 120)
    assert solver.wire_bytes({"x": np.zeros(5, np.float32)}) == 68


def test_tree_schedule_round_through_the_kernels(h100):
    """LT-ADMM with packed=false and RandK block on a churn schedule,
    two-leaf parameters: each round and leaf launches K8 twice and K9
    four times, and the run lowers ||grad F||²."""
    from repro_torch.bench import run_solver
    from repro_torch.core import vr
    from repro_torch.core.schedule import build_graph
    from repro_torch.core.solver import make_solver
    from repro_torch.problems.logistic import LogisticProblem

    prob = LogisticProblem()
    graph, ex = build_graph("churn:p=0.2,base=complete,seed=0",
                            prob.n_agents)

    def split(p, b):
        full = prob.sample_grads(torch.cat([p["w1"], p["w2"]], -1), b)
        return {"w1": full[..., :3], "w2": full[..., 3:]}

    solver = make_solver(
        "ltadmm:eta=0.5,packed=false,compressor=randk:fraction=0.6,"
        "sampler=block", graph, ex, vr.SagaTable(sample_grads=split,
                                                 m=prob.m))
    sg_ops.cyclic_gather.launches = sg_ops.cyclic_scatter.launches = 0
    x0 = {"w1": torch.zeros((10, 3), device=h100),
          "w2": torch.zeros((10, 2), device=h100)}
    idx, gns = run_solver(prob, prob.make_data(0), solver, 40, x0=x0)
    assert sg_ops.cyclic_gather.launches == 40 * 2 * 2
    assert sg_ops.cyclic_scatter.launches == 40 * 2 * 4
    assert np.all(np.isfinite(gns)) and gns[-1] < gns[0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kh,t,s,dh,causal,window,shifted", [
    (2, 16, 8, 512, 512, 128, True, None, False),  # qwen3's heads
    (1, 32, 32, 512, 464, 80, True, 128, False),  # zamba2's, windowed
    (2, 8, 4, 512, 512, 64, True, None, False),  # one swizzle atom wide
    (1, 4, 2, 96, 300, 32, False, None, False),  # non-causal, T % 64 != 0
    (1, 2, 1, 128, 128, 256, True, None, False),  # the widest head
    (1, 6, 2, 64, 64, 16, True, 8, False),
    (1, 1, 1, 128, 128, 20, True, None, False),  # rows TMA cannot address
    (2, 8, 4, 256, 208, 128, True, None, True),  # a base TMA cannot take
    (2, 8, 4, 256, 208, 80, True, None, True),
])
def test_flash_attention(h100, b, h, kh, t, s, dh, causal, window, shifted,
                         dtype):
    """Each call takes the variant ``route`` states (bf16 with Dh a
    multiple of 8 and 16-byte-aligned q, k, v: the tensor-core one; f32,
    and bf16 at Dh 20 or one element past a 16-byte boundary: the
    CUDA-core one) and stays within its limit of the plain version."""
    from repro_torch.kernels.flash_attention import ops as fl_ops
    from repro_torch.kernels.flash_attention import ref as fl_ref

    g = torch.Generator(h100).manual_seed(t + s + dh)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(shape, generator=g, device=h100).to(dt)
               for shape in ((b, t, h, dh), (b, s, kh, dh), (b, s, kh, dh)))
    if shifted:
        q, k, v = (torch.empty(a.numel() + 1, device=h100, dtype=dt)[1:]
                   .view(a.shape).copy_(a) for a in (q, k, v))
    fn = fl_ops.flash_attention
    fn.launches = fn.launches_tc = fn.launches_cc = 0
    got = fl_ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    variant = ("tc" if dt == torch.bfloat16 and dh % 8 == 0 and not shifted
               else "cc")
    assert fl_ops.route(q, k, v) == variant
    assert (fn.launches, fn.launches_tc, fn.launches_cc) == (
        (1, 1, 0) if variant == "tc" else (1, 0, 1))
    want = fl_ref.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert got.dtype == dt and got.shape == q.shape
    if dt == torch.float32:
        assert float((got - want).abs().max()) <= 2e-5
    else:
        assert bf16_ulps(got, want, 2e-5) <= 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,nh,hd,ng,ds,chunk,decay", [
    (2, 512, 80, 64, 1, 64, 128, "usual"),  # zamba2's SSD
    (1, 256, 4, 32, 2, 16, 64, "usual"),  # two groups
    (2, 96, 3, 16, 1, 8, 32, "usual"),  # a shape the tensor cores refuse
    (1, 128, 8, 64, 1, 64, 128, "usual"),  # T = chunk, B = 1
    (2, 128, 6, 32, 2, 32, 32, "usual"),  # chunk 32, two groups
    (1, 256, 8, 64, 2, 64, 64, "strong"),  # chunk 64, exp underflows
    (2, 512, 16, 64, 1, 64, 128, "none"),  # no decay: the state grows
])
def test_ssd_scan(h100, b, t, nh, hd, ng, ds, chunk, decay, dtype):
    """Each call takes the variant ``route`` states (bf16 at the shapes the
    tensor-core kernel takes: it; f32 and the rest: the CUDA-core one),
    then every variant the shape admits runs forced on the same inputs,
    B and C read at their token stride; each within the limits of the
    plain version.  A forced "tc" on a shape it refuses raises."""
    from repro_torch.kernels.ssm_scan import ops as ssm_ops
    from repro_torch.kernels.ssm_scan import ref as ssm_ref
    from repro_torch.models.mamba import SSMConfig

    g = torch.Generator(h100).manual_seed(t + hd + ds)
    dt = getattr(torch, dtype)
    x = 0.5 * torch.randn((b, t, nh, hd), generator=g, device=h100)
    alog = {"usual": -0.2 * torch.randn((b, t, nh), generator=g,
                                        device=h100).abs(),
            "strong": -5.0 + 0.1 * torch.randn((b, t, nh), generator=g,
                                               device=h100),
            "none": torch.zeros((b, t, nh), device=h100)}[decay]
    # B and C as column slices of one tensor, as the Mamba block has them
    xbc = 0.5 * torch.randn((b, t, 2 * ng * ds + 8), generator=g,
                            device=h100).to(dt)
    bm = xbc[..., 8:8 + ng * ds].reshape(b, t, ng, ds)
    cm = xbc[..., 8 + ng * ds:].reshape(b, t, ng, ds)
    x, alog = x.to(dt), alog.to(dt)
    cfg = SSMConfig(64, chunk=chunk)
    tc_takes = dt == torch.bfloat16 and hd in (32, 64) and ds % 16 == 0
    assert ssm_ops.route(x, bm, cfg, cm) == ("tc" if tc_takes else "cc")
    yw, hw = ssm_ref.ssd_scan_plain(x, alog, bm, cm, chunk=chunk)
    scale = float(yw.float().abs().max())
    fn = ssm_ops.ssd_chunked
    for variant in (None, "tc", "cc") if tc_takes else (None, "cc"):
        fn.launches = fn.launches_tc = fn.launches_cc = 0
        y, h = fn(cfg, x, bm, cm, alog, variant=variant)
        torch.cuda.synchronize()
        ran = variant or ("tc" if tc_takes else "cc")
        assert (fn.launches, fn.launches_tc, fn.launches_cc) == (
            (1, 1, 0) if ran == "tc" else (1, 0, 1)), variant
        assert y.dtype == dt and y.shape == x.shape
        assert float((h - hw).abs().max()) <= 1e-5 * float(hw.abs().max())
        if dt == torch.float32:
            assert float((y - yw).abs().max()) <= 1e-5 * scale
        else:
            assert bf16_ulps(y, yw, 1e-5 * scale) <= 1, variant
    if not tc_takes:
        fn.launches = 0
        with pytest.raises(ValueError, match="tensor-core"):
            fn(cfg, x, bm, cm, alog, variant="tc")
        assert fn.launches == 0


def test_serving_wrappers_reject_what_the_kernels_do_not_take(h100):
    from repro_torch.kernels.flash_attention import ops as fl_ops
    from repro_torch.kernels.ssm_scan import ops as ssm_ops
    from repro_torch.models.mamba import SSMConfig

    q = torch.zeros((1, 128, 4, 64), device=h100)
    with pytest.raises(TypeError):
        fl_ops.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError):
        fl_ops.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError):
        fl_ops.flash_attention(q.transpose(1, 2), q, q)
    with pytest.raises(ValueError):
        fl_ops.flash_attention(q, q[:, :, :3], q[:, :, :3])  # 4 % 3 heads
    x = torch.zeros((1, 256, 2, 64), device=h100)
    al = torch.zeros((1, 256, 2), device=h100)
    bc = torch.zeros((1, 256, 1, 64), device=h100)
    with pytest.raises(ValueError):
        ssm_ops.ssd_chunked(SSMConfig(64, chunk=256), x, bc, bc, al)
    with pytest.raises(ValueError):  # the chunk does not fit the card
        ssm_ops.ssd_chunked(SSMConfig(64, chunk=128),
                            torch.zeros((1, 256, 2, 256), device=h100), bc,
                            bc, al)


def test_kernels_bench_rows_launch_their_kernels(h100):
    """Each ``kernels_bench`` row's call launches its kernel once: its
    wrapper's counter moves by one."""
    from repro_torch import kernels_bench

    for name, call, _, wrapper in kernels_bench.cases(h100, fast=False):
        before = wrapper.launches
        call()
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1, name


def test_telemetry_round_on_the_card(h100):
    """A wrapped ring qbit8 round through the kernels: the counters live
    on the card, a round charges 36 B to every agent, the trajectory is
    bit-identical to the unwrapped one, and the wrapped round raises no
    more sync warnings than the unwrapped one."""
    import warnings

    from repro_torch.bench import make_problem, saga
    from repro_torch.core.solver import make_solver
    from repro_torch.obs import telemetry

    prob, data, graph, ex = make_problem()
    data = {k: v.to(h100) for k, v in data.items()}
    spec = "ltadmm:compressor=qbit:bits=8"
    plain = make_solver(spec, graph, ex, saga(prob), device=h100)
    wrapped = telemetry.with_telemetry(
        make_solver(spec, graph, ex, saga(prob), device=h100))
    x0 = torch.zeros((prob.n_agents, prob.n), device=h100)
    sp, sw = plain.init(x0), wrapped.init(x0)
    assert sw.telemetry.tx_bytes.is_cuda
    counts = []
    for i in range(3):
        key = jaxrand.key(i)
        for label, run in (("plain", lambda: plain.step(sp, data, key)),
                           ("wrapped", lambda: wrapped.step(sw, data, key))):
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as w:
                    warnings.simplefilter("always")
                    out = run()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            counts.append((label, len(w)))
            if label == "plain":
                sp = out
            else:
                sw = out
    assert all(counts[i][1] >= counts[i + 1][1] for i in (2, 4)), counts
    for f in sp._fields:
        a, b = getattr(sp, f), getattr(sw.inner, f)
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b), f
    tel = telemetry.counters(sw)
    np.testing.assert_array_equal(tel["tx_bytes"], np.full(10, 3 * 36))
    assert int(tel["rounds"]) == 3
