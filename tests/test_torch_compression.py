"""Compression in the port against the reference, bit for bit.

* the plain versions of the plane kernels (K1 quantize_plane, K2/K3 RandK
  gather/scatter) against the reference's Pallas kernels in interpret
  mode: b = 4 and 8, odd n and n not a multiple of 1024, block and
  stride samplers, a row whose max |x| meets a kappa that rounds the
  level up (int8 saturation, nibble wrap), and the int32 wrap of the
  affine index set (with the repeated indices it causes);
* the plain versions of K1, K4, K5 and ``dequantize_plane`` on the
  quantiser's edge rows (subnormals, a max below 127 tiny, +-0, NaN,
  +-inf), which the reference's XLA arithmetic flushes, bit for bit;
* the plain versions of the per-message kernels (K4/K5 quantize and
  dequantize, K6/K7 gather and scatter, K8/K9 cyclic gather and
  scatter) against the reference's kernels in interpret mode, the same
  way: n = 5, 1000, 1024 and 4099, keys whose bits round kappa to 1.0,
  TopK and RandK uniform, stride and block; for K8/K9 k = 1 and k = n,
  offsets 0, n - 1 and beyond [0, n), and a row of -0.0 values, which
  the reference's K9 returns as +0.0;
* the per-message torch route of every compressor spec against
  ``impl=jnp``, and the per-message kernel route against ``impl=pallas``;
* wire bytes and the spec parser's error messages.
"""
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import admm as jadmm  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.kernels import prng as jprng  # noqa: E402
from repro.kernels.quantize import ops as jq  # noqa: E402
from repro.kernels.sparse_gather import ops as jsg  # noqa: E402
from repro_torch.core import admm  # noqa: E402
from repro_torch.core import compression as comp  # noqa: E402
from repro_torch.core import jaxrand  # noqa: E402
from repro_torch.kernels import _build, prng  # noqa: E402
from repro_torch.kernels.quantize import ops as q_ops  # noqa: E402
from repro_torch.kernels.sparse_gather import ops as sg_ops  # noqa: E402
from repro_torch.kernels.sparse_gather import ref as sg_ref  # noqa: E402

JSEED = jprng.key_seed(jax.random.key(7))
SEED = tuple(int(w) for w in JSEED)
A, S = 3, 2


def _ids(a=A, s=S):
    sids = np.broadcast_to(np.arange(a, dtype=np.uint32)[:, None], (a, s))
    rids = np.broadcast_to(np.arange(s, dtype=np.uint32)[None, :] + 1, (a, s))
    return sids, rids


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int64)) \
        .to(torch.int32)


def _x(shape, salt=0):
    return np.random.RandomState(salt).standard_normal(shape).astype(
        np.float32)


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("n,bits,receivers", [
    (3000, 8, "edge"), (3000, 4, "broadcast"), (1025, 4, "edge"),
    (1025, 8, "broadcast"), (2048, 8, "edge")])
def test_quantize_plane_matches_reference(n, bits, receivers):
    sids, rids = _ids()
    rids = None if receivers == "broadcast" else rids
    x = _x((A, S, n), n)
    q, sc = q_ops.quantize_plane(SEED, _t(sids),
                                 None if rids is None else _t(rids),
                                 torch.from_numpy(x), bits=bits)
    jq_, jsc = jq.quantize_plane(JSEED, jnp.asarray(sids),
                                 None if rids is None else jnp.asarray(rids),
                                 jnp.asarray(x), bits=bits, interpret=True)
    _eq(q.numpy(), jq_)
    _eq(sc.numpy(), jsc)
    n_dq = q_ops.dequantize_plane(q, sc, n=n, bits=bits)
    _eq(n_dq.numpy(), jq.dequantize_plane(jq_, jsc, n=n, bits=bits))


def _saturating_rows(levels, n, want, rid=1):
    """(sid, j) pairs whose kappa lifts ``levels`` to ``levels + 1``."""
    found = []
    for start in range(0, 1 << 16, 1024):
        sids = torch.arange(start, start + 1024)
        es = prng.fold(SEED, sids, rid)
        bits = prng.random_bits((es[0][:, None], es[1][:, None]),
                                torch.arange(n)[None, :])
        hit = (torch.tensor(float(levels)) + prng.uniform01(bits)) \
            == levels + 1
        for r in torch.nonzero(hit.any(dim=1)).reshape(-1).tolist():
            found.append((start + r, int(torch.argmax(hit[r].to(torch.int8)))))
        if len(found) >= want:
            return found[:want]
    raise AssertionError("no saturating element found")


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_plane_saturation_matches_reference(bits):
    levels, n = 2 ** (bits - 1) - 1, 1031
    rows = _saturating_rows(levels, n, want=2 if bits == 8 else 1)
    sids = np.array([s for s, _ in rows] + [0, 5], dtype=np.uint32)
    rids = np.ones_like(sids)
    x = _x((len(sids), n), bits)
    for r, (_, j) in enumerate(rows):
        sign = -1.0 if r % 2 else 1.0
        x[r, j] = sign * 2.0 ** math.ceil(math.log2(2 * np.abs(x[r]).max()))
    q, sc = q_ops.quantize_plane(SEED, _t(sids), _t(rids),
                                 torch.from_numpy(x), bits=bits)
    jq_, jsc = jq.quantize_plane(JSEED, jnp.asarray(sids), jnp.asarray(rids),
                                 jnp.asarray(x), bits=bits, interpret=True)
    _eq(q.numpy(), jq_)
    _eq(sc.numpy(), jsc)
    for r, (_, j) in enumerate(rows):
        if bits == 8:  # 128 saturates to 127 (not -128); -128 stays
            assert int(q[r, j]) == (127 if r % 2 == 0 else -128)
        else:  # level 8 is nibble 16: its own 4 bits are 0
            byte = int(q[r, j // 2])
            assert (byte >> 4 if j % 2 == 0 else byte) & 0xF == 0


def _same_f32(got, want):
    """f32 arrays bit for bit (-0.0 apart from +0.0), a NaN matching a NaN
    whatever its payload."""
    g = np.ascontiguousarray(np.asarray(got, np.float32))
    w = np.ascontiguousarray(np.asarray(want, np.float32))
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    keep = ~np.isnan(g)
    np.testing.assert_array_equal(_bits(g[keep]), _bits(w[keep]))


def _edge_x(m, n, salt):
    """``[m, n]`` rows from ``_x`` with the quantiser's edge rows planted
    (``ref.EDGE_ROWS``)."""
    return q_ops.ref.edge_rows(torch.from_numpy(_x((m, n), salt))).numpy()


# q levels whose dequantised values at scale = tiny are subnormal (+-1: the
# reference gives +-0.0) or normal (+-127)
TINY_LEVELS = np.array([1, -1, 2, -3, 127, -127, 0, 64], np.int8)


@pytest.mark.parametrize("n", [5, 1031, 4099])
@pytest.mark.parametrize("bits,receivers", [(8, "edge"), (4, "broadcast")])
def test_quantize_plane_edge_rows_match_reference(n, bits, receivers):
    """K1's plain version and ``dequantize_plane`` on the quantiser's edge
    rows (subnormals only, subnormal elements in a normal row, a max below
    127 tiny, +-0, a NaN, +-inf, the max last) against the reference in
    interpret mode: q, scale and the dequantised values bit for bit.  The
    reference's f32 arithmetic (XLA) flushes subnormals, operands and
    results; the port's plain versions do the same."""
    sids, rids = _ids(4, 2)
    rids = None if receivers == "broadcast" else rids
    x = _edge_x(8, n, n + bits).reshape(4, 2, n)
    q, sc = q_ops.quantize_plane(SEED, _t(sids),
                                 None if rids is None else _t(rids),
                                 torch.from_numpy(x), bits=bits)
    jq_, jsc = jq.quantize_plane(JSEED, jnp.asarray(sids),
                                 None if rids is None else jnp.asarray(rids),
                                 jnp.asarray(x), bits=bits, interpret=True)
    _eq(q.numpy(), jq_)
    _same_f32(sc.numpy(), jsc)
    _same_f32(q_ops.dequantize_plane(q, sc, n=n, bits=bits).numpy(),
              jq.dequantize_plane(jq_, jsc, n=n, bits=bits))
    # levels at scale = tiny, straight through the dequantiser
    lv = np.resize(TINY_LEVELS, n)[None]
    tq = lv if bits == 8 else np.asarray(q_ops.ref.pack4(
        torch.from_numpy(np.clip(lv, -7, 7).astype(np.float32))))
    tiny = np.full((1,), np.finfo(np.float32).tiny, np.float32)
    _same_f32(q_ops.dequantize_plane(torch.from_numpy(tq),
                                     torch.from_numpy(tiny), n=n,
                                     bits=bits).numpy(),
              jq.dequantize_plane(jnp.asarray(tq), jnp.asarray(tiny), n=n,
                                  bits=bits))


@pytest.mark.parametrize("n,k,receivers", [(3000, 1100, "edge"),
                                           (2048, 512, "broadcast")])
@pytest.mark.parametrize("sampler", ["block", "stride"])
def test_randk_plane_matches_reference(n, k, sampler, receivers):
    strides = (1,) if sampler == "block" else prng.coprime_strides(n)
    sids, rids = _ids()
    rids = None if receivers == "broadcast" else rids
    x = _x((A, S, n), k)
    v = sg_ops.randk_gather_plane(SEED, _t(sids),
                                  None if rids is None else _t(rids),
                                  torch.from_numpy(x), k=k, strides=strides)
    jv = jsg.randk_gather_plane(JSEED, jnp.asarray(sids),
                                None if rids is None else jnp.asarray(rids),
                                jnp.asarray(x), k=k, strides=strides,
                                interpret=True)
    _eq(v.numpy(), jv)
    out = sg_ops.randk_scatter_plane(SEED, _t(sids),
                                     None if rids is None else _t(rids), v,
                                     n=n, gain=n / k, strides=strides)
    jout = jsg.randk_scatter_plane(JSEED, jnp.asarray(sids),
                                   None if rids is None else jnp.asarray(rids),
                                   jv, n=n, gain=n / k, strides=strides,
                                   interpret=True)
    _eq(out.numpy(), jout)


def test_randk_plane_int32_wrap_and_repeated_indices_match_reference():
    n = 100_003
    k = n // 4
    strides = prng.coprime_strides(n)
    sids = np.arange(6, dtype=np.uint32)
    rids = np.ones(6, dtype=np.uint32)
    jseed = jprng.key_seed(jax.random.key(5))
    seed = tuple(int(w) for w in jseed)
    idx = prng.affine_indices(prng.fold(seed, torch.from_numpy(
        sids.astype(np.int64)), 1), n, k, strides)
    repeats = sum(k - torch.unique(r).numel() for r in idx)
    assert repeats > 0  # the wrap repeats indices in some row
    assert not sg_ops.indices_unique(n, k, strides)
    x = _x((6, n), 1)
    v = sg_ops.randk_gather_plane(seed, _t(sids), _t(rids),
                                  torch.from_numpy(x), k=k, strides=strides)
    jv = jsg.randk_gather_plane(jseed, jnp.asarray(sids), jnp.asarray(rids),
                                jnp.asarray(x), k=k, strides=strides,
                                interpret=True)
    _eq(v.numpy(), jv)
    vv = torch.from_numpy(_x((6, k), 2))
    out = sg_ops.randk_scatter_plane(seed, _t(sids), _t(rids), vv, n=n,
                                     gain=n / k, strides=strides)
    jout = jsg.randk_scatter_plane(jseed, jnp.asarray(sids),
                                   jnp.asarray(rids), jnp.asarray(vv.numpy()),
                                   n=n, gain=n / k, strides=strides,
                                   interpret=True)
    _eq(out.numpy(), jout)


def test_indices_unique_rule():
    assert sg_ops.indices_unique(2 ** 20, 629_146, prng.coprime_strides(2 ** 20))
    assert sg_ops.indices_unique(5, 3, prng.coprime_strides(5))
    assert not sg_ops.indices_unique(1_000_003, 250_001,
                                     prng.coprime_strides(1_000_003))
    assert sg_ops.indices_unique(1_000_003, 250_001, (1,))


@pytest.mark.parametrize("n", [5, 3000, 2 ** 16, 100_003, 1_000_003])
def test_inverse_strides(n):
    for strides in (prng.coprime_strides(n), (1,)):
        inv = sg_ops.inverse_strides(n, strides)
        assert len(inv) == len(strides)
        assert all(s * t % n == 1 and 0 <= t < n
                   for s, t in zip(strides, inv))
    with pytest.raises(ValueError):
        sg_ops.inverse_strides(3000, (3,))


# The pull kernels of csrc/randk_plane.cu, written out in int64 step for
# step: a thread owns 4 consecutive outputs of a row, p0 = 4 g - lead
# (lead: the row's start past a 16-byte boundary), clipped to the row.


def _pull_groups(length, lead):
    p0 = torch.arange((length + 3 + 3) // 4) * 4 - lead
    return p0, p0.clamp_min(0)


def _add_mod(t, d, n):
    if n & (n - 1) == 0:
        return (t + d) & (n - 1)
    t = t + d
    return torch.where(t >= n, t - n, t)


def _pull_map(seed, sids, rids, n, strides):
    es = prng.fold(seed, prng.u32(sids), prng.u32(rids))
    slot = prng.derive_stride_slot(es, len(strides))
    return (prng.derive_offset(es, n),
            torch.as_tensor(strides, dtype=torch.int64)[slot],
            torch.as_tensor(sg_ops.inverse_strides(n, strides),
                            dtype=torch.int64)[slot])


def _pull_gather_indices(seed, sids, rids, n, k, strides):
    """idx_j as the pull gather walks it: the index at a thread's first j
    (a mask for a power of two, else the unwrapped int32 sum's floor-mod),
    then + stride mod n by a conditional subtract."""
    off, stride, _ = _pull_map(seed, sids, rids, n, strides)
    out = torch.full((len(off), k), -1, dtype=torch.int64)
    for m in range(len(off)):
        p0, first = _pull_groups(k, m * k % 4)
        u = off[m] + first * stride[m]
        idx = (u & prng.MASK & (n - 1) if n & (n - 1) == 0
               else prng.wrap_i32(u) % n)
        step = int(stride[m]) % n
        for e in range(4):
            pos = p0 + e
            ok = (pos >= 0) & (pos < k)
            out[m, pos[ok]] = idx[ok]
            idx = torch.where(ok, _add_mod(idx, step, n), idx)
    return out


def _pull_scatter(seed, sids, rids, v, n, gain, strides):
    """K3's pull kernel: j(i) = (i - off) * stride^-1 mod n once a thread
    (uint32 and a mask for a power of two, else 64 bits), then
    + stride^-1 mod n; out[i] = gain * v[j] where j < k, else +0.0."""
    k = v.shape[-1]
    off, _, inv = _pull_map(seed, sids, rids, n, strides)
    g = torch.tensor(gain, dtype=torch.float32)
    out = torch.full((len(off), n), float("nan"))
    for m in range(len(off)):
        p0, first = _pull_groups(n, m * n % 4)
        if n & (n - 1) == 0:
            j = ((first - off[m]) & prng.MASK) * inv[m] & prng.MASK & (n - 1)
        else:
            r = torch.where(first >= off[m], first - off[m],
                            first + n - off[m])
            j = r * inv[m] % n
        for e in range(4):
            pos = p0 + e
            ok = (pos >= 0) & (pos < n)
            val = torch.where(j < k, g * v[m, j.clamp(max=k - 1)],
                              torch.tensor(0.0))
            out[m, pos[ok]] = val[ok]
            j = torch.where(ok, _add_mod(j, int(inv[m]), n), j)
    return out


@pytest.mark.parametrize("n,k,sampler", [
    (2 ** 16, round(0.6 * 2 ** 16), "stride"),  # power of two, sum wraps
    (3000, 1100, "stride"),  # no wrap
    (3001, 1101, "stride"),  # rows start off 16-byte boundaries
    (3000, 1100, "block")])
def test_pull_kernels_step_for_step(n, k, sampler):
    strides = (1,) if sampler == "block" else prng.coprime_strides(n)
    wraps = (n - 1) + (k - 1) * max(strides) >= 2 ** 31
    assert wraps == (n == 2 ** 16)
    assert sg_ops.variant(n, k, strides) == "pull"
    sids, rids = (torch.from_numpy(a.reshape(-1).astype(np.int64))
                  for a in _ids())
    idx = _pull_gather_indices(SEED, sids, rids, n, k, strides)
    es = prng.fold(SEED, prng.u32(sids), prng.u32(rids))
    assert torch.equal(idx, prng.affine_indices(es, n, k, strides))
    v = torch.from_numpy(_x((len(sids), k), n))
    v[:, ::5] = -0.0
    got = _pull_scatter(SEED, sids, rids, v, n, n / k, strides)
    want = sg_ref.randk_scatter_plane_ref(SEED, sids, rids, v, n=n,
                                          gain=n / k, strides=strides)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert int((torch.signbit(got) & (got == 0)).sum()) == \
        len(sids) * len(range(0, k, 5))


@pytest.mark.parametrize("n,k,strides,kind", [
    (2 ** 16, round(0.6 * 2 ** 16), "stride", "pull"),
    (2 ** 20, 629_146, "stride", "pull"),
    (3000, 1100, "stride", "pull"),
    (5, 3, "stride", "pull"),
    (1_000_003, 250_001, "block", "pull"),
    (100_003, 100_003 // 4, "stride", "push"),
    (1_000_003, 250_001, "stride", "push"),
    (3000, 1100, (3,), "push"),  # not coprime: the set repeats
    (64, 65, "block", "push")])  # k > n
def test_variant_rule(n, k, strides, kind):
    strides = {"block": (1,), "stride": prng.coprime_strides(n)}.get(
        strides, strides)
    assert sg_ops.variant(n, k, strides) == kind
    assert sg_ops.indices_unique(n, k, strides) == (kind == "pull")


# The K6/K7 kernels of csrc/gather_scatter.cu, written out in int64 step
# for step.  K6: a block takes 256 threads x GATHER_PER j, j = base + i *
# 256; an index outside [0, n) (one unsigned compare) gives 0.  K7's two
# launches, for each window of at most MAX_SEGS segments of the row: bin
# sorts each tile of j by segment of the window, keeping the indices that
# land in it (the runs' starts per (segment, tile)); fill takes its
# segment's run of every tile into a cleared segment (the claim variant: a
# 64-bit max of (j + 1) << 32 | value bits, 0 reading +0.0), then writes
# it out as scalars up to the row's first 16-byte boundary, 16-byte groups
# and a scalar tail.


def _f32_bits(a):
    return a.contiguous().view(torch.int32).to(torch.int64) & prng.MASK


def _bits_f32(b):
    return prng.wrap_i32(b).to(torch.int32).view(torch.float32)


def _gather_kernel(x, idx, threads=256, per=sg_ops.GATHER_PER):
    m, k = idx.shape
    n = x.shape[-1]
    out = torch.full((m, k), float("nan"))
    tile = threads * per
    for b in range(-(-k // tile)):
        for i in range(per):
            j = b * tile + i * threads + torch.arange(threads)
            j = j[j < k]
            s = idx[:, j].to(torch.int64)
            ok = (s >= 0) & (s < n)  # the unsigned compare
            got = torch.gather(x, 1, torch.where(ok, s, 0))
            assert bool(out[:, j].isnan().all())  # each j once
            out[:, j] = torch.where(ok, got, torch.zeros(()))
    return out


def _bin(idx, bits, base, nw, seg_log, tile):
    """bin over the window [base, base + nw): per row and tile, the runs
    (offset, value bits, position) in segment order and their starts
    ``[m, segments + 1, tiles]``."""
    m, k = idx.shape
    nseg = (nw + (1 << seg_log) - 1) >> seg_log
    tiles = -(-k // tile)
    starts = torch.zeros((m, nseg + 1, tiles), dtype=torch.int64)
    runs = []
    for r in range(m):
        row = []
        for t in range(tiles):
            pos = torch.arange(min(tile, k - t * tile))
            i = idx[r, t * tile + pos].to(torch.int64) - base
            ok = (i >= 0) & (i < nw)  # the unsigned compare
            seg = i[ok] >> seg_log
            cnt = torch.bincount(seg, minlength=nseg)
            starts[r, :nseg, t] = torch.cumsum(cnt, 0) - cnt
            starts[r, nseg, t] = int(ok.sum())
            order = torch.sort(seg, stable=True).indices
            row.append((i[ok][order] & ((1 << seg_log) - 1),
                        bits[r, t * tile + pos][ok][order], pos[ok][order]))
        runs.append(row)
    return runs, starts


def _binned_scatter(v, idx, n, gain, *, claim, seg_log, tile,
                    max_segs=sg_ops.MAX_SEGS):
    m, k = idx.shape
    seg_len = 1 << seg_log
    bits = _f32_bits(torch.tensor(gain, dtype=torch.float32) * v)
    out = torch.full((m, n), float("nan"))
    window = max_segs << seg_log
    for base in range(0, n, window):
        nw = min(window, n - base)
        runs, starts = _bin(idx, bits, base, nw, seg_log, tile)
        tiles = starts.shape[-1]
        for r in range(m):
            for s in range(starts.shape[1] - 1):
                g0 = base + (s << seg_log)
                length = min(seg_len, base + nw - g0)
                word = torch.zeros(length, dtype=torch.int64)
                segf = torch.zeros(length)
                for t in range(tiles):
                    lo, hi = int(starts[r, s, t]), int(starts[r, s + 1, t])
                    off, b, pos = (a[lo:hi] for a in runs[r][t])
                    if claim:
                        word.scatter_reduce_(
                            0, off, ((t * tile + pos + 1) << 32) | b,
                            reduce="amax")
                    else:
                        segf[off] = _bits_f32(b)
                if claim:
                    segf = torch.where(word != 0,
                                       _bits_f32(word & prng.MASK),
                                       torch.zeros(()))
                lead = (r * n + g0) % 4  # the plane is 16-byte aligned
                a0 = min((4 - lead) % 4, length)
                groups = (length - a0) // 4
                written = (list(range(a0)) + list(range(a0, a0 + 4 * groups))
                           + list(range(a0 + 4 * groups, length)))
                assert written == list(range(length))
                assert (r * n + g0 + a0) % 4 == 0 or a0 == length
                assert bool(out[r, g0:g0 + length].isnan().all())  # once
                out[r, g0:g0 + length] = segf
    return out


def _index_case(kind, m, n, k, seed):
    rs = np.random.RandomState(seed)
    if kind == "unique":
        return torch.from_numpy(np.stack([rs.permutation(n)
                                          for _ in range(m)]))[:, :k]
    return torch.from_numpy(rs.randint(0, n, (m, k)).astype(np.int64))


@pytest.mark.parametrize("n,k,seg_log,tile,kind", [
    (3001, 1100, 10, 256, "unique"),  # rows off 16-byte boundaries, n % S
    (3001, 1, 10, 256, "unique"),  # k = 1
    (700, 300, 14, 4096, "unique"),  # the package's S and tile: n < S
    (2500, 2000, 10, 512, "repeats"),  # planted repeats: the last j wins
    (4099, 4099, 13, 4096, "repeats")])
def test_binned_scatter_step_for_step(n, k, seg_log, tile, kind):
    idx = _index_case(kind, 3, n, k, n + k)
    if k > 1:
        idx = idx.clone()
        idx[1, k // 3] = n + 7  # outside [0, n): skipped
        idx[2, k // 2] = -5
    v = torch.from_numpy(_x((3, k), n - k))
    v[:, ::7] = -0.0
    gain = n / k
    want = sg_ref.sparse_scatter_ref(v, idx, n, gain)
    assert torch.equal(sg_ops.sparse_scatter(v, idx, n, gain, unique=False)
                       .view(torch.int32), want.view(torch.int32))
    for claim in ((True, False) if kind == "unique" else (True,)):
        got = _binned_scatter(v, idx, n, gain, claim=claim, seg_log=seg_log,
                              tile=tile)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert int((torch.signbit(want) & (want == 0)).sum()) > 0


def test_binned_scatter_step_for_step_int32_wrap():
    """The stride sampler's int32 wrap at n = 100,003 repeats indices; the
    claim variant's model (the package's S = 2^13 and tile) keeps the last
    j, as the plain version does."""
    n = 100_003
    k = n // 4
    keys = jaxrand.split(jaxrand.key(5), 64)
    idx = prng.affine_indices((keys[:, 0], keys[:, 1]), n, k,
                              prng.coprime_strides(n))
    rows = [r for r in range(64) if k - torch.unique(idx[r]).numel() > 0][:2]
    idx = idx[rows]
    v = torch.from_numpy(_x((2, k), 8))
    v[:, ::5] = -0.0
    got = _binned_scatter(v, idx, n, n / k, claim=True,
                          seg_log=sg_ops.SEG_LOG["claim"],
                          tile=sg_ops.BIN_TILE)
    want = sg_ref.sparse_scatter_ref(v, idx, n, n / k)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("n,k", [(3001, 1100), (4099, 1), (1024, 1024)])
def test_gather_kernel_step_for_step(n, k):
    x = torch.from_numpy(_x((3, n), n))
    x[:, ::5] = -0.0
    idx = _index_case("unique", 3, n, k, k)
    idx = torch.cat([idx, torch.full((3, 1), n)], dim=1)[:, :k].clone()
    idx[0, k - 1] = n + 3
    for rows in (idx, idx.to(torch.int32)):
        got = _gather_kernel(x, rows)
        want = sg_ref.sparse_gather_ref(x, rows)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert float(want[0, k - 1]) == 0.0


@pytest.mark.parametrize("n,k,seg_log,tile,max_segs,kind", [
    (3001, 1100, 8, 256, 4, "unique"),  # 3 windows, the last of 953
    (3001, 3001, 7, 512, 3, "unique"),  # 8 windows, the last of 313
    (2500, 2000, 8, 512, 2, "repeats")])  # the last j wins across windows
def test_binned_scatter_step_for_step_windows(n, k, seg_log, tile, max_segs,
                                              kind):
    """A row longer than MAX_SEGS segments goes window by window: each
    window's bin keeps the indices in it and its fill writes it, every
    element once (the model at a few windows of small segments)."""
    idx = _index_case(kind, 3, n, k, n + k + max_segs)
    idx = idx.clone()
    idx[1, k // 3] = n + 7  # outside [0, n): skipped
    idx[2, k // 2] = -5
    v = torch.from_numpy(_x((3, k), n + max_segs))
    v[:, ::7] = -0.0
    want = sg_ref.sparse_scatter_ref(v, idx, n, n / k)
    assert -(-n // (max_segs << seg_log)) >= 3
    for claim in ((True, False) if kind == "unique" else (True,)):
        got = _binned_scatter(v, idx, n, n / k, claim=claim, seg_log=seg_log,
                              tile=tile, max_segs=max_segs)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_kernel_sizes_match_the_wrappers():
    """The wrappers size K7's scratch and the CPU models walk the kernels
    with the sizes of csrc/gather_scatter.cu: each constant there equals
    its counterpart in sparse_gather/ops.py."""
    src = (Path(sg_ops.__file__).resolve().parents[2] / "csrc"
           / "gather_scatter.cu").read_text()
    for line in (f"constexpr int kGatherPer = {sg_ops.GATHER_PER};",
                 f"constexpr int kTile = {sg_ops.BIN_TILE};",
                 f"constexpr int kMaxSegs = {sg_ops.MAX_SEGS};",
                 f"constexpr int kSegLogUnique = {sg_ops.SEG_LOG['unique']};",
                 "constexpr int kSegLog = kClaim ? kSegLogUnique - 1 : "
                 "kSegLogUnique;"):
        assert src.count(line) == 1, line
    assert sg_ops.SEG_LOG["claim"] == sg_ops.SEG_LOG["unique"] - 1


def _bswap(w):
    return (((w & 0xFF) << 24) | (((w >> 8) & 0xFF) << 16)
            | (((w >> 16) & 0xFF) << 8) | ((w >> 24) & 0xFF))


def _k5_walk(q, scale, n, bits, plane, q_addr, out_addr):
    """K5's flat walk step for step (``quantize_leaf.cu``
    ``dequantize_rows``), q's data at byte address ``q_addr`` (the bytes
    before it in its first word are storage the kernel may read but must
    not use: 0xA5 here) and out at ``out_addr``: thread t of block b takes
    the quads at ``e0 + h * 4 * DQ_THREADS``, ``e0 = 4 (b DQ_QUADS
    DQ_THREADS + t)``, its first quad's row by a division and the others'
    by a compare where they stay in it; a quad reads the aligned words
    that hold its 4 bytes (b=8) or nibbles (b=4), shifted into place; a
    quad that straddles two rows or whose words reach past q, and the
    elements past the last quad, read each level alone.  Asserts every
    store aligned and every element written once; returns ``(out [m, n],
    quads, quads taken alone)``."""
    m = scale.numel()
    total, qbytes = m * n, q.numel()
    q0 = q_addr % 4
    quads = 0 if out_addr % 16 else total // q_ops.DQ_QUAD
    pad = bits == 4 and n % 2 == 1  # element e of row r is nibble e + r
    # q's aligned words from q_addr - q0, zero past the storage's end (a
    # whole quad never reads there)
    qb = q.reshape(-1).view(torch.uint8)
    qp = torch.cat([torch.full((q0,), 0xA5, dtype=torch.uint8), qb,
                    torch.zeros(8, dtype=torch.uint8)]).to(torch.int64)
    words = qp[:4 * (qp.numel() // 4)].reshape(-1, 4)
    words = (words[:, 0] | (words[:, 1] << 8) | (words[:, 2] << 16)
             | (words[:, 3] << 24))
    qwords = (q0 + qbytes) // 4
    per_block = q_ops.DQ_QUADS * q_ops.DQ_THREADS
    step = q_ops.DQ_QUAD * q_ops.DQ_THREADS
    blocks = -(-quads // per_block)
    e0 = 4 * (torch.arange(blocks)[:, None] * per_block
              + torch.arange(q_ops.DQ_THREADS)[None, :]).reshape(-1)
    m0 = e0 // n
    e = e0[:, None] + step * torch.arange(q_ops.DQ_QUADS)[None, :]
    r = (e0 - m0 * n)[:, None] + step * torch.arange(q_ops.DQ_QUADS)[None, :]
    row = torch.where(r + 4 > n, e // n, m0[:, None])
    r = e - row * n
    live = e // 4 < quads
    e, r, row = e[live], r[live], row[live]
    if bits == 8:
        at = q0 + e
        word, sh = at >> 2, at & 3
        two = sh != 0
    else:
        at = 2 * q0 + e + (row if pad else 0)
        word, sh = at >> 3, at & 7
        two = sh > 4
    whole = (r + 4 <= n) & (word + two.to(torch.int64) < qwords)
    lo = words[word.clamp_max(words.numel() - 1)]
    hi = torch.where(two, words[(word + 1).clamp_max(words.numel() - 1)], 0)
    k = torch.arange(4)
    if bits == 8:
        both = lo | (hi << 32)  # __byte_perm(lo, hi, 0x3210 + 0x1111 sh)
        byte = (both[:, None] >> (8 * (sh[:, None] + k[None, :]))) & 0xFF
        lv = torch.where(byte >= 128, byte - 256, byte)
    else:
        blo, bhi = _bswap(lo), _bswap(hi)  # the nibble stream, top first
        sh4 = 4 * sh
        win = ((blo << sh4) | (bhi >> (32 - sh4))) & prng.MASK
        lv = ((win[:, None] >> (28 - 4 * k[None, :])) & 0xF) - 8
    assert bool(((out_addr + 4 * e[whole]) % 16 == 0).all())
    alone = torch.cat([(e[~whole][:, None] + k[None, :]).reshape(-1),
                       torch.arange(4 * quads, total)])
    arow = alone // n
    if bits == 8:
        a = qb[alone].to(torch.int64)
        alv = torch.where(a >= 128, a - 256, a)
    else:
        anib = alone + arow if pad else alone
        a = qb[anib >> 1].to(torch.int64)
        alv = torch.where(anib % 2 == 1, a & 0xF, a >> 4) - 8
    elems = torch.cat([(e[whole][:, None] + k[None, :]).reshape(-1), alone])
    rows = torch.cat([row[whole][:, None].expand(-1, 4).reshape(-1), arow])
    levels = torch.cat([lv[whole].reshape(-1), alv]).to(torch.float32)
    assert torch.equal(torch.bincount(elems, minlength=total),
                       torch.ones(total, dtype=torch.int64))
    lv_n = 2 ** (bits - 1) - 1
    p = q_ops.ref.ftz(scale.reshape(-1)[rows]) * levels
    if plane:
        v = q_ops.ref.round_ftz(p.double() / lv_n)
    else:
        inv = torch.tensor(1.0, dtype=torch.float32) / lv_n
        v = q_ops.ref.round_ftz(p.double() * inv.double())
    out = torch.empty(total, dtype=torch.float32)
    out[elems] = v
    return out.reshape(m, n), quads, int((~whole).sum())


@pytest.mark.parametrize("form", ["tensor", "plane"])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m", [1, 3, 7])
@pytest.mark.parametrize("n", [1, 5, 15, 16, 17, 1023, 4097])
def test_dequantize_walk_step_for_step(n, m, bits, form):
    """K5's walk (quads of 4 from the aligned words of q, rows straddling
    quads, odd-n nibble rows) gives the plain versions' bits with q at
    every offset in its first word (a view of q 1-3 bytes past an aligned
    address), and with out misaligned (every element alone)."""
    rs = np.random.RandomState(n * 31 + m * 7 + bits)
    wire = q_ops.wire_len(n, bits)
    q = torch.from_numpy(rs.randint(0, 256, (m, wire)).astype(np.uint8))
    if bits == 8:
        q = q.view(torch.int8)
    scale = torch.from_numpy(
        (rs.standard_normal(m) * 10.0 ** rs.randint(-30, 30, m))
        .astype(np.float32))
    scale[0] = 50 * q_ops.ref.TINY  # levels times it reach below tiny
    plane = form == "plane"
    want = (q_ops.ref.dequantize_plane_ref if plane
            else q_ops.ref.dequantize_tensor_ref)(q, scale, n=n, bits=bits)
    for q_addr, out_addr in ((256, 512), (257, 512), (258, 512), (259, 512),
                             (256, 516)):
        got, quads, alone = _k5_walk(q, scale, n, bits, plane, q_addr,
                                     out_addr)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        if quads and m > 1 and n in (15, 17, 1023):
            assert alone > 0  # some quad straddles two rows


def test_dequantize_walk_sizes_match_the_wrappers():
    """The CPU model walks K5 with the sizes of csrc/quantize_leaf.cu:
    each constant there equals its mirror in quantize/ops.py."""
    src = (Path(q_ops.__file__).resolve().parents[2] / "csrc"
           / "quantize_leaf.cu").read_text()
    for line in (f"constexpr int kDqThreads = {q_ops.DQ_THREADS};",
                 f"constexpr int kDqQuad = {q_ops.DQ_QUAD};",
                 f"constexpr int kDqQuads = {q_ops.DQ_QUADS};"):
        assert src.count(line) == 1, line
    assert q_ops.DQ_QUAD == 4  # a quad: one float4 store


# (f32 bits of a, f32 b, op): one f32 operation whose exact result lies
# just below tiny, where IEEE rounding and XLA's flushing arithmetic part
# (found by a numpy search; the last is a tie on the subnormal grid)
BELOW_TINY = ((66977792, 1 / 127, "mul"), (31457279, 1 / 7, "mul"),
              (22369620, 0.3, "mul"), (0x017FFFFF, 4.0, "div"))


@pytest.mark.parametrize("a_bits,b,op", BELOW_TINY)
def test_round_ftz_matches_xla_below_tiny(a_bits, b, op):
    """``ref.round_ftz`` rounds a result below tiny as XLA's CPU arithmetic
    does (to nearest with an unbounded exponent, then flushed), where
    IEEE rounding would give tiny."""
    a = np.array([a_bits], np.uint32).view(np.float32)
    bf = np.float32(b)
    fn = (lambda u, w: u * w) if op == "mul" else (lambda u, w: u / w)
    want = np.asarray(jax.jit(fn)(jnp.asarray(a), jnp.float32(bf)))
    v = fn(torch.from_numpy(a).double(), float(bf))
    _same_f32(q_ops.ref.round_ftz(v).numpy(), want)


def test_quantizer_key_rows_match_the_kernel():
    """K4's wrapper hands the kernel one int32 (k0, k1) row of uint32 bit
    patterns per message, in the keys' order, converted where the keys
    lie; keys that do not match the messages' shape are refused."""
    keys = jaxrand.split(jaxrand.key(3), 257)
    words = q_ops._key_words(keys.reshape(257, 1, 2), (257, 1),
                             torch.device("cpu"))
    assert words.dtype == torch.int32 and words.shape == (257, 2)
    assert words.is_contiguous()
    want = np.asarray(keys.numpy(), np.int64).astype(np.uint32)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), want)
    meta = q_ops._key_words(keys, (257,), torch.device("meta"))
    assert meta.device.type == "meta" and meta.shape == (257, 2)
    with pytest.raises(ValueError, match="do not match"):
        q_ops._key_words(keys, (256,), torch.device("cpu"))


@pytest.mark.parametrize("extra", [-1, 1])
def test_launch_refuses_a_wrong_argument_count(extra):
    """A C entry called with more or fewer arguments than its ENTRIES
    signature is refused before any library is loaded."""
    k = len(_build.ENTRIES["quantize_leaf"][1]) + extra
    with pytest.raises(TypeError, match="quantize_leaf takes"):
        _build.launch("quantize_leaf", *([0] * k))


@pytest.mark.parametrize("m,n,k,kind", [(20, 2 ** 20, 629_146, "unique"),
                                        (10, 2 ** 20, 262_144, "unique"),
                                        (20, 1_000_003, 250_001, "claim"),
                                        (1, 5, 3, "claim")])
def test_scatter_variant_rule(m, n, k, kind):
    assert sg_ops.scatter_variant(kind == "unique") == kind
    nseg, windows, tiles, pair_words, start_words = sg_ops.bin_layout(
        m, n, k, kind)
    seg_len = 1 << sg_ops.SEG_LOG[kind]
    assert nseg == -(-n // seg_len) and tiles == -(-k // sg_ops.BIN_TILE)
    assert windows == 1  # every main-path row is one window
    # 8 bytes a pair for claim (position and offset share a word), 6 for
    # unique; a 16-bit offset and a 16-bit position fit
    assert 4 * pair_words == (8 if kind == "claim" else 6) * m * tiles \
        * sg_ops.BIN_TILE
    assert start_words == m * (nseg + 1) * tiles
    assert seg_len <= 2 ** 16 and sg_ops.BIN_TILE <= 2 ** 16
    # a longer row: windows of MAX_SEGS segments, the scratch of one
    window = sg_ops.MAX_SEGS * seg_len
    assert sg_ops.bin_layout(m, 2 * window + 1, k, kind) == (
        sg_ops.MAX_SEGS, 3, tiles, pair_words,
        m * (sg_ops.MAX_SEGS + 1) * tiles)


def test_index_rows_int64_and_int32_through_the_cpu_route():
    """K6/K7's CPU route takes int64 rows as the permutation's prefix (a
    strided view) and int32 rows alike, equal to the reference's kernels
    in interpret mode; an index outside [0, n) gives 0 (K6) and is
    skipped (K7)."""
    n, k = 4099, 1500
    x = _x((2, n), 9)
    rs = np.random.RandomState(3)
    perm = torch.from_numpy(np.stack([rs.permutation(n) for _ in range(2)]))
    idx64 = perm[:, :k]
    assert idx64.stride() == (n, 1) and idx64.dtype == torch.int64
    idx32 = idx64.to(torch.int32)
    xt = torch.from_numpy(x)
    v = sg_ops.sparse_gather(xt, idx64)
    assert torch.equal(v, sg_ops.sparse_gather(xt, idx32))
    for unique in (True, False):
        out = sg_ops.sparse_scatter(v, idx64, n, n / k, unique=unique)
        assert torch.equal(out, sg_ops.sparse_scatter(v, idx32, n, n / k,
                                                      unique=unique))
    for r in range(2):
        ji = jnp.asarray(idx32[r].numpy())
        _eq(v[r].numpy(), jsg.sparse_gather(jnp.asarray(x[r]), ji,
                                            interpret=True))
        _eq(out[r].numpy(), jsg.sparse_scatter(jnp.asarray(v[r].numpy()), ji,
                                               n, gain=n / k, interpret=True))
    far = idx64.clone()
    far[1, 7] = n + 2
    vf = sg_ops.sparse_gather(xt, far)
    assert float(vf[1, 7]) == 0.0 and torch.equal(vf[0], v[0])
    outf = sg_ops.sparse_scatter(v, far, n, n / k, unique=True)
    assert float(outf[1, int(idx64[1, 7])]) == 0.0
    keep = torch.ones(k, dtype=torch.bool)
    keep[7] = False
    assert torch.equal(outf[1], sg_ops.sparse_scatter(
        v[1:, keep], idx64[1:, keep], n, n / k, unique=True)[0])


SPECS = ["identity", "qbit:bits=8", "qbit:bits=4",
         "randk:fraction=0.4,sampler=uniform",
         "randk:fraction=0.4,sampler=block",
         "randk:fraction=0.4,sampler=stride", "topk:fraction=0.3"]


def _impl(spec, impl):
    return spec + ("," if ":" in spec else ":") + f"impl={impl}"


@pytest.mark.parametrize("spec,n", [(s, 37) for s in SPECS]
                         + [("qbit:bits=4", 1), ("randk:sampler=stride", 1)])
def test_torch_route_payloads_match_jnp(spec, n):
    jc = jcomp.get_compressor(_impl(spec, "jnp"))
    tc = comp.get_compressor(_impl(spec, "torch"))
    sids, rids = _ids()
    x = _x((A, S, n), n + 3)
    rk = jax.random.key(11)
    tk = jaxrand.key(11)
    jp, jrec = jcomp.plane_compress(
        jc, lambda s, r: jadmm._key_z(rk, s, r), jax.random.fold_in(rk, 13),
        jnp.asarray(sids.astype(np.int32)), jnp.asarray(rids.astype(np.int32)),
        jnp.asarray(x), jax.ShapeDtypeStruct((n,), jnp.float32))
    sh, rh = (torch.from_numpy(a.astype(np.int64)) for a in (sids, rids))
    tp, trec = comp.plane_compress(
        tc, lambda: admm._key_z(tk, sh, rh), jaxrand.fold_in(tk, 13),
        None, None, torch.from_numpy(x), comp.Spec((n,)))
    assert sorted(tp) == sorted(jp)
    for name in tp:
        _eq(tp[name].numpy(), jp[name])
    _eq(trec.numpy(), jrec)
    # the receiver rebuilds the same message from the payload alone
    back = comp.plane_decompress(tc, lambda: admm._key_z(tk, sh, rh),
                                 jaxrand.fold_in(tk, 13), None, None, tp,
                                 comp.Spec((n,)))
    _eq(back.numpy(), trec.numpy())


@pytest.mark.parametrize("spec", SPECS)
def test_wire_bytes_match(spec):
    jc, tc = jcomp.get_compressor(spec), comp.get_compressor(spec)
    for shape in [(5,), (3, 4), (1,), (2 ** 20,)]:
        assert tc.wire_bytes(shape, torch.float32) == jc.wire_bytes(
            shape, jnp.float32)
        assert tc.variance_p(shape) == jc.variance_p(shape)


@pytest.mark.parametrize("bad", [
    "qbit:bit=4", "randk:fractoin=0.1", "topk:x", "foo:bits=4",
    "identity:bits=4", "randk:sampler=bogus", "qbit:bits=3",
    "qbit:bits", "randk:fraction=0.2,bits=8",
])
def test_spec_errors_match(bad):
    with pytest.raises(ValueError) as jerr:
        jcomp.validate_spec(bad)
    with pytest.raises(ValueError) as terr:
        comp.validate_spec(bad)
    assert str(terr.value) == str(jerr.value)


# (k0, k1, j): raw keys whose jax.random.bits word at element j is
# >= 2^32 - 128, so that kappa rounds to 1.0 there (found by a numpy
# search over random keys; checked against jax in the test)
SATURATING_KEYS = ((543808644, 1486979388, 944), (3917027860, 3836244836, 966),
                   (781517975, 2568259190, 493), (1025103629, 3342442247, 743))


def _jkey(words):
    return jax.random.wrap_key_data(jnp.asarray(np.asarray(words, np.uint32)))


@pytest.mark.parametrize("n", [5, 1000, 1024, 4099])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_tensor_matches_reference(n, bits):
    """K4/K5's plain versions against ``quantize_tensor`` /
    ``dequantize_tensor`` in interpret mode: q, scale and the dequantized
    message bit-equal.  Where n allows, rows keyed by SATURATING_KEYS hold
    their max |x| (a power of two) at the element whose kappa is 1.0."""
    levels = 2 ** (bits - 1) - 1
    rs = np.random.RandomState(n + bits)
    plants = [kk for kk in SATURATING_KEYS if kk[2] < n]
    words = [tuple(int(w) for w in rs.randint(0, 2 ** 32, 2, np.uint64))
             for _ in range(2)] + [kk[:2] for kk in plants]
    x = _x((len(words), n), n)
    for r, (_, _, j) in enumerate(plants, start=2):
        sign = -1.0 if r % 2 else 1.0
        x[r, j] = sign * 2.0 ** math.ceil(math.log2(2 * np.abs(x[r]).max()))
    keys = torch.tensor(words, dtype=torch.int64)
    q, sc = q_ops.quantize_tensor(keys, torch.from_numpy(x), bits=bits)
    out = q_ops.dequantize_tensor(q, sc, n=n, bits=bits)
    for r, w in enumerate(words):
        want = jq.quantize_tensor(_jkey(w), jnp.asarray(x[r]), bits=bits,
                                  interpret=True)
        _eq(q[r].numpy(), want["q"])
        _eq(sc[r].numpy(), want["scale"])
        _eq(out[r].numpy(), jq.dequantize_tensor(want, (n,), bits=bits,
                                                 interpret=True))
    for r, (k0, k1, j) in enumerate(plants, start=2):
        n_pad = -(-n // 1024) * 1024
        assert int(jax.random.bits(_jkey((k0, k1)), (n_pad,),
                                   jnp.uint32)[j]) >= 2 ** 32 - 128
        if bits == 8:  # 128 saturates to 127 (not -128); -128 stays
            assert int(q[r, j]) == (127 if r % 2 == 0 else -128)
        else:  # level 8 is nibble 16: its own 4 bits are 0
            byte = int(q[r, j // 2])
            assert (byte >> 4 if j % 2 == 0 else byte) & 0xF == 0
        assert levels + 1 == float(q_ops.ref.quantize_values(
            torch.tensor(x[r, j]), sc[r], 1.0, levels).abs())


@pytest.mark.parametrize("n", [5, 1031, 4099])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_tensor_edge_rows_match_reference(n, bits):
    """K4's and K5's plain versions on the quantiser's edge rows (see
    ``test_quantize_plane_edge_rows_match_reference``) against
    ``quantize_tensor`` / ``dequantize_tensor`` in interpret mode, row by
    row: q, scale and the dequantised message bit for bit; and K5 on
    levels at scale = tiny, whose products the reference flushes."""
    rs = np.random.RandomState(n + bits + 1)
    words = [tuple(int(w) for w in rs.randint(0, 2 ** 32, 2, np.uint64))
             for _ in range(8)]
    x = _edge_x(8, n, n + 7)
    keys = torch.tensor(words, dtype=torch.int64)
    q, sc = q_ops.quantize_tensor(keys, torch.from_numpy(x), bits=bits)
    out = q_ops.dequantize_tensor(q, sc, n=n, bits=bits)
    for r, w in enumerate(words):
        want = jq.quantize_tensor(_jkey(w), jnp.asarray(x[r]), bits=bits,
                                  interpret=True)
        _eq(q[r].numpy(), want["q"])
        _same_f32(sc[r].numpy(), want["scale"])
        _same_f32(out[r].numpy(), jq.dequantize_tensor(
            want, (n,), bits=bits, interpret=True))
    lv = np.resize(TINY_LEVELS, n)
    tq = lv if bits == 8 else np.asarray(q_ops.ref.pack4(
        torch.from_numpy(np.clip(lv, -7, 7).astype(np.float32))))
    tiny = np.float32(np.finfo(np.float32).tiny)
    got = q_ops.dequantize_tensor(torch.from_numpy(tq)[None],
                                  torch.tensor([tiny]), n=n, bits=bits)
    _same_f32(got[0].numpy(), jq.dequantize_tensor(
        {"q": jnp.asarray(tq), "scale": jnp.asarray(tiny)}, (n,), bits=bits,
        interpret=True))


@pytest.mark.parametrize("bits", [8, 4])
def test_torch_route_edge_rows_match_jnp(bits):
    """The per-message torch route of ``qbit`` (its inline quantiser and
    dequantiser) against ``impl=jnp`` on the quantiser's edge rows."""
    n = 1031
    spec = f"qbit:bits={bits}"
    jc = jcomp.get_compressor(_impl(spec, "jnp"))
    tc = comp.get_compressor(_impl(spec, "torch"))
    x = _edge_x(8, n, 3)
    tkeys = jaxrand.split(jaxrand.key(n), 8)
    tp = comp.compress_tree(tc, tkeys, torch.from_numpy(x), nd=1)
    trec = comp.decompress_tree(tc, tkeys, tp, comp.Spec((n,)), nd=1)
    for r in range(8):
        jk = _jkey(tkeys[r].numpy())
        jp = jcomp.compress_tree(jc, jk, jnp.asarray(x[r]))
        _eq(tp["q"][r].numpy(), jp["q"])
        _same_f32(tp["scale"][r].numpy(), jp["scale"])
        _same_f32(trec[r].numpy(), jcomp.decompress_tree(
            jc, jk, jp, jax.ShapeDtypeStruct((n,), jnp.float32)))


PER_MESSAGE_SPECS = ["qbit:bits=8", "qbit:bits=4", "topk:fraction=0.3",
                     "randk:fraction=0.25,sampler=uniform",
                     "randk:fraction=0.25,sampler=stride",
                     "randk:fraction=0.25,sampler=block"]


@pytest.mark.parametrize("n", [1000, 4099])
@pytest.mark.parametrize("spec", PER_MESSAGE_SPECS)
def test_kernel_route_per_message_matches_pallas(spec, n):
    """The per-message kernel route (K4/K5, K6/K7, K8/K9 plain versions on
    the CPU) against the reference's ``impl=pallas`` leaf path in interpret
    mode, message by message: payloads and reconstructions bit-equal."""
    jc = jcomp.get_compressor(_impl(spec, "pallas"))
    tc = comp.get_compressor(_impl(spec, "kernel"))
    x = _x((3, n), n + 1)
    tkeys = jaxrand.split(jaxrand.key(n), 3)
    tp = comp.compress_tree(tc, tkeys, torch.from_numpy(x), nd=1)
    trec = comp.decompress_tree(tc, tkeys, tp, comp.Spec((n,)), nd=1)
    for r in range(3):
        jk = _jkey(tkeys[r].numpy())
        jp = jcomp.compress_tree(jc, jk, jnp.asarray(x[r]))
        assert sorted(tp) == sorted(jp)
        for name in tp:
            _eq(tp[name][r].numpy(), jp[name])
        _eq(trec[r].numpy(), jcomp.decompress_tree(
            jc, jk, jp, jax.ShapeDtypeStruct((n,), jnp.float32)))


def _bits(a):
    """Float32 array as its bit patterns: tells -0.0 from +0.0."""
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


@pytest.mark.parametrize("n,k", [(5, 1), (5, 5), (1024, 700), (3000, 1),
                                 (3000, 1800), (3000, 3000), (4099, 2459)])
def test_cyclic_window_matches_reference(n, k):
    """K8/K9's plain versions against ``cyclic_gather``/``cyclic_scatter``
    in interpret mode, bit for bit (signs of zero included), one message
    per offset: 0, n - 1, an inner one, and two outside [0, n) that both
    reduce mod n.  The last message's values are all -0.0: the
    reference's K9 returns them as +0.0, its jnp version keeps -0.0."""
    offs = [0, n - 1, n // 3, 2 * n + 5, -3]
    x = _x((len(offs), n), n + k)
    v = _x((len(offs), k), n - k)
    v[-1] = -0.0
    gain = n / k
    t_off = torch.tensor(offs, dtype=torch.int64)
    got_v = sg_ops.cyclic_gather(torch.from_numpy(x), t_off, k)
    got = sg_ops.cyclic_scatter(torch.from_numpy(v), t_off, n, gain)
    assert got_v.shape == (len(offs), k) and got.shape == (len(offs), n)
    for r, off in enumerate(offs):
        jo = jnp.asarray(off, jnp.int32)
        np.testing.assert_array_equal(
            _bits(got_v[r].numpy()),
            _bits(jsg.cyclic_gather(jnp.asarray(x[r]), jo, k,
                                    interpret=True)))
        np.testing.assert_array_equal(
            _bits(got[r].numpy()),
            _bits(jsg.cyclic_scatter(jnp.asarray(v[r]), jo, n, gain=gain,
                                     interpret=True)))
    assert not np.signbit(got[-1].numpy()).any()
    from repro.kernels.sparse_gather import ref as jsg_ref

    assert np.signbit(np.asarray(jsg_ref.cyclic_scatter_ref(
        jnp.asarray(v[-1]), offs[-1] % n, n, gain))).sum() == k


def test_sparse_scatter_repeated_indices_match_reference():
    """The stride sampler's int32 wrap repeats indices at n = 100,003:
    K7's plain version (the claim pass's rule) keeps the last j, as the
    reference's scatter kernel does in interpret mode; K6 gathers them."""
    n = 100_003
    k = n // 4
    strides = prng.coprime_strides(n)
    assert not sg_ops.indices_unique(n, k, strides)
    keys = jaxrand.split(jaxrand.key(5), 64)
    idx = prng.affine_indices((keys[:, 0], keys[:, 1]), n, k, strides)
    repeats = torch.tensor([k - torch.unique(r).numel() for r in idx])
    # three rows whose index set repeats, one whose set does not
    rows = torch.cat([torch.nonzero(repeats).reshape(-1)[:3],
                      torch.nonzero(repeats == 0).reshape(-1)[:1]])
    idx = idx[rows]
    assert int((repeats[rows] > 0).sum()) == 3
    x, v = _x((4, n), 3), _x((4, k), 4)
    got_v = sg_ops.sparse_gather(torch.from_numpy(x), idx)
    got = sg_ops.sparse_scatter(torch.from_numpy(v), idx, n, n / k,
                                unique=False)
    for r in range(4):
        ji = jnp.asarray(idx[r].numpy().astype(np.int32))
        _eq(got_v[r].numpy(), jsg.sparse_gather(jnp.asarray(x[r]), ji,
                                                interpret=True))
        _eq(got[r].numpy(), jsg.sparse_scatter(jnp.asarray(v[r]), ji, n,
                                               gain=n / k, interpret=True))


@pytest.mark.parametrize("spec,fused", [
    ("randk:sampler=uniform,impl=kernel", False),
    ("randk:sampler=stride,impl=kernel", True),
    ("topk:impl=kernel", False),
    ("qbit:bits=8,impl=kernel", True),
    ("randk:sampler=block,impl=kernel", True)])
def test_kernel_route_without_a_ported_kernel_raises(spec, fused):
    """Every per-message kernel route runs, the RandK block sampler's
    (K8/K9) included: no kernel of the route is left unported."""
    x = torch.from_numpy(_x((2, 8)))
    keys = jaxrand.split(jaxrand.key(0), 2)
    c = comp.get_compressor(spec)
    assert comp.use_fused(c, "cpu") == fused
    p = c.compress(keys, x)
    assert p.wire_bytes == 2 * c.wire_bytes((8,), torch.float32)
    assert c.decompress(keys, p, 8).shape == (2, 8)
    # identity has nothing to fuse and no kernel to miss
    assert comp.get_compressor("identity:impl=kernel").compress(
        keys, x)["v"] is x


def test_impl_resolution():
    c = comp.get_compressor("qbit:bits=8")
    assert comp.resolve_impl(c.impl, "cpu") == "torch"
    assert comp.resolve_impl(c.impl, "cuda") == "kernel"
    assert comp.resolve_impl("torch", "cuda") == "torch"


def test_kernel_param_is_not_a_second_spelling_of_impl():
    # the reference's deprecated kernel=true|false has no users here
    with pytest.raises(ValueError, match=r"unknown param\(s\) \['kernel'\]; "
                       r"valid params: \['bits', 'impl'\]"):
        comp.get_compressor("qbit:kernel=true")
