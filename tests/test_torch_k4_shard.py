"""K4's shard form over a message tree (``kernels/quantize/ops.py``
``tree_absmax`` / ``quantize_tree``, ``ShardPlan``;
``compression.BBitQuantizer.compress_shards``) on the CPU.

* The grouped plain version (``ref.tree_absmax_ref`` /
  ``quantize_tree_ref``) over a tree that mixes layouts (cut on dim 0, on
  the last dim, by head with inner > 1, zamba2's four-piece in_proj, odd
  local lengths, leaves held whole) on both ranks of a 2-way "model"
  axis, at b = 8 and 4: each rank's payloads and scales bit-equal to the
  per-leaf ``quantize_shard_ref``, and the ranks' levels, put back at
  their places, bit-equal to the live reference's ``quantize_tensor`` of
  the whole leaf (interpret mode), scales too.
* The plan's device table, read back and walked as the kernel walks it
  (``ShardMap``: each group's first place by multiply-highs, then steps;
  the scalar elements one at a time), gives every shard element's flat
  index in the whole leaf (``ShardLayout.counters``).
* The host's divmod constants with the kernel's multiply-high give
  ``n // d`` and ``n % d`` for every divisor that the repo's TP layouts
  give the kernel (every arch, full and smoke, "model" axes of 2 to 16)
  at edge values up to 2^32 - 1.
* A 2-rank gloo world: ``compress_tree`` of a ``ShardedTree`` issues one
  ``all_reduce_max`` a tree (``tp.stats``) on the kernel route (its plain
  version here) and on the torch route, with the payloads of the
  per-leaf route.
* The two-axis class (class 3: a shard cut on a "data" dim, one part,
  and a "model" dim, by pieces, in either order; FSDP+TP) on all four
  shards of a (2 data, 2 model) layout of a tree that mixes it with
  leaves cut over one axis and leaves held whole: the grouped plain
  version bit-equal to the per-leaf one and, put back at their places,
  to the live reference's ``quantize_tensor`` of each whole leaf; the
  plan's table walked as the kernel walks class 3 gives every element's
  whole-leaf index.
"""
import math
import multiprocessing
import os
import pickle
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.quantize import ops as jq  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core import jaxrand  # noqa: E402
from repro_torch.kernels.quantize import ops as qops  # noqa: E402
from repro_torch.kernels.quantize import ref as qref  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402

RANKS = 2
M = 2  # messages (rows) a leaf
SEED = 31
_ZS = ARCHS["zamba2-2.7b"].make_smoke().ssm
_DI, _GS, _NH = _ZS.d_inner, 2 * _ZS.n_groups * _ZS.d_state, _ZS.n_heads
# (name, whole shape, LeafPlan): every class of the kernel's index map
TREE = (
    ("embed, dim 0", (6, 10), shd.LeafPlan(0, ((6, True),))),
    ("norm, whole", (7,), shd.LeafPlan(None)),
    ("wo, last dim", (5, 12), shd.LeafPlan(1, ((12, True),))),
    ("wq, by head", (4, 6, 3), shd.LeafPlan(1, ((6, True),))),
    ("in_proj, four pieces", (3, 2 * _DI + _GS + _NH),
     shd.LeafPlan(1, ((_DI, True), (_DI, True), (_GS, False),
                      (_NH, True)))),
    ("odd local length", (3, 14), shd.LeafPlan(1, ((14, True),))),
    ("odd, whole", (3, 5), shd.LeafPlan(None)),
    ("first dim 1", (1, 9, 4), shd.LeafPlan(1, ((8, True), (1, False)))),
)


def _layouts(rank):
    return tuple(shd.leaf_layout(p, s, rank, RANKS) for _, s, p in TREE)


def _tree(rng):
    return [rng.standard_normal((M,) + s).astype(np.float32)
            for _, s, _ in TREE]


def _keys():
    """``[M, L, 2]``: message m of leaf i keyed by fold_in(fold_in(key,
    i), m), and the reference's same keys."""
    port = torch.stack([torch.stack([
        jaxrand.fold_in(jaxrand.fold_in(jaxrand.key(SEED), i), m)
        for i in range(len(TREE))]) for m in range(M)])
    ref = [[jax.random.fold_in(jax.random.fold_in(jax.random.key(SEED), i),
                               m) for m in range(M)]
           for i in range(len(TREE))]
    return port, ref


def _shards(whole, layouts):
    return [torch.from_numpy(w).reshape(M, -1)[:, lay.counters("cpu")]
            .contiguous() for w, lay in zip(whole, layouts)]


@pytest.fixture(scope="module")
def tree():
    rng = np.random.default_rng(SEED)
    whole = _tree(rng)
    whole[0][0, 1, 3] = 0.0  # a zero and a max at a shard's last element
    whole[2][1, -1, -1] = 9.0
    return whole


@pytest.mark.parametrize("bits", (8, 4))
def test_grouped_plain_is_the_whole_leaf_payload(tree, bits):
    keys, jkeys = _keys()
    per_rank = []
    for r in range(RANKS):
        lays = _layouts(r)
        xs = _shards(tree, lays)
        per_rank.append((lays, xs, qops.tree_absmax(xs, lays)))
    cut = qops.cut_rows(per_rank[0][0], M)
    reduced = torch.maximum(per_rank[0][2][:cut], per_rank[1][2][:cut])
    got = []
    for lays, xs, words in per_rank:
        assert words.shape == (len(TREE) * M,)
        out = qops.quantize_tree(keys, xs, words, lays, bits=bits,
                                 reduced=reduced)
        # against the per-leaf plain version
        order = qref.tree_order(lays)
        for i, (x, lay) in enumerate(zip(xs, lays)):
            p = order.index(i)
            w = (reduced[p * M:(p + 1) * M] if lay.cut
                 else words[p * M:(p + 1) * M])
            one = lay if lay.cut else qref.ShardLayout(lay.shape)
            q1, s1 = qref.quantize_shard_ref(keys[:, i], x, w, one,
                                             bits=bits)
            assert torch.equal(out[i][0], q1), TREE[i][0]
            assert torch.equal(out[i][1].view(torch.int32),
                               s1.view(torch.int32)), TREE[i][0]
        got.append(out)
    # the ranks' levels at their places: the reference's whole-leaf payload
    quantize = jax.jit(lambda k, x: jq.quantize_tensor(k, x, bits=bits,
                                                       interpret=True))
    for i, (name, shape, _) in enumerate(TREE):
        n = math.prod(shape)
        for m in range(M):
            levels = torch.full((n,), 99, dtype=torch.int32)
            for r in range(RANKS):
                q, sc = got[r][i]
                lay = per_rank[r][0][i]
                nl = per_rank[r][1][i].shape[-1]
                lv = q[m] if bits == 8 else qref.unpack4(q[m], nl)
                levels[lay.counters("cpu")] = lv.to(torch.int32)
            x = np.pad(tree[i][m].reshape(-1), (0, -n % qref.BLOCK))
            want = quantize(jkeys[i][m], jnp.asarray(x))
            wq = np.asarray(want["q"])
            wl = (wq.astype(np.int32)[:n] if bits == 8 else
                  qref.unpack4(torch.from_numpy(wq.view(np.uint8).copy()), n)
                  .numpy())
            np.testing.assert_array_equal(levels.numpy(), wl[:n],
                                          err_msg=f"{name} message {m}")
            for r in range(RANKS):
                assert float(got[r][i][1][m]) == float(want["scale"]), name


def _walk(words, j, group):
    """The kernel's ``ShardMap`` over a table entry: element j's flat index
    in the whole leaf, as one element (``group`` 1) or as the first of a
    group whose place is stepped from j's."""
    sw = qops.SW
    e = {k: int(words[i]) & 0xFFFFFFFF for k, i in sw.items()
         if k not in qops._PIECE_WORDS}
    pieces = [tuple(int(words[sw[k] + p]) for k in ("ls", "gs", "len"))
              for p in range(e["pieces"])]

    def div(n, m, s):
        t = (n * m) >> 32
        return (t + ((n - t) >> (s & 0xFF))) >> (s >> 8)

    pieces2 = [tuple(int(words[sw[k] + p]) for k in ("ls2", "gs2", "len2"))
               for p in range(e["pieces2"])]

    def along(lv, ps=pieces):
        for ls, gs, ln in ps:
            if 0 <= lv - ls < ln:
                return lv - ls + gs
        return lv

    if e["cls"] == 0:
        return [j + e["base"] + k for k in range(group)]
    outer = div(j, e["block_m"], e["block_s"])
    r = j - outer * e["block"]
    out = []
    if e["cls"] == 1:
        v = j + outer * e["delta"] + e["base"]
        for _ in range(group):
            out.append(v & 0xFFFFFFFF)
            v += 1
            r += 1
            if r == e["block"]:
                r, v = 0, v + e["delta"]
        return out
    lv = div(r, e["inner_m"], e["inner_s"])
    i = r - lv * e["inner"]
    if e["cls"] == 2:
        for _ in range(group):
            out.append((outer * e["gdim"] + along(lv)) * e["inner"] + i)
            i += 1
            if i == e["inner"]:
                i, lv = 0, lv + 1
                if lv == e["ldim"]:
                    lv, outer = 0, outer + 1
        return out
    # class 3: the outer index as (o, a, c), stepped with the rest
    t = div(outer, e["mid_m"], e["mid_s"])
    o = div(t, e["ldim2_m"], e["ldim2_s"])
    a, c = t - o * e["ldim2"], outer - t * e["mid"]
    for _ in range(group):
        go = (o * e["gdim2"] + along(a, pieces2)) * e["mid"] + c
        out.append((go * e["gdim"] + along(lv)) * e["inner"] + i)
        i += 1
        if i == e["inner"]:
            i, lv = 0, lv + 1
            if lv == e["ldim"]:
                lv, c = 0, c + 1
                if c == e["mid"]:
                    c, a = 0, a + 1
                    if a == e["ldim2"]:
                        a, o = 0, o + 1
    return out


@pytest.mark.parametrize("rank", range(RANKS))
def test_plan_table_maps_every_element_to_its_whole_leaf_index(rank):
    lays = _layouts(rank)
    plan = qops.ShardPlan(lays, M, torch.device("cpu"))
    (launch,) = plan.launches
    table = launch.table.reshape(len(lays), qops.SHARD_WORDS)
    assert tuple(launch.leaves) == qref.tree_order(lays)
    classes = set()
    first = 0
    for row, i in zip(table.tolist(), launch.leaves):
        lay = lays[i]
        n = plan.n[i]
        e = plan.entries[i]
        classes.add(e["cls"])
        assert row[qops.SW["first"]] == first
        assert row[qops.SW["tiles"]] == -(-n // qops.Q_TILE)
        first += M * row[qops.SW["tiles"]]
        want = (lay.counters("cpu") if lay.cut
                else torch.arange(lay.numel)).tolist()
        assert n == len(want), TREE[i][0]
        assert [_walk(row, j, 1)[0] for j in range(n)] == want, TREE[i][0]
        for g in (4, 8):  # the groups of b = 8 and b = 4, from any start
            for j in range(0, n - g + 1):
                assert _walk(row, j, g) == want[j:j + g], (TREE[i][0], j)
    assert classes == {0, 1, 2}
    assert launch.tiles == first


def _divisors():
    """Every ``block`` (ldim * inner) and ``inner`` that the repo's TP
    layouts give the kernel: every arch, full and smoke, on "model" axes
    of 2, 4, 8 and 16, both ranks' ends (a leaf of 2^32 elements or more
    is refused)."""
    from repro_torch.launch import steps

    class Axis:
        def __init__(self, n, r):
            self.shape = {"data": 1, "model": n}
            self.axis_names = ("data", "model")
            self._r = r

        def get_local_rank(self, axis):
            return self._r

    out = set()
    for arch in ARCHS.values():
        for cfg in (arch.make(None), arch.make_smoke()):
            specs = steps.model_specs(arch, cfg)
            for size in (2, 4, 8, 16):
                for r in (0, size - 1):
                    try:
                        lays = shd.shard_layouts(Axis(size, r), "admm",
                                                 specs)
                    except ValueError:
                        continue
                    for lay in lays:  # the kernel refuses 2^32 elements
                        if lay.cut and lay.numel < 2 ** 32:
                            e = qops.shard_entry(lay)
                            out.update((e["block"], e["inner"]))
    return sorted(out)


def test_fast_divmod_is_integer_division():
    divs = _divisors()
    assert len(divs) > 20 and 1 in divs
    extra = [2, 3, 7, 641, 2 ** 16 + 1, 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 1,
             2 ** 32 - 1, 4_294_967_291]
    top = 2 ** 32 - 1
    rng = np.random.default_rng(1)
    for d in divs + extra:
        m, s = qops.fast_divmod(d)
        assert 0 < m < 2 ** 32
        k = np.array([top // d - 1, top // d, 1, 2], dtype=np.uint64)
        n = np.concatenate([
            np.array([0, 1, d - 1, d, d + 1, top, top - 1, top - d],
                     dtype=np.uint64),
            k * np.uint64(d), k * np.uint64(d) - np.uint64(1),
            rng.integers(0, 2 ** 32, 2000, dtype=np.uint64)])
        n = n[(n <= top)]
        t = (n * np.uint64(m)) >> np.uint64(32)
        q = (t + ((n - t) >> np.uint64(s & 0xFF))) >> np.uint64(s >> 8)
        np.testing.assert_array_equal(q, n // np.uint64(d), err_msg=str(d))
        np.testing.assert_array_equal(n - q * np.uint64(d),
                                      n % np.uint64(d), err_msg=str(d))


def _rank(rank, store, out_dir, whole):
    torch.set_num_threads(1)
    from repro_torch.common.trees import tree_flatten
    from repro_torch.core import compression
    from repro_torch.launch import tp
    from repro_torch.launch.mesh import make_host_mesh, use_mesh, world

    lays = _layouts(rank)
    tree = {f"l{i}": x.reshape((M,) + lay.local_shape)
            for i, (x, lay) in enumerate(zip(_shards(whole, lays), lays))}
    keys = torch.stack([jaxrand.fold_in(jaxrand.key(SEED), m)
                        for m in range(M)])
    res = {}
    with world("gloo", store, rank, RANKS):
        mesh = make_host_mesh(RANKS, model=RANKS)
        with use_mesh(mesh):
            for impl in ("kernel", "torch"):
                for bits in (8, 4):
                    comp = compression.BBitQuantizer(bits=bits, impl=impl)
                    sharded = compression.ShardedTree(comp, lays)
                    tp.reset_stats()
                    got = tree_flatten(compression.compress_tree(
                        sharded, keys, tree, nd=1),
                        is_leaf=lambda t: isinstance(t, compression.Payload)
                    )[0]
                    reduces = tp.stats["all_reduce"]
                    leaves = tree_flatten(tree)[0]
                    lk = jaxrand.split(keys, len(leaves))
                    tp.reset_stats()
                    one = [sharded.leaf(i).compress(
                        lk[:, i], x.reshape(M, -1))
                        for i, x in enumerate(leaves)]
                    res[impl, bits] = (reduces, tp.stats["all_reduce"],
                                       all(torch.equal(a[k], b[k])
                                           for a, b in zip(got, one)
                                           for k in ("q", "scale")))
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def test_one_all_reduce_a_tree_in_a_gloo_world(tree):
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=_rank, args=(r, os.path.join(d, "s"), d,
                                                 tree))
                 for r in range(RANKS)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(120)
            assert p.exitcode == 0
        res = []
        for r in range(RANKS):
            with open(os.path.join(d, f"{r}.pkl"), "rb") as f:
                res.append(pickle.load(f))
    n_cut = sum(lay.cut for lay in _layouts(0))
    for got in res:
        assert set(got) == {(i, b) for i in ("kernel", "torch")
                            for b in (8, 4)}
        for key, (tree_reduces, leaf_reduces, same) in got.items():
            assert tree_reduces == 1, key
            assert leaf_reduces == n_cut, key
            assert same, key


# ---------------------------------------------------------------------------
# The two-axis class: FSDP's "data" dim beside the "model" dim
# ---------------------------------------------------------------------------

DATA = 2  # the "data" axis of the two-axis layouts (beside RANKS "model")
# (name, whole shape, LeafPlan with its data_dim): class 3 in both orders,
# with dims before, between and after the cuts, zamba2's four-piece
# in_proj under a data cut, and leaves cut over one axis or held whole
TREE2 = (
    ("embedding: model 0, data 1", (6, 10),
     shd.LeafPlan(0, ((6, True),), data_dim=1)),
    ("wq: data 0, model 1, inner", (4, 6, 3),
     shd.LeafPlan(1, ((6, True),), data_dim=0)),
    ("wo: model 0, mid, data 2", (4, 3, 10),
     shd.LeafPlan(0, ((4, True),), data_dim=2)),
    ("stacked wd: outer, model 1, data 2", (3, 8, 6),
     shd.LeafPlan(1, ((8, True),), data_dim=2)),
    ("in_proj: data 0, four pieces", (4, 2 * _DI + _GS + _NH),
     shd.LeafPlan(1, ((_DI, True), (_DI, True), (_GS, False),
                      (_NH, True)), data_dim=0)),
    ("norm: data only", (10,), shd.LeafPlan(None, data_dim=0)),
    ("wk: data 1 only", (3, 8, 5), shd.LeafPlan(None, data_dim=1)),
    ("head norm, whole", (7,), shd.LeafPlan(None)),
    ("wu: model only", (5, 12), shd.LeafPlan(1, ((12, True),))),
)
COORDS = [(d, r) for d in range(DATA) for r in range(RANKS)]


def _layouts2(d, r):
    return tuple(shd.leaf_layout(p, s, r, RANKS, d, DATA)
                 for _, s, p in TREE2)


@pytest.fixture(scope="module")
def tree2():
    rng = np.random.default_rng(SEED + 1)
    whole = [rng.standard_normal((M,) + s).astype(np.float32)
             for _, s, _ in TREE2]
    whole[0][1, 5, 9] = 7.0  # a max at the last rank's last element
    return whole


def _keys2():
    port = torch.stack([torch.stack([
        jaxrand.fold_in(jaxrand.fold_in(jaxrand.key(SEED), i), m)
        for i in range(len(TREE2))]) for m in range(M)])
    ref = [[jax.random.fold_in(jax.random.fold_in(jax.random.key(SEED), i),
                               m) for m in range(M)]
           for i in range(len(TREE2))]
    return port, ref


def test_two_axis_layouts_take_class_3():
    classes = {}
    for d, r in COORDS:
        for (name, _, _), lay in zip(TREE2, _layouts2(d, r)):
            classes.setdefault(name, set()).add(qops.shard_entry(lay)["cls"])
    for name, cls in classes.items():
        if ": data 0, model" in name or "model 0, data" in name or (
                "model 1, data" in name or "four pieces" in name):
            assert cls == {3}, name
    assert classes["norm: data only"] == {0}  # one run of the leaf
    assert classes["wk: data 1 only"] == {1}
    assert classes["head norm, whole"] == {0}


@pytest.mark.parametrize("bits", (8, 4))
def test_two_axis_grouped_plain_is_the_whole_leaf_payload(tree2, bits):
    keys, jkeys = _keys2()
    per = {}
    for c in COORDS:
        lays = _layouts2(*c)
        xs = _shards(tree2, lays)
        per[c] = (lays, xs, qops.tree_absmax(xs, lays))
    cut = qops.cut_rows(per[COORDS[0]][0], M)
    assert all(qops.cut_rows(p[0], M) == cut for p in per.values())
    # one max over the agent's whole (data x model) group
    reduced = torch.stack([p[2][:cut] for p in per.values()]).amax(0)
    got = {}
    for c, (lays, xs, words) in per.items():
        out = qops.quantize_tree(keys, xs, words, lays, bits=bits,
                                 reduced=reduced)
        order = qref.tree_order(lays)
        for i, (x, lay) in enumerate(zip(xs, lays)):
            p = order.index(i)
            w = (reduced[p * M:(p + 1) * M] if lay.cut
                 else words[p * M:(p + 1) * M])
            one = lay if lay.cut else qref.ShardLayout(lay.shape)
            q1, s1 = qref.quantize_shard_ref(keys[:, i], x, w, one,
                                             bits=bits)
            assert torch.equal(out[i][0], q1), TREE2[i][0]
            assert torch.equal(out[i][1].view(torch.int32),
                               s1.view(torch.int32)), TREE2[i][0]
        got[c] = out
    quantize = jax.jit(lambda k, x: jq.quantize_tensor(k, x, bits=bits,
                                                       interpret=True))
    for i, (name, shape, _) in enumerate(TREE2):
        n = math.prod(shape)
        for m in range(M):
            levels = torch.full((n,), 99, dtype=torch.int32)
            for c in COORDS:
                q, _ = got[c][i]
                lay = per[c][0][i]
                nl = per[c][1][i].shape[-1]
                lv = q[m] if bits == 8 else qref.unpack4(q[m], nl)
                idx = lay.counters("cpu")
                held = levels[idx] != 99
                assert torch.equal(levels[idx][held],
                                   lv.to(torch.int32)[held]), name
                levels[idx] = lv.to(torch.int32)
            x = np.pad(tree2[i][m].reshape(-1), (0, -n % qref.BLOCK))
            want = quantize(jkeys[i][m], jnp.asarray(x))
            wq = np.asarray(want["q"])
            wl = (wq.astype(np.int32)[:n] if bits == 8 else
                  qref.unpack4(torch.from_numpy(wq.view(np.uint8).copy()), n)
                  .numpy())
            np.testing.assert_array_equal(levels.numpy(), wl[:n],
                                          err_msg=f"{name} message {m}")
            for c in COORDS:
                assert float(got[c][i][1][m]) == float(want["scale"]), name


@pytest.mark.parametrize("coord", COORDS, ids=lambda c: f"data{c[0]}-model{c[1]}")
def test_two_axis_plan_table_maps_every_element(coord):
    lays = _layouts2(*coord)
    plan = qops.ShardPlan(lays, M, torch.device("cpu"))
    (launch,) = plan.launches
    table = launch.table.reshape(len(lays), qops.SHARD_WORDS)
    classes = set()
    for row, i in zip(table.tolist(), launch.leaves):
        lay = lays[i]
        n = plan.n[i]
        classes.add(plan.entries[i]["cls"])
        want = (lay.counters("cpu") if lay.cut
                else torch.arange(lay.numel)).tolist()
        assert n == len(want), TREE2[i][0]
        assert [_walk(row, j, 1)[0] for j in range(n)] == want, TREE2[i][0]
        for g in (4, 8):
            for j in range(0, n - g + 1):
                assert _walk(row, j, g) == want[j:j + g], (TREE2[i][0], j)
    assert 3 in classes


def test_two_axis_layouts_of_every_arch_are_refused_or_mapped():
    """Every arch's mode "admm" layouts on a multi-pod (2, 4, 4) stand-in
    mesh (FSDP+TP): each cut leaf's entry validates, and a two-axis cut
    takes class 3."""
    from repro_torch.launch import steps

    class Axis:
        def __init__(self, d, r):
            self.shape = {"pod": 2, "data": 4, "model": 4}
            self.axis_names = ("pod", "data", "model")
            self._c = {"data": d, "model": r}

        def get_local_rank(self, axis):
            return self._c[axis]

    n3 = 0
    for arch in ARCHS.values():
        if not steps.tp_serving(arch, arch.make_smoke()):
            continue
        specs = steps.model_specs(arch, arch.make_smoke())
        for d, r in ((0, 0), (3, 3)):
            for lay in shd.shard_layouts(Axis(d, r), "admm", specs):
                if lay.cut:
                    e = qops.shard_entry(lay)
                    n3 += e["cls"] == 3
                    assert (e["cls"] == 3) == (lay.dim2 is not None)
    assert n3
