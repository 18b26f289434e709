"""Tensor-parallel training over the "model" axis (``launch/tp.py``'s
autograd collectives, the vocab-parallel cross entropy,
``steps.build_train`` with ``packed=false`` and ``build_ddp_train`` with a
mesh, ``compression.ShardedTree`` and K4's shard form) against the live
reference and the port's one-rank runs.

One spawned gloo world of 4 CPU ranks runs ``spmd_check.tp_train_suite``
on two meshes of the world, ``(2 data, 2 model)`` and ``(1 data, 4
model)``, for the smoke configs of qwen3 (its 2 KV heads whole beside
the rank's query head on the 4-way axis), zamba2 (Mamba mixers cut by
SSD head, B|C held whole), command-r (the parallel block, on the (1, 4)
mesh only) and pixtral (the untied head, embeddings in), on numpy-seeded
weights (``spmd_check.tp_weights``).  The reference's and the port's one-rank
runs here overlap the world.

* (a) ``loss_fn``'s gradients on the ranks' shards, gathered, lie within
  1e-5 of each leaf's scale of the reference's ``jax.grad(loss_fn)`` on
  the whole weights (f32; the sums over "model" reassociate), and the
  loss within 1e-5.  That is near f32's floor for zamba2's small
  leaves: its A_log gradient reads 8.8e-6 of scale from the port's
  one-rank one and 4.1e-6 (XLA's default threads, as here) to 6.2e-6
  (XLA on one thread) from the reference's.
* The same for qwen3 with every unit under ``torch.utils.checkpoint``
  (remat re-issues the forward collectives in backward).
* (b) Every leaf that the axis cuts, quantised on the ranks by K4's
  shard form (qbit8 and qbit4, its plain version here): the gathered
  levels, packed, are bit-equal to the reference's ``quantize_tensor``
  of the whole leaf (interpret mode), and so is each rank's scale.  A
  leaf held whole takes the one-rank K4 as it is.
* (c) One LT-ADMM-CC ``packed=false`` round (qbit8, tau 2, 2 agents on
  ``complete``) of ``build_train`` with the mesh: every state field,
  gathered, within 1e-5 of its scale of the port's one-rank round,
  except at elements where a level flipped under the reassociated
  gradients: such an element lies at most one level of its message from
  the one-rank value (x̂ and its mirror one level, z r rho times the two
  ends' levels), and the flips, counted in x̂ where they happen (the
  mirror and z follow them), number at most 1e-4 of x̂'s elements, all
  leaves together, and in each leaf at most 1e-4 of its elements or 12,
  the larger (the counts by leaf are printed).  A flip is f32
  noise: element e flips with a chance of about 127 |dx_e| / scale, dx
  the reassociated gradients' gap, which puts the expected count of a
  32k-element leaf of zamba2's shared block at about 3, the 1e-4 of it
  (hence the floor of 12); over all leaves the measured share is near
  1.5e-5.  x itself and the consensus error within 1e-5; the wire bytes
  are the one-rank solver's (the whole leaves').
* (d) A ``build_ddp_train`` step on the shards (each rank its data
  share) against one process's step on the whole batch: the loss and
  Adam's moments within 1e-5 (held on the ranks).
* qbit8's torch route on the shards, gathered, equals the port's torch
  route on the whole leaf.
* (e) RandK on a leaf cut over "model" raises ``NotImplementedError``
  (on the ranks and here for TopK).
* The dry-run's train record with ``"solver": "ltadmm:packed=false"``
  applies the TP plan (``tp_applied`` true, ``fsdp_applied`` false on the
  single pod, the shards in ``sharded``).
"""
import concurrent.futures
import functools
import multiprocessing
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.archs import ARCHS as JARCHS  # noqa: E402
from repro.kernels.quantize import ops as jq  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch.common.trees import dict_paths, tree_map  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core import compression, jaxrand  # noqa: E402
from repro_torch.kernels.quantize import ref as qref  # noqa: E402
from repro_torch.launch import dryrun, spmd_check, steps  # noqa: E402

# see tests/test_torch_ssd.py: torch 2.13.0+cpu's first exp of a process
torch.exp(torch.linspace(-20.0, 20.0, 50_000))

WORLD, MODELS = 4, (2, 4)
ARCH_IDS = spmd_check.TP_TRAIN_ARCHS
ON_MESH = {2: spmd_check.TP_TRAIN_ARCHS_2D, 4: ARCH_IDS}
CASES = [(a, m) for a in ARCH_IDS for m in MODELS if a in ON_MESH[m]]
IDS = [f"{a}-model{m}" for a, m in CASES]
GRAD_TOL = 1e-5  # of each leaf's scale
STATE_TOL = 1e-5  # of each field's scale, off the flipped elements
FLIP_SHARE = 1e-4  # of x_hat's elements, and of each leaf's ...
# ... or FLIP_FLOOR, where a leaf is too small for 1e-4 of it to stand
# above the flips' noise: a leaf's flips are about Poisson, of mean 3.3 in
# zamba2's 32k-element shared.attn.wk (see the module's docstring), and
# Poisson(3.3) reaches 12 about twice in 1e4 draws
FLIP_FLOOR = 12
LEVELS = 127  # qbit8


@pytest.fixture(scope="module")
def world():
    with tempfile.TemporaryDirectory() as d:
        ctx = spmd_check.start_world("tp_train", WORLD, d, model=2)
        results = []

        def ranks():
            if not results:
                results.extend(spmd_check.collect_world(ctx, WORLD, d))
            return results

        yield ranks
        ranks()


@functools.lru_cache(maxsize=None)
def _ref_grads(arch_id):
    cfg = JARCHS[arch_id].make_smoke()
    params = jax.tree.map(jnp.asarray, spmd_check.tp_weights(arch_id))
    batch = {k: jnp.asarray(v) for k, v in spmd_check.tp_batch(
        arch_id, spmd_check.TP_GRAD_BATCH, spmd_check.TP_GRAD_T, 3).items()}
    if "tokens" in batch:
        batch["tokens"] = batch["tokens"].astype(jnp.int32)
    else:
        batch["labels"] = batch["labels"].astype(jnp.int32)
    val, g = jax.jit(jax.value_and_grad(
        lambda p: jtr.loss_fn(p, cfg, batch)))(params)
    return float(val), {k: np.asarray(v) for k, v in dict_paths(g).items()}


@functools.lru_cache(maxsize=None)
def _ref_quantize(bits):
    return jax.jit(lambda k, x: jq.quantize_tensor(k, x, bits=bits,
                                                   interpret=True))


@functools.lru_cache(maxsize=None)
def _ref_payloads(arch_id):
    """The reference's qbit8 and qbit4 payloads of every whole leaf under
    its key: ``{name: {bits: (q, scale)}}``.  Each leaf goes through a
    zero tail to its padded length, so that leaves of one padded length
    share a compile: a zero changes no scale, and element i's bits and
    level depend on i alone (``quantize_tensor`` pads with zeros itself;
    the b=4 pad nibble of an odd leaf is a zero's)."""
    whole = dict_paths(spmd_check.tp_weights(arch_id))
    out = {}
    for i, (name, w) in enumerate(whole.items()):
        flat = w.reshape(-1).astype(np.float32)
        n = flat.size
        key = jax.random.fold_in(
            jax.random.key(spmd_check.TP_PAYLOAD_KEY), i)
        x = jnp.asarray(np.pad(flat, (0, -n % qref.BLOCK)))
        out[name] = {}
        for bits in (8, 4):
            p = _ref_quantize(bits)(key, x)
            out[name][bits] = (
                np.asarray(p["q"])[:n if bits == 8 else -(-n // 2)],
                float(p["scale"]))
    return out


@functools.lru_cache(maxsize=None)
def _one_rank_round(arch_id):
    """The port's one-rank round of ``TP_ROUND`` on the whole weights and
    every agent: the state fields (numpy) and the solver's wire bytes and
    consensus error."""
    from repro_torch.core import admm

    arch = ARCHS[arch_id]
    cfg = arch.make_smoke()
    step, init, solver = steps.build_train(
        arch, cfg, spmd_check.TP_AGENTS, spmd_check.TP_ROUND,
        spmd_check.tp_recipe(), device="cpu")
    x0_np, data_np = spmd_check.tp_round_inputs(arch_id)
    x0 = spmd_check._tensors(x0_np, "cpu")
    st = step(init(x0), spmd_check._tensors(data_np, "cpu"), 11)
    out = {f: {k: t.numpy() for k, t in dict_paths(getattr(st, f)).items()}
           for f in st._fields if isinstance(getattr(st, f), dict)}
    out["wire_bytes"] = solver.wire_bytes(tree_map(lambda t: t[0], x0))
    out["consensus_error"] = float(admm.consensus_error(st))
    return out


@functools.lru_cache(maxsize=None)
def _dryrun_tp():
    return dryrun.dryrun_one("qwen3-0.6b", "train_4k", False, verbose=False,
                             variant={"solver": "ltadmm:packed=false",
                                      "n_layers": 1})


def _all_grads():
    return {a: _ref_grads(a) for a in ARCH_IDS}


def _all_payloads():
    return {a: _ref_payloads(a) for a in ARCH_IDS}


REF = {}


@pytest.fixture(scope="module")
def ranks(world):
    # while the world runs: the reference's gradients and payloads (their
    # compiles are most of the time) in two spawned processes, the
    # one-rank runs here on one torch thread (the world's ranks and the
    # spawned processes take the other cores; torch's threads would spin
    # against them)
    ctx = multiprocessing.get_context("spawn")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with concurrent.futures.ProcessPoolExecutor(2, mp_context=ctx) as pool:
            grads = pool.submit(_all_grads)
            payloads = pool.submit(_all_payloads)
            for a in ARCH_IDS:
                _one_rank_round(a)
            _dryrun_tp()
            REF["grads"], REF["payloads"] = grads.result(), payloads.result()
    finally:
        torch.set_num_threads(threads)
    return world()


def _results(ranks, model, arch):
    return [(r[model]["model_rank"], r[model][arch]) for r in ranks]


@pytest.mark.parametrize("arch,model", CASES, ids=IDS)
def test_tp_gradients_match_reference(ranks, arch, model):
    loss, want = REF["grads"][arch]
    for _, res in _results(ranks, model, arch):
        got = res["grads"]
        assert got["loss"] == pytest.approx(loss, rel=GRAD_TOL)
        assert set(got["grads"]) == set(want)
        for name, w in want.items():
            g = got["grads"][name]
            assert g.shape == w.shape, name
            np.testing.assert_allclose(
                g, w, rtol=0, atol=GRAD_TOL * max(np.abs(w).max(), 1e-30),
                err_msg=name)


@pytest.mark.parametrize("model", MODELS)
def test_tp_gradients_under_remat_match_reference(ranks, model):
    """qwen3 with each unit rematerialised: the backward issues the unit's
    forward collectives again, in the same order on every rank."""
    loss, want = REF["grads"][ARCH_IDS[0]]
    for r in ranks:
        got = r[model]["remat"]
        assert got["loss"] == pytest.approx(loss, rel=GRAD_TOL)
        for name, w in want.items():
            np.testing.assert_allclose(
                got["grads"][name], w, rtol=0,
                atol=GRAD_TOL * max(np.abs(w).max(), 1e-30), err_msg=name)


@pytest.mark.parametrize("bits", (8, 4))
@pytest.mark.parametrize("arch,model", CASES, ids=IDS)
def test_tp_payloads_are_the_whole_leaf_payload(ranks, arch, model, bits):
    whole = dict_paths(spmd_check.tp_weights(arch))
    per_rank = [res["payloads"] for _, res in _results(ranks, model, arch)]
    names = set(per_rank[0])
    assert names and all(set(p) == names for p in per_rank)
    if ARCHS[arch].make_smoke().ssm is not None:
        assert any(".mamba.in_proj" in n for n in names)
    for name in sorted(names):
        w = whole[name]
        levels = np.full(w.size, -128, np.int16)
        scales = set()
        for p in per_rank:
            lv, sc = p[name][bits]
            idx = p[name]["index"]
            seen = levels[idx] != -128
            np.testing.assert_array_equal(levels[idx][seen], lv[seen],
                                          err_msg=f"{name}: pieces held "
                                          "whole differ across ranks")
            levels[idx] = lv
            scales.add(sc)
        assert (levels != -128).all(), name
        q, scale = REF["payloads"][arch][name][bits]
        got = (levels.astype(np.int8).view(np.uint8) if bits == 8 else
               qref.pack4(torch.from_numpy(levels.astype(np.float32)))
               .numpy())
        np.testing.assert_array_equal(got, q.view(np.uint8), err_msg=name)
        assert scales == {scale}, name


def _assemble(ranks, model, arch, field):
    """The round's gathered field over every agent (the rows of each
    rank with model rank 0)."""
    parts = {}
    for mr, res in _results(ranks, model, arch):
        if mr == 0:
            parts[res["round"]["rows"]] = res["round"][field]
    rows = sorted(parts)
    return {k: np.concatenate([parts[r][k] for r in rows])
            for k in parts[rows[0]]}


@pytest.mark.parametrize("arch,model", CASES, ids=IDS)
def test_tp_torch_route_payloads_are_the_whole_leaf_payload(ranks, arch,
                                                            model):
    """qbit8's torch route (``jax.random.uniform``'s kappa) on the ranks'
    shards, gathered: the port's torch route on the whole leaf, whose
    draw the compression tests hold to the reference's jnp route."""
    whole = dict_paths(spmd_check.tp_weights(arch))
    index = {name: i for i, name in enumerate(whole)}
    per_rank = [res["payloads"] for _, res in _results(ranks, model, arch)]
    comp = compression.BBitQuantizer(bits=8, impl="torch")
    for name in sorted(per_rank[0]):
        w = torch.from_numpy(whole[name]).reshape(1, -1)
        key = jaxrand.fold_in(jaxrand.key(spmd_check.TP_PAYLOAD_KEY),
                              index[name])[None]
        want = comp.compress(key, w)
        levels = np.zeros(w.numel(), np.int8)
        for p in per_rank:
            lv, sc = p[name]["torch"]
            levels[p[name]["index"]] = lv
            assert sc == float(want["scale"][0]), name
        np.testing.assert_array_equal(levels, want["q"][0].numpy(),
                                      err_msg=name)


@pytest.mark.parametrize("arch,model", CASES, ids=IDS)
def test_tp_round_matches_one_rank_round(ranks, arch, model, capsys):
    one = _one_rank_round(arch)
    x0 = dict_paths(spmd_check.tp_round_inputs(arch)[0])
    cfg = steps.TrainRecipe()
    rrho = cfg.r * cfg.rho
    got_x = _assemble(ranks, model, arch, "x")
    # one level of agent a's x-message: its max |x1 - x0| / levels
    level = {k: np.abs(one["x"][k] - x0[k]).reshape(x0[k].shape[0], -1)
             .max(axis=1) / LEVELS for k in x0}
    nbr = np.array([1, 0])  # complete(2): slot 0 holds the other agent
    flips = {}
    for field in one:
        if not isinstance(one[field], dict):
            continue
        got = _assemble(ranks, model, arch, field)
        assert set(got) == set(one[field]), field
        for k, want in one[field].items():
            g = got[k]
            assert g.shape == want.shape, (field, k)
            d = np.abs(g.astype(np.float64) - want)
            tol = STATE_TOL * max(np.abs(want).max(), 1e-30)
            off = d > tol
            if field == "x":
                assert not off.any(), (field, k, d.max())
                continue
            lv = level[k]
            if field == "x_hat":
                bound = lv
            elif field == "x_hat_nbr":
                bound = lv[nbr]
            else:
                bound = rrho * (lv + lv[nbr])
            bound = bound.reshape((-1,) + (1,) * (d.ndim - 1)) * 1.001 + tol
            assert (d <= bound).all(), (field, k, d.max())
            if field == "x_hat":  # where the levels flip; the rest follow
                flips[k] = int(off.sum())
                assert flips[k] <= max(FLIP_SHARE * want.size,
                                       FLIP_FLOOR), (k, flips[k], want.size)
    n_flips = sum(flips.values())
    n_elems = sum(x.size for x in one["x_hat"].values())
    with capsys.disabled():
        print(f"\n[tp_train] {arch} model{model}: x_hat elements a level "
              f"off (past {STATE_TOL} of scale): {n_flips} of {n_elems}; "
              f"by leaf {({k: v for k, v in flips.items() if v})}")
    assert n_flips <= FLIP_SHARE * n_elems, flips
    for _, res in _results(ranks, model, arch):
        rd = res["round"]
        assert rd["k"] == 1 and rd["tp_layouts"]
        assert rd["wire_bytes"] == one["wire_bytes"]
        assert rd["exchange_bytes"] > 0
        assert rd["consensus_error"] == pytest.approx(
            one["consensus_error"], rel=STATE_TOL)


@pytest.mark.parametrize("arch,model", CASES, ids=IDS)
def test_tp_ddp_step_matches_one_rank_step(ranks, arch, model):
    for _, res in _results(ranks, model, arch):
        gaps = res["ddp"]
        assert max(gaps["loss"], gaps["m"], gaps["v"] / 2) <= \
            spmd_check.TP_DDP_TOL, gaps


@pytest.mark.parametrize("model", MODELS)
def test_randk_on_a_cut_leaf_raises(ranks, model):
    for r in ranks:
        assert "ROADMAP item 15" in r[model]["randk"]
    lay = qref.ShardLayout((4, 8), 1, ((0, 2, 2, True),), axes=("model",))
    leaf = compression.ShardLeaf(compression.TopK(fraction=0.5), lay)
    with pytest.raises(NotImplementedError, match="ROADMAP item 15"):
        leaf.compress(jaxrand.key(0)[None], torch.zeros(1, 8))


def test_shard_layout_counters_are_the_whole_leaf_indices():
    """A Mamba-like leaf [2, 14] cut on dim 1 by pieces (4 cut, 2 whole,
    8 cut) on rank 1 of 2: each local element's flat index in the whole
    leaf, and the pieces held whole."""
    from repro_torch.launch import sharding as shd

    plan = shd.LeafPlan(1, ((4, True), (2, False), (8, True)))
    lay = shd.leaf_layout(plan, (2, 14), rank=1, size=2)
    assert lay.pieces == ((0, 2, 2, True), (2, 4, 2, False),
                          (4, 10, 4, True))
    whole = torch.arange(28).reshape(2, 14)
    local = torch.cat([whole[:, 2:4], whole[:, 4:6], whole[:, 10:14]], 1)
    assert torch.equal(lay.counters("cpu"), local.reshape(-1))
    assert lay.whole_mask("cpu").reshape(2, 8)[:, 2:4].all()
    assert lay.whole_mask("cpu").sum() == 4
    assert lay.words() == (1, 14, 8, 3, 0, 2, 2, 2, 4, 2, 4, 10, 4, 0, 0, 0)


def test_dryrun_train_applies_the_tp_plan_per_leaf(ranks):
    """qwen3-0.6b's train_4k cut to one layer on the 16 x 16 mesh (the
    packed round's record, false, is ``tests/test_torch_tp_dryrun.py``'s)."""
    rec = _dryrun_tp()
    assert rec["tp_applied"] and not rec["fsdp_applied"]
    assert rec["sharded"]["params.units.0_attn.attn.wq"] == [[2, ["model"]]]
    assert rec["sharded"]["params.embed.embedding"] == [[0, ["model"]]]
    # K4's two passes and K5 on the shards
    assert rec["kernels"].get("K4") and rec["kernels"].get("K5")
