"""Multi-pod per-leaf LT-ADMM-CC under FSDP+TP (``steps.build_train`` with
``packed=false`` on a ``("pod", "data", "model")`` mesh, ``steps.FsdpRows``,
``fsdp.take_rows``, ``compression.ShardedTree`` over both axes and K4's
shard form in its two-axis class) against the live reference and the
port's one-rank round.

One spawned gloo world of 8 CPU ranks on a ``(2 pod, 2 data, 2 model)``
mesh runs ``spmd_check.fsdp_train_suite`` for the smoke configs of qwen3
and zamba2 (Mamba mixers cut by SSD head beside the "data" cut), one
agent a pod, each agent's parameters and state the rank's FSDP+TP shard
and its m rows cut over "data" (each rank its contiguous m / 2).  The
reference's runs and the port's one-rank round here overlap the world.

* The minibatch indices of each local step are the reference's, drawn
  over the agent's whole m_local (``jax.random.randint(_key_batch(...),
  (b,), 0, m)``), though each rank holds m / 2 rows.
* ``FsdpRows.batch_grad``'s gradients, gathered, lie within 1e-5 of each
  leaf's scale of the reference's ``jax.grad(loss_fn)`` of the whole
  batch: a batch of 4 rows (each "data" rank differentiates its 2 rows'
  share of the mean, the gathers' reduce-scatters sum it) and of 3 rows
  (the axis does not divide them: every rank runs the whole batch and
  keeps its part).
* Every leaf cut over "data" or "model" (most over both: the two-axis
  class), quantised on the ranks by K4's shard form (qbit8 and qbit4, the
  plain version here) with one MAX over the agent's (data x model)
  group, gathered, is bit-equal to the reference's ``quantize_tensor`` of
  the whole leaf, and so is each rank's scale.
* One ``packed=false`` round (qbit8, tau 2, 2 agents on ``complete``):
  every state field, gathered, within 1e-5 of its scale of the port's
  one-rank round on the whole weights and rows, off the elements where a
  level flipped (``tests/test_torch_tp_train.py``'s bounds: x̂ one level
  of its message, its mirror and z after it, flips at most 1e-4 of x̂'s
  elements or ``FLIP_FLOOR`` a leaf); x and the consensus error within
  1e-5; the wire bytes the one-rank solver's.
* The dry-run's multi-pod per-leaf train record (qwen3-0.6b cut to one
  layer) applies FSDP+TP: ``tp_applied`` and ``fsdp_applied``, the embed
  dims under ``"sharded"`` and no parameter dim under ``"whole"``.
"""
import functools
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.archs import ARCHS as JARCHS  # noqa: E402
from repro.core import admm as jadmm  # noqa: E402
from repro.kernels.quantize import ops as jq  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch.common.trees import dict_paths, tree_map  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core import admm  # noqa: E402
from repro_torch.kernels.quantize import ref as qref  # noqa: E402
from repro_torch.launch import spmd_check, steps  # noqa: E402

# see tests/test_torch_ssd.py: torch 2.13.0+cpu's first exp of a process
torch.exp(torch.linspace(-20.0, 20.0, 50_000))

WORLD, PODS, MODEL = 8, spmd_check.FSDP_PODS, 2
ARCH_IDS = ("qwen3-0.6b", "zamba2-2.7b")
GRAD_TOL = 1e-5  # of each leaf's scale
STATE_TOL = 1e-5
FLIP_SHARE, FLIP_FLOOR, LEVELS = 1e-4, 12, 127


@pytest.fixture(scope="module")
def world():
    with tempfile.TemporaryDirectory() as d:
        ctx = spmd_check.start_world("fsdp_train", WORLD, d, model=MODEL,
                                     pods=PODS)
        results = []

        def ranks():
            if not results:
                results.extend(spmd_check.collect_world(ctx, WORLD, d))
            return results

        yield ranks
        ranks()


@functools.lru_cache(maxsize=None)
def _ref_grads(arch_id, rows):
    cfg = JARCHS[arch_id].make_smoke()
    params = jax.tree.map(jnp.asarray, spmd_check.tp_weights(arch_id))
    batch = {k: jnp.asarray(v) for k, v in spmd_check.tp_batch(
        arch_id, rows, spmd_check.TP_GRAD_T, 3).items()}
    for k in ("tokens", "labels"):
        if k in batch:
            batch[k] = batch[k].astype(jnp.int32)
    g = jax.jit(jax.grad(lambda p: jtr.loss_fn(p, cfg, batch)))(params)
    return {k: np.asarray(v) for k, v in dict_paths(g).items()}


@functools.lru_cache(maxsize=None)
def _ref_payloads(arch_id):
    """The reference's qbit8 / qbit4 payload of every whole leaf under
    ``fold_in(key(TP_PAYLOAD_KEY), i)``: ``{name: {bits: (q, scale)}}``."""
    whole = dict_paths(spmd_check.tp_weights(arch_id))
    quant = {b: jax.jit(lambda k, x, b=b: jq.quantize_tensor(
        k, x, bits=b, interpret=True)) for b in (8, 4)}
    out = {}
    for i, (name, w) in enumerate(whole.items()):
        flat = w.reshape(-1).astype(np.float32)
        n = flat.size
        key = jax.random.fold_in(
            jax.random.key(spmd_check.TP_PAYLOAD_KEY), i)
        x = jnp.asarray(np.pad(flat, (0, -n % qref.BLOCK)))
        out[name] = {}
        for bits in (8, 4):
            p = quant[bits](key, x)
            out[name][bits] = (
                np.asarray(p["q"])[:n if bits == 8 else -(-n // 2)],
                float(p["scale"]))
    return out


@functools.lru_cache(maxsize=None)
def _one_rank_round(arch_id):
    """The port's one-rank ``TP_ROUND`` round on the whole weights and
    rows of both agents: the state fields, wire bytes, consensus error."""
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


@pytest.fixture(scope="module")
def ranks(world):
    for a in ARCH_IDS:
        for n in spmd_check.FSDP_GRAD_ROWS:
            _ref_grads(a, n)
        _ref_payloads(a)
        _one_rank_round(a)
    return world()


def test_fsdp_minibatch_indices_are_the_references(ranks):
    tau, bs = 2, 2  # TP_ROUND's
    for r in ranks:
        for a in ARCH_IDS:
            rd = r[a]["round"]
            assert rd["row_shards"] == WORLD // (PODS * MODEL)
            pod = rd["rows"][0]
            assert len(rd["drawn"]) == tau
            for t, idx in enumerate(rd["drawn"]):
                want = jax.random.randint(
                    jadmm._key_batch(jax.random.key(11), pod, t), (bs,), 0,
                    spmd_check.TP_M)
                np.testing.assert_array_equal(idx[0], np.asarray(want))


@pytest.mark.parametrize("rows", spmd_check.FSDP_GRAD_ROWS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_fsdp_gradients_match_reference(ranks, arch, rows):
    want = _ref_grads(arch, rows)
    for r in ranks:
        got = r[arch]["grads"][rows]
        assert set(got) == set(want)
        for name, w in want.items():
            np.testing.assert_allclose(
                got[name], w, rtol=0,
                atol=GRAD_TOL * max(np.abs(w).max(), 1e-30), err_msg=name)


@pytest.mark.parametrize("bits", (8, 4))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_fsdp_payloads_are_the_whole_leaf_payload(ranks, arch, bits):
    whole = dict_paths(spmd_check.tp_weights(arch))
    per_rank = [r[arch]["payloads"] for r in ranks]
    names = set(per_rank[0])
    assert all(set(p) == names for p in per_rank)
    specs = dict_paths(steps.model_specs(ARCHS[arch],
                                         ARCHS[arch].make_smoke()))
    # every leaf with an embed dim is cut over "data" (2 divides them)
    assert {k for k, sp in specs.items() if "embed" in sp.axes} <= names
    assert names <= set(whole)
    n_two = 0
    for name in sorted(names):
        w = whole[name]
        levels = np.full(w.size, -128, np.int16)
        scales = set()
        for p in per_rank:
            lv, sc = p[name][bits]
            idx = p[name]["index"]
            seen = levels[idx] != -128
            np.testing.assert_array_equal(levels[idx][seen], lv[seen],
                                          err_msg=name)
            levels[idx] = lv
            scales.add(sc)
        assert (levels != -128).all(), name
        n_two += len({len(p[name]["index"]) for p in per_rank}) == 1 and (
            len(per_rank[0][name]["index"]) * 4 == w.size)
        q, scale = _ref_payloads(arch)[name][bits]
        got = (levels.astype(np.int8).view(np.uint8) if bits == 8 else
               qref.pack4(torch.from_numpy(levels.astype(np.float32)))
               .numpy())
        np.testing.assert_array_equal(got, q.view(np.uint8), err_msg=name)
        assert scales == {scale}, name
    assert n_two  # leaves a quarter a rank: cut over both axes


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_fsdp_round_matches_one_rank_round(ranks, arch, capsys):
    one = _one_rank_round(arch)
    x0 = dict_paths(spmd_check.tp_round_inputs(arch)[0])
    rec = steps.TrainRecipe()
    rrho = rec.r * rec.rho
    parts = {r["coords"][0]: r[arch]["round"] for r in ranks
             if r["coords"][1:] == (0, 0)}
    assert sorted(parts) == list(range(PODS))

    def gathered(field):
        return {k: np.concatenate([parts[p][field][k] for p in range(PODS)])
                for k in parts[0][field]}

    level = {k: np.abs(one["x"][k] - x0[k]).reshape(x0[k].shape[0], -1)
             .max(axis=1) / LEVELS for k in x0}
    nbr = np.array([1, 0])
    flips = {}
    for field in one:
        if not isinstance(one[field], dict):
            continue
        got = gathered(field)
        assert set(got) == set(one[field]), field
        for k, want in one[field].items():
            d = np.abs(got[k].astype(np.float64) - want)
            tol = STATE_TOL * max(np.abs(want).max(), 1e-30)
            off = d > tol
            if field == "x":
                assert not off.any(), (field, k, d.max())
                continue
            lv = level[k]
            bound = {"x_hat": lv, "x_hat_nbr": lv[nbr]}.get(
                field, rrho * (lv + lv[nbr]))
            bound = bound.reshape((-1,) + (1,) * (d.ndim - 1)) * 1.001 + tol
            assert (d <= bound).all(), (field, k, d.max())
            if field == "x_hat":
                flips[k] = int(off.sum())
                assert flips[k] <= max(FLIP_SHARE * want.size, FLIP_FLOOR)
    n_elems = sum(x.size for x in one["x_hat"].values())
    with capsys.disabled():
        print(f"\n[fsdp_train] {arch}: x_hat elements a level off: "
              f"{sum(flips.values())} of {n_elems}")
    assert sum(flips.values()) <= FLIP_SHARE * n_elems, flips
    for r in ranks:
        rd = r[arch]["round"]
        assert rd["k"] == 1 and rd["axes"] == ("data", "model")
        assert rd["wire_bytes"] == one["wire_bytes"]
        assert rd["consensus_error"] == pytest.approx(
            one["consensus_error"], rel=STATE_TOL)


def test_dryrun_multi_pod_per_leaf_applies_fsdp():
    """qwen3-0.6b's per-leaf train_4k cut to one layer on 2 x 16 x 16:
    the rank's parameters are its FSDP+TP shard (the embed dims over
    "data" in ``"sharded"``) and no parameter dim is run whole."""
    from repro_torch.launch import dryrun

    rec = dryrun.dryrun_one(
        "qwen3-0.6b", "train_4k", True, verbose=False,
        variant={"solver": "ltadmm:packed=false", "n_layers": 1,
                 "recipe_tau": 1})
    assert rec["tp_applied"] and rec["fsdp_applied"]
    assert rec["agent_axis"] == "pod"
    assert not any(k.startswith("params.") for k in rec["whole"])
    assert rec["sharded"]["params.embed.embedding"] == [
        [0, ["model"]], [1, ["data"]]]
    assert rec["sharded"]["params.units.0_attn.attn.wq"] == [
        [1, ["data"]], [2, ["model"]]]
    assert rec["kernels"].get("K4") and rec["kernels"].get("K5")
