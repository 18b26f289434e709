"""FSDP over the "data" axis (``launch/fsdp.py``; ``launch/sharding.py``
``tp_plan`` / ``shard_params`` / ``gather_shards`` over both axes;
``models/transformer.py``'s gathers at the point of use;
``steps.serve_shard``, ``build_prefill`` / ``build_serve`` and
``build_ddp_train`` with a mesh) against the live reference.

One spawned gloo world of 4 CPU ranks runs ``spmd_check.fsdp_suite`` on
two meshes of the world, ``(2 data, 2 model)`` and ``(4 data, 1
model)``, on numpy-seeded weights (``spmd_check.tp_weights``), TF32 off.

* Serving in mode "serve": the six ``tp_serving`` archs FSDP+TP (FSDP
  alone on the (4, 1) mesh), and granite-moe, deepseek-v2-lite and
  xlstm FSDP with their blocks whole over "model".  Each rank serves its
  batch rows (``steps.batch_rows``: a batch of 4 over "data"; the MoE
  archs every row, their experts' capacity being the whole batch's); its
  prefill's last logits and 4 greedy decode steps match the reference's
  single-device ``forward`` / ``decode_step`` on the same rows within
  rtol = atol = 1e-5 (f32), and the tokens are equal.
* Each rank's parameter leaves equal, bit for bit, the slice that the
  reference's ``param_pspec`` gives it over "data" and (for the
  tensor-parallel archs) "model", a Mamba mixer's "model" cut by SSD
  head (``tests/test_torch_tp.py`` holds that layout); ``gather_shards``
  gives the whole weights back.
* The DDP step (``spmd_check.check_tp_ddp``: mode "serve" shards, each
  rank its batch share) lies within ``TP_DDP_TOL`` of one process's
  step on the whole batch: the loss and Adam's moments.
* The gathers: a prefill gathers each cut leaf of a unit once a unit,
  the tied table once (for the lookup and the logits) and ``final_norm``
  once; a
  forward and backward of ``loss_fn`` reduce-scatters each gather once,
  and with every unit under ``torch.utils.checkpoint`` the backward
  gathers each unit again (counted twice).
"""
import functools
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.archs import ARCHS as JARCHS  # noqa: E402
from repro.launch import sharding as jshd  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch.common.trees import dict_paths  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.launch import spmd_check, steps  # noqa: E402

# see tests/test_torch_ssd.py: torch 2.13.0+cpu's first exp of a process
torch.exp(torch.linspace(-20.0, 20.0, 50_000))

WORLD, MODELS = 4, (2, 1)
TOL = dict(rtol=1e-5, atol=1e-5)
SERVE = [(a, m) for a in spmd_check.FSDP_SERVE_ARCHS for m in MODELS]
SERVE_IDS = [f"{a}-model{m}" for a, m in SERVE]
DDP = [(a, m) for a in spmd_check.TP_TRAIN_ARCHS for m in MODELS]
DDP_IDS = [f"{a}-model{m}" for a, m in DDP]


@pytest.fixture(scope="module")
def world():
    with tempfile.TemporaryDirectory() as d:
        ctx = spmd_check.start_world("fsdp", WORLD, d, model=2)
        results = []

        def ranks():
            if not results:
                results.extend(spmd_check.collect_world(ctx, WORLD, d))
            return results

        yield ranks
        ranks()


@functools.lru_cache(maxsize=None)
def _reference(arch_id):
    """The reference's prefill last logits, greedy decode logits and
    tokens of the whole batch of ``fsdp_inputs`` (numpy)."""
    cfg = JARCHS[arch_id].make_smoke()
    params = jax.tree.map(jnp.asarray, spmd_check.tp_weights(arch_id))
    inp = spmd_check.fsdp_inputs(arch_id)
    fwd = jax.jit(lambda p, **kw: jtr.forward(p, cfg, **kw)[0][:, -1:])
    if "embeds" in inp:
        last = fwd(params, embeds=jnp.asarray(inp["embeds"]))
    else:
        last = fwd(params, tokens=jnp.asarray(inp["tokens"], jnp.int32))
    step = jax.jit(lambda p, c, t, pos: jtr.decode_step(p, cfg, c, token=t,
                                                        pos=pos))
    cache = jtr.init_cache(cfg, spmd_check.FSDP_BATCH, spmd_check.TP_STEPS)
    tok = jnp.asarray(inp["first"], jnp.int32)
    logits, tokens = [], []
    for pos in range(spmd_check.TP_STEPS):
        lg, cache = step(params, cache, tok, jnp.int32(pos))
        tok = jnp.argmax(lg[:, 0], axis=-1).astype(jnp.int32)
        logits.append(np.asarray(lg))
        tokens.append(np.asarray(tok))
    return np.asarray(last), np.stack(logits, 1), np.stack(tokens, 1)


@pytest.fixture(scope="module")
def ranks(world):
    for a in spmd_check.FSDP_SERVE_ARCHS:
        _reference(a)
    return world()


@pytest.mark.parametrize("arch,model", SERVE, ids=SERVE_IDS)
def test_fsdp_serving_matches_reference(ranks, arch, model):
    last, logits, tokens = _reference(arch)
    seen = set()
    for r in ranks:
        res = r[model]["serve"][arch]
        lo, hi = res["rows"]
        moe = ARCHS[arch].make_smoke().moe is not None
        assert hi - lo == spmd_check.FSDP_BATCH // (
            1 if moe else WORLD // model)
        seen.update(range(lo, hi))
        np.testing.assert_allclose(res["prefill"], last[lo:hi], **TOL)
        np.testing.assert_allclose(res["decode"], logits[lo:hi], **TOL)
        np.testing.assert_array_equal(res["tokens"], tokens[lo:hi])
    assert seen == set(range(spmd_check.FSDP_BATCH))


class _StandIn:
    def __init__(self, model):
        self.shape = {"data": WORLD // model, "model": model}
        self.axis_names = ("data", "model")


def _slice(w, d, parts, r):
    k = w.shape[d] // parts
    return np.take(w, range(r * k, (r + 1) * k), axis=d)


@pytest.mark.parametrize("arch,model", SERVE, ids=SERVE_IDS)
def test_fsdp_shards_are_the_reference_spec_slices(ranks, arch, model):
    from test_torch_tp import _mamba_piece

    cfg = JARCHS[arch].make_smoke()
    whole = dict_paths(spmd_check.tp_weights(arch))
    pspecs = dict_paths(jshd.param_pspec(_StandIn(model), "serve",
                                         jtr.model_specs(cfg)))
    tp = steps.tp_serving(ARCHS[arch], ARCHS[arch].make_smoke())
    mamba_split = (tp and cfg.ssm is not None
                   and cfg.ssm.n_heads % model == 0 and model > 1)
    data = WORLD // model
    n_cut = 0
    for r in ranks:
        res = r[model]["serve"][arch]
        rd, rm = r[model]["data_rank"], r[model]["model_rank"]
        assert res["inverse"]
        assert set(res["params"]) == set(whole)
        for name, got in res["params"].items():
            w = whole[name]
            if ".mamba." in name and mamba_split:
                want = _mamba_piece(name, w, cfg, model, rm)
            else:
                want = w
                for d, entry in enumerate(pspecs[name]):
                    if entry == "model" and tp:
                        want = _slice(want, d, model, rm)
            for d, entry in enumerate(pspecs[name]):
                if entry == "data":
                    want = _slice(want, d, data, rd)
            n_cut += got.shape != w.shape
            assert got.dtype == w.dtype and got.shape == want.shape, name
            np.testing.assert_array_equal(got, want, err_msg=name)
    assert n_cut


@pytest.mark.parametrize("arch,model", DDP, ids=DDP_IDS)
def test_fsdp_ddp_step_matches_one_rank_step(ranks, arch, model):
    for r in ranks:
        gaps = r[model]["ddp"][arch]
        assert max(gaps["loss"], gaps["m"], gaps["v"] / 2) <= \
            spmd_check.TP_DDP_TOL, gaps


@pytest.mark.parametrize("model", MODELS)
def test_fsdp_gathers_a_unit_and_remat_gathers_twice(ranks, model):
    for r in ranks:
        g = r[model]["gathers"]
        units, unit = g["units"], g["unit"]
        assert unit == 9 and g["tree"] == unit + 2  # qwen3: 9 cut a unit
        once = units * unit + 2  # + the table once, final_norm once
        assert g[False]["gather"] == once
        assert g[False]["reduce_scatter"] == once
        assert g[True]["gather"] == once + units * unit
        assert g[True]["reduce_scatter"] == once
        assert r[model]["serve"]["qwen3-0.6b"]["gathers"] == once
