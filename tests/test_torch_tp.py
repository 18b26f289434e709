"""Tensor-parallel serving over the "model" axis (``launch/tp.py``,
``launch/sharding.py`` ``tp_plan`` / ``local_shard`` / ``shard_params``,
``steps.build_prefill`` / ``build_serve`` with a mesh) against the live
reference.

One spawned gloo world of 4 CPU ranks runs ``spmd_check.tp_suite``: the
smoke configs of qwen3, qwen2, olmo, command-r, pixtral and zamba2 served
on two meshes of the world, ``(2 data, 2 model)`` and ``(1 data, 4
model)``, on each rank's shard of numpy-seeded weights
(``spmd_check.tp_weights``).  Their shapes cover every case of the
sanitized specs: on the 4-way axis qwen3-smoke's 2 KV heads run whole
beside its sharded query heads, qwen2-smoke's 6 heads run its attention
whole, and zamba2-smoke's 8 SSD heads split.

* The prefill's gathered last logits and 4 greedy decode steps are held
  against the reference's single-device ``forward`` / ``decode_step`` on
  the same weights and inputs, within rtol = atol = 1e-5 in f32 (TF32
  off on the ranks): the all-reduces sum the row-parallel partials in
  another order than one product accumulates them.  Greedy tokens equal.
* Each rank's parameter leaves equal, bit for bit, the slice that the
  reference's own ``param_pspec`` gives the rank over "model" and
  "data" (mode "serve" puts "data" on the embed dims: FSDP, applied on
  the (2, 2) mesh), except a Mamba mixer's "model" cut, which is by SSD
  head: in_proj's columns are the rank's z, x and dt beside the whole B
  and C, the conv's the rank's x channels beside B's and C's, A_log, D
  and dt_bias the rank's heads.
* Each rank's KV caches are the whole cache with the dims that
  ``cache_pspec`` gives "model" cut (the KV heads where the axis divides
  them); a Mamba cache holds the rank's heads (``h [B, nh / tp, ds,
  hd]``, where ``cache_pspec`` would cut d_state) and their conv
  channels.
* Without a mesh ``build_prefill`` / ``build_serve`` return what they
  did; ``local_shard`` cuts by pieces; ``shard_params`` empties the
  whole tree as it cuts.
"""
import functools
import tempfile
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.archs import ARCHS as JARCHS  # noqa: E402
from repro.launch import sharding as jshd  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch.checkpoint.reference import (  # noqa: E402
    params_tree_from_reference,
)
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.launch import spmd_check, steps  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402

# see tests/test_torch_ssd.py: torch 2.13.0+cpu's first exp of a process
torch.exp(torch.linspace(-20.0, 20.0, 50_000))

WORLD, MODELS = 4, (2, 4)
TOL = dict(rtol=1e-5, atol=1e-5)
CASES = [(a, m) for a in spmd_check.TP_ARCHS for m in MODELS]
IDS = [f"{a}-model{m}" for a, m in CASES]


@pytest.fixture(scope="module")
def world():
    """The 4-rank world, started at once: the reference's runs overlap
    it.  Yields a function that waits for the ranks' results."""
    with tempfile.TemporaryDirectory() as d:
        ctx = spmd_check.start_world("tp", WORLD, d, model=2)
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
    tokens on ``tp_weights`` (numpy)."""
    cfg = JARCHS[arch_id].make_smoke()
    params = jax.tree.map(jnp.asarray, spmd_check.tp_weights(arch_id))
    inp = spmd_check.tp_inputs(arch_id)
    fwd = jax.jit(lambda p, **kw: jtr.forward(p, cfg, **kw)[0][:, -1:])
    if "embeds" in inp:
        last = fwd(params, embeds=jnp.asarray(inp["embeds"]))
    else:
        last = fwd(params, tokens=jnp.asarray(inp["tokens"], jnp.int32))
    step = jax.jit(lambda p, c, t, pos: jtr.decode_step(p, cfg, c, token=t,
                                                        pos=pos))
    cache = jtr.init_cache(cfg, spmd_check.TP_BATCH, spmd_check.TP_STEPS)
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
    for a in spmd_check.TP_ARCHS:
        _reference(a)
    return world()


def _rank_results(ranks, arch, model):
    return [(r[model]["model_rank"], r[model][arch]) for r in ranks]


@pytest.mark.parametrize("arch,model", CASES, ids=IDS)
def test_tp_serving_matches_reference(ranks, arch, model):
    last, logits, tokens = _reference(arch)
    for _, res in _rank_results(ranks, arch, model):
        np.testing.assert_allclose(res["prefill"], last, **TOL)
        np.testing.assert_allclose(res["decode"], logits, **TOL)
        np.testing.assert_array_equal(res["tokens"], tokens)


def _stand_in(model):
    return types.SimpleNamespace(
        shape={"data": WORLD // model, "model": model},
        axis_names=("data", "model"))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _mamba_piece(name, whole, cfg, model, r):
    """The rank's Mamba leaf by SSD head, built from the config."""
    ssm = cfg.ssm
    di, nh, hd = ssm.d_inner, ssm.n_heads, ssm.head_dim
    gs = ssm.n_groups * ssm.d_state
    hl = nh // model

    def heads(a, start, n_heads, width):
        k = n_heads // model * width
        return a[..., start + r * k:start + (r + 1) * k]

    leaf = name.rsplit(".", 1)[1]
    if leaf == "in_proj":
        return np.concatenate([
            heads(whole, 0, nh, hd), heads(whole, di, nh, hd),
            whole[..., 2 * di:2 * di + 2 * gs],
            heads(whole, 2 * di + 2 * gs, nh, 1)], axis=-1)
    if leaf in ("conv_w", "conv_b"):
        return np.concatenate([heads(whole, 0, nh, hd),
                               whole[..., di:di + 2 * gs]], axis=-1)
    if leaf in ("A_log", "D", "dt_bias"):
        return whole[..., r * hl:(r + 1) * hl]
    if leaf == "norm":
        return whole[..., r * hl * hd:(r + 1) * hl * hd]
    assert leaf == "out_proj"
    return whole[:, r * hl * hd:(r + 1) * hl * hd]


@pytest.mark.parametrize("arch,model", CASES, ids=IDS)
def test_tp_shards_are_the_reference_spec_slices(ranks, arch, model):
    cfg = JARCHS[arch].make_smoke()
    whole = _flat(spmd_check.tp_weights(arch))
    pspecs = _flat(jshd.param_pspec(_stand_in(model), "serve",
                                    jtr.model_specs(cfg)))
    mamba_split = cfg.ssm is not None and cfg.ssm.n_heads % model == 0
    data = WORLD // model
    n_cut = 0
    for r, res in _rank_results(ranks, arch, model):
        rd = [x[model]["coords"][0] for x in ranks
              if x[model][arch] is res][0]
        assert set(res["params"]) == set(whole)
        for name, got in res["params"].items():
            w = whole[name]
            if ".mamba." in name and mamba_split:
                want = _mamba_piece(name, w, cfg, model, r)
            else:
                want = w
                for d, entry in enumerate(pspecs[name]):
                    if entry == "model":
                        k = w.shape[d] // model
                        want = np.take(w, range(r * k, (r + 1) * k), axis=d)
            for d, entry in enumerate(pspecs[name]):
                if entry == "data":
                    k = w.shape[d] // data
                    want = np.take(want, range(rd * k, (rd + 1) * k),
                                   axis=d)
            n_cut += got.shape != w.shape
            assert got.dtype == w.dtype and got.shape == want.shape, name
            np.testing.assert_array_equal(got, want, err_msg=name)
    assert n_cut  # every arch shards some leaf on both meshes


@pytest.mark.parametrize("arch,model", CASES, ids=IDS)
def test_tp_caches_follow_cache_pspec(ranks, arch, model):
    cfg = ARCHS[arch].make_smoke()
    b, s = spmd_check.TP_BATCH, spmd_check.TP_STEPS
    whole = tr.init_cache(cfg, b, s, torch.device("meta"))
    want = {}
    for u, unit in enumerate(whole["units"]):
        for name, c in unit.items():
            for k, v in c.items():
                want[f"units.{u}.{name}.{k}"] = v
    for u, c in enumerate(whole["shared"] or []):
        for k, v in c.items():
            want[f"shared.{u}.{k}"] = v
    ssm = cfg.ssm
    for _, res in _rank_results(ranks, arch, model):
        assert set(res["cache"]) == set(want)
        for name, shape in res["cache"].items():
            v = want[name]
            if name.endswith(".h"):  # the rank's SSD heads
                exp = list(v.shape)
                exp[1] //= model
            elif name.endswith(".conv"):  # their conv channels, B and C
                exp = list(v.shape)
                exp[2] -= ssm.d_inner - ssm.d_inner // model
            else:
                spec = shd.cache_pspec(_stand_in(model), v)
                exp = [n // model if e == "model" else n
                       for n, e in zip(v.shape, spec)]
            assert list(shape) == exp, name


def test_without_a_mesh_the_steps_are_unchanged():
    arch = ARCHS["qwen3-0.6b"]
    cfg = arch.make_smoke()
    params = params_tree_from_reference(spmd_check.tp_weights("qwen3-0.6b"),
                                        "cpu")
    tokens = torch.from_numpy(spmd_check.tp_inputs("qwen3-0.6b")["tokens"])
    prefill = steps.build_prefill(arch, cfg)
    assert callable(prefill)
    with torch.no_grad():
        got = prefill(params, {"tokens": tokens})
        want = tr.forward(params, cfg, tokens=tokens)[0][:, -1:, :]
    assert torch.equal(got, want)
    served = steps.build_serve(arch, cfg)
    assert len(served) == 2
    cache = served[1](2, 4)
    assert cache["units"][0]["0_attn"]["k"].shape == (2, 4, 2, 32)


class _Mesh:
    """A stand-in mesh for ``local_shard`` and ``shard_params``."""

    def __init__(self, model, rank):
        self.shape, self.axis_names = {"data": 1, "model": model}, (
            "data", "model")
        self._rank = rank

    def get_local_rank(self, axis):
        assert axis == "model"
        return self._rank


def test_local_shard_cuts_by_pieces():
    t = torch.arange(2 * 14.0).reshape(2, 14)
    spec = shd.P(None, "model")
    got = shd.local_shard(_Mesh(2, 1), spec, t, ((4, True), (2, False),
                                                 (8, True)))
    want = torch.cat([t[:, 2:4], t[:, 4:6], t[:, 10:14]], dim=1)
    assert torch.equal(got, want) and got.is_contiguous()
    plain = shd.local_shard(_Mesh(2, 1), shd.P("model", None), t)
    assert torch.equal(plain, t[1:]) and plain.data_ptr() != t[1:].data_ptr()
    assert shd.local_shard(_Mesh(2, 0), shd.P(None, None), t) is t
    with pytest.raises(ValueError):
        shd.local_shard(_Mesh(4, 0), spec, t, ((6, True), (8, False)))


def test_shard_params_empties_the_whole_tree():
    arch = ARCHS["zamba2-2.7b"]
    cfg = arch.make_smoke()
    specs = steps.model_specs(arch, cfg)
    tree = params_tree_from_reference(spmd_check.tp_weights("zamba2-2.7b"),
                                      "cpu")
    n = len(_flat(tree))
    shard = shd.shard_params(tree, _Mesh(4, 3), "serve", specs)
    assert tree == {} and len(_flat(shard)) == n
    plan = _flat(shd.tp_plan(_Mesh(4, 3), "serve", specs))
    differs = sorted(k.rsplit(".", 1)[1] for k, p in plan.items()
                     if p.differs)
    # the mixer's layout differs from the spec's slice in these leaves
    assert set(differs) == {"A_log", "D", "conv_b", "conv_w", "dt_bias",
                            "in_proj"}
    assert shard["units"]["0_mamba"]["mamba"]["in_proj"].shape[-1] == (
        2 * 64 + 2 * 16 + 2)
