"""The port's encoder-decoder (``models/encdec.py``, seamless-m4t-medium)
and the cross-attention branch of ``attention.gqa_forward`` against the
reference, on the CPU, on ``seamless_smoke`` (2 + 2 layers, d 128, vocab
512) in f32 unless named:

* ``init_params`` within 8 ulp of the reference's; the reference's tree
  carried across unchanged by ``params_tree_from_reference``;
* ``encode``, ``forward``, ``loss_fn``, ``init_cache`` and ``decode_step``
  within 1e-5; the loss within 1e-5 relative and every gradient leaf at
  x0 within 1e-4 of the leaf's largest |gradient| (the tolerances of
  ``tests/test_torch_train.py``);
* the greedy tokens printed by ``launch.serve.main`` equal to those of
  the reference's ``launch/serve.py`` encdec loop;
* one LT-ADMM-CC round of ``steps.build_train`` on a dict batch
  ``{"src_embeds" [A, m, S, d], "tgt_tokens" [A, m, T+1]}``, finite;
* cross-attention at S != T (q 4096 against kv 1024, and q 1024 against
  kv 3072) through the dense path and ``sdpa_blockwise``, both within
  1e-5 of the reference's dense path at the output's scale;
* with ``qkv_bias`` and nonzero biases, ``forward`` adds the
  cross-attention biases and ``decode_step`` does not, in both packages
  (the gap is the reference's own);
* non-causal attention with a window of 700 at T = 3072: the dense path
  applies no window in either package; the port's ``sdpa_blockwise``
  applies the window mask over every KV block that holds an admitted
  key, the reference's walks the blocks behind the Q block's index and
  lands elsewhere (ROADMAP Queue 3).
"""
import dataclasses
import functools
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.archs import ARCHS as JARCHS  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models.common import init_params as jinit  # noqa: E402
from repro_torch.checkpoint.reference import (  # noqa: E402
    params_tree_from_reference,
)
from repro_torch.common.trees import tree_flatten, tree_map  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core import jaxrand  # noqa: E402
from repro_torch.launch import serve, steps, train  # noqa: E402
from repro_torch.models import attention, common, encdec  # noqa: E402

# see tests/test_torch_ssd.py: torch 2.13.0+cpu's first exp of a process
torch.exp(torch.linspace(-20.0, 20.0, 50_000))

ARCH = "seamless-m4t-medium"
B, S, T = 2, 12, 16
TOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these runs are many tiny ops, and beside the
    suite's other workers spinning thread pools slowed the LT-ADMM-CC
    round 40-fold (2.7 s alone, 107 s in a full run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _reference(bias=False):
    """The reference's smoke config and weights (jax tree, numpy tree);
    with ``bias`` the attention's QKV biases on and drawn nonzero."""
    cfg = JARCHS[ARCH].make_smoke()
    if bias:
        cfg = dataclasses.replace(cfg, attn=dataclasses.replace(
            cfg.attn, qkv_bias=True))
    params = jinit(jax.random.key(0), jencdec.model_specs(cfg))
    if bias:
        rng = np.random.default_rng(3)
        for part in ("enc", "dec"):
            for blk in params[part].values():
                for name in ("bq", "bk", "bv"):
                    if isinstance(blk, dict) and name in blk:
                        blk[name] = jnp.asarray(0.5 * rng.standard_normal(
                            blk[name].shape, dtype=np.float32))
    return cfg, params, jax.tree.map(np.asarray, params)


def _port(bias=False):
    jcfg, _, np_tree = _reference(bias)
    cfg = ARCHS[ARCH].make_smoke()
    if bias:
        cfg = dataclasses.replace(cfg, attn=dataclasses.replace(
            cfg.attn, qkv_bias=True))
    return cfg, params_tree_from_reference(np_tree, "cpu")


def _batch(seed=5):
    rng = np.random.default_rng(seed)
    return {"src_embeds": rng.standard_normal((B, S, 128), dtype=np.float32),
            "tgt_tokens": rng.integers(0, 512, (B, T + 1)).astype(np.int32)}


def _ulps(a, b):
    ia, ib = (np.asarray(x).view(np.uint32).astype(np.int64) for x in (a, b))
    oa, ob = (np.where(i & 0x80000000, -(i & 0x7FFFFFFF), i)
              for i in (ia, ib))
    return int(np.abs(oa - ob).max(initial=0))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=0)


def test_init_params_and_round_trip():
    cfg = ARCHS[ARCH].make_smoke()
    _, _, np_tree = _reference()
    got = tree_flatten(common.init_params(jaxrand.key(0),
                                          encdec.model_specs(cfg)))[0]
    want = jax.tree.leaves(np_tree)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    assert max(_ulps(g.numpy(), w) for g, w in zip(got, want)) <= 8
    # the reference's tree carried across unchanged
    tree = params_tree_from_reference(np_tree, "cpu")
    assert jax.tree.structure(tree) == jax.tree.structure(np_tree)
    for g, w in zip(jax.tree.leaves(tree), want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert sorted(tree) == ["dec", "embed", "enc", "enc_norm", "final_norm"]


def test_encode_forward_loss_match_reference():
    jcfg, jparams, _ = _reference()
    cfg, params = _port()
    batch = _batch()
    src, tgt = batch["src_embeds"], batch["tgt_tokens"]
    with torch.no_grad():
        mem = encdec.encode(params, cfg, torch.from_numpy(src))
        logits = encdec.forward(params, cfg, torch.from_numpy(src),
                                torch.from_numpy(tgt[:, :-1]))
        loss = encdec.loss_fn(params, cfg, tree_map(torch.from_numpy,
                                                    batch))
    _close(mem, jencdec.encode(jparams, jcfg, jnp.asarray(src)))
    _close(logits, jax.jit(lambda p, s, t: jencdec.forward(p, jcfg, s, t))(
        jparams, jnp.asarray(src), jnp.asarray(tgt[:, :-1])))
    want = jencdec.loss_fn(jparams, jcfg, tree_map(jnp.asarray, batch))
    assert abs(float(loss) - float(want)) <= TOL * abs(float(want))


def test_cache_and_decode_match_reference():
    jcfg, jparams, _ = _reference()
    cfg, params = _port()
    batch = _batch(7)
    src, tgt = batch["src_embeds"], batch["tgt_tokens"][:, :8]
    jmem = jencdec.encode(jparams, jcfg, jnp.asarray(src))
    jcache = jencdec.init_cache(jparams, jcfg, jmem, 8)
    jstep = jax.jit(lambda p, c, t, pos: jencdec.decode_step(p, jcfg, c, t,
                                                             pos))
    serve_fn, init_cache = steps.build_serve(ARCHS[ARCH], cfg)
    with torch.no_grad():
        mem = encdec.encode(params, cfg, torch.from_numpy(src))
        cache = init_cache(params, mem, 8)
        assert jax.tree.structure(cache) == jax.tree.structure(jcache)
        for g, w in zip(jax.tree.leaves(cache), jax.tree.leaves(jcache)):
            assert tuple(g.shape) == w.shape
        _close(cache["cross_k"], jcache["cross_k"])
        _close(cache["cross_v"], jcache["cross_v"])
        full = encdec.forward(params, cfg, torch.from_numpy(src),
                              torch.from_numpy(tgt))
        for pos in range(tgt.shape[1]):
            want, jcache = jstep(jparams, jcache, jnp.asarray(tgt[:, pos]),
                                 jnp.int32(pos))
            got, cache = serve_fn(params, cache, {
                "token": torch.from_numpy(tgt[:, pos]).long(), "pos": pos})
            _close(got[:, 0], want[:, 0])
            _close(got[:, 0], full[:, pos])  # prefill against decode
    for g, w in zip(jax.tree.leaves(cache), jax.tree.leaves(jcache)):
        _close(g, w)


def test_loss_and_grads_match_reference():
    jcfg, jparams, np_tree = _reference()
    cfg = ARCHS[ARCH].make_smoke()
    batch = _batch()
    want_l, want_g = jax.jit(jax.value_and_grad(
        lambda p, b: jencdec.loss_fn(p, jcfg, b)))(
        jparams, tree_map(jnp.asarray, batch))
    got_l, got_g = steps.value_and_grad(
        steps.model_loss(ARCHS[ARCH], cfg),
        params_tree_from_reference(np_tree, "cpu"),
        tree_map(torch.from_numpy, batch))
    assert abs(float(got_l) - float(want_l)) <= 1e-5 * abs(float(want_l))
    got, want = tree_flatten(got_g)[0], jax.tree.leaves(want_g)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        assert float(np.abs(g.numpy() - w).max()) <= 1e-4 * max(
            float(np.abs(w).max()), 1e-30)


def test_greedy_serve_matches_reference(capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve.py", "--arch", ARCH, "--smoke"])
    jserve.main()
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("tokens:")]
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    got = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("tokens:")]
    assert tuple(out.shape) == (4, 16)
    assert len(want) == 4 and got == want


def test_train_round_on_a_dict_batch():
    arch = ARCHS[ARCH]
    cfg = arch.make_smoke()
    with pytest.raises(SystemExit, match="enc-dec"):
        train.build(train.parser().parse_args(["--arch", ARCH, "--smoke"]))
    n_agents, m = 4, 4
    recipe = steps.TrainRecipe(tau=2, batch_size=2)
    step_fn, init_fn, solver = steps.build_train(
        arch, cfg, n_agents, "ltadmm:compressor=qbit:bits=8", recipe,
        device="cpu")
    p0 = common.init_params(jaxrand.key(1), steps.model_specs(arch, cfg))
    x0 = tree_map(lambda t: t[None].expand((n_agents,) + t.shape).clone(),
                  p0)
    rng = np.random.default_rng(2)
    data = {"src_embeds": torch.from_numpy(rng.standard_normal(
        (n_agents, m, 6, cfg.d_model), dtype=np.float32)),
            "tgt_tokens": torch.from_numpy(rng.integers(
                0, cfg.vocab, (n_agents, m, 9)))}
    state = step_fn(init_fn(x0), data, 0)
    x = solver.consensus_params(state)
    assert jax.tree.structure(x) == jax.tree.structure(p0)
    leaves = tree_flatten(x)[0]
    assert all(bool(torch.isfinite(v).all()) for v in leaves)
    assert any(not torch.equal(v[0], w) for v, w in
               zip(leaves, tree_flatten(p0)[0]))


def _attn_weights(d, h, dh, seed, bias=False):
    rng = np.random.default_rng(seed)
    shapes = {"wq": (d, h, dh), "wk": (d, h, dh), "wv": (d, h, dh),
              "wo": (h, dh, d)}
    if bias:
        shapes.update(bq=(h, dh), bk=(h, dh), bv=(h, dh))
    return {n: 0.3 * rng.standard_normal(sh, dtype=np.float32)
            for n, sh in shapes.items()}


@pytest.mark.parametrize("t,s", [(4096, 1024), (1024, 3072)])
def test_cross_attention_dense_and_blockwise(t, s, monkeypatch):
    d, h, dh = 16, 2, 8
    cfg = attention.AttnConfig(d, h, h, dh, qkv_bias=True)
    jcfg = jattn.AttnConfig(d, h, h, dh, qkv_bias=True)
    w = _attn_weights(d, h, dh, 4, bias=True)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, t, d), dtype=np.float32)
    mem = rng.standard_normal((1, s, d), dtype=np.float32)
    pos = np.arange(t)[None]
    want = np.asarray(jattn.gqa_forward(
        tree_map(jnp.asarray, w), jcfg, jnp.asarray(x), jnp.asarray(pos),
        kv=jnp.asarray(mem), impl="dense"))
    calls = []
    blockwise = attention.sdpa_blockwise
    monkeypatch.setattr(attention, "sdpa_blockwise", lambda *a, **kw: (
        calls.append(kw) or blockwise(*a, **kw)))
    args = (tree_map(torch.from_numpy, w), cfg, torch.from_numpy(x),
            torch.from_numpy(pos))
    scale = np.abs(want).max()
    with torch.no_grad():
        for impl in ("dense", "blockwise", "auto"):
            got = attention.gqa_forward(*args, kv=torch.from_numpy(mem),
                                        kv_positions=None, impl=impl,
                                        use_flash=True)
            assert np.abs(got.numpy() - want).max() <= TOL * scale, impl
    # blockwise twice: asked for, and by "auto" past the threshold; never
    # causal, and the flash kernel never reached
    assert calls == [{"causal": False, "window": None}] * 2


def test_cross_attention_biases_in_forward_not_in_decode():
    jcfg, jparams, _ = _reference(bias=True)
    cfg, params = _port(bias=True)
    batch = _batch(9)
    src, tgt = batch["src_embeds"], batch["tgt_tokens"][:, :6]
    with torch.no_grad():
        full = encdec.forward(params, cfg, torch.from_numpy(src),
                              torch.from_numpy(tgt))
        cache = encdec.init_cache(
            params, cfg, encdec.encode(params, cfg, torch.from_numpy(src)),
            6)
        steps_ = [encdec.decode_step(params, cfg, cache, torch.from_numpy(
            tgt[:, p]).long(), p)[0][:, 0] for p in range(6)]
    jfull = jencdec.forward(jparams, jcfg, jnp.asarray(src), jnp.asarray(tgt))
    jcache = jencdec.init_cache(
        jparams, jcfg, jencdec.encode(jparams, jcfg, jnp.asarray(src)), 6)
    jstep = jax.jit(lambda pr, c, tok, pos: jencdec.decode_step(
        pr, jcfg, c, tok, pos))
    jsteps = []
    for p in range(6):
        lg, jcache = jstep(jparams, jcache, jnp.asarray(tgt[:, p]),
                           jnp.int32(p))
        jsteps.append(lg[:, 0])
    _close(full, jfull)
    for got, want in zip(steps_, jsteps):
        _close(got, want)
    got_gap = max(float((s_ - full[:, p]).abs().max())
                  for p, s_ in enumerate(steps_))
    want_gap = max(float(jnp.abs(s_ - jfull[:, p]).max())
                   for p, s_ in enumerate(jsteps))
    assert want_gap > 1e-2 and abs(got_gap - want_gap) <= TOL


def test_noncausal_window_dense_and_blockwise(monkeypatch):
    t, d, h, dh, window = 3072, 16, 2, 8, 700
    cfg = attention.AttnConfig(d, h, h, dh, sliding_window=window,
                               causal=False)
    jcfg = jattn.AttnConfig(d, h, h, dh, sliding_window=window,
                            causal=False)
    w = _attn_weights(d, h, dh, 6)
    x = np.random.default_rng(7).standard_normal((1, t, d), dtype=np.float32)
    pos = np.arange(t)[None]
    jargs = (tree_map(jnp.asarray, w), jcfg, jnp.asarray(x), jnp.asarray(pos))
    args = (tree_map(torch.from_numpy, w), cfg, torch.from_numpy(x),
            torch.from_numpy(pos))
    with torch.no_grad():
        dense = attention.gqa_forward(*args, impl="dense").numpy()
        block = attention.gqa_forward(*args).numpy()  # auto: blockwise
        # the window's mask formula over every key, densely
        q, k, v = attention._project_qkv(args[0], cfg, args[2], args[3])
        qi = torch.arange(t)[:, None]
        masked = attention.sdpa(q, k, v, ((qi - qi.T) < window)[None, None,
                                                                None])
        masked = torch.einsum("bthk,hkd->btd", masked, args[0]["wo"]).numpy()
    jdense = np.asarray(jattn.gqa_forward(*jargs, impl="dense"))
    jblock = np.asarray(jattn.gqa_forward(*jargs))
    scale = np.abs(jdense).max()
    # the dense paths: no window in either package
    assert np.abs(dense - jdense).max() <= TOL * scale
    # the port's blockwise path: the window mask, every admitted key
    assert np.abs(block - masked).max() <= TOL * scale
    assert np.abs(block - dense).max() > 1e-2 * scale
    # the reference's blockwise walk lands on neither
    assert np.abs(jblock - block).max() > 1e-2 * scale
    assert np.abs(jblock - jdense).max() > 1e-2 * scale
