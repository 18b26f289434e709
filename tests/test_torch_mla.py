"""The port's MLA (``models/attention.py`` ``mla_*``) and DeepSeek's
leading dense layers against the reference, on the CPU:

* ``init_params`` of deepseek-v2-lite-16b's smoke config in bf16 within
  one ulp of the reference's (f32 within 8 ulp, forward and decode
  within 1e-5, and greedy tokens: ``tests/test_torch_models.py``);
* ``mla_forward`` at deepseek-v2-lite-16b's published MLA widths (d 2048,
  16 heads, kv_lora_rank 512, nope/rope/v 128/64/128) for one block at
  T = 128, on numpy-seeded weights: f32 within 1e-5 of the output's scale
  (measured 2e-7); bf16 within 2 bf16 ulps at the output's scale, the
  measure behind the qwen3 full-width test's 0.05 on logits of scale ~3
  (here the scale is 35: one ulp 0.25, the limit 0.5; measured 0.125,
  one ulp at 21);
* the blockwise branch (T = 3072 > BLOCKWISE_THRESHOLD) on the smoke
  widths: without a window against the reference's blockwise branch,
  with a window of 700 against the reference's dense path (the port's
  ``sdpa_blockwise`` visits the blocks that hold each window; ROADMAP
  Queue 3, Serving 5), both within 1e-5 of the output's scale;
* the latent ring buffer decoded past a 4-slot window (three laps) on the
  smoke model, against the reference's decode and the port's windowed
  prefill within 1e-5, the slots' positions equal to the reference's;
  the MoE capacity factor is n_experts / top_k there, so the prefill
  drops no (token, expert) pair a decode step keeps.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.archs import ARCHS as JARCHS  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.models.common import init_params as jinit  # noqa: E402
from repro_torch.checkpoint.reference import (  # noqa: E402
    model_params_from_reference,
)
from repro_torch.common.trees import tree_flatten  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core import jaxrand  # noqa: E402
from repro_torch.models import attention, common  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402

# see tests/test_torch_ssd.py: torch 2.13.0+cpu's first exp of a process
torch.exp(torch.linspace(-20.0, 20.0, 50_000))

ARCH = "deepseek-v2-lite-16b"


def _uniform(specs, seed):
    """numpy weights for a ParamSpec tree: uniforms of the reference
    initialiser's standard deviation (cheaper to draw than normals)."""
    rng = np.random.default_rng(seed)

    def leaf(s):
        if s.init in ("ones", "zeros"):
            return np.full(s.shape, s.init == "ones", np.float32)
        dims = [d for d, a in zip(s.shape, s.axes) if a != "layers"]
        std = (s.scale if s.init == "embed"
               else s.scale / np.sqrt(dims[0] if len(dims) > 1 else dims[-1]))
        u = rng.random(s.shape, dtype=np.float32) - np.float32(0.5)
        return u * np.float32(std * np.sqrt(12.0))

    return jax.tree.map(leaf, specs, is_leaf=lambda s: hasattr(s, "init"))


def _torch(tree, dtype=torch.float32):
    return jax.tree.map(lambda a: torch.from_numpy(a).to(dtype), tree)


def _bf16_np(t):
    return t.view(torch.uint16).numpy().view(jnp.bfloat16)


def _mla_pair(cfg_kwargs, window=None):
    jcfg = jattn.MLAConfig(**cfg_kwargs, sliding_window=window)
    cfg = attention.MLAConfig(**cfg_kwargs, sliding_window=window)
    return jcfg, cfg


def test_init_params_bf16_matches_reference():
    cfg = ARCHS[ARCH].make_smoke()
    jcfg = JARCHS[ARCH].make_smoke()
    want = jax.tree.leaves(jinit(jax.random.key(0), jtr.model_specs(jcfg),
                                 dtype=jnp.bfloat16))
    got = tree_flatten(common.init_params(
        jaxrand.key(0), tr.model_specs(cfg), dtype=torch.bfloat16))[0]
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        d = np.abs(_bf16_np(g).view(np.uint16).astype(np.int64)
                   - np.asarray(w).view(np.uint16).astype(np.int64))
        assert int(d.max(initial=0)) <= 1


def test_mla_forward_full_width():
    full = JARCHS[ARCH].make(None).mla
    jcfg, cfg = _mla_pair(dict(d_model=full.d_model, n_heads=full.n_heads,
                               kv_lora_rank=full.kv_lora_rank,
                               qk_nope_dim=full.qk_nope_dim,
                               qk_rope_dim=full.qk_rope_dim,
                               v_head_dim=full.v_head_dim))
    assert (cfg.d_model, cfg.n_heads, cfg.kv_lora_rank, cfg.qk_nope_dim,
            cfg.qk_rope_dim, cfg.v_head_dim) == (2048, 16, 512, 128, 64, 128)
    w = _uniform(jattn.mla_specs(jcfg), 1)
    x = np.random.default_rng(2).standard_normal((1, 128, 2048),
                                                 dtype=np.float32)
    pos = np.arange(128)[None]
    fn = jax.jit(lambda p, xx: jattn.mla_forward(p, jcfg, xx,
                                                 jnp.asarray(pos)))
    with torch.no_grad():
        want = np.asarray(fn(jax.tree.map(jnp.asarray, w), jnp.asarray(x)))
        got = attention.mla_forward(_torch(w), cfg, torch.from_numpy(x),
                                    torch.from_numpy(pos)).numpy()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        jb = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), w)
        want = fn(jb, jnp.asarray(x).astype(jnp.bfloat16))
        got = attention.mla_forward(
            _torch(w, torch.bfloat16), cfg,
            torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(pos))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got.float().numpy() - want).max() <= 2 * ulp


@pytest.mark.parametrize("window", [None, 700])
def test_mla_blockwise_branch(window, monkeypatch):
    smoke = JARCHS[ARCH].make_smoke().mla
    jcfg, cfg = _mla_pair(dict(d_model=smoke.d_model, n_heads=smoke.n_heads,
                               kv_lora_rank=smoke.kv_lora_rank,
                               qk_nope_dim=smoke.qk_nope_dim,
                               qk_rope_dim=smoke.qk_rope_dim,
                               v_head_dim=smoke.v_head_dim), window)
    t = 3072
    assert t > attention.BLOCKWISE_THRESHOLD == jattn.BLOCKWISE_THRESHOLD
    w = _uniform(jattn.mla_specs(jcfg), 3)
    x = np.random.default_rng(4).standard_normal((1, t, smoke.d_model),
                                                 dtype=np.float32)
    pos = np.arange(t)[None]
    if window is not None:
        # the reference's dense path (its blockwise walk misses blocks)
        monkeypatch.setattr(jattn, "BLOCKWISE_THRESHOLD", 1 << 30)
    want = np.asarray(jax.jit(lambda p, xx: jattn.mla_forward(
        p, jcfg, xx, jnp.asarray(pos)))(jax.tree.map(jnp.asarray, w),
                                        jnp.asarray(x)))
    with torch.no_grad():
        got = attention.mla_forward(_torch(w), cfg, torch.from_numpy(x),
                                    torch.from_numpy(pos)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_mla_ring_buffer_past_the_window():
    """A 4-slot latent ring buffer decoded over 12 positions (three laps)
    against the reference, and against the windowed prefill."""
    def windowed(c):
        return dataclasses.replace(
            c, mla=dataclasses.replace(c.mla, sliding_window=4),
            moe=dataclasses.replace(
                c.moe, capacity_factor=c.moe.n_experts / c.moe.top_k))

    jcfg = windowed(JARCHS[ARCH].make_smoke())
    cfg = windowed(ARCHS[ARCH].make_smoke())
    jparams = jinit(jax.random.key(0), jtr.model_specs(jcfg))
    params = model_params_from_reference(jax.tree.map(np.asarray, jparams),
                                         cfg, "cpu")
    b, steps = 2, 12
    tokens = np.random.default_rng(9).integers(0, cfg.vocab, (b, steps))
    jcache, cache = (jtr.init_cache(jcfg, b, steps),
                     tr.init_cache(cfg, b, steps))
    assert cache["first"][0]["c"].shape == (b, 4, cfg.mla.kv_lora_rank)
    assert cache["units"][0]["0_mla"]["k_rope"].shape == (
        b, 4, cfg.mla.qk_rope_dim)
    jstep = jax.jit(lambda p, c, tok, pos: jtr.decode_step(
        p, jcfg, c, token=tok, pos=pos))
    with torch.no_grad():
        full, _ = tr.forward(params, cfg, tokens=torch.from_numpy(tokens))
        for pos in range(steps):
            want, jcache = jstep(jparams, jcache, jnp.asarray(tokens[:, pos]),
                                 jnp.int32(pos))
            got, cache = tr.decode_step(params, cfg, cache,
                                        token=torch.from_numpy(
                                            tokens[:, pos]), pos=pos)
            np.testing.assert_allclose(got[:, 0].numpy(),
                                       np.asarray(want[:, 0]), atol=1e-5,
                                       rtol=0)
            np.testing.assert_allclose(got[:, 0].numpy(),
                                       full[:, pos].numpy(), atol=1e-5,
                                       rtol=0)
    for got, want in ((cache["first"][0], jcache["first"]),
                      (cache["units"][0]["0_mla"], jcache["units"]["0_mla"])):
        np.testing.assert_array_equal(got["pos_ids"].numpy(),
                                      np.asarray(want["pos_ids"][0]))
        np.testing.assert_allclose(got["c"].numpy(), np.asarray(want["c"][0]),
                                   atol=1e-5, rtol=0)
