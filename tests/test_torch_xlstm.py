"""The port's xLSTM blocks (``models/xlstm.py``) against the reference, on
the CPU at xlstm-125m's smoke widths (d 128, 2 heads of 128):

* ``init_params`` of the smoke config in bf16 within one ulp of the
  reference's (f32 within 8 ulp, the model's forward and decode, and
  greedy tokens: ``tests/test_torch_models.py``);
* ``mlstm_forward`` where T is not a multiple of the chunk (T = 20 in
  chunks of 8, T = 300 in chunks of 256, the last padded), within 1e-5
  of the output's scale (measured 1.9e-6 / 3.1e-6), and at T = 20 the
  port's chunkwise prefill against its own token-by-token
  ``mlstm_decode`` within 1e-5 (T = 300 at full width: ``chip_smoke.py``'s
  zoo phase);
* ``slstm_forward`` over 4 steps within 1e-5 of the output's scale
  (measured 1.2e-6).  The recurrence amplifies f32 rounding ~1.6x a step at these weights in
  both packages (ROADMAP Queue 3), so over 16 steps each package's f32
  output is held to the port's f64 one: the reference's within 5e-3 of
  the scale (measured 2.2e-4), the port's within 4x the reference's
  distance (measured 1.4x);
* the decode caches' dtypes after 1 and 2 decode steps of the bf16 smoke
  model equal to the reference's: the mLSTM cache's ``c`` and ``n`` turn
  f32 at the first step (the bf16 cache times the f32 gates), ``m`` stays
  f32, the sLSTM cache keeps bf16 ``c``, ``n``, ``h`` and f32 ``m``; the
  port's bf16 logits closer to the reference's than the reference's are
  to the f32 logits of the same weights (measured 0.0093-0.0098 against
  0.017-0.018, at a logit scale of 0.75).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.archs import ARCHS as JARCHS  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro.models.common import init_params as jinit  # noqa: E402
from repro_torch.checkpoint.reference import (  # noqa: E402
    model_params_from_reference,
)
from repro_torch.common.trees import tree_flatten  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core import jaxrand  # noqa: E402
from repro_torch.models import common, xlstm  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402

# see tests/test_torch_ssd.py: torch 2.13.0+cpu's first exp of a process
torch.exp(torch.linspace(-20.0, 20.0, 50_000))

ARCH = "xlstm-125m"
JCFG = jx.XLSTMConfig(128, n_heads=2)
CFG = xlstm.XLSTMConfig(128, n_heads=2)


def _block(name, seed=0):
    """A block's reference weights (jax tree) and the port's (tensors)."""
    jp = jinit(jax.random.key(seed), getattr(jx, f"{name}_specs")(JCFG))
    return jp, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)


def _x(b, t, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, t, CFG.d_model), dtype=np.float32)


def test_init_params_bf16_matches_reference():
    want = jax.tree.leaves(jinit(
        jax.random.key(0), jtr.model_specs(JARCHS[ARCH].make_smoke()),
        dtype=jnp.bfloat16))
    got = tree_flatten(common.init_params(
        jaxrand.key(0), tr.model_specs(ARCHS[ARCH].make_smoke()),
        dtype=torch.bfloat16))[0]
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        d = np.abs(g.view(torch.uint16).numpy().astype(np.int64)
                   - np.asarray(w).view(np.uint16).astype(np.int64))
        assert int(d.max(initial=0)) <= 1


@pytest.mark.parametrize("t,chunk", [(20, 8), (300, 256)])
def test_mlstm_forward_pads_to_the_chunk(t, chunk):
    jp, tp = _block("mlstm")
    x = _x(2, t, 1)
    want = np.asarray(jax.jit(lambda p, xx: jx.mlstm_forward(
        p, JCFG, xx, chunk=chunk))(jp, jnp.asarray(x)))
    with torch.no_grad():
        got = xlstm.mlstm_forward(tp, CFG, torch.from_numpy(x), chunk=chunk)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
        if t > 3 * chunk:
            return
        # the chunkwise prefill against the recurrent decode
        cache = xlstm.mlstm_init_cache(CFG, 2, torch.float32)
        steps = []
        for pos in range(t):
            y, cache = xlstm.mlstm_decode(tp, CFG, cache,
                                          torch.from_numpy(x[:, pos:pos + 1]),
                                          pos)
            steps.append(y)
    dec = torch.cat(steps, dim=1).numpy()
    assert np.abs(dec - got.numpy()).max() <= 1e-5 * np.abs(want).max()


def test_slstm_forward_and_its_drift():
    jp, tp = _block("slstm")
    tp64 = jax.tree.map(lambda t: t.double(), tp)
    fn = jax.jit(lambda p, xx: jx.slstm_forward(p, JCFG, xx))
    for t in (4, 16):
        x = _x(2, t, 2)
        want = np.asarray(fn(jp, jnp.asarray(x)))
        with torch.no_grad():
            got = xlstm.slstm_forward(tp, CFG, torch.from_numpy(x)).numpy()
            exact = xlstm.slstm_forward(tp64, CFG,
                                        torch.from_numpy(x).double()).numpy()
        scale = np.abs(exact).max()
        if t == 4:
            assert np.abs(got - want).max() <= 1e-5 * scale
            continue
        ref_drift = np.abs(want - exact).max()
        assert ref_drift <= 5e-3 * scale
        assert np.abs(got - exact).max() <= 4 * ref_drift


def test_decode_cache_dtypes_follow_the_reference_in_bf16():
    jcfg = dataclasses.replace(JARCHS[ARCH].make_smoke(), dtype=jnp.bfloat16)
    cfg = dataclasses.replace(ARCHS[ARCH].make_smoke(), dtype=torch.bfloat16)
    jparams = jinit(jax.random.key(0), jtr.model_specs(jcfg),
                    dtype=jnp.bfloat16)
    params = model_params_from_reference(jax.tree.map(np.asarray, jparams),
                                         cfg, "cpu")
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = model_params_from_reference(
        jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jparams),
        cfg32, "cpu")
    b = 2
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (b, 2))
    jcache, cache = jtr.init_cache(jcfg, b, 2), tr.init_cache(cfg, b, 2)
    cache32 = tr.init_cache(cfg32, b, 2)
    jstep = jax.jit(lambda p, c, tok, pos: jtr.decode_step(
        p, jcfg, c, token=tok, pos=pos))
    with torch.no_grad():
        for pos in range(2):
            want, jcache = jstep(jparams, jcache, jnp.asarray(tokens[:, pos]),
                                 jnp.int32(pos))
            tok = torch.from_numpy(tokens[:, pos])
            got, cache = tr.decode_step(params, cfg, cache, token=tok,
                                        pos=pos)
            f32, cache32 = tr.decode_step(params32, cfg32, cache32,
                                          token=tok, pos=pos)
            for block, leaves in (("0_mlstm", "cnm"), ("1_slstm", "cnhm")):
                dtypes = {k: str(cache["units"][0][block][k].dtype)
                          for k in leaves}
                want_dtypes = {k: "torch." + jcache["units"][block][k]
                               .dtype.name for k in leaves}
                assert dtypes == want_dtypes, (pos, block)
            assert cache["units"][0]["0_mlstm"]["c"].dtype == torch.float32
            assert cache["units"][0]["1_slstm"]["c"].dtype == torch.bfloat16
            want = np.asarray(want.astype(jnp.float32))
            assert (np.abs(got.float().numpy() - want).max()
                    <= np.abs(want - f32.numpy()).max())
