"""The SSD-scan kernel's plain version (K11, run by the port's wrapper on a
CPU tensor) and the Mamba2 block against the reference, in f32, on the
same numpy-seeded inputs:

* the plain K11 against the reference's Pallas ``ssd_scan`` in interpret
  mode (through its model-layout wrapper) on the four shapes of
  ``tests/test_kernels.py`` and zamba2's heads (80 x 64, d_state 64,
  chunk 128), groups shared by several heads included; y and h_final
  within 1e-5 of the output's scale (measured: a few 1e-7);
* the per-step recurrence oracle against the reference's;
* ``mamba_forward`` with ``use_kernel`` False and True, and a run of
  ``mamba_decode`` steps, against the reference at zamba2-smoke's block
  and at one full-width zamba2 block (d 2560) over T = 256, within 2e-5
  of the output's scale (measured: 6e-6; the 2560-wide projections sum in
  another order);
* the wrapper's contract: h0 is None and T a multiple of the chunk;
* the tensor-core K11's arithmetic (``ref.ssd_scan_tc_model``: the
  chunk-parallel split, each f32 operand in bf16 pieces) on bf16 inputs
  against the reference's Pallas kernel in interpret mode, at zamba2's
  heads and with two groups, without decay, with a strong one (alog about
  -5 a step, exp underflows inside a chunk) and the usual -0.2 |N(0, 1)|:
  y within one bf16 ulp (a floor of 1e-5 of its scale), h_final within
  1e-5 of its max; and ``route``, which sends those shapes to it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssm_scan import ops as jssm  # noqa: E402
from repro.kernels.ssm_scan import ref as jssm_ref  # noqa: E402
from repro.models import mamba as jm  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as ssm  # noqa: E402
from repro_torch.kernels.ssm_scan import ref as ssm_ref  # noqa: E402
from repro_torch.kernels.tolerance import bf16_ulps  # noqa: E402
from repro_torch.models import mamba as m  # noqa: E402

# torch 2.13.0+cpu's first float32 exp of a process now and then returns
# values 1.5e-4 off (relative) on inputs that mix signs; later calls are
# right.  One call here, at import, keeps that out of the tolerances.
torch.exp(torch.linspace(-20.0, 20.0, 50_000))


def _close(got, want, rel):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, rel)


def _scan_inputs(b, nh, ng, t, hd, ds, seed):
    rng = np.random.default_rng(seed)
    return (0.5 * rng.standard_normal((b, t, nh, hd), dtype=np.float32),
            (-0.2 * np.abs(rng.standard_normal((b, t, nh)))).astype(
                np.float32),
            0.5 * rng.standard_normal((b, t, ng, ds), dtype=np.float32),
            0.5 * rng.standard_normal((b, t, ng, ds), dtype=np.float32))


@pytest.mark.parametrize("b,nh,ng,t,hd,ds,chunk", [
    (2, 3, 1, 256, 64, 16, 64),
    (1, 2, 2, 128, 32, 64, 32),
    (2, 1, 1, 64, 16, 8, 64),
    (1, 4, 2, 512, 32, 16, 128),
    (1, 80, 1, 256, 64, 64, 128),  # zamba2's heads
])
def test_plain_ssd_matches_reference_kernel(b, nh, ng, t, hd, ds, chunk):
    x, al, bm, cm = _scan_inputs(b, nh, ng, t, hd, ds, t + hd + ds)
    cfg, jcfg = m.SSMConfig(64, chunk=chunk), jm.SSMConfig(64, chunk=chunk)
    y, h = ssm.ssd_chunked(cfg, *(torch.from_numpy(a)
                                  for a in (x, bm, cm, al)))
    yw, hw = jssm.ssd_chunked(jcfg, *(jnp.asarray(a) for a in (x, bm, cm,
                                                               al)))
    _close(y, yw, 1e-5)
    _close(h, hw, 1e-5)
    # the recurrence oracle, head-major, against the reference's
    rep = nh // ng
    hm = [np.moveaxis(a, 1, 2) for a in (x, al)] + [
        np.moveaxis(np.repeat(a, rep, axis=2), 1, 2) for a in (bm, cm)]
    yr, hr = ssm_ref.ssd_scan_ref(*(torch.from_numpy(a) for a in hm))
    yrw, hrw = jssm_ref.ssd_scan_ref(*(jnp.asarray(a) for a in hm))
    _close(yr, yrw, 1e-5)
    _close(hr, hrw, 1e-5)
    # chunked against the per-step recurrence (the reference's own check)
    np.testing.assert_allclose(y.numpy(), np.moveaxis(yr.numpy(), 1, 2),
                               atol=5e-4, rtol=2e-3)


def test_wrapper_contract():
    x, al, bm, cm = (torch.from_numpy(a)
                     for a in _scan_inputs(1, 2, 1, 96, 8, 8, 0))
    with pytest.raises(ValueError, match="h0"):
        ssm.ssd_chunked(m.SSMConfig(64, chunk=32), x, bm, cm, al,
                        h0=torch.zeros(1, 2, 8, 8))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssm.ssd_chunked(m.SSMConfig(64, chunk=64), x, bm, cm, al)


def _block_params(cfg, seed):
    """A Mamba block's weights, numpy-seeded: fan-in scaled normals, decay
    rates A_log in [0, 1.5) and dt biases in [-2, 0) (the reference
    initialises them to constants, which would leave every head alike)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, s in m.mamba_specs(cfg).items():
        if s.init == "normal":
            out[name] = (rng.standard_normal(s.shape, dtype=np.float32)
                         / np.float32(np.sqrt(s.shape[0])))
        else:
            out[name] = np.full(s.shape, s.init == "ones", np.float32)
    out["A_log"] = rng.uniform(0, 1.5, out["A_log"].shape).astype(np.float32)
    out["dt_bias"] = rng.uniform(-2, 0, out["dt_bias"].shape).astype(
        np.float32)
    return out


BLOCKS = {"zamba2-smoke": (dict(d_model=128, d_state=16, head_dim=32,
                                chunk=32), 96),
          "zamba2-full": (dict(d_model=2560, d_state=64, head_dim=64), 256)}


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_mamba_block_matches_reference(block):
    kw, t = BLOCKS[block]
    cfg, jcfg = m.SSMConfig(**kw), jm.SSMConfig(**kw)
    npp = _block_params(cfg, 7)
    x = np.random.default_rng(8).standard_normal((1, t, cfg.d_model),
                                                 dtype=np.float32)
    mod = m.Mamba(cfg, {k: torch.from_numpy(v) for k, v in npp.items()})
    jp = {k: jnp.asarray(v) for k, v in npp.items()}
    with torch.no_grad():
        for use_kernel in (False, True):
            want = jm.mamba_forward(jp, jcfg, jnp.asarray(x),
                                    use_kernel=use_kernel)
            _close(mod(torch.from_numpy(x), use_kernel=use_kernel), want,
                   2e-5)
        # decode steps from a zero cache, against the reference's
        steps = 8
        cache = m.mamba_init_cache(cfg, 1, torch.float32)
        jcache = jm.mamba_init_cache(jcfg, 1, jnp.float32)
        for pos in range(steps):
            y, cache = m.mamba_decode(mod, cfg, cache,
                                      torch.from_numpy(x[:, pos:pos + 1]),
                                      pos)
            yw, jcache = jm.mamba_decode(jp, jcfg, jcache,
                                         jnp.asarray(x[:, pos:pos + 1]),
                                         jnp.int32(pos))
            _close(y, yw, 2e-5)
        _close(cache["h"], jcache["h"], 2e-5)
        _close(cache["conv"], jcache["conv"], 2e-5)


def _bf16_inputs(b, nh, ng, t, hd, ds, decay, seed):
    """bf16 inputs (numpy-seeded) and their f32 values for the reference."""
    rng = np.random.default_rng(seed)
    alog = {"none": np.zeros((b, t, nh)),
            "strong": -5.0 + 0.1 * rng.standard_normal((b, t, nh)),
            "usual": -0.2 * np.abs(rng.standard_normal((b, t, nh)))}[decay]
    arrs = (0.5 * rng.standard_normal((b, t, nh, hd)),
            0.5 * rng.standard_normal((b, t, ng, ds)),
            0.5 * rng.standard_normal((b, t, ng, ds)), alog)
    bf = [torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
          for a in arrs]
    return bf, [a.float().numpy() for a in bf]


def _reference(chunk, x, bm, cm, al):
    yw, hw = jssm.ssd_chunked(jm.SSMConfig(64, chunk=chunk),
                              *(jnp.asarray(a) for a in (x, bm, cm, al)))
    return torch.from_numpy(np.array(yw)), torch.from_numpy(np.array(hw))


TC_SHAPES = {"zamba2 heads": (1, 4, 1, 256, 64, 64, 128),
             "two groups": (2, 4, 2, 128, 32, 16, 64)}


@pytest.mark.parametrize("decay", ["none", "strong", "usual"])
@pytest.mark.parametrize("shape", sorted(TC_SHAPES))
def test_tc_model_matches_reference_kernel(shape, decay):
    b, nh, ng, t, hd, ds, chunk = TC_SHAPES[shape]
    (x, bm, cm, al), f32 = _bf16_inputs(b, nh, ng, t, hd, ds, decay,
                                        t + nh)
    yw, hw = _reference(chunk, *f32)
    y, h = ssm_ref.ssd_scan_tc_model(x, al, bm, cm, chunk=chunk)
    scale = float(yw.abs().max())
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    assert bf16_ulps(y, yw.to(torch.bfloat16), 1e-5 * scale) <= 1
    assert float((h - hw).abs().max()) <= 1e-5 * float(hw.abs().max())


def test_tc_model_needs_its_pieces():
    """One bf16 piece an operand misses y's limit by hundreds of ulps, so
    the split test above holds the pieces, not just the decomposition."""
    (x, bm, cm, al), f32 = _bf16_inputs(1, 4, 1, 256, 64, 64, "usual", 3)
    yw, _ = _reference(128, *f32)
    y, _ = ssm_ref.ssd_scan_tc_model(x, al, bm, cm, chunk=128,
                                     pieces={"g": 1, "h_in": 1, "bw": 1})
    scale = float(yw.abs().max())
    assert bf16_ulps(y, yw.to(torch.bfloat16), 1e-5 * scale) > 8


@pytest.mark.parametrize("case,want", [
    ("zamba2-2.7b bf16", "tc"), ("zamba2-smoke bf16", "tc"),
    ("two groups bf16", "tc"), ("zamba2-2.7b f32", "cc"),
    ("head_dim 16 bf16", "cc"), ("d_state 8 bf16", "cc"),
    ("chunk 96 bf16", "cc"), ("odd token stride bf16", "cc"),
    ("misaligned bf16", "cc")])
def test_route(case, want):
    """bf16 at the served shapes goes to the tensor-core kernel; f32 and
    what it refuses (head_dim, d_state, chunk, B/C rows 16-byte apart, a
    base off 16 bytes) to the CUDA-core one."""
    shape = {"zamba2-2.7b": (2, 256, 80, 64, 1, 64, 128),
             "zamba2-smoke": (2, 64, 8, 32, 1, 16, 32),
             "two groups": (1, 256, 4, 32, 2, 16, 64),
             "head_dim 16": (2, 96, 3, 16, 1, 16, 32),
             "d_state 8": (2, 96, 3, 32, 1, 8, 32),
             "chunk 96": (1, 192, 2, 64, 1, 64, 96),
             "odd token stride": (1, 128, 2, 64, 1, 64, 128),
             "misaligned": (1, 128, 2, 64, 1, 64, 128)}[case.rsplit(" ", 1)[0]]
    b, t, nh, hd, ng, ds, chunk = shape
    dt = torch.bfloat16 if case.endswith("bf16") else torch.float32
    pad = 4 if case.startswith("odd") else 8
    # B and C as column slices of one conv output, as the Mamba block has
    xbc = torch.zeros((b, t, pad + 2 * ng * ds), dtype=dt)
    bm = xbc[..., pad:pad + ng * ds].reshape(b, t, ng, ds)
    cm = xbc[..., pad + ng * ds:].reshape(b, t, ng, ds)
    x = torch.zeros(b * t * nh * hd + 1, dtype=dt)
    x = (x[1:] if case.startswith("misaligned") else x[:-1]).view(
        b, t, nh, hd)
    assert ssm.route(x, bm, m.SSMConfig(64, chunk=chunk), cm) == want
