"""The flash-attention kernel's plain version (K10, run by the port's
wrapper on a CPU tensor) against the reference's Pallas kernel in
interpret mode, on the same numpy-seeded inputs:

* the five shapes of ``tests/test_kernels.py::test_flash_matches_ref``
  (GQA, causal, a 64-wide window, non-causal with S > T and S < T, S not
  a multiple of the 128-column kv block) and the head widths of qwen3
  (Dh 128, 16/8 heads) and zamba2 (Dh 80, 32/32 heads), in f32 and bf16,
  within the reference's own tolerances (2e-5 in f32, 2e-2 in bf16);
* the dense oracle ``attention_ref`` against the reference's;
* ``supported`` against the reference's on the same shapes and masks;
* the dense and blockwise attention paths of the model layer;
* the arithmetic of K10's tensor-core variant (``flash_attention_tc_plain``:
  exp2, p split into bf16 halves p_hi + p_lo, each product in f32) against
  the reference's Pallas kernel on bf16 inputs, within one bf16 ulp (the
  limit the card holds the kernel to), before any run on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as jflash  # noqa: E402
from repro.kernels.flash_attention import ref as jflash_ref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash  # noqa: E402
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa: E402
from repro_torch.kernels.tolerance import bf16_ulps  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402

SHAPES = [
    # b, h, kh, t, s, dh, causal, window
    (2, 4, 2, 256, 256, 64, True, None),
    (1, 8, 8, 128, 128, 128, True, None),
    (2, 4, 1, 256, 256, 32, True, 64),
    (1, 2, 2, 128, 384, 64, False, None),
    (1, 4, 4, 384, 200, 64, False, None),  # padded kv
    (1, 16, 8, 256, 256, 128, True, None),  # qwen3's heads
    (1, 32, 32, 256, 256, 80, True, None),  # zamba2's heads
    (1, 32, 32, 256, 200, 80, True, 96),  # zamba2's, windowed, S % 128
]
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(b, h, kh, t, s, dh, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, h, dh), dtype=np.float32),
            rng.standard_normal((b, s, kh, dh), dtype=np.float32),
            rng.standard_normal((b, s, kh, dh), dtype=np.float32))


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) \
        if not isinstance(a, torch.Tensor) else a.float().numpy()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,h,kh,t,s,dh,causal,window", SHAPES)
def test_plain_flash_matches_reference_kernel(b, h, kh, t, s, dh, causal,
                                              window, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _inputs(b, h, kh, t, s, dh, t + s + dh)
    want = jflash.flash_attention(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
        causal=causal, window=window)
    got = flash.flash_attention(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
        causal=causal, window=window)
    assert got.dtype == tdt and tuple(got.shape) == (b, t, h, dh)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 48),
                                           (False, None)])
def test_dense_oracle_matches_reference(causal, window):
    q, k, v = _inputs(2, 4, 2, 128, 128, 32, 3)
    tr = [torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)]
    jr = [jnp.swapaxes(jnp.asarray(a), 1, 2) for a in (q, k, v)]
    got = flash_ref.attention_ref(*tr, causal=causal, window=window)
    want = jflash_ref.attention_ref(*jr, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                               rtol=2e-6)
    # and the plain kernel version against the dense oracle
    plain = flash_ref.flash_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        window=window)
    np.testing.assert_allclose(plain.transpose(1, 2).numpy(), got.numpy(),
                               atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("t,dh,masked", [(128, 64, False), (256, 256, False),
                                         (96, 64, False), (200, 64, False),
                                         (64, 257, False), (16, 32, False),
                                         (128, 64, True)])
def test_supported_agrees(t, dh, masked):
    q = np.zeros((1, t, 2, dh), np.float32)
    mask = np.ones((1, 1, 1, t, t), bool) if masked else None
    want = jflash.supported(jnp.asarray(q), q, q,
                            None if mask is None else jnp.asarray(mask))
    got = flash.supported(torch.from_numpy(q), None, None,
                          None if mask is None else torch.from_numpy(mask))
    assert got == want


@pytest.mark.parametrize("t,s,causal,window", [(256, 256, True, None),
                                               (256, 256, True, 64),
                                               (128, 512, False, None)])
def test_sdpa_paths_match_reference(t, s, causal, window):
    """The model layer's dense ``sdpa`` and ``sdpa_blockwise`` against the
    reference's (the paths ``gqa_forward`` takes without the kernel)."""
    q, k, v = _inputs(2, 4, 2, t, s, 32, 11)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tmask = attn.causal_mask(t, s, window) if causal else None
    jmask = jattn.causal_mask(t, s, window) if causal else None
    for got, want in (
            (attn.sdpa(tq, tk, tv, tmask), jattn.sdpa(jq, jk, jv, jmask)),
            (attn.sdpa_blockwise(tq, tk, tv, causal=causal, window=window,
                                 q_block=64, kv_block=64),
             jattn.sdpa_blockwise(jq, jk, jv, causal=causal, window=window,
                                  q_block=64, kv_block=64))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                                   rtol=2e-6)


@pytest.mark.parametrize("window", [None, 700])
def test_gqa_forward_goes_blockwise_above_the_threshold(window, monkeypatch):
    """Without the kernel, ``gqa_forward`` at T > BLOCKWISE_THRESHOLD takes
    ``sdpa_blockwise`` and computes what the reference's dense path does.
    (The reference's own blockwise path is held only without a window: with
    one it walks the wrong KV blocks at 512-row Q and 1024-row KV blocks.)"""
    t, d, h, kh, dh = 3072, 32, 2, 1, 16
    cfg = attn.AttnConfig(d, h, kh, dh, sliding_window=window)
    jcfg = jattn.AttnConfig(d, h, kh, dh, sliding_window=window)
    rng = np.random.default_rng(13)
    shapes = {"wq": (d, h, dh), "wk": (d, kh, dh), "wv": (d, kh, dh),
              "wo": (h, dh, d)}
    params = {n: 0.2 * rng.standard_normal(sh, dtype=np.float32)
              for n, sh in shapes.items()}
    x = rng.standard_normal((1, t, d), dtype=np.float32)
    pos = np.arange(t)[None]
    calls = []
    blockwise = attn.sdpa_blockwise
    monkeypatch.setattr(attn, "sdpa_blockwise",
                        lambda *a, **kw: calls.append(1) or blockwise(*a,
                                                                      **kw))
    got = attn.gqa_forward({n: torch.from_numpy(a) for n, a in
                            params.items()}, cfg, torch.from_numpy(x),
                           torch.from_numpy(pos))
    jargs = ({n: jnp.asarray(a) for n, a in params.items()}, jcfg,
             jnp.asarray(x), jnp.asarray(pos))
    assert t > attn.BLOCKWISE_THRESHOLD and calls == [1]
    for impl in ("dense",) if window else ("dense", "auto"):
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jattn.gqa_forward(*jargs, impl=impl)),
            atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("b,h,kh,t,s,dh,causal,window,q_scale", [
    (1, 4, 2, 256, 256, 128, True, None, 1.0),  # qwen3's head width
    (1, 4, 4, 256, 200, 80, True, 96, 1.0),  # zamba2's, windowed, S % 128
    (1, 2, 1, 128, 300, 80, False, None, 1.0),  # non-causal, S > T, ragged
    (1, 4, 2, 128, 128, 128, True, None, 8.0),  # p over many binades
])
def test_split_p_arithmetic_within_one_bf16_ulp_of_reference(
        b, h, kh, t, s, dh, causal, window, q_scale):
    """The tensor-core kernel's p_hi + p_lo split keeps p.v at the f32
    reference within one bf16 ulp at each element (2e-5 floor), the limit
    ``chip_smoke.py`` and the card tests hold the kernel to."""
    q, k, v = _inputs(b, h, kh, t, s, dh, 7 * t + s + dh)
    q = q * np.float32(q_scale)
    want = jflash.flash_attention(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
        causal=causal, window=window)
    got = flash_ref.flash_attention_tc_plain(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, t, h, dh)
    assert bf16_ulps(got, torch.tensor(_f32(want)), 2e-5) <= 1
