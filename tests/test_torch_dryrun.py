"""The dry-run and roofline tooling (``repro_torch.launch.dryrun``,
``op_analysis``, ``hillclimb``, ``repro_torch.roofline``) against the
reference's ``launch/dryrun.py`` and ``launch/hlo_analysis.py``.

* ``input_specs``, ``active_param_count`` and ``model_flops`` equal the
  reference's for every arch x shape (pure arithmetic: exactly).
* ``OpCounter``'s ``dot_flops`` on ``meta`` traces of the port's smoke
  steps equal ``hlo_analysis.analyze`` of the reference's compiled
  counterparts on the CPU, exactly (tolerance 0): qwen3's prefill (B 2,
  T 64) and decode (B 2, cache 64), granite-moe's prefill, and one
  LT-ADMM-CC round of qwen3 smoke over 2 agents (tau 2, batch 2, m 4,
  T 16).  The train step could differ where XLA drops a dot whose result
  is unused or fuses two; it does not here.  ``flop_counter_flops``
  (``torch.utils.flop_counter``'s formulas) agrees as well.
* A fake world counts an ``all_to_all_single``, an ``all_reduce`` and
  the all-gathers of known sizes at the reference's names and bytes;
  ``MemoryTracker`` gives the known peak of a scripted sequence.
* Every kernel wrapper's fake route returns its plain version's shapes
  and dtypes, launches nothing and reports one op with its bytes; a real
  CPU tensor still takes the plain route.
* ``dryrun_one`` at full width (qwen3-0.6b, cut to one layer; the train
  round at tau 1) on the four shapes in the 256-rank world, and the
  multi-pod train round in the 512-rank world; ``roofline.rows`` and
  ``hillclimb.summary`` render its record.
"""
import importlib
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import input_specs as jinput_specs  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.core import solver as jsolver  # noqa: E402
from repro.launch import hlo_analysis as ha  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.models.common import abstract_params as jabstract  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, SRC_FRAMES_RATIO  # noqa: E402
from repro_torch.configs import input_specs  # noqa: E402
from repro_torch.core import jaxrand  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch import dryrun, hillclimb, op_analysis  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models.common import abstract_params  # noqa: E402

META = torch.device("meta")


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's dry-run module.  Importing it sets XLA_FLAGS for a
    512-device host; the backend starts first, so this process keeps its
    devices, and the variable is restored."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old


# ---------------------------------------------------------------------------
# The abstract inputs and the analytic FLOPs
# ---------------------------------------------------------------------------


def _sds(spec: dict) -> dict:
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in spec.items()}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_specs_match_reference(arch):
    assert SRC_FRAMES_RATIO == 4
    for shape in SHAPES:
        for n_agents in (None, 16):
            got = input_specs(arch, shape, n_agents=n_agents)
            want = jinput_specs(arch, shape, n_agents=n_agents)
            assert all(v.device.type == "meta" for v in got.values())
            assert _sds(got) == {k: (tuple(v.shape), str(v.dtype))
                                 for k, v in want.items()}, (shape, n_agents)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_active_params_and_model_flops_match_reference(arch, ref_dryrun):
    recipe, jrecipe = steps.TrainRecipe(), jsteps.TrainRecipe()
    for shape in SHAPES:
        cfg, jcfg = ARCHS[arch].make(shape), JARCHS[arch].make(shape)
        assert dryrun.active_param_count(ARCHS[arch], cfg) == \
            ref_dryrun.active_param_count(JARCHS[arch], jcfg)
        s, js = SHAPES[shape], JSHAPES[shape]
        assert dryrun.model_flops(ARCHS[arch], cfg, s, s.kind, 16, recipe) \
            == ref_dryrun.model_flops(JARCHS[arch], jcfg, js, js.kind, 16,
                                      jrecipe)


# ---------------------------------------------------------------------------
# dot_flops against the reference's HLO
# ---------------------------------------------------------------------------


def _ref_dots(fn, *args) -> float:
    return ha.analyze(jax.jit(fn).lower(*args).compile().as_text()).dot_flops


def _port_prefill(arch_id, b, t):
    arch = ARCHS[arch_id]
    cfg = arch.make_smoke()
    params = abstract_params(steps.model_specs(arch, cfg), cfg.dtype)
    tokens = torch.empty((b, t), dtype=torch.int32, device=META)
    return dryrun.analyze_step(steps.build_prefill(arch, cfg),
                               (params, {"tokens": tokens}))


def _ref_prefill(arch_id, b, t):
    arch = JARCHS[arch_id]
    cfg = arch.make_smoke()

    def fn(p, tokens):
        return jtr.forward(p, cfg, tokens=tokens)[0][:, -1:, :]

    return _ref_dots(fn, jabstract(jsteps.model_specs(arch, cfg), cfg.dtype),
                     jax.ShapeDtypeStruct((b, t), jnp.int32))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-1b-a400m"])
def test_prefill_dot_flops_match_reference(arch):
    res = _port_prefill(arch, 2, 64)
    want = _ref_prefill(arch, 2, 64)
    assert res.stats.dot_flops == want > 0
    assert res.counter.flop_counter_flops == want
    assert res.stats.dot_flops_by_dtype == {"float32": want}


def test_decode_dot_flops_match_reference():
    b, max_len = 2, 64
    arch, jarch = ARCHS["qwen3-0.6b"], JARCHS["qwen3-0.6b"]
    cfg, jcfg = arch.make_smoke(), jarch.make_smoke()
    serve, init_cache = steps.build_serve(arch, cfg)
    params = abstract_params(steps.model_specs(arch, cfg), cfg.dtype)
    token = torch.empty((b,), dtype=torch.int32, device=META)
    got = dryrun.analyze_step(serve, (params, init_cache(b, max_len, META),
                                      {"token": token, "pos": max_len - 1}))

    def fn(p, cache, tok, pos):
        return jtr.decode_step(p, jcfg, cache, token=tok, pos=pos)

    want = _ref_dots(fn, jabstract(jsteps.model_specs(jarch, jcfg)),
                     jax.eval_shape(lambda: jtr.init_cache(jcfg, b, max_len)),
                     jax.ShapeDtypeStruct((b,), jnp.int32),
                     jax.ShapeDtypeStruct((), jnp.int32))
    assert got.stats.dot_flops == want > 0


def test_train_step_dot_flops_match_reference():
    """One LT-ADMM-CC round (ring, SVRG) of qwen3 smoke over two agents:
    the port's per-agent forward and backward passes against the
    reference's vmapped gradients in its compiled round.  Uncompressed
    messages keep the reference's compile short; a compressor adds no
    products (the records below run qbit8 through K1/K5)."""
    a, m, t = 2, 4, 16
    spec = "ltadmm:compressor=identity"
    arch, jarch = ARCHS["qwen3-0.6b"], JARCHS["qwen3-0.6b"]
    cfg, jcfg = arch.make_smoke(), jarch.make_smoke()
    recipe = steps.TrainRecipe(tau=2, batch_size=2)
    step, _, solver = steps.build_train(arch, cfg, a, spec, recipe,
                                        device=META)
    state = dryrun._concrete_counter(
        steps.abstract_train_state(arch, cfg, solver))
    tokens = torch.empty((a, m, t + 1), dtype=torch.int32, device=META)
    got = dryrun.analyze_step(step, (state, {"tokens": tokens}, 0))

    jrecipe = jsteps.TrainRecipe(tau=2, batch_size=2)
    graph, ex = jsched.build_graph("ring", a)
    js = jsolver.make_solver(
        spec, graph, ex, jsteps.build_estimator(jarch, jcfg, jrecipe, "vr"),
        defaults=jrecipe.solver_defaults("ltadmm"))
    lowered = jax.jit(
        lambda s, d, seed: js.step(s, d, jax.random.PRNGKey(seed))).lower(
        jsteps.abstract_train_state(jarch, jcfg, js),
        {"tokens": jax.ShapeDtypeStruct((a, m, t + 1), jnp.int32)},
        jax.ShapeDtypeStruct((), jnp.uint32))
    want = ha.analyze(lowered.compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}).as_text()).dot_flops
    assert got.stats.dot_flops == want > 0


# ---------------------------------------------------------------------------
# Collectives, live bytes, the roofline terms
# ---------------------------------------------------------------------------


def test_collectives_count_at_the_reference_names():
    import torch.distributed as dist

    with dryrun.fake_world(8):
        counter = op_analysis.OpCounter()
        with counter:
            x = torch.empty((8, 4), device=META)  # 128 B
            y = torch.empty_like(x)
            dist.all_to_all_single(y, x)
            dist.all_reduce(torch.empty((16,), device=META))  # 64 B
            out = torch.empty((64, 4), device=META)  # 1024 B
            dist.all_gather_into_tensor(out, x)
            if hasattr(dist, "all_gather_single"):
                dist.all_gather_single(out, x)
            else:
                dist.all_gather_into_tensor(out, x)
    st = counter.stats
    assert st.collective_counts == {"all-to-all": 1.0, "all-reduce": 1.0,
                                    "all-gather": 2.0}
    assert st.collective_bytes == 128 + 64 + 2 * 1024
    assert set(st.collective_counts) <= set(op_analysis.COLLECTIVES)
    with pytest.raises(RuntimeError, match="already"):
        with dryrun.fake_world(2):
            with dryrun.fake_world(2):
                pass


def test_memory_tracker_peak_of_a_scripted_sequence():
    mem = op_analysis.MemoryTracker()
    with op_analysis.OpCounter(memory=mem):
        a = torch.empty((1000,), device=META)  # 4000 B
        b = torch.empty((500,), device=META)  # 2000 B
        assert mem.live == 6000
        del a
        assert mem.live == 2000
        v = b.view(20, 25)[1:]  # a view keeps b's storage
        del b
        assert mem.live == 2000
        c = v * 2  # 1900 B
        d = torch.zeros((3000,), device=META)  # 12000 B
        assert mem.live == 2000 + 1900 + 12000
        del v, c, d
    assert mem.live == 0 and mem.peak == 15900


def test_roofline_terms_on_the_h100_constants():
    st = op_analysis.OpStats(
        dot_flops=2 * 989e12, memory_bytes=1.0, memory_bytes_w2=3.35e12,
        collective_bytes=50e9,
        dot_flops_by_dtype={"bfloat16": 989e12, "float32": 989e12})
    terms = op_analysis.roofline_terms(st)
    assert terms["t_compute_s"] == pytest.approx(1 + 989 / 67)
    assert terms["t_memory_s"] == pytest.approx(1.0)
    assert terms["t_collective_s"] == pytest.approx(1.0)
    assert terms["dominant"] == "compute"
    assert op_analysis.DEVICE == "NVIDIA H100 80GB HBM3, 700.00 W"


def test_resolve_device_raises_for_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("meta") == META


# ---------------------------------------------------------------------------
# The kernel wrappers' fake routes
# ---------------------------------------------------------------------------


def _wrapper_cases():
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.quantize import ops as qo
    from repro_torch.kernels.sparse_gather import ops as so
    from repro_torch.kernels.ssm_scan import ops as ss

    rng = np.random.RandomState(0)

    def f32(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    ids = torch.arange(3, dtype=torch.int32)
    keys = jaxrand.split(jaxrand.key(0), 3)
    q8, s8 = qo.quantize_tensor(keys, f32(3, 64), bits=8)
    perm = torch.from_numpy(np.stack([rng.permutation(64)[:16]
                                      for _ in range(3)]))
    off = torch.tensor([0, 5, 63])
    ssm_cfg = type("C", (), {"chunk": 16})()
    return {
        "K1": (qo.quantize_plane, lambda x: ((1, 2), ids, None, x),
               {"bits": 8}, f32(3, 64)),
        "K4": (qo.quantize_tensor, lambda x: (keys, x), {"bits": 4},
               f32(3, 64)),
        "K5": (qo.dequantize_tensor, lambda q: (q, s8), {"n": 64, "bits": 8},
               q8),
        "K5-plane": (qo.dequantize_plane, lambda q: (q, s8),
                     {"n": 64, "bits": 8}, q8),
        "K2": (so.randk_gather_plane, lambda x: ((1, 2), ids, None, x),
               {"k": 16, "strides": (1, 3)}, f32(3, 64)),
        "K3": (so.randk_scatter_plane, lambda v: ((1, 2), ids, None, v),
               {"n": 64, "gain": 2.0, "strides": (1, 3)}, f32(3, 16)),
        "K6": (so.sparse_gather, lambda x: (x, perm), {}, f32(3, 64)),
        "K7": (so.sparse_scatter, lambda v: (v, perm, 64),
               {"unique": True}, f32(3, 16)),
        "K8": (so.cyclic_gather, lambda x: (x, off, 16), {}, f32(3, 64)),
        "K9": (so.cyclic_scatter, lambda v: (v, off, 64), {}, f32(3, 16)),
        "K10": (fa.flash_attention, lambda q: (q, f32(2, 32, 2, 8),
                                               f32(2, 32, 2, 8)),
                {"causal": True, "window": 8}, f32(2, 32, 4, 8)),
        "K11": (ss.ssd_chunked, lambda x: (ssm_cfg, x, f32(1, 32, 1, 16),
                                           f32(1, 32, 1, 16),
                                           -f32(1, 32, 4).abs()),
                {}, f32(1, 32, 4, 8)),
    }


def _to_meta(a):
    if isinstance(a, torch.Tensor):
        return torch.empty(a.shape, dtype=a.dtype, device=META)
    if isinstance(a, tuple):
        return tuple(_to_meta(x) for x in a)
    return a


def _launches():
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.quantize import ops as qo
    from repro_torch.kernels.sparse_gather import ops as so
    from repro_torch.kernels.ssm_scan import ops as ss

    return [f.launches for f in (
        qo.quantize_plane, qo.quantize_tensor, qo.dequantize_tensor,
        qo.dequantize_plane, so.randk_gather_plane, so.randk_scatter_plane,
        so.sparse_gather, so.sparse_scatter, so.cyclic_gather,
        so.cyclic_scatter, fa.flash_attention, ss.ssd_chunked)]


@pytest.mark.parametrize("kid", list(_wrapper_cases()))
def test_fake_route_shapes_no_launch_and_bytes(kid):
    fn, args_of, kw, x = _wrapper_cases()[kid]
    args = args_of(x)
    plain = fn(*args, **kw)  # a real CPU tensor: the plain route
    plain_t = plain if isinstance(plain, tuple) else (plain,)
    assert all(t.device.type == "cpu" for t in plain_t)
    before = _launches()
    counter = op_analysis.OpCounter()
    meta_args = _to_meta(args)
    with counter:
        out = fn(*meta_args, **kw)
    out_t = out if isinstance(out, tuple) else (out,)
    assert [(tuple(t.shape), t.dtype, t.device.type) for t in out_t] == [
        (tuple(t.shape), t.dtype, "meta") for t in plain_t]
    assert _launches() == before
    name = kid.split("-")[0]
    assert dict(counter.kernels) == {name: 1}
    nb = sum(t.numel() * t.element_size() for t in out_t)
    assert counter.stats.memory_bytes_w2 == 2 * nb
    assert counter.stats.memory_bytes > nb
    if name == "K10":  # causal, window 8: 8 pairs a row past row 7
        pairs = sum(min(i + 1, 8) for i in range(32))
        assert counter.stats.dot_flops == 2.0 * 2 * 4 * pairs * (8 + 8)
    elif name == "K11":
        assert counter.stats.dot_flops == 2.0 * (16 * 16 * 16 + 16 * 16 * 8
                                                 + 2 * 16 * 16 * 8) * 4 * 2
    else:
        assert counter.stats.dot_flops == 0


@pytest.mark.parametrize("t,s,causal,window", [
    (32, 32, True, None), (32, 32, True, 8), (32, 32, False, 8),
    (40, 24, True, 5), (40, 24, False, 5), (24, 40, True, None),
    (24, 40, False, None), (33, 7, True, 3), (33, 7, False, 30)])
def test_k10_products_count_the_pairs_its_mask_admits(t, s, causal,
                                                      window):
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref

    q = torch.empty((2, t, 4, 8), device=META)
    k = torch.empty((2, s, 2, 8), device=META)
    v = torch.empty((2, s, 2, 6), device=META)
    pairs = int(fa_ref._mask(torch.arange(t), torch.arange(s), causal,
                             window).sum())
    assert fa.products(q, k, v, causal=causal, window=window) == (
        2.0 * 2 * 4 * pairs * (8 + 6))


def test_kernel_op_counts_only_while_a_counter_listens():
    calls = []

    def flops():
        calls.append(1)
        return 10.0

    out = torch.empty(3, device=META)
    assert op_analysis.kernel_op("K10", (out,), out, flops) is out
    assert calls == []
    counter = op_analysis.OpCounter()
    with counter:
        op_analysis.kernel_op("K10", (out,), out, flops, torch.bfloat16)
    assert calls == [1] and counter.stats.dot_flops == 10.0
    assert counter.stats.dot_flops_by_dtype == {"bfloat16": 10.0}


# ---------------------------------------------------------------------------
# dryrun_one in the fake production world, and its renderers
# ---------------------------------------------------------------------------

CUT = {"n_layers": 1}


@pytest.fixture(scope="module")
def records():
    out = {}
    for shape in SHAPES:
        variant = dict(CUT, recipe_tau=1) if shape == "train_4k" else CUT
        out[(shape, False)] = dryrun.dryrun_one(
            "qwen3-0.6b", shape, False, verbose=False, variant=variant)
    out[("train_4k", True)] = dryrun.dryrun_one(
        "qwen3-0.6b", "train_4k", True, verbose=False,
        variant=dict(CUT, recipe_tau=1))
    return out


@pytest.mark.parametrize("shape", list(SHAPES))
def test_dryrun_one_full_width_on_the_single_pod(records, shape):
    rec = records[(shape, False)]
    assert rec["chips"] == 256 and rec["mesh"] == "16x16"
    # tensor parallelism runs on the served steps, not on the train round
    kind = SHAPES[shape].kind
    assert rec["tp_applied"] is (kind != "train")
    ops = rec["ops"]
    assert ops["dot_flops"] > 0 and ops["memory_bytes_w2"] > 0
    assert rec["flop_counter_flops"] == ops["dot_flops"]
    assert set(rec["roofline"]) == {"t_compute_s", "t_memory_s",
                                    "t_collective_s", "dominant"}
    b = rec["bytes_per_device"]
    assert b["total_live"] == b["args"] + b["out"] + b["temp"] - b["alias"]
    assert 0 < rec["useful_fraction"] < 1
    if kind == "train":
        assert rec["n_agents"] == 16 and rec["agent_axis"] == "data"
        assert rec["kernels"] == {"K1": 2, "K5": 4}
        assert rec["ops"]["collective_counts"] == {"all-to-all": 8.0}
        assert rec["sharded"]["state"] == [[0, ["data"]]]
        assert rec["sharded"]["tokens"] == [[0, ["data"]]]
    elif shape == "long_500k":
        # one request: nothing splits the batch; the ring-buffer cache's
        # sequence dim, which the reference shards over "data", runs whole
        assert rec["n_agents"] is None and "token" not in rec["sharded"]
        assert [1, ["data"]] in rec["whole"]["cache[1]"]
    else:
        assert rec["n_agents"] is None and rec["agent_axis"] is None
        name = "tokens" if kind == "prefill" else "token"
        assert rec["sharded"][name] == [[0, ["data"]]]
    json.dumps(rec)


def test_dryrun_one_multi_pod_train(records):
    rec = records[("train_4k", True)]
    assert rec["chips"] == 512 and rec["mesh"] == "2x16x16"
    assert rec["agent_axis"] == "pod" and rec["n_agents"] == 2
    # one agent a pod, its 128 sequences over "data": 8 on this rank
    assert rec["sharded"]["tokens"] == [[0, ["pod"]], [1, ["data"]]]


def test_roofline_and_hillclimb_render_a_record(records, tmp_path, capsys):
    from repro_torch import roofline

    rec = records[("decode_32k", False)]
    path = tmp_path / "torch_dryrun.jsonl"
    path.write_text(json.dumps(rec) + "\n")
    got = roofline.run(path=str(tmp_path / "torch_dryrun*.jsonl"))
    assert got == [("roofline/qwen3-0.6b/decode_32k/16x16",
                    rec["roofline"]["t_compute_s"],
                    rec["roofline"]["dominant"])]
    line = capsys.readouterr().out.strip()
    assert line.startswith("# roofline/qwen3-0.6b/decode_32k/16x16")
    # under tensor parallelism the decode's logits gather (2.4 MB over
    # 50 GB/s) outweighs its traced memory traffic
    assert rec["roofline"]["dominant"] == "collective"
    assert "dom=collective" in line and "dev_bytes=" in line
    s = hillclimb.summary(rec, "t")
    assert s["dot_flops"] == rec["ops"]["dot_flops"] and s["tag"] == "t"
