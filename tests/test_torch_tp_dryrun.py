"""The dry-run under tensor parallelism (``launch/dryrun.py`` with
``steps.build_prefill`` / ``build_serve`` over a mesh) against the
reference's partitioned HLO.

* qwen3-smoke's prefill (B 8, T 64) and decode (B 8, cache 64) traced on
  ``meta`` on rank 0 of a fake world on a ``(4 data, 2 model)`` and a
  ``(2 data, 2 model)`` mesh: ``OpCounter``'s dot FLOPs of the rank (its
  batch share and its shard of the parameters: FSDP+TP in mode "serve",
  TP in mode "serve_replicated") against ``hlo_analysis.analyze`` of
  the reference's ``build_prefill`` / ``build_serve`` compiled with the
  same ``param_pspec`` shardings on a host mesh of as many devices, in a
  subprocess (``--xla_force_host_platform_device_count=8``, as
  ``tests/test_distributed.py`` drives its check).  Decode is equal in
  both modes, and so is the prefill in mode "serve_replicated".  In mode
  "serve" GSPMD partitions the prefill differently in one place: it
  follows the FSDP sharding of the weights' embed dim over "data" into
  the activations (``[8, 64, 128 / D]``), so the attention's two batched
  products (QK^T and PV), which contract no embed dim, run for the whole
  batch on every "data" rank: D times the port's, which keeps the batch
  split.  On the (2, 2) mesh it does the same with the decode step's
  two attention products (one query row against the cache of T), and
  on the (4, 2) mesh it does not.  The test holds each difference
  exactly (``GSPMD_WHOLE_BATCH``).  The port's
  collectives: a row-parallel sum a layer for attention and the FFN,
  the embedding's sum and the logits' gather, and in mode "serve" one
  FSDP gather a cut leaf where it is used (a unit's leaves, the
  embedding once for its lookup and the tied logits, ``final_norm``).
* ``dryrun_one`` at full width (qwen3-0.6b cut to one layer) records
  ``"tp_applied"`` and ``"fsdp_applied"`` true for prefill and decode,
  with the rank's shard
  of the parameters over "model" and "data" in ``"sharded"`` and no
  parameter in ``"whole"``, and both false for the train round.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.launch import dryrun, fsdp, steps  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.models.common import abstract_params  # noqa: E402

META = torch.device("meta")
B, T, MODEL = 8, 64, 2
DATAS = (4, 2)  # the meshes' "data" sizes
MODES = ("serve", "serve_replicated")
# the (kind, mode, data) whose attention products GSPMD runs for the whole
# batch on every "data" rank, after the FSDP-sharded activations
GSPMD_WHOLE_BATCH = {("prefill", "serve", 4), ("prefill", "serve", 2),
                     ("decode", "serve", 2)}


def _reference_dots() -> dict:
    """The reference's per-device dot FLOPs: ``{data size: {mode:
    {"prefill": f, "decode": f}}}`` (run in a process with 8 host
    devices; a mesh of fewer takes the first of them)."""
    out = {}
    for data in DATAS:
        out[data] = _reference_mesh_dots(data)
    return out


def _reference_mesh_dots(data) -> dict:
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec

    from repro.configs import ARCHS as JARCHS
    from repro.launch import hlo_analysis as ha
    from repro.launch import sharding as jshd
    from repro.launch import steps as jsteps
    from repro.models.common import abstract_params as jabstract

    arch = JARCHS["qwen3-0.6b"]
    cfg = arch.make_smoke()
    mesh = jax.make_mesh((data, MODEL), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:data * MODEL])

    def named(tree):
        return jax.tree.map(lambda p: NamedSharding(mesh, p), tree,
                            is_leaf=lambda x: isinstance(x, PartitionSpec))

    def dots(fn, shardings, *args):
        compiled = jax.jit(fn, in_shardings=shardings).lower(*args).compile()
        return ha.analyze(compiled.as_text()).dot_flops

    params = jabstract(jsteps.model_specs(arch, cfg), cfg.dtype)
    out = {}
    with jax.set_mesh(mesh):
        for mode in MODES:
            prefill, pps = jsteps.build_prefill(arch, cfg, mesh, mode=mode)
            data = {"tokens": jax.ShapeDtypeStruct((B, T), jnp.int32)}
            dps = {"tokens": jshd.batch_pspec(mesh, (B, T))}
            serve, pps, abstract_cache = jsteps.build_serve(arch, cfg, mesh,
                                                            mode=mode)
            cache = abstract_cache(params, {
                "token": jax.ShapeDtypeStruct((B,), jnp.int32),
                "_max_len": T})
            step = {"token": jax.ShapeDtypeStruct((B,), jnp.int32),
                    "pos": jax.ShapeDtypeStruct((), jnp.int32)}
            sps = {"token": jshd.batch_pspec(mesh, (B,)),
                   "pos": PartitionSpec()}
            out[mode] = {
                "prefill": dots(prefill, (named(pps), named(dps)), params,
                                data),
                "decode": dots(serve, (named(pps), named(
                    jshd.cache_pspec(mesh, cache)), named(sps)), params,
                    cache, step)}
    return out


@pytest.fixture(scope="module")
def reference_dots():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(
        os.path.dirname(__file__), "..", "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    res = subprocess.run([sys.executable, __file__], capture_output=True,
                         text=True, env=env, timeout=240)
    assert res.returncode == 0, res.stdout + res.stderr
    return {int(k): v for k, v in json.loads(
        res.stdout.strip().splitlines()[-1]).items()}


def _port_dots(data, mode):
    """Rank 0's dot FLOPs and collectives in a fake world of ``data *
    MODEL`` ranks, its parameters cut as ``mode`` says."""
    arch = ARCHS["qwen3-0.6b"]
    cfg = arch.make_smoke()
    specs = steps.model_specs(arch, cfg)
    b = B // data
    with dryrun.fake_world(data * MODEL):
        mesh = make_host_mesh(data * MODEL, model=MODEL)
        params = steps.serve_shard(arch, cfg, abstract_params(
            specs, cfg.dtype), mesh, mode)
        prefill = steps.build_prefill(arch, cfg, mesh)
        pre = dryrun.analyze_step(prefill, (params, {"tokens": torch.empty(
            (b, T), dtype=torch.int32, device=META)}))
        serve, init_cache = steps.build_serve(arch, cfg, mesh)
        dec = dryrun.analyze_step(serve, (params, init_cache(b, T, META), {
            "token": torch.empty((b,), dtype=torch.int32, device=META),
            "pos": T - 1}))
    # the attention's QK^T and PV over the rank's batch share and heads:
    # T query rows in the prefill, one in the decode step
    attn = {q: cfg.n_layers * 2 * (2.0 * b * (cfg.attn.n_heads // MODEL)
                                   * q * T * cfg.attn.head_dim)
            for q in (T, 1)}
    # FSDP's gathers: a unit's cut leaves, the tied table once (for the
    # lookup and the logits) and final_norm
    gathers = (cfg.n_units * fsdp.gathers(tr._part_specs(cfg)["unit"], data)
               + 2 if mode == "serve" else 0)
    return {"prefill": pre, "decode": dec, "gathers": gathers,
            "attn": {"prefill": attn[T], "decode": attn[1]}}


@pytest.fixture(scope="module")
def port_dots():
    return {(d, m): _port_dots(d, m) for d in DATAS for m in MODES}


@pytest.mark.parametrize("data", DATAS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ("prefill", "decode"))
def test_tp_dot_flops_match_reference(reference_dots, port_dots, kind, mode,
                                      data):
    port = port_dots[data, mode]
    got = port[kind].stats.dot_flops
    want = reference_dots[data][mode][kind]
    if (kind, mode, data) in GSPMD_WHOLE_BATCH:
        # GSPMD runs the attention's products for the whole batch on each
        # of the "data" ranks (module doc)
        got += (data - 1) * port["attn"][kind]
    assert got == want
    # a row-parallel sum a layer for attention and the FFN, the embedding's
    # sum, the logits' gather, and FSDP's gathers in mode "serve"
    assert port["gathers"] == (20 if mode == "serve" else 0)
    assert port[kind].stats.collective_counts == {
        "all-reduce": 2 * 2 + 1, "all-gather": 1 + port["gathers"]}


@pytest.mark.parametrize("shape", ("prefill_32k", "decode_32k", "train_4k"))
def test_dryrun_one_records_tp(shape):
    variant = {"n_layers": 1}
    if shape == "train_4k":
        variant["recipe_tau"] = 1
    rec = dryrun.dryrun_one("qwen3-0.6b", shape, False, verbose=False,
                            variant=variant)
    assert rec["tp_applied"] is (shape != "train_4k")
    assert rec["fsdp_applied"] is (shape != "train_4k")
    if shape == "train_4k":
        assert not any(k.startswith("params.") for k in rec["sharded"])
        return
    sharded = {k: v for k, v in rec["sharded"].items()
               if k.startswith("params.")}
    # 16 q heads, 3072 FFN columns and 151936 vocab rows over 16 ranks;
    # the 8 KV heads do not divide, so wk / wv stay whole over "model";
    # every embed dim of 1024 over the 16 "data" ranks (FSDP)
    assert sharded == {
        "params.embed.embedding": [[0, ["model"]], [1, ["data"]]],
        "params.units.0_attn.attn.wq": [[1, ["data"]], [2, ["model"]]],
        "params.units.0_attn.attn.wk": [[1, ["data"]]],
        "params.units.0_attn.attn.wv": [[1, ["data"]]],
        "params.units.0_attn.attn.wo": [[1, ["model"]], [3, ["data"]]],
        "params.units.0_attn.ffn.wg": [[1, ["data"]], [2, ["model"]]],
        "params.units.0_attn.ffn.wu": [[1, ["data"]], [2, ["model"]]],
        "params.units.0_attn.ffn.wd": [[1, ["model"]], [2, ["data"]]],
        "params.units.0_attn.ln1.scale": [[1, ["data"]]],
        "params.units.0_attn.ln2.scale": [[1, ["data"]]],
        "params.final_norm.scale": [[0, ["data"]]]}
    assert not any(k.startswith("params.") for k in rec["whole"])
    assert rec["tp_layout"] == {}
    assert rec["ops"]["collective_counts"]["all-reduce"] == 3


if __name__ == "__main__":
    print(json.dumps(_reference_dots()))
