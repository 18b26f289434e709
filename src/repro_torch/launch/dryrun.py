"""Dry-run: trace rank 0's step of every (architecture x input shape x
mesh) combination in a fake world of the production mesh's 256 (16 x 16)
or 512 (2 x 16 x 16) ranks, on ``meta`` tensors: nothing is allocated and
no collective moves a byte, but every op of the card's route is
dispatched and counted.  The counterpart of
``src/repro/launch/dryrun.py``, which lowers and compiles the step
against the production mesh with ``ShapeDtypeStruct`` inputs.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch qwen3-0.6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        --multi-pod both --out results/torch_dryrun.jsonl

The world is ``torch.distributed``'s "fake" backend over a ``FakeStore``
(``torch.testing._internal.distributed.fake_pg``): one process plays rank
0, the mesh is ``launch.mesh.make_production_mesh``'s, and the c10d
collectives dispatch as on the card.  The trace runs on ``meta``
tensors, which take the card's route wherever the port chooses one by
device (``compression.resolve_impl``: the kernels; each kernel wrapper's
fake route reports its launch).  A CPU-only PyTorch cannot index a fake
CUDA tensor (its indexing needs CUDA's device guard), and a fake tensor's
dispatch costs ~10x a ``meta`` op's through the counter's cache, so
``meta`` stands in for the card.

What rank 0 runs:

* train: ``steps.build_train(..., device="meta", mesh=mesh)`` with the
  variant's solver (default "ltadmm"), one ``step`` on the rank's rows
  of ``abstract_train_state`` and of ``input_specs(..., n_agents)``:
  A / W agents, and its share of the local batch where
  ``shd.train_data_pspec`` shards it over "data" (the multi-pod mesh).
  A per-leaf LT-ADMM-CC solver (``"ltadmm:packed=false"``) of the archs
  that ``steps.tensor_parallel`` admits runs tensor-parallel: every
  state leaf is the rank's shard over "model" (the ``tp_plan`` of mode
  "admm", recorded as for serving), and on the multi-pod mesh also over
  "data" (FSDP, ``steps.fsdp_training``: the reference's rules give the
  embed dims "data" there).
* prefill and decode: ``build_prefill`` / ``build_serve`` with the mesh,
  the parameters cut by the variant's ``serve_mode`` (default "serve";
  ``shd.shard_params``, ``shd.param_pspec``), the rank's share of
  each input's batch dim as ``shd.batch_pspec`` and ``shd.cache_pspec``
  assign it; any other dim runs whole (the cache's sequence dim
  included), unless the variant's ``attn_seq_shard`` asks for
  sequence-sharded attention.  Where ``steps.tp_serving`` holds (the
  GQA + FFN archs and zamba2) the step runs tensor-parallel over "model"
  on the rank's shard of the parameters (``shd.shard_params``) and its
  cache (the KV heads, the SSD heads and their conv channels).  In mode
  "serve" every decoder-only arch's parameters are also cut over "data"
  (FSDP: the embed dims, gathered where they are used).

A record says whether tensor parallelism ran (``"tp_applied"``: the
rank held a shard of the parameters over "model"; true for
``tp_serving``'s archs' prefill and decode and their per-leaf
LT-ADMM-CC training; false for the packed training round, whose plane
the reference too replicates over "model", and for the MoE, MLA, xLSTM
and encoder-decoder archs, whose parameters are replicated over
"model", so their per-device bytes and FLOPs exceed the reference's by
design) and whether FSDP ran (``"fsdp_applied"``: a shard over "data";
true for every decoder-only arch's prefill and decode in mode "serve"
and for the per-leaf training on the multi-pod mesh) beside the dims it
sharded (``"sharded"``),
those the reference's specs shard that it ran whole (``"whole"``: the
MoE, MLA and xLSTM archs' "model" dims, the encoder-decoder's "data"
dims), and the leaves it holds in another layout than the
reference's spec gives (``"tp_layout"``: a Mamba mixer's, cut by SSD
head, and its decode state ``h``, whose heads dim takes "model" where
``cache_pspec`` shards d_state).

A record holds the reference's keys, with ``hlo`` renamed ``ops`` (an
``op_analysis.OpStats``), ``xla_cost_analysis_flops`` replaced by
``flop_counter_flops`` (the total of ``torch.utils.flop_counter``'s
formulas over the same ops, a cross-check of ``dot_flops``) and
``compile_s`` holding the trace's seconds; ``kernels`` adds the
hand-written kernels' launches.  ``bytes_per_device``: args (the rank's
inputs), out, temp (the ``MemoryTracker``'s peak above args, outputs
left out), alias (outputs that are inputs updated in place) and
total_live = args + out + temp - alias; ``peak_by_op`` the bytes live at
the tracker's peak by the op that made them (its largest 12).  The
records go to ``results/torch_dryrun.jsonl`` by default, never to the
reference's ``results/dryrun*.jsonl``.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import contextlib
import dataclasses
import functools
import json
import math
import multiprocessing
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.common.trees import dict_paths, tree_flatten, tree_map
from repro_torch.configs import ARCHS, SHAPES, input_specs
from repro_torch.launch import op_analysis
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps
from repro_torch.launch.mesh import (agent_axis_for, axes_of,
                                     make_production_mesh, use_mesh)
from repro_torch.models.common import abstract_params, param_count

DEFAULT_OUT = os.path.join("results", "torch_dryrun.jsonl")
TRACE_DEVICE = torch.device("meta")
# combos traced at once by ``main``.  The 80 combos' traces take 94 min
# one after another on the CPU (xlstm-125m train_4k alone 13.6 min), 25
# min four at a time; a trace is one busy core and ~1 GB of host memory.
# Each combo runs in a fresh spawned process, so no combo's world or
# caches carry into the next.
JOBS = 4


# ---------------------------------------------------------------------------
# The world
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fake_world(world_size: int):
    """A "fake" ``torch.distributed`` world of ``world_size`` ranks in this
    process (rank 0), destroyed on exit.  Refuses to start inside an
    initialised world."""
    if dist.is_initialized():
        raise RuntimeError("a torch.distributed world is already "
                           "initialised; the dry-run starts its own")
    # registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The analytic model FLOPs (line for line the reference's)
# ---------------------------------------------------------------------------


def active_param_count(arch, cfg) -> float:
    """Parameters touched per token (MoE: routed experts scaled by
    top_k / E)."""
    total = param_count(steps.model_specs(arch, cfg))
    moe = getattr(cfg, "moe", None)
    if moe is None:
        return float(total)
    # routed expert params per MoE layer
    per_expert = 3 * moe.d_model * moe.d_ff_expert
    n_moe_layers = cfg.n_units * sum(
        1 for k in cfg.pattern if k in ("moe", "mla"))
    routed = n_moe_layers * moe.n_experts * per_expert
    active_routed = routed * moe.top_k / moe.n_experts
    return float(total - routed + active_routed)


def model_flops(arch, cfg, shape, mode, n_agents, recipe) -> float:
    """Analytic 6 N_active D (dense fwd + bwd) / 2 N D (forward only)."""
    del mode
    n_act = active_param_count(arch, cfg)
    b, t = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        # LT-ADMM-CC outer round: the SVRG anchor (m_local seqs) + tau
        # inner steps x 2 batch gradients each, per agent
        m_local = b // n_agents
        tokens = n_agents * (m_local + 2 * recipe.tau * recipe.batch_size) * t
        return 6.0 * n_act * tokens
    if shape.kind == "prefill":
        return 2.0 * n_act * b * t
    return 2.0 * n_act * b  # decode: one token per request


# ---------------------------------------------------------------------------
# One step, counted
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StepAnalysis:
    out: object
    counter: op_analysis.OpCounter
    memory: op_analysis.MemoryTracker
    bytes_per_device: dict
    seconds: float

    @property
    def stats(self) -> op_analysis.OpStats:
        return self.counter.stats


@contextlib.contextmanager
def _all_nonzero():
    """On ``meta`` tensors a boolean-mask index (the MoE dispatch's kept
    pairs) takes every element as selected, the upper bound of its data-
    dependent size (``torch.fx``'s ``meta_nonzero_assume_all_nonzero``)."""
    import torch.fx.experimental._config as fx_config

    prev = getattr(fx_config, "meta_nonzero_assume_all_nonzero", None)
    if prev is None:
        yield
        return
    fx_config.meta_nonzero_assume_all_nonzero = True
    try:
        yield
    finally:
        fx_config.meta_nonzero_assume_all_nonzero = prev


def analyze_step(fn, args) -> StepAnalysis:
    """``fn(*args)`` once under an ``OpCounter`` and a ``MemoryTracker``:
    the step's op counts, its live bytes and the seconds it took."""
    mem = op_analysis.MemoryTracker()
    counter = op_analysis.OpCounter(memory=mem)
    t0 = time.perf_counter()
    with _all_nonzero(), counter:
        out = fn(*args)
    seconds = time.perf_counter() - t0
    ins = op_analysis.storages(args)
    outs = op_analysis.storages(out)
    alias = sum(b for s, b in outs.items() if s in ins)
    out_bytes = sum(outs.values())
    args_bytes = sum(ins.values())
    temp = max(mem.peak - (out_bytes - alias), 0)
    return StepAnalysis(out, counter, mem, {
        "args": args_bytes, "out": out_bytes, "temp": temp, "alias": alias,
        "total_live": args_bytes + out_bytes + temp - alias}, seconds)


# ---------------------------------------------------------------------------
# The rank's share of its inputs
# ---------------------------------------------------------------------------


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _share(mesh, t, spec, dims, name, sharded, whole):
    """``t``'s rank-0 share: dims ``dims`` divided by the sizes of their
    mesh axes in ``spec``; the other sharded dims are run whole."""
    sizes = axes_of(mesh).shape
    shape = list(t.shape)
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes or d >= len(shape):
            continue
        if d in dims:
            shape[d] //= math.prod(sizes[a] for a in axes)
            sharded.setdefault(name, []).append([d, list(axes)])
        else:
            whole.setdefault(name, []).append([d, list(axes)])
    return torch.empty(shape, dtype=t.dtype, device=TRACE_DEVICE)


def _concrete_counter(state):
    """The abstract state with its round counter at 0 (the port's rounds
    read it as a Python int)."""
    if hasattr(state, "_fields"):
        kw = {f: _concrete_counter(getattr(state, f))
              for f in state._fields}
        if "k" in kw:
            kw["k"] = 0
        return type(state)(**kw)
    if isinstance(state, dict):
        return {f: 0 if f == "k" else _concrete_counter(v)
                for f, v in state.items()}
    return state


def _cfg_for(arch, shape_name, variant):
    cfg = arch.make(shape_name)
    for field in ("xent_chunks", "remat", "remat_policy", "n_layers"):
        if field in variant and hasattr(cfg, field):
            cfg = dataclasses.replace(cfg, **{field: variant[field]})
    if "attn_seq_shard" in variant and getattr(cfg, "attn", None):
        cfg = dataclasses.replace(cfg, attn=dataclasses.replace(
            cfg.attn, seq_shard_axis=variant["attn_seq_shard"]))
    return cfg


def _train_case(arch_id, arch, cfg, shape_name, mesh, recipe, variant,
                sharded, whole, layout):
    """Rank 0's train step and its inputs: the agent rows of the state
    and data; the rank's shard of every state leaf where the solver runs
    tensor-parallel (``solver.tp_layouts``: per-leaf LT-ADMM-CC,
    ``packed=false``).  Returns ``(n_agents, step, args, applied)``
    (``_params_case``)."""
    step_fn, _, _, solver = steps.build_train(
        arch, cfg, None, variant.get("solver", "ltadmm"), recipe,
        device=TRACE_DEVICE, mesh=mesh)
    n_agents = solver.graph.n_agents
    rows = solver.exchange.rows
    if len(rows) != n_agents:
        sharded["state"] = [[0, [agent_axis_for(mesh)]]]
    applied = NOT_APPLIED
    if getattr(solver, "tp_layouts", None) is not None:
        params, applied = _params_case(arch, cfg, mesh, "admm", sharded,
                                       whole, layout)
    else:
        params = abstract_params(steps.model_specs(arch, cfg), cfg.dtype)
    x_sds = tree_map(
        lambda t: torch.empty((len(rows),) + tuple(t.shape), dtype=t.dtype,
                              device=TRACE_DEVICE), params)
    state = _concrete_counter(solver.abstract_state(x_sds))
    data_sds = input_specs(arch_id, shape_name, n_agents=n_agents)
    data_ps = shd.train_data_pspec(
        mesh, {k: v.dim() for k, v in data_sds.items()})
    data = {k: _share(mesh, v, data_ps[k], (0, 1), k, sharded, whole)
            for k, v in data_sds.items()}
    return n_agents, step_fn, (state, data, 0), applied


NOT_APPLIED = {"tp_applied": False, "fsdp_applied": False}


def _params_case(arch, cfg, mesh, mode, sharded, whole, layout):
    """The rank's parameters (``meta``): its shard where tensor
    parallelism or FSDP runs (recorded per leaf), else the whole tree.
    Returns ``(params, applied)``: ``applied`` the record's
    ``"tp_applied"`` and ``"fsdp_applied"``."""
    specs = steps.model_specs(arch, cfg)
    params = abstract_params(specs, cfg.dtype)
    tp_on = steps.tp_serving(arch, cfg) and axes_of(mesh).shape.get(
        shd.TP_AXIS, 1) > 1
    plans = {}
    if arch.kind != "encdec":
        plans = dict_paths(shd.tp_plan(mesh, mode, specs, model=tp_on))
    cut_over = set()
    for name, ps in dict_paths(shd.param_pspec(mesh, mode, specs)).items():
        plan = plans.get(name)
        cuts = {}
        if plan is not None:
            if plan.dim is not None:
                cuts[plan.dim] = shd.TP_AXIS
            if plan.data_dim is not None:
                cuts[plan.data_dim] = shd.DATA_AXIS
        cut_over.update(cuts.values())
        for d, entry in enumerate(ps):
            axes = [a for a in _axes(entry) if cuts.get(d) != a]
            if axes:
                whole.setdefault(f"params.{name}", []).append([d, axes])
        for d in sorted(cuts):
            sharded.setdefault(f"params.{name}", []).append([d, [cuts[d]]])
        if plan and plan.differs:
            layout[f"params.{name}"] = (
                "held whole" if plan.dim is None else
                f"dim {plan.dim} by SSD head: pieces (length, cut) "
                f"{[list(x) for x in plan.segments]}")
    if cut_over:
        params = shd.shard_params(params, mesh, mode, specs, model=tp_on)
    return params, {"tp_applied": shd.TP_AXIS in cut_over,
                    "fsdp_applied": shd.DATA_AXIS in cut_over}


def _prefill_case(arch_id, arch, cfg, shape_name, mesh, mode, sharded,
                  whole, layout):
    prefill = steps.build_prefill(arch, cfg, mesh)
    params, applied = _params_case(arch, cfg, mesh, mode, sharded, whole,
                                   layout)
    data = {k: _share(mesh, v, shd.batch_pspec(mesh, tuple(v.shape)), (0,),
                      k, sharded, whole)
            for k, v in input_specs(arch_id, shape_name).items()}
    return prefill, (params, data), applied


def _decode_case(arch_id, arch, cfg, shape, mesh, mode, sharded, whole,
                 layout):
    serve, init_cache = steps.build_serve(arch, cfg, mesh)
    params, applied = _params_case(arch, cfg, mesh, mode, sharded, whole,
                                   layout)
    specs = input_specs(arch_id, shape.name)
    data = {}
    for k, v in specs.items():
        if v.dim():
            data[k] = _share(mesh, v, shd.batch_pspec(mesh, tuple(v.shape)),
                             (0,), k, sharded, whole)
    # the decoded position: the last of a full cache
    data["pos"] = shape.seq_len - 1
    with torch.no_grad():
        if arch.kind == "encdec":
            cache = init_cache(params, data.pop("memory"), shape.seq_len)
        else:
            cache = init_cache(data["token"].shape[0], shape.seq_len,
                               TRACE_DEVICE)
    # the reference's cache specs on the whole cache: the rank holds its
    # batch share (dim 0) and, under tensor parallelism, the heads it
    # computes; another dim they shard runs whole
    if applied["tp_applied"]:
        with torch.no_grad():
            ref_cache = steps.build_serve(arch, cfg)[1](
                data["token"].shape[0], shape.seq_len, TRACE_DEVICE)
    else:
        ref_cache = cache
    full = tree_map(lambda t: torch.empty(
        (shape.global_batch,) + tuple(t.shape[1:]), dtype=t.dtype,
        device=TRACE_DEVICE) if isinstance(t, torch.Tensor) and t.dim()
        else t, ref_cache)
    leaves = tree_flatten(shd.cache_pspec(mesh, full),
                          is_leaf=shd.is_pspec)[0]
    locals_ = tree_flatten(cache)[0]
    refs = tree_flatten(ref_cache)[0]
    for i, (spec, mine, ref) in enumerate(zip(leaves, locals_, refs)):
        if mine is None:
            continue
        cut = [d for d in range(1, mine.dim())
               if mine.shape[d] < ref.shape[d]]
        for d, entry in enumerate(spec or ()):
            if _axes(entry):
                (sharded if d == 0 or d in cut else whole).setdefault(
                    f"cache[{i}]", []).append([d, list(_axes(entry))])
        for d in cut:
            if shd.TP_AXIS not in _axes(spec[d]):
                sharded.setdefault(f"cache[{i}]", []).append(
                    [d, [shd.TP_AXIS]])
                layout[f"cache[{i}]"] = (
                    f"dim {d} cut over {shd.TP_AXIS!r} by SSD head; the "
                    f"spec gives the axis to dims "
                    f"{[j for j, e in enumerate(spec) if shd.TP_AXIS in _axes(e)]}")
    return serve, (params, cache, data), applied


def dryrun_one(arch_id, shape_name, multi_pod, recipe=None, verbose=True,
               variant=None):
    """One (arch x shape x mesh) record (module doc).  ``variant``: the
    perf-iteration overrides ``xent_chunks``, ``remat``,
    ``remat_policy``, ``n_layers`` (a depth cut), ``attn_seq_shard``,
    ``serve_mode`` (the prefill's and decode's ``param_pspec`` mode),
    ``recipe_*`` and ``solver``."""
    variant = variant or {}
    recipe = recipe or steps.TrainRecipe()
    rec_over = {k[7:]: v for k, v in variant.items()
                if k.startswith("recipe_")}
    if rec_over:
        recipe = dataclasses.replace(recipe, **rec_over)
    arch = ARCHS[arch_id]
    shape = SHAPES[shape_name]
    cfg = _cfg_for(arch, shape_name, variant)
    world_size = 512 if multi_pod else 256
    mode = variant.get("serve_mode", "serve")
    sharded, whole, layout = {}, {}, {}
    applied = NOT_APPLIED
    with fake_world(world_size):
        mesh = make_production_mesh(multi_pod=multi_pod)
        aaxis = agent_axis_for(mesh)
        n_agents = None
        t0 = time.time()
        if shape.kind == "train":
            n_agents, fn, args, applied = _train_case(
                arch_id, arch, cfg, shape_name, mesh, recipe, variant,
                sharded, whole, layout)
        elif shape.kind == "prefill":
            fn, args, applied = _prefill_case(
                arch_id, arch, cfg, shape_name, mesh, mode, sharded, whole,
                layout)
        else:
            fn, args, applied = _decode_case(
                arch_id, arch, cfg, shape, mesh, mode, sharded, whole,
                layout)
        with use_mesh(mesh):
            res = analyze_step(fn, args)
        t_trace = time.time() - t0
        mesh_name = "x".join(str(s) for s in axes_of(mesh).sizes)
        chips = math.prod(axes_of(mesh).sizes)
    stats = res.stats
    mf = model_flops(arch, cfg, shape, shape.kind, n_agents or 1, recipe)
    rec = {
        "arch": arch_id,
        "shape": shape_name,
        "mesh": mesh_name,
        "multi_pod": multi_pod,
        "agent_axis": aaxis if shape.kind == "train" else None,
        "n_agents": n_agents,
        "chips": chips,
        "compile_s": round(t_trace, 1),
        "bytes_per_device": res.bytes_per_device,
        "peak_by_op": res.memory.peak_by_op,
        "flop_counter_flops": res.counter.flop_counter_flops,
        "ops": stats.as_dict(),
        "kernels": dict(res.counter.kernels),
        "n_ops": res.counter.n_ops,
        "roofline": op_analysis.roofline_terms(stats),
        "model_flops_global": mf,
        "model_flops_per_chip": mf / chips,
        "useful_fraction": (mf / chips) / stats.dot_flops
        if stats.dot_flops else None,
        **applied,
        "sharded": sharded,
        "whole": whole,
        "tp_layout": layout,
        "variant": variant,
    }
    if verbose:
        print(json.dumps(rec, indent=1, default=str))
    return rec


def _run_combo(combo, verbose):
    """One combo in a worker: ``(record or None, failure or None)``."""
    a, s, mp = combo
    tag = f"{a} x {s} x {'2x16x16' if mp else '16x16'}"
    print(f"=== dryrun {tag}", flush=True)
    try:
        rec = dryrun_one(a, s, mp, verbose=verbose)
        print(f"--- {tag}: {rec['n_ops']} ops traced in {rec['compile_s']}"
              f" s", flush=True)
        return rec, None
    except Exception as e:  # noqa: BLE001
        traceback.print_exc()
        return None, {"combo": tag, "error": f"{type(e).__name__}: {e}"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    pods = {"single": [False], "multi": [True], "both": [False, True]}[
        args.multi_pod]
    archs = list(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    combos = [(a, s, mp) for a in archs for s in shapes for mp in pods]

    jobs = min(JOBS, os.cpu_count() or 1, len(combos))
    ctx = multiprocessing.get_context("spawn")
    with cf.ProcessPoolExecutor(jobs, mp_context=ctx,
                                max_tasks_per_child=1) as pool:
        results = list(pool.map(
            functools.partial(_run_combo, verbose=not args.all), combos))
    records = [r for r, _ in results if r is not None]
    failures = [f for _, f in results if f is not None]
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            for r in records:
                f.write(json.dumps(r, default=str) + "\n")
    print(f"\n{len(records)} ok, {len(failures)} failed")
    for f_ in failures:
        print("FAILED:", f_["combo"], "->", f_["error"])
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
