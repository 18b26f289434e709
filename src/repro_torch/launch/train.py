"""Distributed-training driver: any registered solver on a real model,
the counterpart of ``src/repro/launch/train.py``, flag for flag, plus
``--device`` (default: the card).

Runs LT-ADMM-CC (default) or any baseline of ``core.solver.SOLVERS`` end
to end: agents hold heterogeneous synthetic data shards, train locally,
and exchange (compressed) messages over the agent graph of
``--topology`` or the time-varying ``--topology-schedule``.  The agents
run in one process; the exchange is the host-simulated ``Exchange``.

    PYTHONPATH=src python -m repro_torch.launch.train --smoke \\
        --agents 4 --rounds 3 --telemetry --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --agents 4 \\
        --rounds 20 --solver choco:lr=0.02 --topology ring --device cpu

The weights come from ``init_params(key(seed + 1))`` in f32 and the data
from ``SyntheticLMDataset.sample(key(seed))``, the reference's draws;
round r runs under ``key(1000 + r)``.  A full (non-smoke) config trains
in f32: the reference draws f32 weights for a bf16 config, whose
activations its first block promotes to f32, and its ``lax.scan`` then
refuses the mixed carry (ROADMAP Queue 3).

Observability: ``--telemetry`` wraps the solver in the counter plane
(``repro_torch.obs.telemetry``) and prints the counters as one JSON line
at the end; ``--trace out.json`` writes wall-clock spans (build, each
chunk of rounds with a ``cold`` marker on the first, checkpoints,
watchdog rollbacks) as Chrome-trace JSONL (``python -m
repro_torch.obs.summary out.json``); ``--trace-profile DIR`` adds
``torch.profiler`` over the same window.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.common.trees import tree_flatten, tree_map
from repro_torch.configs import ARCHS
from repro_torch.core import jaxrand
from repro_torch.core.schedule import (SCHEDULES, TopologySchedule,
                                       build_graph, union_topology)
from repro_torch.core.solver import (SOLVERS, consensus_error, make_solver,
                                     solver_entry)
from repro_torch.core.topology import TOPOLOGIES
from repro_torch.data import SyntheticLMDataset
from repro_torch.device import resolve_device
from repro_torch.launch.steps import (DivergenceWatchdog, TrainRecipe,
                                      build_estimator, model_loss,
                                      model_specs)
from repro_torch.models.common import init_params, param_count
from repro_torch.obs import telemetry, trace


def train_config(arch, smoke: bool):
    """The config ``build`` trains: the smoke config, or the full one in
    f32 (see the module docstring)."""
    if smoke:
        return arch.make_smoke()
    return dataclasses.replace(arch.make(None), dtype=torch.float32)


def build(args, cfg=None):
    """``(arch, cfg, solver, loss)`` for the parsed ``args``; ``cfg``
    replaces the arch's config (``chip_smoke.py`` hands in a cut one)."""
    arch = ARCHS[args.arch]
    if cfg is None:
        cfg = train_config(arch, args.smoke)
    if arch.kind == "encdec" or getattr(cfg, "inputs_via_embeds", False):
        raise SystemExit(
            "train.py drives token-LM archs; embed/enc-dec archs are "
            "exercised via the tests")
    spec = args.topology_schedule or args.topology
    graph, ex = build_graph(spec, args.agents)
    comp_spec = (
        f"qbit:bits={args.bits}" if args.compressor == "qbit" else
        f"randk:fraction={args.fraction},sampler=block"
        if args.compressor == "randk" else args.compressor
    )
    recipe = TrainRecipe(
        tau=args.tau,
        gamma=args.gamma,
        beta=args.beta,
        batch_size=args.batch_size,
        compressor=comp_spec,
        topology=spec,
    )
    entry = solver_entry(args.solver)
    est = build_estimator(arch, cfg, recipe, entry.estimator)
    defaults = recipe.solver_defaults(entry.name)
    if args.faults:
        # every registered solver accepts a faults= param; spec params win
        defaults["faults"] = args.faults
    solver = make_solver(args.solver, graph, ex, est, defaults=defaults,
                         device=args.device)
    return arch, cfg, solver, model_loss(arch, cfg)


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--agents", type=int, default=4)
    ap.add_argument("--solver", default="ltadmm",
                    help=f"solver spec, one of {sorted(SOLVERS)} with "
                         "optional :k=v,... params (e.g. ltadmm:tau=8, "
                         "choco:lr=0.02); CLI hyperparameter flags are "
                         "defaults: spec params win")
    ap.add_argument("--topology", default="ring",
                    help=f"agent graph spec, one of {TOPOLOGIES} with "
                         "optional :k=v,... params (e.g. erdos:p=0.4,seed=1)")
    ap.add_argument("--topology-schedule", default=None,
                    help="time-varying graph spec, one of "
                         f"{SCHEDULES}, e.g. cycle:ring|star, "
                         "drop:p=0.2,base=complete, "
                         "gossip:edges=2,base=ring; overrides --topology")
    ap.add_argument("--m-local", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--tau", type=int, default=3)
    ap.add_argument("--gamma", type=float, default=0.05)
    ap.add_argument("--beta", type=float, default=0.005)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--compressor", default="qbit",
                    choices=["qbit", "randk", "topk", "identity"])
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument("--fraction", type=float, default=0.25)
    ap.add_argument("--heterogeneity", type=float, default=0.7)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--faults", default=None,
                    help="fault-injection spec, e.g. "
                         "faults:drop=0.05,corrupt=1e-3,crash=0.01,seed=0: "
                         "seeded message drops, payload bit flips, stale "
                         "rounds and crash-restarts at the exchange "
                         "(a spec's faults= param wins)")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="with --checkpoint PATH: every N rounds also "
                         "write the FULL solver state to PATH.state "
                         "(atomic; resumable via --resume PATH.state)")
    ap.add_argument("--resume", default=None,
                    help="checkpoint dir written by --checkpoint-every; "
                         "continues from the saved round")
    ap.add_argument("--watchdog-blowup", type=float, default=1e4,
                    help="divergence watchdog: roll back to the last-good "
                         "state when mean loss is NaN/Inf or exceeds "
                         "blowup x the best seen (0 disables)")
    ap.add_argument("--log-every", type=int, default=1,
                    help="rounds per chunk (one metrics evaluation and "
                         "log line per chunk; raise for speed)")
    ap.add_argument("--telemetry", action="store_true",
                    help="accumulate counters (wire bytes, messages, "
                         "fault rejects, participation, grad evals) beside "
                         "the solver state; printed as one JSON line at the "
                         "end; trajectories unchanged")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write wall-clock spans (build, chunks, "
                         "checkpoints, rollbacks) as Chrome-trace JSONL; "
                         "summarize with python -m repro_torch.obs.summary "
                         "PATH")
    ap.add_argument("--trace-profile", default=None, metavar="DIR",
                    help="with --trace: also capture a torch.profiler "
                         "trace into DIR over the run")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap


def parse_args(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    if args.checkpoint_every and not args.checkpoint:
        ap.error("--checkpoint-every requires --checkpoint PATH")
    if args.trace_profile and not args.trace:
        ap.error("--trace-profile requires --trace PATH")
    return args


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0])


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def mean_loss(solver, loss, state, tokens) -> float:
    """Each agent's mean loss over its own m_local sequences at the
    consensus mean x̄, averaged over the agents (the reference's vmap)."""
    x = solver.consensus_params(state)
    pbar = tree_map(lambda t: torch.mean(t, dim=0), x)
    with torch.no_grad():
        ls = torch.stack([loss(pbar, {"tokens": tokens[a]})
                          for a in range(tokens.shape[0])])
    return float(torch.mean(ls))


def run(args, cfg=None):
    """Train as ``args`` (from ``parse_args``) say; ``cfg`` replaces the
    arch's config.  Prints the reference's header, one JSON line per
    logged round and the telemetry line; returns ``{"params", "wire",
    "ddp", "rounds": [per logged round dict], "telemetry", "state",
    "solver"}``."""
    dev = resolve_device(args.device)
    tracer = (trace.Tracer(args.trace, args.trace_profile)
              if args.trace else trace.NULL)
    with tracer.span("build", arch=args.arch, solver=args.solver):
        arch, cfg, solver, loss = build(args, cfg)
    if args.telemetry:
        solver = telemetry.with_telemetry(solver)
    ds = SyntheticLMDataset(
        vocab=cfg.vocab, seq_len=args.seq_len, n_agents=args.agents,
        m_local=args.m_local, heterogeneity=args.heterogeneity,
    )
    data = {"tokens": ds.sample(jaxrand.key(args.seed)).to(dev)}

    specs = model_specs(arch, cfg)
    params0 = init_params(jaxrand.key(args.seed + 1, dev), specs)
    n_params = param_count(specs)
    print(f"# arch={cfg.name} params={n_params:,} "
          f"agents={args.agents} solver={args.solver} "
          f"topology={args.topology_schedule or args.topology}")
    # wire accounting: for a time-varying schedule only the links active
    # in a round carry payloads: the exact round-0 cost beside the
    # period mean.  DDP equivalent: one LT-ADMM round covers tau local
    # steps (tau f32 all-reduces); one baseline iteration covers one
    tau = getattr(getattr(solver, "cfg", None), "tau", 1)
    ddp = 2 * tau * _nbytes(params0)
    wire = solver.wire_bytes(params0)
    if isinstance(solver.graph, TopologySchedule):
        print(f"# wire bytes/agent/round: "
              f"{solver.wire_bytes(params0, t=0):,} at round 0, "
              f"{wire:,} period-mean (f32 DDP equivalent: {ddp:,})")
    else:
        print(f"# wire bytes/agent/round: {wire:,} "
              f"(f32 DDP equivalent: {ddp:,})")
    if hasattr(solver, "degree_cap"):
        # learned-graph solver: the candidate topology only bounds the
        # support; at most degree_cap edges per agent ever carry bytes
        cand = int(np.max(union_topology(solver.graph).degrees()))
        print(f"# learned graph: degree_cap={solver.degree_cap} live "
              f"edges/agent (candidate degree {cand}), graph round every "
              f"{solver.graph_every} rounds")

    x0 = tree_map(lambda t: t[None].expand((args.agents,) + t.shape)
                  .clone(), params0)
    del params0
    state = solver.init(x0)
    del x0
    done = 0
    if args.resume:
        # all persistent solver state lives in the state tree and round
        # keys are pure functions of the round index, so restoring the
        # tree and the round counter continues the interrupted run
        state, manifest = load_checkpoint(args.resume, like_tree=state)
        done = int(manifest["step"])
        print(f"# resumed from {args.resume} at round {done}")

    watchdog = (DivergenceWatchdog(blowup=args.watchdog_blowup)
                if args.watchdog_blowup > 0 else None)
    out = {"params": n_params, "wire": wire, "ddp": ddp, "rounds": [],
           "telemetry": None}
    t_start = time.time()
    cold = True
    try:
        while done < args.rounds:
            n = min(args.log_every, args.rounds - done)
            with tracer.span("chunk", first_round=done, rounds=n,
                             cold=cold):
                for r in range(done, done + n):
                    state = solver.step(state, data,
                                        jaxrand.key(1000 + r))
                if tracer is not trace.NULL:
                    _sync(dev)
            cold = False
            done += n
            ml = mean_loss(solver, loss, state, data["tokens"])
            if watchdog is not None:
                state, rolled_back = watchdog.observe(state, ml)
                if rolled_back:
                    # skip ahead: restore the last-good state but keep
                    # advancing rounds (rewinding would replay the same
                    # divergence)
                    tracer.instant("watchdog-rollback", round=done - 1,
                                   mean_loss=ml)
                    print(json.dumps({
                        "round": done - 1, "watchdog": "rollback",
                        "mean_loss": ml, "rollbacks": watchdog.rollbacks,
                    }))
                    continue
            line = {
                "round": done - 1,
                "mean_loss": round(ml, 4),
                "consensus_err": float(
                    consensus_error(solver.consensus_params(state))),
                "wall_s": round(time.time() - t_start, 1),
            }
            out["rounds"].append(dict(line, mean_loss_full=ml))
            print(json.dumps(line))
            if (args.checkpoint_every and done < args.rounds
                    and done % args.checkpoint_every == 0):
                with tracer.span("checkpoint", round=done):
                    save_checkpoint(
                        args.checkpoint + ".state", state, step=done,
                        extra={"arch": args.arch, "smoke": args.smoke,
                               "solver": args.solver})
        if args.telemetry:
            tel = {k: np.asarray(v).tolist()
                   for k, v in telemetry.counters(state).items()}
            out["telemetry"] = tel
            print(json.dumps({"telemetry": tel}))
        if args.checkpoint:
            x = solver.consensus_params(state)
            pbar = tree_map(lambda t: torch.mean(t, dim=0), x)
            with tracer.span("checkpoint", round=args.rounds):
                save_checkpoint(
                    args.checkpoint, pbar, step=args.rounds,
                    extra={"arch": args.arch, "smoke": args.smoke,
                           "solver": args.solver})
            print(f"# checkpoint written to {args.checkpoint}")
    finally:
        tracer.close()
    out.update(state=state, solver=solver)
    return out


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
