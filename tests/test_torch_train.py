"""The port's training half (``models.transformer.loss_fn``,
``optim.optimizers``, ``data.pipeline``, ``launch.steps``
``build_estimator`` / ``build_train`` / ``build_ddp_train``,
``launch.train``) against the reference, on the CPU in f32 at small
sizes (B = 2, T = 16, m_local 4):

* ``loss_fn`` and every gradient leaf, on the reference's smoke weights
  carried across as numpy, for the eight trainable smoke archs (granite's
  and deepseek's with their MoE aux loss) and pixtral's embeds branch:
  the loss within 1e-5 relative of the reference's (measured <1e-7),
  each leaf within 1e-4 of ``jax.grad``'s relative to the leaf's largest
  |g| (measured <1e-5).  xlstm-125m's sLSTM recurrence amplifies f32
  rounding in both packages (ROADMAP Queue 3: at these weights its
  gradients grow ~1.55x a step backwards through time, 1e10 at T = 64),
  so at T = 16 (|g| up to ~600) the two packages' gradients sit ~5e-3
  of a leaf's largest |g| apart, each as far from the port's f64
  gradients: the reference's are held within 2e-2 of those (measured
  5.8e-3) and the port's within 4x the reference's distance (0.74x);
  the streamed cross entropy (``xent_chunks``) against the
  reference's and against ``softmax_xent`` (measured ~1e-7); remat (full
  and dots) leaving the loss and every gradient bit for bit unchanged;
* ``sgd`` (with and without momentum), ``adam`` and ``adamw`` over 3
  updates within 1e-6 relative (measured 0: Adam's f32 ``b ** t`` is
  XLA's bit for bit on this CPU for t < 2000);
* ``SyntheticLMDataset`` tokens bit-equal;
* the SVRG anchor's microbatched full gradient, one LT-ADMM round with
  ``compressor=identity`` (every state plane within 1e-5 of its largest
  |value|; measured ~1e-7) and 3 DDP Adam steps (the loss within 1e-5
  relative every step, measured 1e-7; params within 1e-5 of each
  leaf's largest |value|, and within 1e-4 where a step's gradient is
  below 1e-5 of its leaf's largest |g|: see the test);
* ``launch/train.py`` on the reference's argv beside the port's:
  the header and telemetry lines equal, ``mean_loss`` within 1e-4 and
  ``consensus_err`` within 1e-3 relative every round (measured ~1e-7
  and ~1e-5), for LT-ADMM-CC qbit8 and CHOCO; deepseek-v2-lite-16b's
  smoke run against the reference's printed numbers, and xlstm-125m's
  at the defaults refused by the watchdog as the reference's is;
  ``train_lm_admm`` handing ``launch/train`` the reference example's
  argv (``--full-100m`` too); the consensus checkpoint
  the port writes loads in the reference's ``load_checkpoint`` with the
  reference's leaf paths, within 1e-5 of its values; ``--resume`` from
  a ``--checkpoint-every 1`` state continues bit for bit;
* K5's row groups (``quantize.ops.row_groups``) with the limit lowered,
  and the plain versions' column windows equal to whole rows.
"""
import argparse
import dataclasses
import functools
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import load_checkpoint as jload  # noqa: E402
from repro.configs.archs import ARCHS as JARCHS  # noqa: E402
from repro.data import SyntheticLMDataset as JDataset  # noqa: E402
from repro.data import partition_for_agents as jpartition  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.models.common import init_params as jinit  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.checkpoint.reference import (  # noqa: E402
    params_tree_from_reference,
)
from repro_torch.common.trees import tree_flatten, tree_map  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core import jaxrand  # noqa: E402
from repro_torch.data import SyntheticLMDataset  # noqa: E402
from repro_torch.data import partition_for_agents  # noqa: E402
from repro_torch.kernels.quantize import ops as q_ops  # noqa: E402
from repro_torch.kernels.quantize import ref as q_ref  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402

# see tests/test_torch_ssd.py: torch 2.13.0+cpu's first exp of a process
torch.exp(torch.linspace(-20.0, 20.0, 50_000))

TRAINABLE = ["command-r-plus-104b", "deepseek-v2-lite-16b",
             "granite-moe-1b-a400m", "olmo-1b", "qwen2-1.5b", "qwen3-0.6b",
             "xlstm-125m", "zamba2-2.7b"]
B, T = 2, 16
ARGV = ["--smoke", "--agents", "4", "--rounds", "3", "--seq-len", "16",
        "--m-local", "4", "--telemetry"]


@functools.lru_cache(maxsize=None)
def _reference(arch_id):
    """The reference's smoke weights (jax tree, numpy tree)."""
    cfg = JARCHS[arch_id].make_smoke()
    params = jinit(jax.random.key(0), jtr.model_specs(cfg))
    return params, jax.tree.map(np.asarray, params)


def _batch(cfg, seed=5):
    rng = np.random.default_rng(seed)
    if cfg.inputs_via_embeds:
        return {"embeds": rng.standard_normal((B, T, cfg.d_model),
                                              dtype=np.float32),
                "labels": rng.integers(0, cfg.vocab, (B, T)).astype(
                    np.int32)}
    return {"tokens": rng.integers(0, cfg.vocab, (B, T + 1)).astype(
        np.int32)}


def _port_value_and_grad(cfg, np_tree, batch, arch_id="qwen3-0.6b"):
    loss = steps.model_loss(ARCHS[arch_id], cfg)
    return steps.value_and_grad(
        loss, params_tree_from_reference(np_tree, "cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()})


def _ref_value_and_grad(jcfg, jparams, batch):
    fn = jax.jit(jax.value_and_grad(lambda p, b: jtr.loss_fn(p, jcfg, b)))
    return fn(jparams, {k: jnp.asarray(v) for k, v in batch.items()})


def _assert_grads(got, want, rel=1e-4):
    got, want = tree_flatten(got)[0], jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g.numpy() - w).max()) <= rel * scale


def _leaf_drift(got, exact):
    """The largest |got - exact| of any leaf, relative to the leaf's
    largest |exact|."""
    return max(float(np.abs(np.asarray(g) - x).max())
               / max(float(np.abs(x).max()), 1e-30)
               for g, x in zip(got, exact))


@pytest.mark.parametrize("arch_id", TRAINABLE + ["pixtral-12b"])
def test_loss_and_grads_match_reference(arch_id):
    jparams, np_tree = _reference(arch_id)
    jcfg, cfg = JARCHS[arch_id].make_smoke(), ARCHS[arch_id].make_smoke()
    batch = _batch(cfg)
    want_l, want_g = _ref_value_and_grad(jcfg, jparams, batch)
    got_l, got_g = _port_value_and_grad(cfg, np_tree, batch, arch_id)
    assert abs(float(got_l) - float(want_l)) <= 1e-5 * abs(float(want_l))
    if arch_id != "xlstm-125m":
        _assert_grads(got_g, want_g)
        return
    # the sLSTM recurrence: both packages against the port's f64 gradients
    _, exact = _port_value_and_grad(
        dataclasses.replace(cfg, dtype=torch.float64),
        jax.tree.map(lambda a: a.astype(np.float64), np_tree), batch,
        arch_id)
    exact = [x.numpy() for x in tree_flatten(exact)[0]]
    got = [g.numpy() for g in tree_flatten(got_g)[0]]
    want = jax.tree.leaves(want_g)
    assert [g.shape for g in got] == [np.shape(w) for w in want]
    ref_drift = _leaf_drift(want, exact)
    assert ref_drift <= 2e-2
    assert _leaf_drift(got, exact) <= 4 * ref_drift, ref_drift


def test_granite_loss_carries_the_moe_aux():
    _, np_tree = _reference("granite-moe-1b-a400m")
    cfg = ARCHS["granite-moe-1b-a400m"].make_smoke()
    tokens = torch.from_numpy(_batch(cfg)["tokens"])
    params = params_tree_from_reference(np_tree, "cpu")
    logits, aux = tr.forward(params, cfg, tokens=tokens[:, :-1])
    assert aux.dtype == torch.float32 and float(aux) > 0
    loss = steps.model_loss(ARCHS["granite-moe-1b-a400m"], cfg)(
        params, {"tokens": tokens})
    xent = float(loss) - float(aux)
    assert abs(xent - float(tr.softmax_xent(
        logits, tokens[:, 1:]))) <= 1e-6 * abs(xent)


def test_streamed_xent_matches_reference_and_softmax_xent():
    jparams, np_tree = _reference("qwen3-0.6b")
    jcfg = dataclasses.replace(JARCHS["qwen3-0.6b"].make_smoke(),
                               xent_chunks=4)
    cfg = dataclasses.replace(ARCHS["qwen3-0.6b"].make_smoke(),
                              xent_chunks=4)
    batch = _batch(cfg)
    want_l, want_g = _ref_value_and_grad(jcfg, jparams, batch)
    got_l, got_g = _port_value_and_grad(cfg, np_tree, batch)
    plain_l, plain_g = _port_value_and_grad(
        dataclasses.replace(cfg, xent_chunks=0), np_tree, batch)
    assert abs(float(got_l) - float(want_l)) <= 1e-5 * abs(float(want_l))
    assert abs(float(got_l) - float(plain_l)) <= 1e-5 * abs(float(plain_l))
    _assert_grads(got_g, want_g)
    _assert_grads(got_g, tree_map(lambda t: t.numpy(), plain_g))


@pytest.mark.parametrize("arch_id", ["qwen3-0.6b", "zamba2-2.7b"])
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_changes_no_value(arch_id, policy):
    _, np_tree = _reference(arch_id)
    cfg = ARCHS[arch_id].make_smoke()
    assert not cfg.remat  # the smoke configs, as the reference's
    batch = _batch(cfg)
    plain_l, plain_g = _port_value_and_grad(cfg, np_tree, batch, arch_id)
    got_l, got_g = _port_value_and_grad(
        dataclasses.replace(cfg, remat=True, remat_policy=policy), np_tree,
        batch, arch_id)
    assert torch.equal(got_l, plain_l)
    for g, w in zip(tree_flatten(got_g)[0], tree_flatten(plain_g)[0]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name,args", [("sgd", (0.1,)), ("sgd", (0.1, 0.9)),
                                       ("adam", (1e-3,)),
                                       ("adamw", (1e-3,))])
def test_optimizers_match_reference(name, args):
    rng = np.random.default_rng(0)
    p = {"a": rng.standard_normal((5, 7)).astype(np.float32),
         "b": {"c": rng.standard_normal(11).astype(np.float32)}}
    grads = [jax.tree.map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), p)
        for _ in range(3)]
    jo, to = getattr(jopt, name)(*args), getattr(optimizers, name)(*args)
    jp = jax.tree.map(jnp.asarray, p)
    tp = tree_map(lambda a: torch.from_numpy(a.copy()), p)
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        u, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = jopt.apply_updates(jp, u)
        u, ts = to.update(tree_map(torch.from_numpy, g), ts, tp)
        tp = optimizers.apply_updates(tp, u)
    for g, w in zip(tree_flatten(tp)[0], jax.tree.leaves(jp)):
        w = np.asarray(w)
        assert g.dtype == torch.float32
        assert float(np.abs(g.numpy() - w).max()) <= 1e-6 * np.abs(w).max()
    if name.startswith("adam"):
        assert int(ts["t"]) == int(js["t"]) == 3
        assert ts["t"].dtype == torch.int32


@pytest.mark.parametrize("dims", [(512, 16, 4, 4, 0.7), (151936, 8, 3, 5,
                                                         0.5)])
def test_synthetic_tokens_bit_equal(dims):
    want = np.asarray(JDataset(*dims).sample(jax.random.key(3)))
    got = SyntheticLMDataset(*dims).sample(jaxrand.key(3))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    for w, g in zip(JDataset(*dims).batches(jax.random.key(1), 2),
                    SyntheticLMDataset(*dims).batches(jaxrand.key(1), 2)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    flat = np.arange(7 * 3).reshape(7, 3)
    np.testing.assert_array_equal(
        partition_for_agents(torch.from_numpy(flat), 3).numpy(),
        np.asarray(jpartition(jnp.asarray(flat), 3)))


def _agent_data(cfg, n_agents=2, m=4):
    return np.asarray(JDataset(cfg.vocab, T, n_agents, m, 0.7).sample(
        jax.random.key(0)))


def test_anchor_microbatches_match_reference():
    """The SVRG anchor's full gradient in 2 microbatches (the mean of the
    chunk means) against the reference's ``lax.map`` for each agent."""
    arch_id = "qwen3-0.6b"
    jparams, np_tree = _reference(arch_id)
    jcfg, cfg = JARCHS[arch_id].make_smoke(), ARCHS[arch_id].make_smoke()
    tokens = _agent_data(cfg)
    jrec = jsteps.TrainRecipe(anchor_microbatches=2)
    jest = jsteps.build_estimator(JARCHS[arch_id], jcfg, jrec, "vr")
    est = steps.build_estimator(ARCHS[arch_id], cfg,
                                steps.TrainRecipe(anchor_microbatches=2),
                                "vr")
    stacked = tree_map(lambda t: torch.stack([t, 2 * t]),
                       params_tree_from_reference(np_tree, "cpu"))
    got = est.full_grad(stacked, {"tokens": torch.from_numpy(tokens)})
    jfull = jax.jit(jest.full_grad)
    for a in range(2):
        jp = jax.tree.map(lambda x, s=a + 1: x * s, jparams)
        want = jfull(jp, {"tokens": jnp.asarray(tokens[a])})
        _assert_grads(tree_map(lambda t, a=a: t[a], got), want)


def _args(argv):
    return train.parse_args(argv + ["--device", "cpu"])


def _state_leaves(state):
    from repro_torch.common.trees import tree_children

    out = {}

    def walk(node, path):
        kids = tree_children(node)
        if kids is None:
            if isinstance(node, (torch.Tensor, np.ndarray, jax.Array)):
                out["/".join(path)] = np.asarray(node)
            return
        for name, child in kids:
            walk(child, path + (name.lstrip("."),))

    walk(state, ())
    return out


def test_one_identity_round_matches_reference():
    argv = ARGV[:-1] + ["--compressor", "identity"]
    args = _args(argv)
    jarch, jcfg, jsolver, _ = jtrain.build(args)
    tokens = JDataset(jcfg.vocab, T, 4, 4, 0.7).sample(jax.random.key(0))
    jp0 = jinit(jax.random.key(1), jtr.model_specs(jcfg))
    jx0 = jax.tree.map(lambda t: jnp.broadcast_to(t[None], (4,) + t.shape),
                       jp0)
    want = jax.jit(jsolver.step)(jsolver.init(jx0), {"tokens": tokens},
                                 jax.random.key(1000))
    arch, cfg = ARCHS["qwen3-0.6b"], ARCHS["qwen3-0.6b"].make_smoke()
    recipe = steps.TrainRecipe(tau=args.tau, gamma=args.gamma,
                               beta=args.beta, batch_size=args.batch_size,
                               compressor="identity")
    step_fn, init_fn, _ = steps.build_train(arch, cfg, 4, "ltadmm", recipe,
                                            device="cpu")
    x0 = tree_map(lambda t: torch.from_numpy(np.asarray(
        jnp.broadcast_to(t[None], (4,) + t.shape))), jp0)
    got = step_fn(init_fn(x0), {"tokens": torch.from_numpy(
        np.asarray(tokens))}, 1000)
    gw, ww = _state_leaves(got), _state_leaves(want)
    assert sorted(gw) == sorted(k for k in ww if k != "k")
    for k, w in ww.items():
        if k == "k":
            continue
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(gw[k] - w).max()) <= 1e-5 * scale, k


def _ref_main(argv, capsys):
    old = sys.argv
    sys.argv = ["train.py"] + argv
    try:
        jtrain.main()
    finally:
        sys.argv = old
    return capsys.readouterr().out.splitlines()


def _rounds(lines):
    return [json.loads(ln) for ln in lines if ln.startswith('{"round"')]


def _header(lines):
    return [ln for ln in lines if ln.startswith("# ") and "written" not in ln]


@pytest.mark.parametrize("solver", ["ltadmm", "choco:lr=0.02"])
def test_train_main_matches_reference(solver, tmp_path, capsys):
    argv = ARGV + ["--solver", solver, "--checkpoint",
                   str(tmp_path / "ck")]
    want = _ref_main(argv, capsys)
    ref_ck = jload(tmp_path / "ck")
    got_out = train.main(argv + ["--checkpoint", str(tmp_path / "port"),
                                 "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert _header(got) == _header(want)
    tel = [ln for ln in want if ln.startswith('{"telemetry"')]
    assert tel and [ln for ln in got if ln.startswith('{"telemetry"')] == tel
    wr, gr = _rounds(want), _rounds(got)
    assert [r["round"] for r in gr] == [r["round"] for r in wr] == [0, 1, 2]
    for w, g, full in zip(wr, gr, got_out["rounds"]):
        assert abs(full["mean_loss_full"] - w["mean_loss"]) <= 1e-4
        assert abs(g["consensus_err"] - w["consensus_err"]) <= (
            1e-3 * w["consensus_err"])
    # the consensus model in the reference's checkpoint format
    got_ck, manifest = jload(tmp_path / "port")
    assert manifest["step"] == 3 and sorted(got_ck) == sorted(ref_ck[0])
    for k, w in ref_ck[0].items():
        assert got_ck[k].shape == w.shape and got_ck[k].dtype == w.dtype
        assert np.abs(got_ck[k] - w).max() <= 1e-5 * max(
            np.abs(w).max(), 1e-30), k


# the reference's launch/train.py at ARGV + --arch deepseek-v2-lite-16b on
# the CPU (jax 0.9.0): its header, telemetry and rounds
DEEPSEEK_REFERENCE = {
    "header": ["# arch=deepseek-smoke params=347,328 agents=4 solver=ltadmm "
               "topology=ring",
               "# wire bytes/agent/round: 1,389,328 (f32 DDP equivalent: "
               "8,335,872)"],
    "telemetry": {"tx_bytes": 4_167_984, "tx_msgs": 12, "grad_evals": 48,
                  "participations": 3},
    "mean_loss": (6.1569, 6.0641, 6.0349),
    "consensus_err": (0.7044211626052856, 1.1338051557540894,
                      1.8120474815368652),
}


@pytest.fixture
def one_thread():
    """One intra-op thread for a run of many tiny ops: more gain nothing
    alone (measured ~5 s either way), and beside the suite's other
    workers their spinning pools slowed such a run 40-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_deepseek_smoke_run_matches_reference(capsys, one_thread):
    """The MLA + MoE model with its leading dense layer through
    LT-ADMM-CC qbit8: the reference's integers, mean_loss within 1e-4 and
    consensus_err within 1e-3 relative every round (measured 2e-6)."""
    ref = DEEPSEEK_REFERENCE
    out = train.main(ARGV + ["--arch", "deepseek-v2-lite-16b", "--device",
                             "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert _header(lines) == ref["header"]
    assert (out["params"], out["wire"], out["ddp"]) == (347_328, 1_389_328,
                                                        8_335_872)
    for key, per in ref["telemetry"].items():
        assert out["telemetry"][key] == [per] * 4, key
    rounds = _rounds(lines)
    assert [r["round"] for r in rounds] == [0, 1, 2]
    for r, full, loss, cerr in zip(rounds, out["rounds"], ref["mean_loss"],
                                   ref["consensus_err"]):
        assert abs(full["mean_loss_full"] - loss) <= 1e-4
        assert abs(r["consensus_err"] - cerr) <= 1e-3 * cerr


def test_xlstm_smoke_run_diverges_as_the_reference_does(capsys,
                                                         one_thread):
    """At launch/train.py's defaults the xLSTM smoke model's gradients at
    x0 overflow a gamma-0.05 step (the sLSTM recurrence, ROADMAP Queue
    3): the reference's watchdog refuses round 0, and so does the
    port's, after the reference's header."""
    with pytest.raises(RuntimeError, match=r"divergence \(metric=nan\) "
                       "before any healthy snapshot"):
        train.main(["--arch", "xlstm-125m", "--smoke", "--agents", "4",
                    "--rounds", "3", "--telemetry", "--device", "cpu"])
    assert _header(capsys.readouterr().out.splitlines()) == [
        "# arch=xlstm-smoke params=658,308 agents=4 solver=ltadmm "
        "topology=ring",
        "# wire bytes/agent/round: 2,633,248 (f32 DDP equivalent: "
        "15,799,392)"]


def test_resume_continues_bit_for_bit(tmp_path, capsys):
    argv = ARGV[:-1] + ["--checkpoint", str(tmp_path / "ck"),
                        "--checkpoint-every", "1"]
    whole = train.main(argv + ["--device", "cpu"])
    first = _rounds(capsys.readouterr().out.splitlines())
    assert (tmp_path / "ck.state" / "manifest.json").exists()
    resumed = train.main(argv + ["--resume", str(tmp_path / "ck.state"),
                                 "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert "# resumed from" in "\n".join(out) and "at round 2" in "\n".join(
        out)
    again = _rounds(out)
    assert [r["round"] for r in again] == [2]
    assert again[0]["mean_loss"] == first[2]["mean_loss"]
    assert again[0]["consensus_err"] == first[2]["consensus_err"]
    a, b = _state_leaves(whole["state"]), _state_leaves(resumed["state"])
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_ddp_adam_steps_match_reference():
    """3 DDP Adam steps: the loss within 1e-5 relative every step, and
    every param element within 1e-5 of its leaf's largest |value|, save
    those whose gradient, at some step, is below 1e-5 of its leaf's
    largest |g|.  Adam's step ``m / sqrt(v)`` does not depend on the
    gradient's scale, so for such an element the rounding of its few
    significant bits (the two packages sum in different orders) moves
    the step as much as a large gradient's value does: these are held
    at 1e-4 and must stay under 1 % of the elements (measured: 613 of
    361,216; the largest difference 3.8e-5, where the gradient was
    1.5e-6 of its leaf's largest; every other element within 2.9e-6)."""
    arch_id = "qwen3-0.6b"
    jparams, np_tree = _reference(arch_id)
    jcfg, cfg = JARCHS[arch_id].make_smoke(), ARCHS[arch_id].make_smoke()
    batch = _batch(cfg)
    jstep, _, jo = jsteps.build_ddp_train(JARCHS[arch_id], jcfg,
                                          make_host_mesh(), lr=1e-3)
    jstep = jax.jit(jstep)
    jgrad = jax.jit(jax.grad(lambda p, b: jtr.loss_fn(p, jcfg, b)))
    step_fn, opt = steps.build_ddp_train(ARCHS[arch_id], cfg, lr=1e-3)
    jp, js = jparams, jo.init(jparams)
    tp = params_tree_from_reference(np_tree, "cpu")
    ts = opt.init(tp)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    losses, small = [], None
    for i in range(3):
        g = [np.abs(np.asarray(x)) for x in jax.tree.leaves(jgrad(jp, jb))]
        g = [x < 1e-5 * max(float(x.max()), 1e-30) for x in g]
        small = g if small is None else [a | b for a, b in zip(small, g)]
        jp, js, jl = jstep(jp, js, jb, i)
        tp, ts, tl = step_fn(tp, ts, tb, i)
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
        losses.append(float(tl))
    assert losses[-1] < losses[0]
    got, want = tree_flatten(tp)[0], jax.tree.leaves(jp)
    assert len(got) == len(want) == len(small)
    n_small = n_all = 0
    for g, w, sm in zip(got, want, small):
        w = np.asarray(w)
        d = np.abs(g.numpy() - w) / max(float(np.abs(w).max()), 1e-30)
        assert float(d[~sm].max(initial=0.0)) <= 1e-5
        assert float(d[sm].max(initial=0.0)) <= 1e-4
        n_small, n_all = n_small + int(sm.sum()), n_all + w.size
    assert n_small <= 1e-2 * n_all, (n_small, n_all)


def test_full_config_trains_in_f32_and_refusals():
    cfg = train.train_config(ARCHS["qwen3-0.6b"], smoke=False)
    assert cfg.dtype == torch.float32 and cfg.d_model == 1024
    cfg = train.train_config(ARCHS["xlstm-125m"], smoke=False)
    assert cfg.dtype == torch.float32 and cfg.n_layers == 12
    with pytest.raises(SystemExit, match="token-LM"):
        train.run(_args(["--arch", "pixtral-12b", "--smoke"]))


@pytest.mark.parametrize("full", [False, True])
def test_train_lm_admm_hands_train_the_examples_argv(full, monkeypatch):
    """``train_lm_admm.main`` hands ``launch/train`` the argv of the
    reference's ``examples/train_lm_admm.py`` (its subprocess command
    caught, nothing run), the checkpoint under this machine's temporary
    directory and ``--device`` added."""
    import importlib.util
    import subprocess

    from repro_torch import train_lm_admm

    spec = importlib.util.spec_from_file_location(
        "ref_train_lm_admm",
        Path(__file__).resolve().parents[1] / "examples" / "train_lm_admm.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    flags = ["--rounds", "7"] + (["--full-100m"] if full else [])
    seen = {}
    monkeypatch.setattr(subprocess, "call",
                        lambda cmd, env=None: seen.setdefault("ref", cmd) and 0)
    monkeypatch.setattr(sys, "argv", ["train_lm_admm.py"] + flags)
    with pytest.raises(SystemExit):
        example.main()
    monkeypatch.setattr(train, "main", lambda argv: seen.setdefault(
        "port", argv))
    train_lm_admm.main(flags + ["--device", "cpu"])
    want = seen["ref"][3:]
    assert seen["ref"][1:3] == ["-m", "repro.launch.train"]
    ck = want.index("--checkpoint") + 1
    want[ck] = str(Path(tempfile.gettempdir()) / "ltadmm_lm_ckpt")
    assert seen["port"] == want + ["--device", "cpu"]
    assert ("xlstm-125m" in want) == full and ("--smoke" in want) != full


def test_dequantize_row_groups():
    """K5's row groups, with the kernel's limit lowered: every group stays
    below it, the groups cover the rows in order, and the plain version
    run group by group into one output (as the wrapper launches) equals
    one call over all rows, bit for bit."""
    src = (Path(q_ops.__file__).resolve().parents[2] / "csrc"
           / "quantize_leaf.cu").read_text()
    assert ("((1LL << 32) - 8LL * kDqQuads * kDqThreads) / 2" in src
            and q_ops.DQ_MOST_ELEMENTS == 2 ** 31 - 2 ** 11)
    assert q_ops.row_groups(12, 187_045_376) == [slice(0, 11),
                                                 slice(11, 12)]
    assert q_ops.row_groups(8, 187_045_376) == [slice(0, 8)]
    g = torch.Generator().manual_seed(1)
    for m, n, most in ((12, 1000, 5000), (7, 33, 100), (3, 10, 31),
                       (5, 9, 10)):
        groups = q_ops.row_groups(m, n, most)
        assert [(s.start, s.stop) for s in groups] == [
            (r, min(m, r + (most - 1) // n))
            for r in range(0, m, (most - 1) // n)]
        assert all((s.stop - s.start) * n < most for s in groups)
        x = torch.randn((m, n), generator=g)
        for bits in (8, 4):
            q, sc = q_ref.quantize_plane_ref((3, 4), None, None, x,
                                             bits=bits)
            out = torch.empty((m, n))
            for s in groups:
                out[s] = q_ref.dequantize_plane_ref(q[s], sc[s], n=n,
                                                    bits=bits)
            want = q_ref.dequantize_plane_ref(q, sc, n=n, bits=bits)
            assert torch.equal(out.view(torch.int32),
                               want.view(torch.int32))
    with pytest.raises(ValueError, match="past"):
        q_ops.row_groups(1, 100, 100)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("n,window", [(1001, 64), (1001, 1000), (4097, 2)])
def test_windowed_plain_versions_match_whole_rows(bits, n, window):
    """``quantize_plane_ref`` and ``dequantize_plane_ref`` a window of
    columns at a time (how chip_smoke.py holds the full-width training
    planes) against one pass over the whole row, bit for bit: odd n,
    even windows that do not divide it (so at b=4 a window ends on a
    nibble pair's boundary and the last one holds the odd tail), on a
    ``[2, 3, n]`` z-plane layout with the quantiser's edge rows; an odd
    window is refused."""
    g = torch.Generator().manual_seed(n + bits)
    x = torch.randn((6, n), generator=g)
    x = q_ref.edge_rows(x).reshape(2, 3, n)
    ids = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    q, sc = q_ref.quantize_plane_ref((5, 9), ids, ids + 1, x, bits=bits)
    qw, scw = q_ref.quantize_plane_ref((5, 9), ids, ids + 1, x, bits=bits,
                                       window=window)
    assert q.shape[-1] == (n if bits == 8 else (n + 1) // 2)
    assert torch.equal(qw, q)
    assert torch.equal(scw.view(torch.int32), sc.view(torch.int32))
    want = q_ref.dequantize_plane_ref(q, sc, n=n, bits=bits)
    got = q_ref.dequantize_plane_ref(q, sc, n=n, bits=bits, window=window)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    with pytest.raises(ValueError, match="even"):
        q_ref.dequantize_plane_ref(q, sc, n=n, bits=bits, window=3)


def test_flags_match_reference(monkeypatch):
    """Every flag of the reference's parser is the port's, with the same
    default; the port adds ``--device`` only."""
    seen = {}

    def capture(self, *a, **kw):
        seen.update({act.option_strings[0]: act.default
                     for act in self._actions if act.option_strings})
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(SystemExit):
        jtrain.main()
    monkeypatch.undo()
    port = {a.option_strings[0]: a.default for a in train.parser()._actions
            if a.option_strings}
    assert port.pop("--device") is None
    assert port == seen
