"""Faults and recovery in the port against the reference.

* the seeded masks (``crash_mask``, ``message_masks``, ``edge_ok``,
  ``edge_dark``) bit-equal to the reference's, a 64-bit seed and
  ``start`` included, on Ring(6), Star(6) and the drop0.3 union;
* the sealed wire: ``crc`` and ``tag`` words bit-equal for int8, nibble,
  f32 and int32 leaves, every single bit flip caught, a stale rewind
  checksum-consistent and rejected by the tag alone; ``inject`` and the
  armed exchange give the reference's leaves bit for bit;
* the port's wire detection equals its ``edge_ok`` oracle;
* one faulted ``_step_schedule_packed`` round from a carried-over state
  within rtol 1e-5 / atol 1e-6, and the ``admm/ring/q8+saga+faults`` row
  (the reference's combined-fault perf row) at 68 B/round with the live
  reference's rounds_to_tol and log10 ||grad F||^2 within 0.05 at every
  sample >= 1e-12;
* zero-rate faults keep the trajectory, a faulted run replays bit for
  bit, each baseline stays finite under faults and follows the reference,
  crash = 1 freezes every parameter;
* the divergence watchdog (the reference's four tests).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks.common import make_problem  # noqa: E402
from benchmarks.common import run_solver as jrun_solver  # noqa: E402
from repro.checkpoint.store import save_checkpoint  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.core import solver as jsolver  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.core import vr as jvr  # noqa: E402
from repro_torch import fault_sweep, paper_fig2  # noqa: E402
from repro_torch.bench import rounds_to_tol, run_solver  # noqa: E402
from repro_torch.checkpoint.reference import (  # noqa: E402
    data_from_numpy, state_from_checkpoint)
from repro_torch.core import compression, faults, jaxrand  # noqa: E402
from repro_torch.core import schedule, solver, topology, vr  # noqa: E402
from repro_torch.core.faults import FaultPlane  # noqa: E402
from repro_torch.launch.steps import DivergenceWatchdog  # noqa: E402
from repro_torch.problems.logistic import LogisticProblem  # noqa: E402

JPROB, JDATA, JGRAPH, JEX = make_problem(seed=0)
DATA_NP = jax.tree.map(np.asarray, JDATA)
PROB = LogisticProblem()
DATA = data_from_numpy(DATA_NP, "cpu")

# the reference's acceptance recipe: simultaneous drops, flips, crashes
FAULTY = "faults:drop=0.05|corrupt=1e-3|crash=0.01|seed=0"
# every kind at once, at rates that hit several messages a round
HEAVY = "faults:drop=0.2|corrupt=0.2|stale=0.2|crash=0.1|seed=3"


def _topos():
    sched, _ = schedule.build_graph("drop:p=0.3,base=complete,seed=0", 6)
    jsch, _ = jsched.build_graph("drop:p=0.3,base=complete,seed=0", 6)
    return [("ring6", topology.Ring(6), jtopo.Ring(6)),
            ("star6", topology.Star(6), jtopo.Star(6)),
            ("drop0.3-union", sched.union, jsch.union)]


TOPOS = _topos()


def _np(t):
    """Port tensor -> numpy; int32 seal words as the reference's uint32."""
    a = t.numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a


# ---------------------------------------------------------------------------
# Spec parsing + registry
# ---------------------------------------------------------------------------


def test_spec_parsing_and_validation():
    fp = faults.get_faults("faults:drop=0.05,corrupt=1e-3,stale=0.02,"
                           "crash=0.01")
    assert fp == FaultPlane(drop=0.05, corrupt=1e-3, stale=0.02, crash=0.01)
    assert faults.get_faults("faults:drop=0.1|seed=3") == FaultPlane(
        drop=0.1, seed=3)
    assert faults.get_faults(None) is None and faults.get_faults(fp) is fp
    for spec, err in (("bogus:drop=0.1", "unknown fault model"),
                      ("faults:drp=0.1", "valid params"),
                      ("faults:drop=1.5", r"outside \[0, 1\]"),
                      ("faults:drop", "malformed fault param")):
        with pytest.raises(ValueError, match=err):
            faults.validate_spec(spec)
    with pytest.raises(ValueError, match="valid params"):
        solver.parse_solver_spec("ltadmm:faults=faults:drp=0.1")
    assert set(faults.FAULTS) == set(jfaults.FAULTS)
    assert faults.fault_entry("faults").params == \
        jfaults.fault_entry("faults").params


# ---------------------------------------------------------------------------
# Seeded masks
# ---------------------------------------------------------------------------

MASK_CASES = [(0, 0, 0.3, 0), (7, 5, 0.15, 0), (42, 17, 0.5, 5),
              ((1 << 40) + 9, 3, 0.25, 0), (2 ** 63 - 1, 6, 0.4, 6)]


@pytest.mark.parametrize("name,topo,jt", TOPOS, ids=[t[0] for t in TOPOS])
def test_masks_match_reference(name, topo, jt):
    for seed, k, rate, start in MASK_CASES:
        kw = dict(drop=rate, corrupt=rate / 2, stale=rate / 3,
                  crash=rate / 2, seed=seed, start=start)
        fp, jfp = FaultPlane(**kw), jfaults.FaultPlane(**kw)
        case = f"{name} seed={seed} k={k} rate={rate} start={start}"
        np.testing.assert_array_equal(
            fp.crash_mask(k, topo.n_agents).numpy(),
            np.asarray(jfp.crash_mask(k, jt.n_agents)), err_msg=case)
        for got, want in zip(fp.message_masks(k, topo),
                             jfp.message_masks(k, jt)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=case)
        np.testing.assert_array_equal(fp.edge_ok(k, topo).numpy(),
                                      np.asarray(jfp.edge_ok(k, jt)),
                                      err_msg=case)
        np.testing.assert_array_equal(fp.edge_dark(k, topo).numpy(),
                                      np.asarray(jfp.edge_dark(k, jt)),
                                      err_msg=case)
        np.testing.assert_array_equal(
            fp.node_alive(k, topo).numpy(),
            ~np.asarray(jfp.crash_mask(k, jt.n_agents)), err_msg=case)


def test_start_delays_all_fault_kinds():
    fp = FaultPlane(drop=0.9, corrupt=0.9, stale=0.9, crash=0.9, start=5)
    topo = topology.Ring(10)
    for k in (0, 4):
        assert not any(bool(m.any()) for m in fp.message_masks(k, topo))
        assert not bool(fp.crash_mask(k, 10).any())
    assert bool(fp.crash_mask(5, 10).any())


# ---------------------------------------------------------------------------
# Sealed wire format
# ---------------------------------------------------------------------------


def _leaf(kind, shape, rng):
    """A payload leaf of ``kind`` with random bits (every byte value)."""
    words = rng.integers(0, 2 ** 32, size=shape, dtype=np.uint64).astype(
        np.uint32)
    if kind == "f32":
        return words.view(np.float32)
    if kind == "int32":
        return words.view(np.int32)
    b = rng.integers(0, 256, size=shape, dtype=np.uint8)
    return b.view(np.int8) if kind == "int8" else b  # nibbles: uint8


LEAF_KINDS = ["int8", "nibble", "f32", "int32"]


def _payloads(kind, topo, d=7, seed=0):
    """The same sealed-to-be payload in both packages: a data leaf of
    ``kind`` and an f32 scale, ``[A, S, d]`` and ``[A, S]``."""
    rng = np.random.default_rng(seed)
    a, s = topo.n_agents, topo.n_slots
    q = _leaf(kind, (a, s, d), rng)
    sc = rng.standard_normal((a, s)).astype(np.float32)
    return (compression.Payload(q=torch.from_numpy(q.copy()),
                                scale=torch.from_numpy(sc.copy())),
            jcomp.Payload(q=jnp.asarray(q), scale=jnp.asarray(sc)))


@pytest.mark.parametrize("kind", LEAF_KINDS)
def test_seal_words_match_reference(kind):
    topo = topology.Ring(6)
    p, jp = _payloads(kind, topo)
    for tag in (0, 9, 123456789):
        s, js = compression.seal_plane(p, tag, 2), jcomp.seal_plane(jp, tag,
                                                                    2)
        assert s["crc"].dtype == s["tag"].dtype == torch.int32
        for key in ("crc", "tag"):
            np.testing.assert_array_equal(_np(s[key]), np.asarray(js[key]))
        _, ok = compression.verify_plane(s, tag)
        assert bool(ok.all())
        _, bad = compression.verify_plane(s, tag + 1)
        assert not bool(bad.any())
    # the checksum alone, of the data leaf by itself, against the
    # reference and against its plain definition, in chunks of a few
    # columns as a wide plane is summed
    got = compression.payload_checksum(compression.Payload(q=p["q"]), 2)
    np.testing.assert_array_equal(
        got.numpy().astype(np.uint32),
        np.asarray(jcomp.payload_checksum(jcomp.Payload(q=jp["q"]), 2)))
    plain = compression._u32_view(p["q"]).sum(dim=-1) & 0xFFFFFFFF
    assert torch.equal(got, plain)
    chunk = compression._SUM_CHUNK
    try:
        compression._SUM_CHUNK = 2 * p["q"].shape[0] * p["q"].shape[1]
        assert torch.equal(compression.payload_checksum(
            compression.Payload(q=p["q"]), 2), plain)
    finally:
        compression._SUM_CHUNK = chunk


@pytest.mark.parametrize("kind", LEAF_KINDS)
def test_every_single_bit_flip_is_caught(kind):
    """The additive mod-2^32 checksum moves by a nonzero power of two
    under any single bit flip: every bit of every element is detected,
    and only its own message is rejected."""
    topo = topology.Ring(2)
    p, _ = _payloads(kind, topo, d=3, seed=1)
    sealed = compression.seal_plane(p, 3, 2)
    raw = sealed["q"].numpy()
    flat = raw.view({1: np.uint8, 4: np.uint32}[raw.itemsize]).reshape(-1)
    nbits = 8 * raw.itemsize
    for i in range(flat.size):
        for bit in range(nbits):
            v = flat.copy()
            v[i] ^= v.dtype.type(1 << bit)
            tampered = compression.Payload(
                q=torch.from_numpy(v.view(raw.dtype).reshape(raw.shape)),
                scale=sealed["scale"], crc=sealed["crc"], tag=sealed["tag"])
            _, ok = compression.verify_plane(tampered, 3)
            edge = np.unravel_index(i, raw.shape)[:2]
            want = np.ones(ok.shape, bool)
            want[edge] = False
            np.testing.assert_array_equal(ok.numpy(), want, err_msg=(i, bit))


def test_stale_rewind_is_crc_consistent_but_tag_rejected():
    topo = topology.Ring(6)
    fp = FaultPlane(stale=1.0, seed=5)
    p, _ = _payloads("f32", topo, seed=2)
    for k in (9, 0):
        sealed = compression.seal_plane(p, k, 2)
        injected = fp.inject(sealed, topo, k)
        # every tag rewound by exactly one round (round 0 wraps to
        # 0xFFFFFFFF), the crc with it ...
        np.testing.assert_array_equal(
            _np(injected["tag"]),
            (_np(sealed["tag"]).astype(np.int64) - 1).astype(np.uint32))
        # ... rejected by the tag against round k, valid against k - 1
        _, ok_now, crc_ok, tag_ok = compression.verify_plane_kinds(injected,
                                                                   k)
        assert not bool(ok_now.any()) and bool(crc_ok.all())
        assert not bool(tag_ok.any())
        _, ok_prev = compression.verify_plane(injected,
                                              (k - 1) & 0xFFFFFFFF)
        assert bool(ok_prev.all())


def test_inject_requires_sealed_payloads():
    topo = topology.Ring(6)
    p, _ = _payloads("f32", topo)
    with pytest.raises(ValueError, match="seal_plane"):
        FaultPlane(drop=0.5).inject(p, topo, 0)
    with pytest.raises(TypeError, match="sealed Payloads"):
        FaultPlane(drop=0.5).inject({"x": p["q"]}, topo, 0)


INJECT_CASES = [dict(drop=0.3), dict(corrupt=0.5), dict(stale=0.4),
                dict(crash=0.3), dict(drop=0.2, corrupt=0.4, stale=0.3,
                                      crash=0.1)]


@pytest.mark.parametrize("kind", ["int8", "f32"])
@pytest.mark.parametrize("rates", INJECT_CASES,
                         ids=["drop", "corrupt", "stale", "crash", "all"])
def test_inject_matches_reference(rates, kind):
    """The same sealed payload, routed through each package's armed
    exchange (the port's injects in place) and through ``inject``
    directly, gives the reference's leaves bit for bit; the input stays
    as it was."""
    name, topo, jt = TOPOS[2]  # the complete union: 5 slots
    fp, jfp = FaultPlane(seed=11, **rates), jfaults.FaultPlane(seed=11,
                                                               **rates)
    ex = topology.Exchange(topo).armed(fp)
    jex = jtopo.Exchange(jt, faults=jfp)
    p, jp = _payloads(kind, topo, seed=3)
    for k in (0, 1, 7):
        sealed, jsealed = (compression.seal_plane(p, k, 2),
                           jcomp.seal_plane(jp, k, 2))
        before = {n: v.clone() for n, v in sealed.items()}
        for got, want in (
                (ex.exchange_batched(sealed, round_index=k),
                 jex.exchange_batched(jsealed, round_index=k)),
                (fp.inject(sealed, topo, k), jfp.inject(jsealed, jt, k))):
            assert sorted(got) == sorted(want)
            for n in got:
                np.testing.assert_array_equal(_np(got[n]),
                                              np.asarray(want[n]),
                                              err_msg=f"{rates} k={k} {n}")
            verdicts = compression.verify_plane_kinds(got, k)[1:]
            jverdicts = jcomp.verify_plane_kinds(want, k)[1:]
            for v, jv in zip(verdicts, jverdicts):
                np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        for n, v in sealed.items():
            assert torch.equal(v, before[n])


@pytest.mark.parametrize("name,topo,jt", TOPOS[:2],
                         ids=[t[0] for t in TOPOS[:2]])
def test_wire_detection_equals_edge_ok_oracle(name, topo, jt):
    """Checksum and tag verification, the crash-aware alive mask and the
    NAK symmetrisation give exactly the ``edge_ok`` mask: the baselines'
    oracle is the wire's truth."""
    ex = topology.Exchange(topo)
    fp = FaultPlane(drop=0.2, corrupt=0.05, stale=0.1, crash=0.1, seed=7)
    armed = ex.armed(fp)
    smask = torch.from_numpy(np.asarray(topo.slot_mask()))
    for k in range(6):
        p, _ = _payloads("f32", topo, seed=k)
        recv = armed.exchange_batched(compression.seal_plane(p, k, 2),
                                      round_index=k)
        _, ok = compression.verify_plane(recv, k)
        ok = ok & fp.node_alive(k, topo)[:, None]
        detected = ok & ex.exchange_batched(ok)
        assert torch.equal(detected & smask, fp.edge_ok(k, topo)), k


def test_armed_exchange_shares_the_index_cache():
    ex = topology.Exchange(topology.Ring(4))
    ex.indices("cpu")
    fp = FaultPlane(drop=0.1)
    armed = ex.armed(fp)
    assert armed.faults is fp and ex.faults is None
    assert ex.armed(fp) is armed and armed._index is ex._index
    assert armed.armed(fp) is armed


# ---------------------------------------------------------------------------
# The faulted LT-ADMM round
# ---------------------------------------------------------------------------


def _saga():
    return vr.SagaTable(sample_grads=PROB.sample_grads, m=PROB.m)


def _ref(spec, graph=None):
    ex = JEX if graph is None else jtopo.Exchange(graph.union)
    return jsolver.make_solver(spec, JGRAPH if graph is None else graph, ex,
                               jvr.SagaTable(sample_grad=JPROB.sample_grad,
                                             m=JPROB.m))


def _port(spec, graph=None):
    graph = topology.Ring(PROB.n_agents) if graph is None else graph
    return solver.make_solver(spec, graph, None, _saga(), device="cpu")


DROP = "drop:p=0.3,base=complete,seed=0"
ROUND_CASES = [("jnp", "torch", FAULTY, "ring"),
               ("pallas", "kernel", HEAVY, "ring"),
               ("pallas", "kernel", HEAVY, DROP)]


@pytest.mark.parametrize("jimpl,impl,fspec,gspec", ROUND_CASES,
                         ids=["torch-faulty", "kernel-heavy",
                              "kernel-heavy-drop0.3"])
def test_one_faulted_round_matches_reference(jimpl, impl, fspec, gspec,
                                             tmp_path):
    """One ``_step_schedule_packed`` round with faults armed, on the ring
    (a period-1 schedule) and on the drop0.3 schedule, from a state the
    reference made (3 rounds in, carried across through its checkpoint):
    rtol 1e-5 / atol 1e-6, as the unfaulted round."""
    spec = "ltadmm:compressor=qbit:bits=8,impl={},faults=" + fspec
    jg = None if gspec == "ring" else jsched.make_graph(gspec, 10)
    js = _ref(spec.format(jimpl), jg)
    step = jax.jit(lambda s, k: js.step(s, JDATA, k))
    st = js.init(jnp.zeros((PROB.n_agents, PROB.n)))
    for i in range(3):
        st = step(st, jax.random.fold_in(jax.random.key(1), i))
    want = jax.tree.map(np.asarray, step(st, jax.random.fold_in(
        jax.random.key(1), 3)))
    save_checkpoint(tmp_path / "ck", st, step=3)
    ts = _port(spec.format(impl), None if gspec == "ring"
               else schedule.make_graph(gspec, 10))
    assert ts.is_schedule and ts.cfg.faults == faults.get_faults(fspec)
    tst = state_from_checkpoint(tmp_path / "ck", ts.cfg, device="cpu")
    got = ts.step(tst, DATA, jaxrand.fold_in(jaxrand.key(1), 3))
    assert got.k == 4 == int(want.k)
    for f in got._fields[:-1]:
        w, g = getattr(want, f), getattr(got, f)
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6,
                                   err_msg=f)
    # the round's verdicts: some edges of round 3 held under HEAVY
    fp = ts.cfg.faults
    assert fp.active and ts.wire_bytes({"x": np.zeros(5, np.float32)}) == \
        js.wire_bytes({"x": np.zeros(5, np.float32)})


def test_sealed_exchange_verdicts():
    """The internal helper's verdict planes: with every kind armed, the
    edge mask is the oracle's on real slots, and each kind's planes are
    consistent (``ok = crc_ok & tag_ok``)."""
    from repro_torch.core import admm

    topo = topology.Ring(10)
    ex = topology.Exchange(topo)
    fp = faults.get_faults(HEAVY)
    rng = np.random.default_rng(0)
    for k in range(4):
        mx = compression.Payload(v=torch.from_numpy(
            rng.standard_normal((10, 2, 5)).astype(np.float32)))
        mz = compression.Payload(v=torch.from_numpy(
            rng.standard_normal((10, 2, 5)).astype(np.float32)))
        rx, rz, v = admm.sealed_exchange(fp, ex, mx, mz, k,
                                         fp.node_alive(k, topo))
        assert torch.equal(v.edge_ok, fp.edge_ok(k, topo))
        assert torch.equal(v.ok_x, v.crc_x & v.tag_x)
        assert torch.equal(v.ok_z, v.crc_z & v.tag_z)
        assert sorted(rx) == ["v"] and sorted(rz) == ["v"]


def test_faulted_row_matches_reference():
    """``admm/ring/q8+saga+faults`` (``faults:drop=0.05,corrupt=1e-3,
    crash=0.01,seed=0``): 68 B/round, the live reference's rounds_to_tol
    (110 under this jax's partitionable Threefry; the reference's BENCH
    file, recorded under the older mode, says 120), and log10 ||grad F||^2
    within 0.05 of the live reference at every sample >= 1e-12 (120
    rounds: the row's tolerance and a little past it)."""
    jidx, jg = jrun_solver(
        JPROB, JDATA, _ref("ltadmm:compressor=qbit:bits=8,faults="
                           + FAULTY), 120, metric_every=10)
    jidx, jg = np.asarray(jidx), np.asarray(jg)
    row = fault_sweep.smoke_row(rounds=120, device="cpu")
    assert row["name"] == "admm/ring/q8+saga+faults"
    assert row["wire_bytes_per_round"] == 68
    assert row["rounds_to_tol"] == rounds_to_tol(jidx, jg, 1e-8) == 110
    prob, data, ts = fault_sweep.solver_for(fault_sweep.SMOKE_FAULTS, "cpu")
    idx, g = run_solver(prob, data, ts, 120, metric_every=10)
    np.testing.assert_array_equal(idx, jidx)
    keep = jg >= 1e-12
    np.testing.assert_allclose(np.log10(g[keep]), np.log10(jg[keep]),
                               atol=0.05)


def _run_port(spec, rounds, graph=None, seed_stream=1000):
    s = _port(spec, graph) if spec.startswith("ltadmm") else \
        solver.make_solver(spec, topology.Ring(PROB.n_agents), None,
                           paper_fig2._estimator("sgd", PROB), device="cpu")
    st = s.init(torch.zeros(PROB.n_agents, PROB.n))
    for r in range(rounds):
        st = s.step(st, DATA, jaxrand.key(seed_stream + r))
    return s, st


def _leaves(st):
    return [v for v in (st if isinstance(st, tuple) else st.values())
            if isinstance(v, torch.Tensor)]


def test_zero_rate_faults_keep_trajectory_and_runs_replay():
    """All-zero rates arm the sealed wire but inject nothing: the
    trajectory stays the unarmed schedule round's; a faulted run replays
    bit for bit."""
    _, plain = _run_port("ltadmm:compressor=qbit:bits=8", 6,
                         graph=schedule.static_schedule(
                             topology.Ring(PROB.n_agents)))
    _, armed = _run_port("ltadmm:compressor=qbit:bits=8,faults=faults:seed=0",
                         6)
    for a, b in zip(_leaves(plain), _leaves(armed)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)
    spec = "ltadmm:compressor=qbit:bits=8,faults=" + HEAVY
    _, st1 = _run_port(spec, 8)
    _, st2 = _run_port(spec, 8)
    for a, b in zip(_leaves(st1), _leaves(st2)):
        assert torch.equal(a, b)


BASELINE_SPECS = {
    "dsgd": "dsgd:lr=0.1",
    "choco": "choco:lr=0.1,compressor=qbit:bits=8",
    "lead": "lead:lr=0.1,compressor=qbit:bits=8",
    "cold": "cold:lr=0.1,compressor=randk:fraction=0.5,sampler=block",
    "cedas": "cedas:lr=0.1,compressor=qbit:bits=4",
    "dpdc": "dpdc:lr=0.1,compressor=qbit:bits=8",
}
BASELINE_FAULTS = ",faults=faults:drop=0.15|stale=0.05|crash=0.1|seed=3"


BASELINE_CASES = [(n, "ring") for n in BASELINE_SPECS] + [("choco", DROP)]


@pytest.mark.parametrize("name,gspec", BASELINE_CASES,
                         ids=[n if g == "ring" else f"{n}-drop0.3"
                              for n, g in BASELINE_CASES])
def test_baselines_under_faults_follow_reference(name, gspec):
    """Each baseline takes ``faults=``: finite after 8 iterations, and
    within 1e-5 of the reference's state at every iteration (the same
    surviving-graph weights, over a schedule's round graph too, draws and
    payload bits; f32 sums reassociated)."""
    spec = BASELINE_SPECS[name] + BASELINE_FAULTS
    ring = gspec == "ring"
    js = jsolver.make_solver(spec, JGRAPH if ring else
                             jsched.make_graph(gspec, 10), JEX,
                             jvr.PlainSgd(batch_grad=JPROB.batch_grad))
    ts = solver.make_solver(spec, topology.Ring(PROB.n_agents) if ring else
                            schedule.make_graph(gspec, 10), None,
                            paper_fig2._estimator("sgd", PROB), device="cpu")
    assert ts.faults == faults.get_faults(spec.split("faults=")[1])
    jstep = jax.jit(lambda s, k: js.step(s, JDATA, k))
    jst = js.init(jnp.zeros((PROB.n_agents, PROB.n)))
    st = ts.init(torch.zeros(PROB.n_agents, PROB.n))
    for r in range(8):
        jst = jstep(jst, jax.random.key(1000 + r))
        st = ts.step(st, DATA, jaxrand.key(1000 + r))
        for f in ts.state_fields:
            np.testing.assert_allclose(st[f].numpy(), np.asarray(jst[f]),
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"{name} {f} it {r}")
    assert st["k"] == 8
    assert all(bool(torch.isfinite(v).all()) for v in _leaves(st))


def test_metropolis_online_matches_induced_graph():
    from repro_torch.core.baselines import _metropolis_online

    union = topology.Complete(6)
    rng = np.random.default_rng(0)
    for _ in range(5):
        edges = [e for e in topology.edge_set(union)
                 if e[0] < e[1] and rng.random() < 0.5]
        act = np.zeros((6, union.n_slots), bool)
        nbr = union.neighbor_table()
        for i in range(6):
            for s in range(union.n_slots):
                j = int(nbr[i, s])
                act[i, s] = union.slot_mask()[i, s] and (
                    (min(i, j), max(i, j)) in edges)
        w = _metropolis_online(union, act)
        want = np.eye(6)
        if edges:
            g = topology.GraphTopology.from_edges(6, edges)
            d = g.degrees()
            want = np.zeros((6, 6))
            for (i, j) in topology.edge_set(g):
                want[i, j] = 1.0 / (1.0 + max(int(d[i]), int(d[j])))
            want[np.diag_indices(6)] = 1.0 - want.sum(axis=1)
        np.testing.assert_allclose(w, want, rtol=1e-6, atol=1e-7)


def test_total_crash_freezes_params():
    """crash = 1: every agent is inert every round, so every parameter
    holds exactly (the gossip baseline and LT-ADMM alike)."""
    _, st = _run_port("dsgd:lr=0.1,faults=faults:crash=1.0", 4)
    assert torch.equal(st["x"], torch.zeros(PROB.n_agents, PROB.n))
    _, st = _run_port("ltadmm:compressor=qbit:bits=8,faults=faults:crash=1.0",
                      3)
    assert torch.equal(st.x, torch.zeros(PROB.n_agents, PROB.n))
    assert not bool(st.z.any())


# ---------------------------------------------------------------------------
# Divergence watchdog (the reference's tests/test_faults.py:283-328)
# ---------------------------------------------------------------------------


def test_watchdog_passthrough_and_rollback():
    wd = DivergenceWatchdog(depth=2, blowup=10.0)
    s1 = {"x": torch.tensor([1.0])}
    s2 = {"x": torch.tensor([2.0])}
    out, rb = wd.observe(s1, 1.0)
    assert out is s1 and not rb
    out, rb = wd.observe(s2, 0.5)
    assert out is s2 and not rb
    # NaN -> rollback to the OLDEST ring entry (s1); the round counter is
    # not the watchdog's to rewind
    out, rb = wd.observe({"x": torch.tensor([float("nan")])}, float("nan"))
    assert rb and float(out["x"][0]) == 1.0
    assert wd.rollbacks == 1
    # blow-up against the best seen (0.5): 100 > 10 * 0.5
    out, rb = wd.observe(s2, 100.0)
    assert rb and float(out["x"][0]) == 1.0


def test_watchdog_raises_after_consecutive_rollbacks():
    wd = DivergenceWatchdog(blowup=10.0, max_consecutive=2)
    wd.observe({"x": torch.tensor([1.0])}, 1.0)
    wd.observe({"x": torch.tensor([0.0])}, float("inf"))
    wd.observe({"x": torch.tensor([0.0])}, float("nan"))
    with pytest.raises(RuntimeError, match="consecutive"):
        wd.observe({"x": torch.tensor([0.0])}, float("nan"))


def test_watchdog_divergence_before_any_snapshot_raises():
    wd = DivergenceWatchdog()
    with pytest.raises(RuntimeError, match="before any healthy"):
        wd.observe({"x": torch.tensor([0.0])}, float("nan"))


def test_watchdog_snapshots_survive_in_place_updates():
    """Ring entries are clones: updating the observed state in place (the
    port's counterpart of jit donation) cannot reach a later rollback;
    a solver state's round counter rides along as it was."""
    wd = DivergenceWatchdog(depth=1, blowup=10.0)
    live = {"x": torch.arange(4.0)}
    wd.observe(live, 1.0)
    live["x"].mul_(0.0).add_(float("nan"))
    out, rb = wd.observe({"x": torch.zeros(4)}, float("nan"))
    assert rb
    np.testing.assert_array_equal(out["x"].numpy(), np.arange(4.0))
    s, st = _run_port("ltadmm:compressor=qbit:bits=8,faults=" + FAULTY, 2)
    wd = DivergenceWatchdog(depth=1)
    wd.observe(st, 1.0)
    st.x.fill_(float("nan"))
    back, rb = wd.observe(st, float("nan"))
    assert rb and back.k == 2 and bool(torch.isfinite(back.x).all())
    assert back.u_edge is None and isinstance(back, type(st))
    del s
