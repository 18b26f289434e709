"""The reference's public names that the port carries under the same
module paths, against the reference on the same inputs:

* the runtime-checkable Protocols ``core.solver.Solver`` (every solver
  the registry builds, the telemetry wrapper) and ``core.topology.
  Topology`` (every topology family), with the reference's members, the
  solver's two sharding hooks included;
* ``core.packing.leaf_views`` (views of the plane's segments: a write to
  the plane shows through), ``cache_layout`` and ``cached_layout`` (the
  trivial layout of a flat plane, the assertion for a pytree);
* the ``common.trees`` helpers, each against the reference's on one tree
  (integers and casts bit-equal, sums within 1e-6 relative);
* ``kernels.quantize.ref.quantize_ref`` / ``dequantize_ref`` bit-equal
  to the reference's at b = 8 and 4;
* the ten ``configs/<arch>.py`` modules;
* ``run.full_csv``: with both packages' harness ``run``s stubbed to the
  same rows, the same CSV lines apart from the roofline section (one
  comment line in the port);
* ``serve_lm``: ``examples/serve_lm.py``'s arguments.
"""
import dataclasses
import importlib
import os
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.common import trees as jtrees  # noqa: E402
from repro.core import packing as jpacking  # noqa: E402
from repro.core import solver as jsolver  # noqa: E402
from repro.core import topology as jtopology  # noqa: E402
from repro.kernels.quantize import ref as jqref  # noqa: E402
from repro_torch import run, serve_lm  # noqa: E402
from repro_torch.common import trees  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core import packing, schedule, solver, topology  # noqa: E402
from repro_torch.kernels.quantize import ref as qref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.obs import telemetry  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_MODULES = ("command_r_plus_104b", "deepseek_v2_lite_16b",
                  "granite_moe_1b_a400m", "olmo_1b", "pixtral_12b",
                  "qwen2_1_5b", "qwen3_0_6b", "seamless_m4t_medium",
                  "xlstm_125m", "zamba2_2_7b")


def test_solver_protocol_over_the_registry():
    assert solver.Solver.__protocol_attrs__ == (
        jsolver.Solver.__protocol_attrs__)
    ring, ex = schedule.build_graph("ring", 4)
    drop, _ = schedule.build_graph("drop:p=0.3,base=complete", 4)
    built = [solver.make_solver(name, ring, ex, None, device="cpu")
             for name in solver.SOLVERS]
    built += [solver.make_solver("ltadmm:packed=false", drop, None, None,
                                 device="cpu"),
              telemetry.with_telemetry(built[0])]
    assert len(built) == len(solver.SOLVERS) + 2 == 10
    for s in built:
        assert isinstance(s, solver.Solver), type(s).__name__
    assert not isinstance(object(), solver.Solver)
    assert solver.consensus_mean is trees.tree_consensus_mean
    assert solver.consensus_error is trees.tree_consensus_error


def test_topology_protocol_over_the_families():
    assert (topology.Topology.__protocol_attrs__
            == jtopology.Topology.__protocol_attrs__)
    specs = ("ring", "grid2d:rows=3", "star", "complete", "erdos:p=0.5",
             "smallworld:k=2,p=0.2")
    topos = [topology.make_topology(spec, 9) for spec in specs]
    assert {type(t) for t in topos} == {topology.Ring, topology.Grid2D,
                                        topology.GraphTopology}
    for t in topos:
        assert isinstance(t, topology.Topology)
    assert not isinstance(topology.Exchange(topos[0]), topology.Topology)


TREE = {"b": np.arange(5, dtype=np.float32),
        "w": np.arange(12, dtype=np.float32).reshape(3, 4),
        "z": {"s": np.float32(2.5) * np.ones((2,), np.float32)}}


def test_leaf_views_alias_the_plane():
    tree = trees.tree_map(torch.from_numpy, TREE)
    lay = packing.layout_of(tree)
    jlay = jpacking.layout_of(TREE)
    assert [(s.shape, s.offset, s.size) for s in lay.slots] == [
        (s.shape, s.offset, s.size) for s in jlay.slots]
    flat = packing.pack(lay, tree)
    views = packing.leaf_views(lay, flat)
    off = lay.slots[[s.shape for s in lay.slots].index((3, 4))].offset
    flat[off] = 123.0
    assert float(views["w"][0, 0]) == 123.0
    for v in trees.tree_flatten(views)[0]:
        assert v.untyped_storage().data_ptr() == (
            flat.untyped_storage().data_ptr())
    # with an agent axis too: each leaf a view of its columns
    stacked = packing.pack(lay, trees.tree_map(
        lambda t: torch.stack([t, 2 * t]), tree))
    views = packing.leaf_views(lay, stacked)
    stacked[1, off] = -1.0
    assert float(views["w"][1, 0, 0]) == -1.0
    assert torch.equal(views["b"][1], 2 * tree["b"])


def test_layout_cache():
    @dataclasses.dataclass(frozen=True)
    class Owner:
        name: str = "owner"

    plane = torch.zeros((4, 7))
    got, want = (packing.cached_layout(Owner(), plane),
                 jpacking.cached_layout(Owner(), jnp.zeros((4, 7))))
    assert got.is_trivial and want.is_trivial
    assert (got.size, got.slots[0].shape) == (want.size,
                                              want.slots[0].shape) == (7, (7,))
    owner = Owner()
    lay = packing.layout_of(trees.tree_map(torch.from_numpy, TREE))
    assert packing.cache_layout(owner, lay) is lay
    assert packing.cached_layout(owner, {"x": plane}) is lay
    msg = "call solver.init"
    with pytest.raises(AssertionError, match=msg):
        jpacking.cached_layout(Owner(), {"x": jnp.zeros((4, 7))})
    with pytest.raises(AssertionError, match=msg):
        packing.cached_layout(Owner(), {"x": plane})


def _same(got, want, rel=0.0):
    got = [np.asarray(g) for g in trees.tree_flatten(got)[0]]
    want = [np.asarray(w) for w in jax.tree.leaves(want)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.dtype, w.dtype)
        if rel:
            np.testing.assert_allclose(g, w, rtol=rel, atol=0)
        else:
            np.testing.assert_array_equal(g, w)


def test_tree_helpers_match_reference():
    rng = np.random.default_rng(1)
    a = {"w": rng.standard_normal((4, 3, 5), dtype=np.float32),
         "v": [rng.standard_normal((4, 7), dtype=np.float32)]}
    b = jax.tree.map(lambda x: x + np.float32(0.5), a)
    ta, tb = (trees.tree_map(torch.from_numpy, t) for t in (a, b))
    ja, jb = (jax.tree.map(jnp.asarray, t) for t in (a, b))
    for name, args, jargs in (
            ("tree_scale", (0.3, ta), (0.3, ja)),
            ("tree_axpy", (0.3, ta, tb), (0.3, ja, jb)),
            ("tree_lerp", (ta, tb, 0.25), (ja, jb, 0.25)),
            ("tree_add", (ta, tb), (ja, jb)),
            ("tree_sub", (ta, tb), (ja, jb)),
            ("tree_zeros_like", (ta,), (ja,)),
            ("tree_cast", (ta, torch.float64), (ja, jnp.float32)),
            ("tree_stack", ([ta, tb],), ([ja, jb],)),
            ("tree_index", (ta, 2), (ja, 2)),
            ("tree_where", (torch.tensor(False), ta, tb),
             (jnp.asarray(False), ja, jb)),
            ("tree_broadcast_leading", (ta, 3), (ja, 3)),
            ("tree_consensus_mean", (ta,), (ja,))):
        got = getattr(trees, name)(*args)
        want = getattr(jtrees, name)(*jargs)
        if name == "tree_cast":
            got = trees.tree_map(lambda x: x.float(), got)
        _same(got, want, rel=1e-6 if name == "tree_consensus_mean" else 0)
    # bf16 casts round alike
    got = trees.tree_cast(ta, torch.bfloat16)
    want = jtrees.tree_cast(ja, jnp.bfloat16)
    for g, w in zip(trees.tree_flatten(got)[0], jax.tree.leaves(want)):
        np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                      np.asarray(w).view(np.int16))
    for name in ("tree_dot", "tree_sq_norm", "tree_norm",
                 "tree_consensus_error"):
        args = (ta, tb) if name == "tree_dot" else (ta,)
        jargs = (ja, jb) if name == "tree_dot" else (ja,)
        got, want = getattr(trees, name)(*args), getattr(jtrees, name)(*jargs)
        assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want)), name
    assert trees.tree_nbytes(ta) == jtrees.tree_nbytes(ja) == 4 * (60 + 28)
    assert trees.tree_size(ta) == jtrees.tree_size(ja) == 88
    assert bool(trees.tree_all_finite(ta)) and bool(jtrees.tree_all_finite(ja))
    ta["v"][0][1, 2] = float("inf")
    ja["v"][0] = ja["v"][0].at[1, 2].set(jnp.inf)
    assert not bool(trees.tree_all_finite(ta))
    assert not bool(jtrees.tree_all_finite(ja))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_ref_and_dequantize_ref_bit_equal(bits):
    rng = np.random.default_rng(bits)
    n = 4096
    x = rng.standard_normal(n, dtype=np.float32)
    x[::97] = 0.0
    x[5] = -0.0
    rnd = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    rnd[:3] = (0, 2 ** 32 - 1, 2 ** 31)
    scale = np.float32(np.abs(x).max())
    want = np.asarray(jqref.quantize_ref(jnp.asarray(x), jnp.asarray(rnd),
                                         jnp.float32(scale), bits=bits))
    got = qref.quantize_ref(torch.from_numpy(x), rnd, scale,
                            bits=bits).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    cut = None if bits == 8 else n - 3
    for out_dtype, jdtype in ((torch.float32, jnp.float32),
                              (torch.bfloat16, jnp.bfloat16)):
        dwant = np.asarray(jqref.dequantize_ref(
            jnp.asarray(want), jnp.float32(scale), bits=bits, n=cut,
            out_dtype=jdtype))
        dgot = qref.dequantize_ref(torch.from_numpy(got), scale, bits=bits,
                                   n=cut, out_dtype=out_dtype)
        bits_view = torch.int16 if out_dtype == torch.bfloat16 else (
            torch.int32)
        np.testing.assert_array_equal(
            dgot.view(bits_view).numpy(),
            dwant.view(np.int16 if bits_view == torch.int16 else np.int32))


@pytest.mark.parametrize("module", CONFIG_MODULES)
def test_config_modules(module):
    mod = importlib.import_module(f"repro_torch.configs.{module}")
    jmod = importlib.import_module(f"repro.configs.{module}")
    assert mod.ARCH_ID == jmod.ARCH_ID
    arch = ARCHS[mod.ARCH_ID]
    assert mod.config() == arch.make(None)
    assert mod.smoke_config() == arch.make_smoke()
    assert mod.config("long_500k") == arch.make("long_500k")
    for got, want in ((mod.config(), jmod.config()),
                      (mod.smoke_config(), jmod.smoke_config())):
        assert type(got).__name__ == type(want).__name__
        assert got.name == want.name and got.d_model == want.d_model


def _harness_rows():
    return {
        "paper_fig1": [("fig1/q8", 1.25e-13, 0.8123, 36)],
        "paper_fig2": [("fig2/lt-admm-cc", 12400.0, 3.5e-17)],
        "topology_sweep": [("topology/ring", 1e-14, 0.79, 36, 23.04)],
        "schedule_sweep": [("schedule/drop", 2e-14, 0.7, 118, 31.5)],
        "paper_table1": [("table1/lead", "t_g + 2 t_c")],
        "fault_sweep": [("faults/none", 100, 9.1e-9, 1.0)],
        "personalization_sweep": [("personalization/sep=3", 0.6944, 0.4439,
                                   1.0, 1.0)],
        "kernels_bench": [("kernels/quantize", 41.7, "GB/s=12.3")],
        "roofline": [("roofline/qwen3", 0.0123, "flops")],
    }


def test_full_csv_matches_reference(monkeypatch, capsys):
    """Every row the reference's full CSV prints, the roofline rows (read
    from the port's dry-run records) included, in its format."""
    rows = _harness_rows()
    for name, out in rows.items():
        for pkg in ("benchmarks", "repro_torch"):
            mod = importlib.import_module(f"{pkg}.{name}")
            monkeypatch.setattr(mod, "run", lambda *a, _o=out, **kw: _o)
    from benchmarks import run as jrun

    jrun.full_csv()
    want = capsys.readouterr().out.splitlines()
    run.full_csv(device="cpu")
    got = capsys.readouterr().out.splitlines()
    assert want[0] == got[0] == "name,us_per_call,derived"
    assert got == want
    assert got[-1] == "roofline/qwen3,,t_compute_s=0.0123;dominant=flops"
    assert len(got) == len(want) == 10


def test_full_csv_without_dryrun_records(monkeypatch, capsys, tmp_path):
    """No dry-run records: the CSV ends with the reference's "no dry-run
    records yet" line, naming the port's command."""
    from repro_torch import roofline

    for name, out in _harness_rows().items():
        if name != "roofline":
            mod = importlib.import_module(f"repro_torch.{name}")
            monkeypatch.setattr(mod, "run", lambda *a, _o=out, **kw: _o)
    monkeypatch.setattr(roofline, "DEFAULT_PATH",
                        str(tmp_path / "torch_dryrun*.jsonl"))
    monkeypatch.setattr(roofline.run, "__defaults__",
                        (True, roofline.DEFAULT_PATH))
    run.full_csv(device="cpu")
    got = capsys.readouterr().out.splitlines()
    assert got[-1] == run.ROOFLINE_NOTE == roofline.NO_RECORDS
    assert "repro_torch.launch.dryrun" in got[-1]
    assert len(got) == 10


def test_serve_lm_argv(monkeypatch):
    seen = []
    monkeypatch.setattr(subprocess, "call",
                        lambda argv, **kw: seen.append(argv) or 0)
    spec = importlib.util.spec_from_file_location(
        "serve_lm_example", os.path.join(ROOT, "examples", "serve_lm.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    with pytest.raises(SystemExit):
        example.main()
    assert seen[0][1:3] == ["-m", "repro.launch.serve"]
    assert seen[0][3:] == serve_lm.ARGV
    monkeypatch.setattr(serve, "main", lambda argv: argv)
    assert serve_lm.main(["--device", "cpu"]) == serve_lm.ARGV + [
        "--device", "cpu"]
