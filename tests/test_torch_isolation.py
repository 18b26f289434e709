"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or anything of the JAX package ``repro``,
and importing them all pulls neither in."""
import ast
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")


def _sources():
    for dirpath, dirs, files in os.walk(PORT):
        dirs.sort()  # the same order in every pytest worker
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _modules():
    for path in _sources():
        rel = os.path.relpath(path, os.path.join(ROOT, "src"))
        if rel.startswith(".."):
            continue
        mod = rel[:-3].replace(os.sep, ".")
        yield mod[:-len(".__init__")] if mod.endswith(".__init__") else mod


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", list(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_no_jax_and_no_reference(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_importing_the_port_loads_no_jax():
    mods = sorted(_modules())
    code = (
        "import sys, importlib\n"
        f"sys.path.insert(0, {os.path.join(ROOT, 'src')!r})\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr


def test_fault_and_checkpoint_modules_load_no_jax():
    """The fault plane, the checkpoint store and the fault sweep (whose
    reference counterparts live beside JAX code) pull in neither JAX nor
    the reference."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {os.path.join(ROOT, 'src')!r})\n"
        "import repro_torch.core.faults, repro_torch.checkpoint.store\n"
        "import repro_torch.fault_sweep\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr


def test_obs_and_harness_modules_load_no_jax():
    """The observability layer and the paper's harnesses (whose reference
    counterparts import JAX) pull in neither JAX nor the reference."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {os.path.join(ROOT, 'src')!r})\n"
        "import repro_torch.obs, repro_torch.obs.summary\n"
        "import repro_torch.core.reference, repro_torch.bench\n"
        "import repro_torch.paper_fig1, repro_torch.paper_table1\n"
        "import repro_torch.topology_sweep, repro_torch.schedule_sweep\n"
        "import repro_torch.kernels_bench, repro_torch.perf_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr


def test_chip_smoke_fails_without_a_card(tmp_path):
    import shutil

    import torch

    if torch.cuda.is_available():
        pytest.skip("this checks the failure on a machine without CUDA")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd, script in ((ROOT, os.path.join(ROOT, "chip_smoke.py")),
                        (tmp_path, shutil.copy(
                            os.path.join(ROOT, "chip_smoke.py"), tmp_path))):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=300,
                             env=env)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_chip_smoke_rehearses_on_the_cpu():
    """Every phase of chip_smoke.py but the card's own (build, timing,
    profile) runs on the CPU at a tiny size with the kernels' plain
    versions; it prints no result and exits 3 by design."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                          "--rehearse"], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode == 3, out.stderr[-2000:]
    assert '"ok"' not in out.stdout
    assert "[rehearse] done" in out.stdout
    # 57 kernel checks (K6/K7: four index sets at k = n / 4 and k = 1; K5
    # at its walk's edge shapes; K4's shard form on one tree at b = 8
    # and 4, two lines each), and one line per wide spec (the faulted ring's and dada's
    # included) holding its second round's kernel calls against the plain
    # versions
    assert out.stdout.count("bit-equal") == 57 + 12
    assert out.stdout.count("round 1's kernel calls bit-equal") == 12
    # the faulted paper rows: the reference's combined-fault row, the same
    # run on the CPU, a row per fault kind and LEAD under faults
    assert "admm/ring/q8+saga+faults" in out.stdout
    assert out.stdout.count("[paper] faults/") == 4
    assert "LEAD" in out.stdout or "lead:lr=0.1" in out.stdout
    assert "ring-faults-qbit8 round" in out.stdout
    # K10 and K11 within their limits (18 + 8 and 9 checks: the served
    # shapes' 18, f32, bf16 and bf16 at a misaligned base, then the eight
    # bf16 design cases; K11's three cases in f32, in bf16 by route and
    # in bf16 with the CUDA-core variant forced), then the serving phase
    # on the smoke configs: each prefill's K10 calls, also with the
    # CUDA-core kernel forced, and zamba2's Mamba blocks through K11 (also
    # with its CUDA-core variant forced) held against the plain versions,
    # the f32 prefill against decode, and both greedy servers
    assert out.stdout.count("[kernels] K10 flash_attention") == 18 + 8
    assert out.stdout.count("misaligned") == 6
    assert out.stdout.count("scores x8") == 2
    assert out.stdout.count("[kernels] K11 ssd_scan") == 9
    assert out.stdout.count("[kernels] K11 ssd_scan (cc, forced)") == 3
    assert out.stdout.count("every call held against its plain") == 2
    assert out.stdout.count("with the CUDA-core K10 forced") == 2
    assert "Mamba blocks through K11:" in out.stdout
    assert "Mamba blocks through K11 (CUDA-core variant forced)" \
        in out.stdout
    assert "f32 prefill vs decode_step" in out.stdout
    assert out.stdout.count("greedy server") == 2
    # the obs phase: the tx-parity matrix on the ring, drop0.3, churn0.2
    # and with faults nested; the perf-smoke rows' counters; the wrapped
    # fault row against the CPU run; the wrapped trajectory bit-identical;
    # the wrapped round beside the unwrapped one (3 recipes x 2 sizes)
    assert out.stdout.count("[obs] tx parity on") == 4
    assert out.stdout.count("[obs] BENCH admm/") == 4
    assert "[obs] BENCH dada/complete16/learned-graph" in out.stdout
    # the dada phase: the perf row, its metric beside the CPU run's, and
    # the personalization sweep's three rows
    assert "[dada] perf row dada/complete16/learned-graph" in out.stdout
    assert out.stdout.count("[dada] personalization/sep=") == 3
    assert "every field equal to the CPU run's" in out.stdout
    assert "bit-identical to the unwrapped ones" in out.stdout
    assert out.stdout.count("% (host clock") == 6
    # the harness phase: Fig. 1's four variants, Table I, the 15 sweep
    # rows, the 4 participation rows, the perf-smoke trace read back
    assert out.stdout.count("[harness] fig1/") == 4
    assert "[harness] Table I equal to the reference's" in out.stdout
    assert out.stdout.count(") t/round=") == 15
    assert out.stdout.count("[harness] participation sample:") == 4
    assert "[harness] perf-smoke trace warm" in out.stdout
    # the zoo phase: deepseek's prefills and greedy steps, its prefill
    # against absorbed decoding, xlstm's prefill and decoding, deepseek's
    # smoke training with the reference's integers
    assert "dense MLA" in out.stdout and "(blockwise)" in out.stdout
    assert "prefill vs absorbed decode_step" in out.stdout
    assert "mLSTM blocks alone" in out.stdout
    assert "[zoo] deepseek smoke run" in out.stdout
    # seamless-m4t-medium (smoke widths): its prefills and greedy steps
    # from the encoder's memory, the use_flash prefill's K10 calls (two
    # non-causal encoder calls, two causal decoder ones, each held), the
    # f32 prefill against decoding at every position
    assert "[zoo] seamless-m4t-medium: 2 + 2 layers" in out.stdout
    assert "8 greedy steps from the 16-frame memory" in out.stdout
    assert ("calls 2 non-causal at [2, 16, 4, 32] and 2 causal at "
            "[2, 64, 4, 32] (4 in all" in out.stdout)
    assert "prefill vs decode_step at every position" in out.stdout
    assert "argmax equal at every position True" in out.stdout
    assert "[zoo] zoo_seamless" in out.stdout
    assert "[zoo] phase" in out.stdout
