#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device: the card's name, capability, and nvidia-smi's name and
     power limit;
  2. build: every CUDA kernel of the port from ``src/repro_torch/csrc``
     and, beside them, the first K6/K7 and K1/K4 designs (the yardsticks,
     from ``tools/gather_scatter_probe.py`` and
     ``tools/quantize_probe.py``), and the SASS instruction count, by the
     pipes that may issue each, of one Threefry block (cuobjdump of a
     probe built with the kernels' flags), which the bounds use, also by
     the pipes ptxas fixed ("as compiled"; the block's adds must be IMADs,
     none an IADD3), and of the whole K1/K4 element body (Threefry, level,
     packing, its share of the 16-byte load and the 4-byte store), printed
     beside the bounds;
     the tensor-core K10's SASS (wgmma, TMA and mbarrier instructions,
     which every instantiation must have) and the tensor-core K11's
     (wgmma and cp.async in its states and outputs kernels);
  3. kernels: each kernel held bit-exact against its plain PyTorch
     version on the card (K0 Threefry, K1 quantize_plane and K4/K5 on the
     quantiser's edge rows too: subnormals, a max below 127 tiny, +-0,
     NaN, +-inf, the max last; each K1/K4 call one kernel launch and one
     memset in the profiler, no other kernel; K2/K3 RandK
     gather/scatter, K4/K5 per-message quantize/dequantize (K5 in both
     forms, also at n = 1 to 4097 with M = 1, 3, 7, at M = 70,000, from
     q 1, 2 and 4 bytes past a 16-byte boundary, and its first design),
     K6/K7
     gather/scatter, K8/K9 cyclic gather/scatter), at n = 2^20 and
     n = 1,000,003 (K2/K3: the pull variant, and the push variant where
     the stride sampler's int32 sum wraps at 1,000,003, each case's
     variant asserted by its counter; K6/K7 on int64 rows read in place
     and on int32 rows, at k = n / 4 and k = 1, with -0.0 values and one
     index outside [0, n), through each K7 variant the rows allow and
     the first designs, and at n = 2^26 + 5, which K7 scatters in
     windows); K10 flash attention at the
     served models' prefill shapes (causal, a 512 window, a ragged
     kv length; f32 through the CUDA-core variant within 2e-5, bf16
     through the tensor-core variant and, at a misaligned base, through
     the CUDA-core one, within one ulp), and in bf16 with scores scaled by 8, T = 96 with S = 300
     non-causal, Dh 16, 32, 64 and 256 (tensor cores) and Dh 20 (CUDA
     cores; each call's variant checked by its counter), and K11 the
     SSD scan at zamba2-2.7b's and with two groups (one case at chunk 64
     with a strong decay): f32 through the CUDA-core variant, bf16
     through the tensor-core one and then the CUDA-core one forced, each
     call's variant checked by its counter (within 1e-5 of the output's
     scale, one ulp for bf16 y, h_final within 1e-5);
  4. paper problem: LT-ADMM-CC on the paper's logistic task (ring N=10,
     n=5, m=100, SAGA) for qbit8, qbit4 and the Fig.-1 RandK settings,
     and the reference's two schedule rows (q8 + SAGA on drop0.3 and
     churn0.2 over the complete graph, packed and packed=false), through
     the kernels, against the reference's rounds-to-tolerance and wire
     bytes, and against the same run on the CPU; then faults: the
     reference's combined-fault row (``fault_sweep.smoke_row``,
     drop 0.05 + corrupt 1e-3 + crash 0.01: 68 B a round, rounds_to_tol
     the live reference's 110 or its BENCH file's 120) beside the same
     run on the CPU, a row per fault kind at the reference sweep's middle
     rate, and LEAD qbit8 under the row's faults against the CPU;
  fig2. the paper's Fig.-2 comparison (``repro_torch.paper_fig2``): its
     seven methods at the paper's size through the kernels (the gossip
     baselines' qbit messages through K4/K5), counters zeroed and read
     around each method, wire bytes against the reference's, time to
     1e-8 and floor beside the reference's own run, and each method
     against the same run on the CPU;
  obs. the telemetry counters (``repro_torch.obs``) through the kernels:
     the tx-parity matrix (the 8 solvers of the reference's
     tests/test_obs.py, dada included, on the ring, drop0.3, churn0.2
     and with faults nested on drop0.3, 4 rounds: the busiest agent's measured bytes
     equal ``wire_bytes(params, t)`` each round and every counter the
     CPU run's); ``repro_torch.perf_smoke`` (the reference's BENCH
     schema; its three rows' telemetry exactly the reference's
     21600/24000/6000, 70884/73932/6000, 75546/70264/4797, no drops or
     NAKs, 600 rounds; the dada row 190 rounds at 62 B, no telemetry);
     the combined-fault row wrapped on the card and on
     the CPU, every field equal; ring-faults-qbit8 at n = 2^20 wrapped
     and unwrapped, every state leaf equal; the wrapped round beside the
     unwrapped one at the paper's size and at n = 2^20 (ring qbit8,
     drop-qbit8, ring-faults-qbit8; host clock, in turns), with each
     round's host syncs under torch's sync debug mode (equal counts
     required) and the tap's device launches a round (the fewest over
     three profiled rounds); the phase's own trace, summarised;
  harness. the paper's harnesses through the kernels: Fig. 1's four
     variants at 1500 rounds (rounds_to_tol and wire bytes the live
     reference's, final ||grad F||^2 < 1e-12 for q8, q4 and RandK, the
     rate within 10 % of the reference's CPU run), Table I, the topology
     and schedule sweeps at their default rounds (wire bytes and t/round
     the reference's, final < 1e-12, rates within 10 %), the
     participation sweep at 300 rounds (every row's rounds to 1e-10 by
     190 in the reference), and the perf-smoke trace read back through
     ``load_events`` and ``python -m repro_torch.obs.summary``;
  dada. the learned graphs (``repro_torch.personalization_sweep``) at
     the paper's size (16 agents, n = 5, the planted-cluster problem):
     the perf row cold and warm (rounds_to_tol and wire bytes the live
     reference's 190 and 62, its metric within 1e-3 relative of the CPU
     run's at every sample) and the sweep's three rows at 300 rounds
     (losses within 2e-3 of the live reference's, edge P = R = 1 at
     separation 1 and 3; separation 0's printed);
  5. main path at real width: the solvers at n = 2^20 for 20 rounds per
     spec (LT-ADMM-CC with qbit8, qbit4, RandK stride and RandK uniform,
     LEAD qbit8, CHOCO TopK on the ring; LT-ADMM-CC qbit8 on drop0.3,
     RandK block with packed=false on churn0.2, qbit8 with packed=false
     on the ring, CHOCO RandK block on drop0.3; LT-ADMM-CC qbit8 on the
     ring with every fault kind armed, its round time beside the
     unfaulted ring's; dada qbit8 on the complete graph, its [10, 9, n]
     mirrors, one K4 and one K5 a round), launch counters zeroed
     just before each spec's rounds and read just after, every kernel
     call of each spec's second round held bit for bit against its plain
     version on the same inputs, then each kernel timed at the shapes of
     those runs (wrapper and bare launch) beside its bound, its plain
     version and the PyTorch library call where one exists; K2/K3 also
     with the push kernels forced on the same inputs, in turns, and
     with the block sampler; K6/K7 at the RandK-uniform and TopK shapes
     beside the first designs, in turns; K1 also at drop0.3's
     [150, 2^20]; K1/K4 beside their first designs (the scale pass, then
     the kernel), in turns; K0 and K1/K4 also with an issue estimate from
     the pipes their SASS was compiled to; K5 (multiply form at
     [10, 2^20], division form at [150, 2^20]) beside its first design,
     in turns;
  6. profile: torch.profiler over three n = 2^20 rounds of the static
     qbit8 round, the faulted ring round (with the device time of its
     seal, verify and inject), the RandK-stride and RandK-uniform rounds,
     CHOCO TopK,
     the drop0.3 schedule round, the churn0.2 tree round, CHOCO's
     drop0.3 iteration and dada's qbit8 round on the complete graph (five
     rounds, one a graph round): device time by kernel and operator, the
     device's idle share, and the share of the port's kernels (K1-K4, K6/K7);
  serve. qwen3-0.6b and zamba2-2.7b at full width, bf16 weights from the
     port's init_params: the prefill step with use_flash (B = 4 / 2,
     T = 2048) with counters zeroed just before and read just after (28
     / 9 launches of K10's tensor-core variant) and every K10 call held
     against its plain version, then once more with the CUDA-core
     variant forced (28 / 9 of its launches, each call held); zamba2's 54 Mamba blocks' prefill inputs (forward hooks)
     through mamba_forward(use_kernel=True): 54 launches of K11's
     tensor-core variant, each held, then 54 of its CUDA-core variant
     forced, each held, and a profile of each run (K11's device time by
     kernel, the idle share);
     the prefill without the kernel; qwen3's f32 prefill logits (28
     launches of K10's CUDA-core variant) against token-by-token
     decode_step at T = 256; the greedy server (ms per decode step,
     tok/s) and profiles of a prefill and of decode steps; then K10
     and K11 (both variants each) timed beside their bounds, their plain
     versions and (K10) scaled_dot_product_attention, and the
     tensor-core K11's launches as the runtime reports them (registers,
     shared memory, resident blocks per SM).
The last two lines are a JSON object of per-kernel results and
``{"ok": true, "device": {...}}``.  Imports only the port, torch, numpy
and the standard library.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # non-tensor fp32, NVIDIA data sheet
# dense bf16 on the tensor cores (f32 accumulation), NVIDIA data sheet:
# the rate of a product of two bf16 operands, exact in f32
BF16_OPS_PER_S = 989e12
# 32-bit integer instructions, counted by the pipes that can issue them.
# NVIDIA's throughput table for compute capability 9.0 gives 64 a clock
# per SM for 32-bit integer shift, compare and bitwise ops, which only the
# ALU pipe issues (LOP3, SHF, ISETP, SEL, ...), and 64 for multiply-add,
# which only the FMA pipe issues (IMAD with a real multiply).  An add or a
# move may go to either pipe: ptxas writes one as IADD3 / VIADD / MOV on
# the ALU pipe or as IMAD.IADD / IMAD.MOV / IMAD.SHL on the FMA pipe, so
# both pipes together issue 128 a clock per SM.  The least time of some
# work is then the largest of its ALU-only count over 64 a clock, its
# FMA-only count over 64 and its whole count over 128, on 132 SMs at the
# 1.98 GHz boost clock.  ``tools/gather_scatter_probe.py`` measures the
# rates on the card: LOP3, SHF and IMAD chains at 63.5-64 a clock per SM,
# a chain of adds (which ptxas splits between IADD3 and IMAD) and a
# LOP3/IMAD mix at 123-124.
INT_PIPE_OPS_PER_S = 64 * 132 * 1.98e9  # one pipe


class Pipes(tuple):
    """Integer instructions of some work by the pipes that may issue them,
    ``(alu, fma, either)``: ALU-only, FMA-only, and adds and moves that
    either pipe takes.  Scales by a count and adds, so a per-element count
    times the elements is the work's count.  A plain number is all
    ALU-only."""

    def __new__(cls, alu, fma=0, either=0):
        return super().__new__(cls, (alu, fma, either))

    def __mul__(self, c):
        return Pipes(*(a * c for a in self))

    __rmul__ = __mul__

    def __add__(self, other):
        o = other if isinstance(other, Pipes) else Pipes(other)
        return Pipes(*(a + b for a, b in zip(self, o)))

    __radd__ = __add__

    def seconds(self):
        """The least time: the busier pipe, with the adds and moves spread
        over both."""
        alu, fma, either = self
        return max(alu, fma, (alu + fma + either) / 2) / INT_PIPE_OPS_PER_S


# SASS instructions of one Threefry-2x32-20 block as K1 draws it (counter
# word 1 zero, seed fixed per thread, only word 0 kept), by pipe: counted
# by ``phase_sass`` from cuobjdump of a probe built with the kernels'
# flags.
TF_OPS = None
# the same for one jax.random.bits word as K4 draws it (counter (0, j),
# both output words XORed)
TF_LEAF_OPS = None
# the same two blocks by the pipes ptxas fixed (``compiled_pipe``)
TF_COMPILED = TF_LEAF_COMPILED = None
# the most ALU-pipe instructions a block may take as compiled: 37 and 40
# with the adds as IMADs (40 and 40 with ptxas's own IADD3s for some)
TF_ALU_MOST, TF_LEAF_ALU_MOST = 37, 40
# the fewest ALU-only instructions a block is known to compile to on
# sm_90a: 37 as K1 draws it, 39 as K4 draws it (threefry.cuh with plain
# adds, whose K4 block compiled to one LOP3 fewer).  The ideal split
# counts the fewer of these and the current compile, so a rewrite of the
# cipher that costs an ALU instruction cannot loosen a bound
TF_ALU_FEWEST, TF_LEAF_ALU_FEWEST = 37, 39
# the pull kernels' index step an element (K2/K3): an add (either pipe)
# and a mask or a conditional subtract (ALU)
IDX_OPS = Pipes(1, 0, 1)
# exps on the special-function units: 16 per SM per clock (4 per SM
# sub-partition), 132 SMs at the 1.98 GHz boost clock
SFU_OPS_PER_S = 16 * 132 * 1.98e9
# SASS of the whole K1/K4 element body by class, per element (``body_sass``):
# "K1 b=8", "K1 b=4", "K4 b=8" -> {class: count}
BODY_SASS: dict = {}
# the tensor-core K10's SASS counts by instantiation (``k10_sass``)
SASS_K10_OPS = ("HGMMA", "UTMALDG", "UTMASTG", "SYNCS")
K10_SASS: dict = {}

# One and two Threefry blocks per loop step, as K1's loop draws them; the
# difference of their SASS instruction counts, less the xor that joins the
# two, is the instruction count of one block.
SASS_PROBE = r"""
#include "quantize.cuh"
#include "threefry.cuh"

extern "C" __global__ void one_block(uint32_t s0, uint32_t s1, uint32_t* out,
                                     int n) {
  const repro::Pair es{s0, s1};
#pragma unroll 1
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += gridDim.x * blockDim.x) {
    out[j] = repro::random_bits(es, static_cast<uint32_t>(j));
  }
}

extern "C" __global__ void two_blocks(uint32_t s0, uint32_t s1, uint32_t* out,
                                      int n) {
  const repro::Pair es{s0, s1};
#pragma unroll 1
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += gridDim.x * blockDim.x) {
    out[j] = repro::random_bits(es, static_cast<uint32_t>(j)) ^
             repro::random_bits(es, static_cast<uint32_t>(j) + 0x9E3779B9u);
  }
}

// the same for K4's draw: jax.random.bits, both words of counter (0, j)
extern "C" __global__ void one_leaf(uint32_t k0, uint32_t k1, uint32_t* out,
                                    int n) {
#pragma unroll 1
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += gridDim.x * blockDim.x) {
    out[j] = repro::jax_bits(k0, k1, static_cast<uint32_t>(j));
  }
}

extern "C" __global__ void two_leaf(uint32_t k0, uint32_t k1, uint32_t* out,
                                    int n) {
#pragma unroll 1
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += gridDim.x * blockDim.x) {
    out[j] = repro::jax_bits(k0, k1, static_cast<uint32_t>(j)) ^
             repro::jax_bits(k0, k1, static_cast<uint32_t>(j) + 0x9E3779B9u);
  }
}

// the fused quantiser's whole element body (quantize.cuh quantize_group:
// Threefry, level, packing, the group's 16-byte loads and 4-byte store),
// one and two groups a loop step
template <int kBits, class Kappa, int kGroups>
__device__ __forceinline__ void body(const float4* x, Kappa src, uint32_t s0,
                                     uint32_t s1, float sc, uint32_t* out,
                                     int n) {
  const repro::Pair st{s0, s1};
  constexpr int g = kBits == 8 ? 1 : 2;
#pragma unroll 1
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
#pragma unroll
    for (int h = 0; h < kGroups; ++h) {
      const int k = i + h * n;
      out[k] = repro::quantize_group<kBits>(src, st, x + g * k, sc,
                                            static_cast<uint32_t>(4 * g * k));
    }
  }
}

#define REPRO_BODY(name, bits, Kappa, ...)                                   \
  extern "C" __global__ void name##_one(const float4* x, uint32_t s0,        \
                                        uint32_t s1, float sc,               \
                                        uint32_t* out, int n) {              \
    body<bits, Kappa, 1>(x, Kappa{__VA_ARGS__}, s0, s1, sc, out, n);         \
  }                                                                          \
  extern "C" __global__ void name##_two(const float4* x, uint32_t s0,        \
                                        uint32_t s1, float sc,               \
                                        uint32_t* out, int n) {              \
    body<bits, Kappa, 2>(x, Kappa{__VA_ARGS__}, s0, s1, sc, out, n);         \
  }
REPRO_BODY(k1_b8, 8, repro::PlaneKappa, 0u, 0u, nullptr, nullptr)
REPRO_BODY(k1_b4, 4, repro::PlaneKappa, 0u, 0u, nullptr, nullptr)
REPRO_BODY(k4_b8, 8, repro::LeafKappa, nullptr)
"""

WIDE_N = 2 ** 20
ODD_N = 1_000_003
PAPER_ROUNDS, WIDE_ROUNDS = 600, 20
DEV = "cuda"
ERRS: dict = {}  # kernel -> max |kernel - plain| over phase 3
# ``call(entry, *args)`` of the first K6/K7 designs' library (phase_build)
YARDSTICK = None
# the same for the first K1/K4 designs (tools/quantize_probe.py)
QUANT_FIRST = None
CARD = None  # nvidia-smi's name and power limit, beside every time


def sync():
    import torch

    if DEV == "cuda":
        torch.cuda.synchronize()


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn()`` by CUDA events over ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, int_ops=0, fp_ops=0, bf16_ops=0, sfu_ops=0):
    """Least time for the work: bytes over HBM rate vs operations over
    their type's peak rate (``int_ops`` a ``Pipes`` count, or a number of
    ALU-only instructions; ``fp_ops`` with an f32 operand on the CUDA
    cores, ``bf16_ops`` of two bf16 operands on the tensor cores,
    ``sfu_ops`` exps on the special-function units; each type on its own
    units, so the slowest sets the time); returns (ms, "bytes" |
    "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    int_ops = int_ops if isinstance(int_ops, Pipes) else Pipes(int_ops)
    t_ops = max(int_ops.seconds(), fp_ops / FP32_OPS_PER_S,
                bf16_ops / BF16_OPS_PER_S, sfu_ops / SFU_OPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------


def phase_device():
    global CARD
    import torch

    name = torch.cuda.get_device_name(0)
    log(f"[device] {name} capability {torch.cuda.get_device_capability(0)} "
        f"count {torch.cuda.device_count()} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    CARD = smi
    return name, smi


def load_tool(name):
    """The module ``tools/<name>.py`` of this checkout."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_build():
    """Every source of the package, one nvcc each, and beside them the
    first K6/K7 and K1/K4 designs (the yardsticks, built by
    ``tools/gather_scatter_probe.py`` and ``tools/quantize_probe.py``),
    all started together; sets YARDSTICK and QUANT_FIRST."""
    global YARDSTICK, QUANT_FIRST
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build

    probe = load_tool("gather_scatter_probe")
    qprobe = load_tool("quantize_probe")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        first = pool.submit(probe.build, str(_build.BUILD_DIR / "yardstick"),
                            ("base",))
        qfirst = pool.submit(qprobe.build,
                             str(_build.BUILD_DIR / "quant_yardstick"),
                             ("base",))
        report = _build.build()
        YARDSTICK = probe.caller(first.result()["base"])
        QUANT_FIRST = qprobe.caller(qfirst.result()["base"])
    log(f"[build] {time.perf_counter() - t0:.2f} s wall, "
        f"{len(report)} sources compiled into {_build.BUILD_DIR}, the "
        "first K6/K7 and K1/K4 designs beside them")
    for stem, (secs, ptxas) in sorted(report.items()):
        log(f"[build] {stem}.cu {secs:.2f} s")
        for line in ptxas.splitlines():
            if "Used" in line or "spill" in line or "Compiling" in line:
                log(f"[ptxas] {line.strip()}")


def sass_counts(cubin, suffixes=False):
    """{kernel: {opcode: count}} of a cubin's SASS (NOPs left out); with
    ``suffixes`` the opcodes keep theirs (``IMAD.MOV.U32``)."""
    import re
    from pathlib import Path

    from repro_torch.kernels import _build

    tool = Path(_build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(cubin)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            fn = counts.setdefault(head.group(1), {})
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z]\w*)"
                       + (r"((?:\.\w+)*)" if suffixes else ""), line)
        if fn is not None and ins and ins.group(1) != "NOP":
            op = ins.group(0).split()[-1] if suffixes else ins.group(1)
            fn[op] = fn.get(op, 0) + 1
    return counts


# SASS opcodes (with suffixes) by the pipe that issues them.  Adds and
# moves go to either pipe (IMAD.IADD / .MOV / .SHL are an add, a move and a
# shift by a constant written as a multiply-add); a real multiply-add and
# the float ops only to the FMA pipe; the uniform datapath (U...: once a
# warp, on its own pipe), branch control and constant loads to neither, so
# they are left out of the count; every other opcode only to the ALU pipe.
EITHER_PIPE = ("IADD3", "VIADD", "IADD", "MOV", "LEA", "IMAD.IADD", "IMAD.MOV",
               "IMAD.SHL")
FMA_PIPE = ("IMAD", "FFMA", "FMUL", "FADD")
NO_INT_PIPE = ("BSSY", "BSYNC", "BRA", "EXIT", "LDC")


def pipe_of(op):
    """"either", "fma", "alu" or None (no integer pipe) for a SASS opcode
    with its suffixes."""
    base = op.split(".")[0]
    if any(op == e or op.startswith(e + ".") for e in EITHER_PIPE):
        return "either"
    if base in FMA_PIPE:
        return "fma"
    if base.startswith("U") or base in NO_INT_PIPE:
        return None
    return "alu"


def compiled_pipe(op):
    """The pipe that ptxas fixed for a SASS opcode (with its suffixes):
    an add or a move written as an IMAD form or as VIADD goes to the FMA
    pipe, one written as IADD3 / IADD / MOV / LEA to the ALU pipe; every
    other opcode as ``pipe_of`` says.  VIADD: a Threefry block with 14 of
    them (K4's before its adds became IMADs) ran at 0.71 clocks a block
    per SM in ``tools/quantize_probe.py``'s rate probe, below the 0.84
    that 54 ALU-pipe instructions would take."""
    pipe = pipe_of(op)
    if pipe == "either":
        return "fma" if op.startswith(("IMAD", "VIADD")) else "alu"
    return pipe


def sass_pipes(one, two, what):
    """The instructions of one block: ``two`` less ``one`` (a kernel's
    opcode counts, with suffixes, with two blocks a loop step and with
    one), less the xor that joins the two: ``(ideal, compiled)``, the
    first as ``Pipes`` by the pipes that may issue each instruction, the
    second by the pipes ptxas fixed (``compiled_pipe``; no "either")."""
    delta = {op: two.get(op, 0) - one.get(op, 0)
             for op in sorted(set(one) | set(two))}
    delta = {op: v for op, v in delta.items() if v}
    xor = next(op for op in delta if op.startswith("LOP3"))
    delta[xor] -= 1  # the joining xor
    by = {"alu": 0, "fma": 0, "either": 0, None: 0}
    fixed = {"alu": 0, "fma": 0, None: 0}
    for op, v in delta.items():
        by[pipe_of(op)] += v
        fixed[compiled_pipe(op)] += v
    total = by["alu"] + by["fma"] + by["either"]
    log(f"[sass] {what}: {total} integer-pipe instructions, {by['alu']} "
        f"only on the ALU pipe, {by['fma']} only on the FMA pipe, "
        f"{by['either']} adds and moves on either; as compiled "
        f"{fixed['alu']} on the ALU pipe, {fixed['fma']} on the FMA pipe; "
        f"{by[None]} left out (uniform datapath, branch control, constant "
        f"loads) (two {sum(two.values())} - one {sum(one.values())} - 1 "
        f"xor); by opcode {delta}")
    if not 20 <= total <= 120:
        raise AssertionError(f"implausible Threefry count {total}")
    return (Pipes(by["alu"], by["fma"], by["either"]),
            Pipes(fixed["alu"], fixed["fma"]),
            sum(v for op, v in delta.items() if op.startswith("IADD3")))


# SASS opcodes of the element body outside the integer pipes: conversions
# and the special-function unit (16 a clock per SM) and memory
XU_OPS = ("F2I", "I2F", "F2F", "FRND", "MUFU")
LSU_OPS = ("LDG", "STG", "LDS", "STS", "LD", "ST", "ATOM", "ATOMG", "RED")


def body_sass(one, two, what, elements):
    """The SASS of the quantiser's element body, per element: ``two`` less
    ``one`` (a loop step of two groups and of one), over the group's
    ``elements``, by class ("alu", "fma" (float ops and real IMADs),
    "either", "xu", "lsu", "other"); logs it with an issue estimate: per
    SM and clock, 128 instructions of all kinds issue, 64 ALU-only, 16
    conversions."""
    delta = {op: two.get(op, 0) - one.get(op, 0)
             for op in sorted(set(one) | set(two))}
    by = {"alu": 0, "fma": 0, "either": 0, "xu": 0, "lsu": 0, "other": 0}
    for op, v in delta.items():
        base = op.split(".")[0]
        cls = ("xu" if base in XU_OPS else "lsu" if base in LSU_OPS
               else pipe_of(op) or "other")
        by[cls] += v
    # as compiled: the adds and moves on the pipe ptxas fixed, every IMAD
    # form on the FMA pipe's 64 a clock (float ops also issue on its
    # second half, so they count only in the total)
    alu_c = by["alu"] + sum(v for op, v in delta.items()
                            if compiled_pipe(op) == "alu"
                            and pipe_of(op) == "either")
    imad = sum(v for op, v in delta.items() if op.startswith("IMAD"))
    per = {k: v / elements for k, v in by.items()}
    clocks = max(sum(per.values()) / 128, per["alu"] / 64, per["xu"] / 16)
    compiled = max(sum(per.values()) / 128, alu_c / elements / 64,
                   imad / elements / 64, per["xu"] / 16)
    per["issue_clocks"] = clocks
    per["compiled_alu"] = alu_c / elements
    per["compiled_imad"] = imad / elements
    per["compiled_clocks"] = compiled
    log(f"[sass] {what} element body: "
        + ", ".join(f"{k} {per[k]:.2f}" for k in by)
        + f" SASS an element ({sum(by.values())} a group of {elements}); "
        f"issue estimate {clocks:.3f} clocks an element per SM; as "
        f"compiled {per['compiled_alu']:.2f} on the ALU pipe, "
        f"{per['compiled_imad']:.2f} IMAD forms on the FMA pipe: "
        f"{compiled:.3f} clocks")
    return per


def ideal_block(ops, fewest, what):
    """The ideal split of one Threefry block from its compiled ``Pipes``:
    ALU-only work at most ``fewest`` (``TF_ALU_FEWEST``), and every
    FMA-only instruction counted as an add that either pipe may issue (the
    cipher multiplies nothing: its IMADs are ``add_fma``'s adds)."""
    alu, fma, either = ops
    ideal = Pipes(min(alu, fewest), 0, fma + either)
    log(f"[sass] the ideal split of a block as {what} draws it: "
        f"{ideal[0]} only on the ALU pipe (compiled {alu}, fewest known "
        f"{fewest}), {ideal[2]} adds and moves on either")
    return ideal


def phase_sass():
    """Count the SASS instructions of one Threefry block as K1 and as K4
    draw it, by pipe (sets TF_OPS and TF_LEAF_OPS), and of the whole
    K1/K4 element body (sets BODY_SASS)."""
    global TF_OPS, TF_LEAF_OPS, TF_COMPILED, TF_LEAF_COMPILED
    from repro_torch.kernels import _build

    src = _build.BUILD_DIR / "threefry_probe.cu"
    cubin = src.with_suffix(".cubin")
    src.write_text(SASS_PROBE)
    subprocess.run([_build.nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
                    "-cubin", f"-I{_build._CSRC}", "-o", str(cubin), str(src)],
                   check=True, capture_output=True, timeout=300)
    counts = sass_counts(cubin, suffixes=True)
    TF_OPS, TF_COMPILED, iadd3 = sass_pipes(
        counts["one_block"], counts["two_blocks"],
        "one Threefry block as K1 draws it")
    TF_LEAF_OPS, TF_LEAF_COMPILED, leaf_iadd3 = sass_pipes(
        counts["one_leaf"], counts["two_leaf"],
        "one jax.random.bits word as K4 draws it")
    TF_OPS = ideal_block(TF_OPS, TF_ALU_FEWEST, "K1")
    TF_LEAF_OPS = ideal_block(TF_LEAF_OPS, TF_LEAF_ALU_FEWEST, "K4")
    # the cipher's adds are IMADs on the FMA pipe (threefry.cuh add_fma): a
    # compiler that turned some back into IADD3s would load the ALU pipe
    for what, fixed, adds, most in (
            ("K1", TF_COMPILED, iadd3, TF_ALU_MOST),
            ("K4", TF_LEAF_COMPILED, leaf_iadd3, TF_LEAF_ALU_MOST)):
        if adds or fixed[0] > most:
            raise AssertionError(
                f"a Threefry block as {what} draws it has {adds} IADD3 and "
                f"{fixed[0]} instructions on the ALU pipe as compiled (at "
                f"most {most}): its adds are no longer all IMADs")
    for key, name, group in (("K1 b=8", "k1_b8", 4), ("K1 b=4", "k1_b4", 8),
                             ("K4 b=8", "k4_b8", 4)):
        BODY_SASS[key] = body_sass(counts[f"{name}_one"],
                                   counts[f"{name}_two"], key, group)
    k10_sass()
    k11_sass()


def k11_sass():
    """The tensor-core K11's SASS: per kernel the counts of wgmma (HGMMA)
    and cp.async (LDGSTS) instructions; raises unless its states and
    outputs kernels have both."""
    from repro_torch.kernels import _build

    counts = sass_counts(_build._lib_path("ssd_scan_sm90"))
    found = 0
    for fn, ops in sorted(counts.items()):
        for kernel in ("ssd_state_kernel", "ssd_output_kernel"):
            if kernel not in fn:
                continue
            found += 1
            reading = {op: ops.get(op, 0) for op in ("HGMMA", "LDGSTS")}
            log(f"[sass] K11 {fn}: {reading}")
            if not all(reading.values()):
                raise AssertionError(f"K11 {fn} has no wgmma or no cp.async")
    if not found:
        raise AssertionError("no tensor-core kernel in the K11 library")


def k10_sass():
    """The tensor-core K10's SASS: per instantiation (head width kD, kv
    tile kBK) the counts of wgmma (HGMMA), TMA loads and stores (UTMALDG,
    UTMASTG) and mbarrier operations (SYNCS); raises unless every one has
    HGMMA and UTMALDG (sets K10_SASS)."""
    import re

    from repro_torch.kernels import _build

    counts = sass_counts(_build._lib_path("flash_attention_sm90"))
    for fn, ops in sorted(counts.items()):
        widths = re.search(r"ILi(\d+)ELi(\d+)E", fn)
        if not widths:
            continue
        key = f"kD={widths.group(1)} kBK={widths.group(2)}"
        K10_SASS[key] = {op: ops.get(op, 0) for op in SASS_K10_OPS}
        log(f"[sass] K10 flash_kernel_sm90 {key}: {K10_SASS[key]}")
        if not (ops.get("HGMMA") and ops.get("UTMALDG")):
            raise AssertionError(f"K10 {key} has no wgmma or no TMA load")
    if not K10_SASS:
        raise AssertionError("no flash_kernel_sm90 in the K10 library")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions, bit-exact
# ---------------------------------------------------------------------------


def note_err(kernel, got, want):
    """Largest |got - want| so far for ``kernel``; equal values (infs)
    and NaN against NaN count as 0."""
    import torch

    if not got.numel():
        err = 0.0
    else:
        g, w = got.double(), want.double()
        same = (g == w) | (torch.isnan(g) & torch.isnan(w))
        err = float(torch.where(same, 0.0, (g - w).abs()).max())
    ERRS[kernel] = max(ERRS.get(kernel, 0.0), err)


def same_scale(a, b):
    """Scales bit for bit, a NaN matching a NaN whatever its payload."""
    import torch

    nan = torch.isnan(b)
    return (torch.equal(torch.isnan(a), nan)
            and same_bits(a[~nan].contiguous(), b[~nan].contiguous()))


def one_launch(fn, tag, label):
    """Run ``fn`` once under torch.profiler and raise unless the card ran
    exactly one kernel whose name holds ``tag`` and, besides it, nothing
    but at most one memset (no abs/amax pass); returns the kernel's
    name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # a trace with no device activity at all is the profiler losing the
    # call (CUPTI), not a count of its launches: profile it again, logging
    # the host-side launch calls the empty trace did hold
    for attempt in range(1, 4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.events()
        names = [e.name for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
        host = sum("LaunchKernel" in e.name or "Memset" in e.name
                   for e in events)
        log(f"[profile] {label}: trace {attempt} of 3 held no device "
            f"event and {host} host-side launch or memset calls; "
            f"profiling again")
    kernels = [nm for nm in names if "Memset" not in nm
               and "Memcpy" not in nm]
    memsets = [nm for nm in names if "Memset" in nm]
    if len(kernels) != 1 or tag not in kernels[0] or len(memsets) > 1:
        raise AssertionError(f"{label}: the card ran {names}, not one "
                             f"{tag} kernel and at most one memset")
    return kernels[0], len(memsets)


def z_plane_ids(device):
    """Sender/receiver ids of the z-plane of a 10-agent ring."""
    import torch

    from repro_torch.core.topology import Ring

    nbr = torch.as_tensor(Ring(10).neighbor_table(), device=device)
    sid = torch.arange(10, device=device)[:, None].expand(10, 2)
    return sid.reshape(-1).to(torch.int32), nbr.reshape(-1).to(torch.int32)


def plane_cases(device):
    """(sids, rids) of the main path's planes: the z-plane (20 per-edge
    messages) and the x-plane (10 broadcasts, rids None)."""
    import torch

    return (z_plane_ids(device),
            (torch.arange(10, device=device, dtype=torch.int32), None))


def edge_ids(gspec, device):
    """(sids, rids) of the per-edge messages of graph ``gspec`` on 10
    agents, [A, S] flattened over the slots of its union topology, as
    ``core.admm.RoundIds`` builds them (the complete graph's union has
    S = 15 slots)."""
    import numpy as np
    import torch

    from repro_torch.core.schedule import build_graph, union_topology

    topo = union_topology(build_graph(gspec, 10)[0])
    nbr = torch.as_tensor(np.asarray(topo.neighbor_table(), np.int64),
                          device=device)
    sids = torch.arange(topo.n_agents, device=device)[:, None].expand(
        nbr.shape)
    return (sids.reshape(-1).to(torch.int32),
            nbr.reshape(-1).to(torch.int32))


def check_k0(seed, dev):
    import torch

    from repro_torch.kernels import prng

    # int32 tensors carry the uint32 bit patterns
    sids = prng.u32([0, 1, 9, 2 ** 31, 2 ** 31 + 7, 2 ** 32 - 1, 12345,
                     3_000_000_000], dev).to(torch.int32)
    rids = prng.u32([1, 0, prng.BROADCAST, 5, 2 ** 31 + 1, 3, 2 ** 32 - 2,
                     4_000_000_000], dev).to(torch.int32)
    c = WIDE_N
    ctr = ((torch.arange(c, device=dev, dtype=torch.int64) * 4099
            + 2 ** 31 - 100) & prng.MASK).to(torch.int32)
    got = prng.threefry_bits(seed, sids, rids, ctr, n=ODD_N, n_strides=64)
    sync()
    want = prng._threefry_bits_ref(seed, sids, rids, ctr, ODD_N, 64)
    for g, w, what in zip(got, want, ("bits", "offset", "slot")):
        note_err("K0", g, w)
        if not torch.equal(g, w):
            raise AssertionError(f"K0 {what}: {(g != w).sum()} mismatches")
    log(f"[kernels] K0 threefry_bits: {sids.numel()} seeds x {c} counters "
        "(ids and counters >= 2^31) bit-equal")
    return {"sids": sids, "rids": rids, "ctr": ctr}


def plant_saturation(x, seed, sids, rids, levels, first=0):
    """Put each row's max |x| (a power of two, so levels*|x|/scale is
    exactly ``levels``) at the first element whose kappa lifts it to
    ``levels + 1``, in rows ``first`` on; returns the planted (row, col)
    pairs."""
    import torch

    from repro_torch.kernels import prng

    n = x.shape[1]
    es = prng.fold(seed, prng.u32(sids), prng.u32(rids))
    ctr = torch.arange(n, device=x.device, dtype=torch.int64)
    kappa = prng.uniform01(prng.random_bits((es[0][:, None],
                                             es[1][:, None]), ctr[None, :]))
    hit = (torch.tensor(float(levels), device=x.device) + kappa) == levels + 1
    hit[:first] = False
    rows = torch.nonzero(hit.any(dim=1)).reshape(-1)
    cols = torch.argmax(hit.to(torch.int8), dim=1)[rows]
    big = 2.0 ** math.ceil(math.log2(2 * float(x[first:].abs().max())))
    x[rows, cols] = big
    return rows, cols


def check_k1(seed, dev):
    """K1 bit for bit (q and scale) at the main path's planes (the ring's
    z- and x-planes, drop0.3's per-edge plane) at n = 2^20 and 1,000,003,
    b = 8 and 4: the quantiser's edge rows (``ref.EDGE_ROWS``) in rows 0-7
    and saturating elements planted in the rest; the first design on the
    z-plane; on the card each call one launch of the fused kernel and one
    memset."""
    import torch

    from repro_torch.kernels import prng
    from repro_torch.kernels.quantize import ops, ref

    (zs, zr), (xs, _) = plane_cases(dev)
    es, er = edge_ids(DROP_SPEC, dev)
    g = torch.Generator(device=dev).manual_seed(1)
    edge = len(ref.EDGE_ROWS)
    for n, sid, rid in ((WIDE_N, zs, zr), (ODD_N, zs, zr), (WIDE_N, xs, None),
                        (WIDE_N, es, er)):
        for bits in (8, 4):
            x = torch.randn((sid.numel(), n), generator=g, device=dev)
            ref.edge_rows(x)
            levels = 2 ** (bits - 1) - 1
            rows, cols = plant_saturation(
                x, seed, sid, prng.BROADCAST if rid is None else rid, levels,
                first=edge)
            q, sc = ops.quantize_plane(seed, sid, rid, x, bits=bits)
            sync()
            qw, scw = ref.quantize_plane_ref(seed, sid, rid, x, bits=bits)
            note_err("K1", q, qw)
            note_err("K1", sc, scw)
            if not (torch.equal(q, qw) and same_scale(sc, scw)):
                raise AssertionError(
                    f"K1 n={n} b={bits}: {(q != qw).sum()} q mismatches")
            out = ops.dequantize_plane(q, sc, n=n, bits=bits)
            sync()
            ow = ref.dequantize_plane_ref(q, sc, n=n, bits=bits)
            note_err("K5", out, ow)
            if not same_scale(out.reshape(-1), ow.reshape(-1)):
                raise AssertionError(f"K5 dequantize_plane n={n} b={bits}: "
                                     "mismatch")
            if rows.numel():
                pre = ref.quantize_values(x[rows, cols], sc[rows], 1.0,
                                          levels)
                if not bool((pre == levels + 1).all()):
                    raise AssertionError("K1 saturation plant missed")
            what = ""
            if DEV == "cuda" and n == WIDE_N and rid is zr:
                qf, scf = load_tool("quantize_probe").first_plane(
                    QUANT_FIRST, seed, sid, rid, x, bits)
                sync()
                if not (torch.equal(qf, qw) and same_scale(scf, scw)):
                    raise AssertionError(f"K1 first design b={bits}: "
                                         "mismatch")
                name, sets = one_launch(
                    lambda: ops.quantize_plane(seed, sid, rid, x, bits=bits),
                    "quantize_rows", f"K1 b={bits}")
                what = (f"; the first design bit-equal too; one call ran "
                        f"{name[:60]} and {sets} memset")
            log(f"[kernels] K1 quantize_plane [{sid.numel()}, {n}] b={bits}"
                f"{' broadcast' if rid is None else ''} and its "
                f"dequantize_plane (K5's division form): bit-equal (edge "
                f"rows 0-{edge - 1}), {rows.numel()} rows with a planted "
                f"saturating element{what}")


def check_k23(seed, dev):
    """K2/K3 bit for bit (-0.0 kept) at the main path's n = 2^20 and at
    n = 1,000,003, both samplers; each case's variant asserted by its
    counter: push only where the stride sampler's int32 sum wraps at
    ODD_N, pull everywhere else."""
    import torch

    from repro_torch.kernels import prng
    from repro_torch.kernels.sparse_gather import ops, ref

    (zs, zr), (xs, _) = plane_cases(dev)
    g = torch.Generator(device=dev).manual_seed(2)
    for n, frac, sid, rid in ((WIDE_N, 0.25, zs, zr), (ODD_N, 0.25, zs, zr),
                              (WIDE_N, 0.6, zs, zr), (WIDE_N, 0.6, xs, None)):
        k = max(1, round(frac * n))
        x = torch.randn((sid.numel(), n), generator=g, device=dev)
        x[:, ::13] = -0.0
        for sampler in ("block", "stride"):
            strides = (1,) if sampler == "block" else prng.coprime_strides(n)
            kind = ops.variant(n, k, strides)
            if DEV == "cuda" and kind != ("push" if (n, sampler) == (
                    ODD_N, "stride") else "pull"):
                raise AssertionError(f"K2/K3 n={n} {sampler}: variant {kind}")
            before = read_counts()
            v = ops.randk_gather_plane(seed, sid, rid, x, k=k,
                                       strides=strides)
            sync()
            vw = ref.randk_gather_plane_ref(seed, sid, rid, x, k=k,
                                            strides=strides)
            note_err("K2", v, vw)
            if not same_bits(v, vw):
                raise AssertionError(f"K2 n={n} {sampler}: mismatch")
            out = ops.randk_scatter_plane(seed, sid, rid, v, n=n, gain=n / k,
                                          strides=strides)
            sync()
            ow = ref.randk_scatter_plane_ref(seed, sid, rid, v, n=n,
                                             gain=n / k, strides=strides)
            note_err("K3", out, ow)
            if not same_bits(out, ow):
                raise AssertionError(f"K3 n={n} {sampler}: mismatch")
            after = read_counts()
            ran = {c: after[c] - before[c] for c in after
                   if c.startswith("randk_") and after[c] != before[c]}
            if DEV == "cuda" and ran != {
                    "randk_gather_plane": 1, f"randk_gather_plane_{kind}": 1,
                    "randk_scatter_plane": 1,
                    f"randk_scatter_plane_{kind}": 1}:
                raise AssertionError(f"K2/K3 n={n} {sampler}: launches {ran}"
                                     f", expected one {kind} each")
            es = prng.fold(seed, prng.u32(sid),
                           prng.BROADCAST if rid is None else prng.u32(rid))
            idx = prng.affine_indices(es, n, k, strides)
            exact = ((prng.derive_offset(es, n)[:, None]
                      + torch.arange(k, device=dev)
                      * torch.as_tensor(strides, device=dev)[
                          prng.derive_stride_slot(es, len(strides))][:, None])
                     % n)
            wrapped = int((idx != exact).any(dim=1).sum())
            dup = int(sum(k - torch.unique(r).numel() for r in idx))
            neg0 = int(((out == 0) & torch.signbit(out)).sum())
            log(f"[kernels] K2/K3 randk [{sid.numel()}, {n}] k={k} {sampler}"
                f"{' broadcast' if rid is None else ''}: {kind} variant, "
                f"bit-equal; {wrapped} rows hit the int32 wrap, {dup} "
                f"repeated indices, {neg0} -0.0 kept")


# (k0, k1, j): raw keys whose jax.random.bits word at element j is >=
# 2^32 - 128, so that K4's kappa rounds to 1.0 there (as in
# tests/test_torch_compression.py)
SATURATING_KEYS = ((543808644, 1486979388, 944), (3917027860, 3836244836, 966),
                   (781517975, 2568259190, 493), (1025103629, 3342442247, 743))


def check_k45(dev):
    """K4/K5 on [10, n] messages (the baselines' x-plane) and on the ring
    tree round's per-leaf x and z messages, [10 or 20, WIDE_SPLIT] and
    [10 or 20, n - WIDE_SPLIT]: random keys, the quantiser's edge rows in
    rows 0-7, and four rows keyed by SATURATING_KEYS with their max |x|
    planted at the element whose kappa is 1.0; the first K4 design at
    [10, 2^20]; on the card each K4 call one launch of the fused kernel
    and one memset."""
    import torch

    from repro_torch.core import jaxrand
    from repro_torch.kernels import prng
    from repro_torch.kernels.quantize import ops, ref

    g = torch.Generator(device=dev).manual_seed(3)
    edge = len(ref.EDGE_ROWS)
    for m, n in ((10, WIDE_N), (10, ODD_N), (10, WIDE_SPLIT),
                 (20, WIDE_SPLIT), (10, WIDE_N - WIDE_SPLIT),
                 (20, WIDE_N - WIDE_SPLIT)):
        for bits in (8, 4):
            keys = torch.randint(0, 2 ** 32, (m, 2), generator=g,
                                 device=dev, dtype=torch.int64)
            x = torch.randn((m, n), generator=g, device=dev)
            ref.edge_rows(x)
            levels = 2 ** (bits - 1) - 1
            big = 2.0 ** math.ceil(math.log2(2 * float(x[edge:].abs()
                                                       .max())))
            planted = [(r, kk) for r, kk in enumerate(SATURATING_KEYS,
                                                      start=edge)
                       if r < m and kk[2] < n]
            for r, (k0, k1, j) in planted:
                keys[r] = torch.tensor([k0, k1], device=dev)
                x[r, j] = big if r % 2 == 0 else -big
            q, sc = ops.quantize_tensor(keys, x, bits=bits)
            sync()
            qw, scw = ref.quantize_tensor_ref(keys, x, bits=bits)
            note_err("K4", q, qw)
            note_err("K4", sc, scw)
            if not (torch.equal(q, qw) and same_scale(sc, scw)):
                raise AssertionError(
                    f"K4 [{m}, {n}] b={bits}: {(q != qw).sum()} q "
                    "mismatches")
            hold_k5(q, sc, n, bits, f"[{m}, {n}]")
            for r, (k0, k1, j) in planted:
                kap = prng.uniform01(jaxrand.bits(keys[r], (j + 1,)))[j]
                pre = ref.quantize_values(x[r, j], sc[r], kap, levels)
                if float(pre.abs()) != levels + 1:
                    raise AssertionError("K4 saturation plant missed")
            what = ""
            if DEV == "cuda" and (m, n) == (10, WIDE_N):
                for plane in (0, 1):  # K5's first design
                    out = torch.empty((m, n), device=dev)
                    QUANT_FIRST("dequantize_leaf_first", q.data_ptr(), m, n,
                                bits, sc.data_ptr(), out.data_ptr(),
                                q.shape[-1], plane)()
                    want = (ref.dequantize_plane_ref if plane
                            else ref.dequantize_tensor_ref)(q, sc, n=n,
                                                            bits=bits)
                    sync()
                    if not same_scale(out.reshape(-1), want.reshape(-1)):
                        raise AssertionError(f"K5 first design b={bits} "
                                             f"plane={plane}: mismatch")
                kd = ops._key_words(keys, (m,), x.device)
                qf, scf = load_tool("quantize_probe").first_leaf(
                    QUANT_FIRST, kd, x, bits)
                sync()
                if not (torch.equal(qf, qw) and same_scale(scf, scw)):
                    raise AssertionError(f"K4 first design b={bits}: "
                                         "mismatch")
                hkeys = keys.cpu()
                name, sets = one_launch(
                    lambda: ops.quantize_tensor(hkeys, x, bits=bits),
                    "quantize_rows", f"K4 b={bits}")
                what = (f"; the first design bit-equal too; one call ran "
                        f"{name[:60]} and {sets} memset")
            log(f"[kernels] K4/K5 quantize/dequantize_tensor [{m}, {n}] "
                f"b={bits}: bit-equal (edge rows 0-{min(m, edge) - 1}), "
                f"{len(planted)} rows with a planted saturating "
                f"element; K5 in both forms, also from q 1, 2 and 4 bytes "
                f"past a 16-byte boundary{what}")
    # K5's walk at its edges: rows shorter than a quad, rows straddling
    # quads, odd n at b=4 (a pad nibble a row), every byte value of q, a
    # scale whose levels reach below tiny; and more rows than a 2-D grid's
    # y takes (on the card)
    many = 70_000 if DEV == "cuda" else 700
    for m, n in [(m, n) for n in (1, 5, 15, 16, 17, 1023, 4097)
                 for m in (1, 3, 7)] + [(many, 17)]:
        for bits in (8, 4):
            wire = ops.wire_len(n, bits)
            q = torch.randint(0, 256, (m, wire), generator=g, device=dev,
                              dtype=torch.int32).to(torch.uint8)
            if bits == 8:
                q = q.view(torch.int8)
            sc = torch.randn((m,), generator=g, device=dev) * 1e3
            sc[0] = 50 * ref.TINY
            hold_k5(q, sc, n, bits, f"[{m}, {n}]")
    log("[kernels] K5 both forms at n = 1, 5, 15, 16, 17, 1023, 4097 x "
        f"M = 1, 3, 7 and [{many}, 17], b = 8 and 4, from q 0, 1, 2 and 4 "
        "bytes past a 16-byte boundary: bit-equal")


def hold_k5(q, sc, n, bits, label):
    """K5 in both forms (``dequantize_tensor``, ``dequantize_plane``, one
    launch each, asserted by their counters) bit-equal to their plain
    versions on ``q``, ``sc``, and again on copies of q whose data start
    1, 2 and 4 bytes past a 16-byte boundary."""
    import torch

    from repro_torch.kernels.quantize import ops, ref

    views = [q]
    for offset in (1, 2, 4):
        flat = torch.empty(q.numel() + 16, dtype=q.dtype, device=q.device)
        views.append(flat[offset:offset + q.numel()].view(q.shape))
        views[-1].copy_(q)
    for qv in views:
        for fn, plain in ((ops.dequantize_tensor, ref.dequantize_tensor_ref),
                          (ops.dequantize_plane, ref.dequantize_plane_ref)):
            before = fn.launches
            out = fn(qv, sc, n=n, bits=bits)
            sync()
            want = plain(q, sc, n=n, bits=bits)
            note_err("K5", out, want)
            if DEV == "cuda" and fn.launches != before + 1:
                raise AssertionError(f"K5 {fn.__name__}: not one launch")
            if not same_scale(out.reshape(-1), want.reshape(-1)):
                raise AssertionError(f"K5 {fn.__name__} {label} b={bits} "
                                     f"q at {qv.data_ptr() % 16}: mismatch")


def hold_k67(x, rows, n, gain, variants, label):
    """K6 and K7 (each variant of ``variants``, each asserted by its
    counter) on index rows ``rows`` bit for bit against their plain
    versions, with -0.0 planted in every third value; on the card also
    the first designs on the same rows (int32, K7 onto a zeroed plane).
    Returns K6's output."""
    import torch

    from repro_torch.kernels.sparse_gather import ops, ref

    v = ops.sparse_gather(x, rows)
    sync()
    vw = ref.sparse_gather_ref(x, rows)
    note_err("K6", v, vw)
    if not same_bits(v, vw):
        raise AssertionError(f"K6 {label}: mismatch")
    vals = v.clone()
    vals[:, ::3] = -0.0
    want = ref.sparse_scatter_ref(vals, rows, n, gain)
    for kind in variants:
        before = read_counts()
        out = ops.sparse_scatter(vals, rows, n, gain,
                                 unique=kind == "unique")
        sync()
        ran = {c: read_counts()[c] - before[c] for c in before
               if c.startswith("sparse_scatter")}
        if DEV == "cuda" and ran != {"sparse_scatter": 1,
                                     f"sparse_scatter_{kind}": 1,
                                     **{f"sparse_scatter_{o}": 0
                                        for o in ("unique", "claim")
                                        if o != kind}}:
            raise AssertionError(f"K7 {label}: launches {ran}, expected one "
                                 f"{kind}")
        note_err("K7", out, want)
        if not same_bits(out, want):
            raise AssertionError(f"K7 {label} {kind}: mismatch")
    if DEV == "cuda":
        m, k = vals.shape
        r32 = rows.to(torch.int32).contiguous()
        first = torch.empty((m, k), device=x.device)
        YARDSTICK("sparse_gather_first", x.data_ptr(), m, n, r32.data_ptr(), k,
                  first.data_ptr())()
        plane = torch.zeros((m, n), device=x.device)
        winner = (None if "unique" in variants else
                  torch.full((m, n), -1, dtype=torch.int32, device=x.device))
        YARDSTICK("sparse_scatter_first", vals.data_ptr(), r32.data_ptr(), m,
                  n, k, float(gain),
                  None if winner is None else winner.data_ptr(),
                  plane.data_ptr())()
        sync()
        if not (same_bits(first, vw) and same_bits(plane, want)):
            raise AssertionError(f"K6/K7 first designs {label}: mismatch")
    return v


def check_k67(dev):
    """K6/K7 on the index sets of the per-message route: RandK uniform on
    the LT-ADMM z-plane [20, n] (n = 2^20 and ODD_N), TopK on [10, n],
    and RandK stride at n = 1,000,003, where the int32 wrap repeats
    indices and only K7's claim variant may run; each at k = n / 4 and
    k = 1, the rows as the callers hold them (int64 prefixes of [..., n],
    read in place) and as int32, and with one index outside [0, n) (K6
    gives 0, K7 skips it).  K7 through each variant the rows allow, the
    first designs beside them (``hold_k67``).  On the card also uniform
    rows at n = 2^26 + 5, which K7 scatters in windows."""
    import torch

    from repro_torch.core import jaxrand
    from repro_torch.kernels import prng
    from repro_torch.kernels.sparse_gather import ops

    g = torch.Generator(device=dev).manual_seed(4)
    # the stride case keeps n = 1,000,003 in the rehearsal too: a smaller
    # n never wraps
    for n, kind, m in ((WIDE_N, "uniform", 20), (ODD_N, "uniform", 20),
                       (WIDE_N, "topk", 10), (1_000_003, "stride", 20)):
        x = torch.randn((m, n), generator=g, device=dev)
        x[:, ::11] = -0.0
        keys = jaxrand.split(jaxrand.key(n), m).to(dev)
        strides = prng.coprime_strides(n)
        for k in (max(1, round(0.25 * n)), 1):
            if kind == "uniform":
                idx = jaxrand.permutation(keys, n)[..., :k]
            elif kind == "topk":
                idx = torch.sort(x.abs(), dim=-1, descending=True,
                                 stable=True).indices[..., :k]
            else:
                idx = prng.affine_indices((keys[:, 0], keys[:, 1]), n, k,
                                          strides)
            gain = 1.0 if kind == "topk" else n / k
            unique = kind != "stride" or ops.indices_unique(n, k, strides)
            variants = ("unique", "claim") if unique else ("claim",)
            far = idx.clone()
            far[1, k // 2] = n + 3 if k > 1 else -2
            for rows, what in ((idx, f"{idx.dtype} prefix"),
                               (idx.to(torch.int32), "int32"),
                               (far, "an index outside [0, n)")):
                v = hold_k67(x, rows, n, gain, variants,
                             f"[{m}, {n}] k={k} {kind} {what}")
            if float(v[1, k // 2]) != 0.0:
                raise AssertionError("K6 read an index outside [0, n)")
            dup = int(sum(k - torch.unique(r).numel() for r in idx))
            log(f"[kernels] K6/K7 gather/scatter [{m}, {n}] k={k} {kind}: "
                f"bit-equal on int64 rows in place, int32 rows and one "
                f"index outside [0, n), -0.0 kept; K7 variants "
                f"{'/'.join(variants)}"
                f"{', first designs too' if DEV == 'cuda' else ''}; {dup} "
                "repeated indices")
            if kind == "stride" and k > 1 and not (dup > 0 and not unique):
                raise AssertionError("K7 stride case missed the int32 wrap")
    if DEV == "cuda":
        # rows longer than one window of K7's bin (MAX_SEGS segments: 2^26
        # elements unique, 2^25 claim), n odd, so that the last window holds
        # 5 elements off a 16-byte boundary, with an index planted there;
        # on the card only (the CPU route has no windows)
        n = (ops.MAX_SEGS << ops.SEG_LOG["unique"]) + 5
        m, k = 2, n // 8
        x = torch.randn((m, n), generator=g, device=dev)
        perm = jaxrand.permutation(jaxrand.split(jaxrand.key(n), m).to(dev), n)
        for r in range(m):  # n - 1 into the prefix, a swap: still unique
            at = int((perm[r] == n - 1).nonzero()[0])
            perm[r, [0, at]] = perm[r, [at, 0]]
        idx = perm[..., :k]
        far = idx.clone()
        far[1, k // 2] = n + 3
        for rows, what in ((idx, "int64 prefix"), (idx.to(torch.int32),
                                                   "int32"),
                           (far, "an index outside [0, n)")):
            hold_k67(x, rows, n, n / k, ("unique", "claim"),
                     f"[{m}, {n}] k={k} uniform {what}")
        windows = {kind: ops.bin_layout(m, n, k, kind)[1]
                   for kind in ("unique", "claim")}
        log(f"[kernels] K6/K7 gather/scatter [{m}, {n}] k={k} uniform: "
            "bit-equal on int64 rows in place, int32 rows and one index "
            f"outside [0, n), -0.0 kept; K7 in windows {windows}, first "
            "designs too")


def check_k89(dev):
    """K8/K9 on [20, n] messages at k = 1, 0.6 * 2^20 and n, and at the
    wide runs' own shapes, k = 1, RandK's k at fraction 0.6 and n: the
    churn0.2 tree round's per-edge leaves [150, WIDE_SPLIT] and [150, n -
    WIDE_SPLIT] (150 = 10 agents x 15 slots), CHOCO's [10, n] on
    drop0.3.  Offsets 0 and n - 1
    planted, one row of -0.0 values (K9 returns +0.0 there, as the
    reference's kernel does); compared as bit patterns."""
    import torch

    from repro_torch.kernels.sparse_gather import ops, ref

    g = torch.Generator(device=dev).manual_seed(5)
    cases = [(20, n, k) for n in (WIDE_N, ODD_N)
             for k in (1, round(0.6 * WIDE_N), n)]
    edges = edge_ids(CHURN_SPEC, dev)[0].numel()
    cases += [(m, n, k) for m, n in ((edges, WIDE_SPLIT),
                                     (edges, WIDE_N - WIDE_SPLIT),
                                     (10, WIDE_N))
              for k in (1, max(1, round(0.6 * n)), n)]
    for m, n, k in cases:
        x = torch.randn((m, n), generator=g, device=dev)
        v = torch.randn((m, k), generator=g, device=dev)
        v[2] = -0.0
        off = torch.randint(0, n, (m,), generator=g, device=dev)
        off[:2] = torch.tensor([0, n - 1], device=dev)
        got = ops.cyclic_gather(x, off, k)
        sync()
        want = ref.cyclic_gather_ref(x, off, k)
        note_err("K8", got, want)
        if not same_bits(got, want):
            raise AssertionError(f"K8 [{m}, {n}] k={k}: mismatch")
        out = ops.cyclic_scatter(v, off, n, n / k)
        sync()
        want = ref.cyclic_scatter_ref(v, off, n, n / k)
        note_err("K9", out, want)
        if not same_bits(out, want):
            raise AssertionError(f"K9 [{m}, {n}] k={k}: mismatch")
        if bool(torch.signbit(out[2]).any()):
            raise AssertionError("K9 kept a -0.0")
        log(f"[kernels] K8/K9 cyclic gather/scatter [{m}, {n}] k={k}: "
            "bit-equal (offsets 0 and n - 1, a -0.0 row out as +0.0)")


# K10 at the two served models' attention shapes: (label, B, H, KH, T, Dh)
# as their prefills give them (qwen3-0.6b at B = 4, zamba2-2.7b at B = 2,
# T = 2048); each with a causal mask, a 512-wide window and S = T - 48 (not
# a multiple of the 128-column block)
K10_CASES = (("qwen3", 4, 16, 8, 2048, 128), ("zamba2", 2, 32, 32, 2048, 80))
K10_MASKS = (("causal", 0, None), ("window 512", 0, 512), ("S = T - 48", 48,
                                                           None))
K10_F32_TOL = 2e-5  # the reference's own (tests/test_kernels.py:140)
# bf16 cases that would expose a slip in the tensor-core design: (label,
# B, H, KH, T, S, Dh, causal, window, q scale).  Scores scaled by 8 spread
# p over many binades, so a dropped p_lo half shows; T = 96 leaves half of
# the second warpgroup's rows past T, S = 300 a ragged last tile; Dh 16
# and 32 run p.v narrower than a swizzle atom, Dh 64 one atom (its own
# build), Dh 256 on 64-column tiles.  Dh 20 is a row TMA cannot address:
# ``route`` sends it to the CUDA-core kernel
K10_TC_CASES = (
    ("qwen3 scores x8", 4, 16, 8, 2048, 2048, 128, True, None, 8.0),
    ("zamba2 scores x8", 2, 32, 32, 2048, 2048, 80, True, None, 8.0),
    ("T = 96 non-causal S = 300", 2, 8, 2, 96, 300, 128, False, None, 1.0),
    ("Dh 16", 2, 8, 4, 512, 512, 16, True, None, 1.0),
    ("Dh 32 window 128", 2, 8, 4, 512, 512, 32, True, 128, 1.0),
    ("Dh 64", 2, 8, 4, 512, 512, 64, True, None, 1.0),
    ("Dh 256 S = T - 64", 2, 8, 4, 512, 448, 256, True, None, 1.0),
    ("Dh 20 H = 1", 1, 1, 1, 128, 128, 20, True, None, 1.0),
)
# K11 at zamba2-2.7b's SSD: (B, T, NH, HD, NG, DS, chunk)
K11_CASE = (2, 2048, 80, 64, 1, 64, 128)
# check_k11's cases: (label, B, T, NH, HD, NG, DS, chunk, decay); each in
# f32 (the CUDA-core variant) and bf16 (the tensor-core one by ``route``,
# then the CUDA-core one forced), B and C at their token stride
K11_CASES = (("zamba2", *K11_CASE, "usual"),
             ("two groups", 2, 1024, 16, 64, 2, 64, 128, "usual"),
             ("two groups strong decay chunk 64", 1, 512, 8, 32, 2, 16, 64,
              "strong"))
K11_REL_TOL = 1e-5  # max |kernel - plain| over max |plain|, f32 outputs


def bit_share(got, want):
    import torch

    return float((got.contiguous().view(torch.int16)
                  == want.contiguous().view(torch.int16)).float().mean())


def hold_k10(got, want, label, variant="tc"):
    """K10's limit against its plain version: 2e-5 in f32; in bf16 one
    ulp at each element's magnitude (or 2e-5), with the share of
    bit-equal outputs.  Returns the reading.  The error is noted under
    the kernel that ran: "K10" the CUDA-core one in f32, "K10-cc" in bf16,
    "K10-tc" the tensor-core one (``variant``, which ``k10_call`` and the
    serving phase's counters check)."""
    import torch

    if got.dtype == torch.float32:
        note_err("K10", got, want)
        err = float((got - want).abs().max())
        if not err <= K10_F32_TOL:
            raise AssertionError(f"K10 {label}: max |d| {err:.3e} > "
                                 f"{K10_F32_TOL}")
        return f"max |d| {err:.3e} <= {K10_F32_TOL}"
    from repro_torch.kernels.tolerance import bf16_ulps

    note_err(f"K10-{variant}", got, want)
    ulps = bf16_ulps(got, want, K10_F32_TOL)
    if ulps > 1:
        raise AssertionError(f"K10 {label}: {ulps:.3f} bf16 ulps from its "
                             "plain version")
    return (f"<= {ulps:.3f} bf16 ulp, {bit_share(got, want):.4%} "
            "identical")


def misaligned(a):
    """A copy of ``a`` one element past a 16-byte boundary: a base that
    TMA cannot take, so ``route`` sends it to the CUDA-core kernel."""
    import torch

    buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)
    out = buf[1:].view(a.shape)
    out.copy_(a)
    return out


def k10_call(q, k, v, causal, window, expect):
    """K10 through its wrapper; on the card, raises unless ``route`` names
    the variant ``expect`` ("tc" or "cc") and that variant's counter, and
    no other, moved.  Returns (output, variant)."""
    from repro_torch.kernels.flash_attention import ops

    before = read_counts()
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    sync()
    after = read_counts()
    if DEV == "cpu":
        return got, "plain"
    variant = ops.route(q, k, v)
    moved = [n for n in ("tc", "cc") if after[f"flash_attention_{n}"]
             != before[f"flash_attention_{n}"]]
    if moved != [expect] or variant != expect:
        raise AssertionError(f"K10 launched {moved}, route {variant}, "
                             f"expected {expect}")
    return got, variant


def check_k10(dev, cases=K10_CASES, tc_cases=K10_TC_CASES):
    """K10 against its plain version on unit-normal inputs at the served
    models' shapes, f32 (the CUDA-core variant), bf16 (the tensor-core
    one) and bf16 at a misaligned base (the CUDA-core one), causal,
    windowed and ragged S; then the bf16 design cases, each on the
    variant ``route`` gives its shape."""
    import torch

    from repro_torch.kernels.flash_attention import ref

    bf = torch.bfloat16
    served = ((torch.float32, False, "cc"), (bf, False, "tc"),
              (bf, True, "cc"))
    g = torch.Generator(device=dev).manual_seed(10)
    runs = [(label, b, h, kh, t, t - short, dh, True, window, 1.0, mask,
             served)
            for label, b, h, kh, t, dh in cases
            for mask, short, window in K10_MASKS]
    runs += [(*case, "", ((bf, False, "tc" if case[6] % 8 == 0 else "cc"),))
             for case in tc_cases]
    for label, b, h, kh, t, s, dh, causal, window, qs, mask, kinds in runs:
        q = qs * torch.randn((b, t, h, dh), generator=g, device=dev)
        k = torch.randn((b, s, kh, dh), generator=g, device=dev)
        v = torch.randn((b, s, kh, dh), generator=g, device=dev)
        for dt, shifted, expect in kinds:
            args = [a.to(dt) for a in (q, k, v)]
            if shifted:
                args = [misaligned(a) for a in args]
            got, variant = k10_call(*args, causal, window, expect)
            want = ref.flash_attention_plain(*args, causal=causal,
                                             window=window)
            tag = (f"{label} [{b}, {t}, {h}, {dh}] kv {kh}x{s}"
                   f"{'' if causal else ' non-causal'}"
                   f"{' ' + mask if mask else ''} {dt}"
                   f"{' misaligned' if shifted else ''}")
            log(f"[kernels] K10 flash_attention ({variant}) {tag}: "
                f"{hold_k10(got, want, tag, expect)}")


def ssd_inputs(dev, b, t, nh, hd, ng, ds, dtype, seed=11, decay="usual"):
    """SSD inputs in the model layout, B and C as column slices of one
    [B, T, NH * HD + 2 NG DS] tensor, as the Mamba block hands them over;
    alog -0.2 |N(0, 1)| ("usual") or about -5 a step ("strong": exp
    underflows inside a chunk)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    x = 0.5 * torch.randn((b, t, nh, hd), generator=g, device=dev)
    alog = -0.2 * torch.randn((b, t, nh), generator=g, device=dev).abs()
    if decay == "strong":
        alog = -5.0 + 0.5 * alog
    xbc = 0.5 * torch.randn((b, t, nh * hd + 2 * ng * ds), generator=g,
                            device=dev)
    bm = xbc[..., nh * hd:nh * hd + ng * ds].reshape(b, t, ng, ds)
    cm = xbc[..., nh * hd + ng * ds:].reshape(b, t, ng, ds)
    return [a.to(dtype) for a in (x, bm, cm, alog)]


def hold_k11(got, want, label, variant="tc"):
    """K11's limits against its plain version: y within K11_REL_TOL of its
    scale in f32 (one bf16 ulp in bf16), h_final within K11_REL_TOL.  The
    error is noted under the variant that ran: "K11-tc", "K11-cc" (bf16)
    or "K11-cc-f32"."""
    import torch

    from repro_torch.kernels.tolerance import bf16_ulps

    (y, h), (yw, hw) = got, want
    kid = f"K11-{variant}" + ("-f32" if y.dtype == torch.float32 else "")
    note_err(kid, y, yw)
    note_err(kid, h, hw)
    rel_h = float((h - hw).abs().max() / hw.abs().max())
    scale = float(yw.float().abs().max())
    if y.dtype == torch.float32:
        rel_y = float((y - yw).abs().max()) / scale
        ok, text = rel_y <= K11_REL_TOL, f"y rel {rel_y:.3e}"
    else:
        ulps = bf16_ulps(y, yw, K11_REL_TOL * scale)
        ok = ulps <= 1
        text = f"y <= {ulps:.3f} bf16 ulp ({bit_share(y, yw):.4%} identical)"
    if not (ok and rel_h <= K11_REL_TOL):
        raise AssertionError(f"K11 {label}: {text}, h rel {rel_h:.3e}")
    return f"{text}, h_final rel {rel_h:.3e} (limit {K11_REL_TOL})"


def k11_call(cfg, x, bm, cm, alog, expect, variant=None):
    """K11 through its wrapper (``variant`` forced, or ``route``'s); on the
    card, raises unless the variant ``expect`` ran and no other (its
    counter alone moved; without ``variant``, ``route`` named it)."""
    from repro_torch.kernels.ssm_scan import ops

    before = read_counts()
    got = ops.ssd_chunked(cfg, x, bm, cm, alog, variant=variant)
    sync()
    after = read_counts()
    if DEV == "cpu":
        return got
    moved = [n for n in ("tc", "cc") if after[f"ssd_chunked_{n}"]
             != before[f"ssd_chunked_{n}"]]
    ran = variant or ops.route(x, bm, cfg, cm)
    if moved != [expect] or ran != expect:
        raise AssertionError(f"K11 launched {moved} ({ran}), expected "
                             f"{expect}")
    return got


def check_k11(dev, cases=K11_CASES):
    """K11 against its plain version at zamba2's SSD shape and with two
    groups (one case at chunk 64 with a strong decay): f32 through the
    CUDA-core variant; bf16 through the tensor-core one (``route``), then
    the CUDA-core one forced, on the same inputs."""
    import torch

    from repro_torch.kernels.ssm_scan import ref
    from repro_torch.models.mamba import SSMConfig

    for label, b, t, nh, hd, ng, ds, chunk, decay in cases:
        cfg = SSMConfig(nh * hd // 2, d_state=ds, head_dim=hd, n_groups=ng,
                        chunk=chunk)
        for dt, runs in ((torch.float32, ((None, "cc"),)),
                         (torch.bfloat16, ((None, "tc"), ("cc", "cc")))):
            x, bm, cm, alog = ssd_inputs(dev, b, t, nh, hd, ng, ds, dt,
                                         decay=decay)
            want = ref.ssd_scan_plain(x, alog, bm, cm, chunk=chunk)
            for variant, expect in runs:
                got = k11_call(cfg, x, bm, cm, alog, expect, variant)
                tag = (f"{label} [{b}, {nh}, {t}, {hd}] NG {ng} DS {ds} "
                       f"chunk {chunk} {decay} decay {dt}")
                log(f"[kernels] K11 ssd_scan ({expect}"
                    f"{', forced' if variant else ''}) {tag}: "
                    f"{hold_k11(got, want, tag, expect)}")


def same_bits(a, b):
    """Equal shapes, types and bit patterns (so -0.0 != +0.0)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = (t.contiguous().view(torch.int32) for t in (a, b))
    return torch.equal(a, b)


# ---------------------------------------------------------------------------
# phase 4: the paper's problem through the kernels
# ---------------------------------------------------------------------------

# card vs CPU after 20 rounds or iterations of the same run, max |dx|
# (the ring rows and Fig. 2)
PAPER_DX_TOL = 2e-4
# (label, spec, wire bytes, kernels the run must launch, the reference's
# rounds_to_tol where a test holds it: tests/test_torch_admm.py, q8 and
# Fig. 1's RandK rows)
PAPER_SPECS = (
    ("qbit8", "ltadmm:compressor=qbit:bits=8", 36, ("quantize_plane",), 100),
    ("qbit4", "ltadmm:compressor=qbit:bits=4", 28, ("quantize_plane",),
     None),
    # n = 5 passes K2/K3's pull rule (no int32 wrap)
    ("randk-stride",
     "ltadmm:eta=0.5,compressor=randk:fraction=0.6,sampler=stride", 48,
     ("randk_gather_plane_pull", "randk_scatter_plane_pull"), 100),
    ("randk-block",
     "ltadmm:eta=0.5,compressor=randk:fraction=0.6,sampler=block", 48,
     ("randk_gather_plane_pull", "randk_scatter_plane_pull"), 100),
)


def kernel_counters():
    """Counter name -> the wrapper that holds the count (while a
    ``MainPathTap`` is installed, its stand-in, which the wrapper's own
    ``launches += 1`` then reaches)."""
    from repro_torch.kernels import prng
    from repro_torch.kernels.quantize import ops as qops
    from repro_torch.kernels.sparse_gather import ops as sgops

    from repro_torch.kernels.flash_attention import ops as flops
    from repro_torch.kernels.ssm_scan import ops as ssmops

    fns = {"threefry_bits": prng.threefry_bits,
            "quantize_plane": qops.quantize_plane,
            "randk_gather_plane": sgops.randk_gather_plane,
            "randk_scatter_plane": sgops.randk_scatter_plane,
            "quantize_tensor": qops.quantize_tensor,
            "dequantize_tensor": qops.dequantize_tensor,
            "dequantize_plane": qops.dequantize_plane,
            "sparse_gather": sgops.sparse_gather,
            "sparse_scatter": sgops.sparse_scatter,
            "cyclic_gather": sgops.cyclic_gather,
            "cyclic_scatter": sgops.cyclic_scatter,
            "flash_attention": flops.flash_attention,
            "ssd_chunked": ssmops.ssd_chunked}
    return fns


# a wrapper's launch counters: ``launches``, and per variant K10's
# (``launches_tc`` the tensor-core kernel, ``launches_cc`` the CUDA-core
# one), K2/K3's (``launches_pull``, ``launches_push``) and K7's
# (``launches_unique``, ``launches_claim``); ``launches`` is the sum of a
# wrapper's variants
LAUNCH_ATTRS = ("launches", "launches_tc", "launches_cc", "launches_pull",
                "launches_push", "launches_unique", "launches_claim")


def _attrs(fn):
    return [a for a in LAUNCH_ATTRS if hasattr(fn, a)]


def reset_counts():
    for fn in kernel_counters().values():
        for a in _attrs(fn):
            setattr(fn, a, 0)


def read_counts():
    """{counter: launches}; a variant's as its wrapper's name and the
    variant (flash_attention_tc, randk_gather_plane_pull, ...) beside the
    wrapper's sum."""
    return {name + a[len("launches"):]: getattr(fn, a)
            for name, fn in kernel_counters().items() for a in _attrs(fn)}


def set_counts(counts):
    for name, fn in kernel_counters().items():
        for a in _attrs(fn):
            setattr(fn, a, counts[name + a[len("launches"):]])


def phase_paper(rounds):
    import numpy as np
    import torch

    from repro_torch.bench import rounds_to_tol, run_solver
    from repro_torch.core import vr
    from repro_torch.core.schedule import build_graph
    from repro_torch.core.solver import make_solver
    from repro_torch.problems.logistic import LogisticProblem

    prob = LogisticProblem()
    data = prob.make_data(0)
    graph, ex = build_graph("ring", prob.n_agents)
    est = vr.SagaTable(sample_grads=prob.sample_grads, m=prob.m)
    for label, spec, wire, used, ref_r2t in PAPER_SPECS:
        # impl=auto picks the kernels on the card; the CPU rehearsal asks
        # for the kernel route (the plain versions) explicitly
        solver = make_solver(spec + (",impl=kernel" if DEV == "cpu" else ""),
                             graph, ex, est, device=DEV)
        reset_counts()
        t0 = time.perf_counter()
        idx, gns, st = run_solver(prob, data, solver, rounds,
                                  metric_every=10, return_state=True)
        sync()
        secs = time.perf_counter() - t0
        counts = read_counts()
        r2t = rounds_to_tol(idx, gns, 1e-8)
        wb = solver.wire_bytes({"x": np.zeros(prob.n, np.float32)})
        log(f"[paper] {label}: rounds_to_tol={r2t} (reference "
            f"{ref_r2t or 'not pinned'}) final={gns[-1]:.3e} "
            f"wire_bytes_per_round={wb} launches="
            f"{ {k: v for k, v in counts.items() if v} } "
            f"host_s_per_round={secs / rounds:.5f}")
        if r2t is None or r2t > 125:
            raise AssertionError(f"{label}: rounds_to_tol {r2t} > 125")
        if ref_r2t is not None and r2t != ref_r2t:
            raise AssertionError(f"{label}: rounds_to_tol {r2t} != the "
                                 f"reference's {ref_r2t}")
        if wb != wire:
            raise AssertionError(f"{label}: wire bytes {wb} != {wire}")
        if DEV == "cuda" and not all(counts[u] > 0 for u in used):
            raise AssertionError(f"{label}: kernels {used} not launched")
        # the same route on the CPU (the kernels' plain versions)
        cpu = make_solver(spec + ",impl=kernel", graph, ex, est,
                          device="cpu")
        _, g_cpu, st_cpu = run_solver(prob, data, cpu, 20, metric_every=10,
                                      return_state=True)
        _, g_gpu, st_gpu = run_solver(prob, data, solver, 20,
                                      metric_every=10, return_state=True)
        dx = float((st_gpu.x.cpu() - st_cpu.x).abs().max())
        log(f"[paper] {label}: card vs CPU after 20 rounds: max |dx| = "
            f"{dx:.3e}, ||gradF||^2 {g_gpu[-1]:.3e} vs {g_cpu[-1]:.3e}")
        # same kernel arithmetic; matmul rounding differs and can flip a
        # rounding decision, which error feedback then absorbs: the card
        # read 8.9e-8 to 1.7e-7 (qbit4, RandK) and 2.0e-5 (qbit8, likely
        # such a flip); the limit keeps 10x over the largest (PERF.md)
        if not dx < PAPER_DX_TOL:
            raise AssertionError(f"{label}: card and CPU runs disagree")


# The reference's CI rows on schedules (benchmarks/BENCH_BASELINE.json,
# admm/drop0.3:complete/q8+saga and admm/churn0.2:complete/q8+saga):
# rounds_to_tol 20 and these wire bytes; its gate allows 1.25 x 20.
# label -> (graph spec, packed, wire bytes, kernels the run must launch)
SCHEDULE_ROWS = (
    ("drop0.3", "drop:p=0.3,base=complete", True, 118, ("quantize_plane",)),
    ("drop0.3-tree", "drop:p=0.3,base=complete", False, 118,
     ("quantize_tensor", "dequantize_tensor")),
    ("churn0.2", "churn:p=0.2,base=complete", True, 126,
     ("quantize_plane",)),
    ("churn0.2-tree", "churn:p=0.2,base=complete", False, 126,
     ("quantize_tensor", "dequantize_tensor")),
)


def tree_estimator(prob, split):
    """SAGA on the two-leaf tree ``{"w1": [.., split], "w2": [..,
    n - split]}`` (one leaf ``{"w": ..}`` when ``split`` is None): the
    problem's gradient of the joined vector, split as the leaves."""
    import torch

    from repro_torch.core import vr

    def grads(p, b):
        if split is None:
            return {"w": prob.sample_grads(p["w"], b)}
        full = prob.sample_grads(torch.cat([p["w1"], p["w2"]], -1), b)
        return {"w1": full[..., :split], "w2": full[..., split:]}

    return vr.SagaTable(sample_grads=grads, m=prob.m)


def tree_x0(prob, split, dev):
    import torch

    if split is None:
        return {"w": torch.zeros((prob.n_agents, prob.n), device=dev)}
    return {"w1": torch.zeros((prob.n_agents, split), device=dev),
            "w2": torch.zeros((prob.n_agents, prob.n - split), device=dev)}


def flat_params(params):
    import torch

    from repro_torch.common.trees import tree_flatten

    return torch.cat([p.reshape(p.shape[0], -1)
                      for p in tree_flatten(params)[0]], dim=1)


def phase_paper_schedules(rounds, kind_rounds=30):
    """The two schedule rows, packed and with packed=false, through the
    kernels, counters zeroed and read around each run, then 20 rounds of
    each against the CPU; then ``kind_rounds`` rounds of every schedule
    kind, plane and pytree."""
    import numpy as np

    from repro_torch.bench import rounds_to_tol, run_solver
    from repro_torch.core import vr
    from repro_torch.core.schedule import build_graph
    from repro_torch.core.solver import make_solver
    from repro_torch.problems.logistic import LogisticProblem

    prob = LogisticProblem()
    data = prob.make_data(0)
    for label, gspec, packed, wire, used in SCHEDULE_ROWS:
        graph, ex = build_graph(gspec, prob.n_agents)
        if packed:
            est, params = (vr.SagaTable(sample_grads=prob.sample_grads,
                                        m=prob.m),
                           {"x": np.zeros(prob.n, np.float32)})
        else:
            est, params = (tree_estimator(prob, None),
                           {"w": np.zeros(prob.n, np.float32)})
        spec = (f"ltadmm:packed={str(packed).lower()},compressor=qbit:bits=8"
                + (",impl=kernel" if DEV == "cpu" else ""))

        def run(device, n_rounds):
            solver = make_solver(spec, graph, ex, est, device=device)
            x0 = None if packed else tree_x0(prob, None, device)
            return solver, run_solver(prob, data, solver, n_rounds,
                                      return_state=True, x0=x0)

        reset_counts()
        t0 = time.perf_counter()
        solver, (idx, gns, _) = run(DEV, rounds)
        sync()
        secs = time.perf_counter() - t0
        counts = read_counts()
        r2t = rounds_to_tol(idx, gns, 1e-8)
        wb = solver.wire_bytes(params)
        log(f"[paper] {label}: rounds_to_tol={r2t} (reference 20) final="
            f"{gns[-1]:.3e} wire_bytes_per_round={wb} (reference {wire}) "
            f"launches={ {k: v for k, v in counts.items() if v} } "
            f"host_s_per_round={secs / rounds:.5f}")
        if r2t is None or r2t > 25:
            raise AssertionError(f"{label}: rounds_to_tol {r2t} > 25")
        if wb != wire:
            raise AssertionError(f"{label}: wire bytes {wb} != {wire}")
        if DEV == "cuda" and not all(counts[u] > 0 for u in used):
            raise AssertionError(f"{label}: kernels {used} not launched")
        cpu, (_, g_cpu, st_cpu) = run("cpu", 20)
        dev, (_, g_dev, st_dev) = run(DEV, 20)
        dx = float((flat_params(dev.consensus_params(st_dev)).cpu()
                    - flat_params(cpu.consensus_params(st_cpu))).abs().max())
        log(f"[paper] {label}: card vs CPU after 20 rounds: max |dx| = "
            f"{dx:.3e}, ||gradF||^2 {g_dev[-1]:.3e} vs {g_cpu[-1]:.3e}")
        # the whole round (masks, selects, exchange) against the CPU: the
        # card's runs came within 7.9e-6 (PERF.md, Findings)
        if not dx < 1e-4:
            raise AssertionError(f"{label}: card and CPU runs disagree")
    # every schedule kind of make_schedule, plane and pytree, through the
    # kernels: kind_rounds rounds each must launch them and lower
    # ||grad F||²
    for gspec in ("cycle:ring|star", "gossip:edges=2,base=ring",
                  "burst:fail=0.2,recover=0.5",
                  "sample:frac=0.5,base=complete", "drop:p=0.3,base=ring",
                  "churn:p=0.3,base=complete,seed=1,period=8"):
        graph, ex = build_graph(gspec, prob.n_agents)
        for packed in (True, False):
            est = (vr.SagaTable(sample_grads=prob.sample_grads, m=prob.m)
                   if packed else tree_estimator(prob, 2))
            solver = make_solver(
                f"ltadmm:packed={str(packed).lower()},compressor=qbit:bits=8"
                + (",impl=kernel" if DEV == "cpu" else ""), graph, ex, est,
                device=DEV)
            reset_counts()
            _, gns = run_solver(prob, data, solver, kind_rounds,
                                x0=None if packed else tree_x0(prob, 2, DEV))
            counts = read_counts()
            used = (("quantize_plane", "dequantize_plane") if packed
                    else ("quantize_tensor", "dequantize_tensor"))
            log(f"[paper] {gspec} packed={packed}: ||gradF||^2 "
                f"{gns[0]:.3e} -> {gns[-1]:.3e} in {kind_rounds} rounds, "
                f"launches="
                f"{ {k: v for k, v in counts.items() if v} }")
            if not (np.isfinite(gns[-1]) and gns[-1] < gns[0]):
                raise AssertionError(f"{gspec}: ||gradF||^2 did not fall")
            if DEV == "cuda" and not all(counts[u] > 0 for u in used):
                raise AssertionError(f"{gspec}: kernels {used} not launched")


# The reference's combined-fault perf row (benchmarks/BENCH_BASELINE.json,
# admm/ring/q8+saga+faults, ``fault_sweep.SMOKE_FAULTS``): 68 B a round.
# Its file records rounds_to_tol 120, taken under jax's older
# (non-partitionable) Threefry mode; the live reference in the
# partitionable mode, whose draws the port follows, reaches 1e-8 at round
# 110 (tests/test_torch_faults.py holds the CPU run to it), 0.1 % under the
# tolerance: a card's rounding may give the next sample.  The reference's
# regression gate allows 1.25 x 120.
FAULT_ROW_WIRE, FAULT_ROW_R2T, FAULT_GATE = 68, (110, 120), 150
# the reference sweep's middle rates (benchmarks/fault_sweep.py SWEEP) and
# the live reference's rounds_to_tol at each (600 rounds, jax 0.9.0 on a
# CPU; the port's CPU run gives the same four)
FAULT_KIND_ROWS = (("drop", 0.05, 110), ("corrupt", 5e-3, 100),
                   ("stale", 0.05, 110), ("crash", 0.02, 110))
LEAD_FAULTS = ("lead:lr=0.1,compressor=qbit:bits=8,"
               "faults=faults:drop=0.05|corrupt=1e-3|crash=0.01|seed=0")


def with_impl(spec, impl="kernel"):
    """``spec`` with its compressor's ``impl`` (``bench.with_impl``:
    before a nested ``faults=``)."""
    from repro_torch.bench import with_impl as pin

    return pin(spec, impl)


def phase_paper_faults(rounds, kind_rounds):
    """Faults on the paper's problem through the kernels: the reference's
    combined-fault row by ``fault_sweep.smoke_row`` (counters zeroed and
    read around it), the same run on the CPU beside it, one row per fault
    kind at the sweep's middle rate, and LEAD qbit8 under the row's faults
    against the CPU."""
    import numpy as np

    from repro_torch import fault_sweep, paper_fig2
    from repro_torch.bench import rounds_to_tol, run_solver
    from repro_torch.core.schedule import build_graph
    from repro_torch.core.solver import make_solver
    from repro_torch.problems.logistic import LogisticProblem

    impl = "kernel" if DEV == "cpu" else None
    reset_counts()
    row = fault_sweep.smoke_row(rounds=rounds, device=DEV, impl=impl)
    counts = read_counts()
    r2t, wb = row["rounds_to_tol"], row["wire_bytes_per_round"]
    log(f"[paper] {row['name']} ({row['spec']}): rounds_to_tol={r2t} "
        f"(reference: {FAULT_ROW_R2T[0]} live, {FAULT_ROW_R2T[1]} in its "
        f"BENCH file) wire_bytes_per_round={wb} (reference "
        f"{FAULT_ROW_WIRE}) final={row['final_gradnorm_sq']:.3e} "
        f"cold_wall_s={row['cold_wall_s']} warm_wall_s={row['warm_wall_s']}"
        f" launches={ {k: v for k, v in counts.items() if v} }")
    if wb != FAULT_ROW_WIRE:
        raise AssertionError(f"faulted row: wire bytes {wb} != 68")
    if r2t not in FAULT_ROW_R2T:
        raise AssertionError(f"faulted row: rounds_to_tol {r2t} is neither "
                             f"of the reference's {FAULT_ROW_R2T}")
    if DEV == "cuda" and not (counts["quantize_plane"] > 0
                              and counts["dequantize_plane"] > 0):
        raise AssertionError("faulted row: K1/K5 not launched")
    # the same run on the CPU (the kernels' plain versions) beside it
    prob, data, dev = fault_sweep.solver_for(fault_sweep.SMOKE_FAULTS, DEV,
                                             impl=impl)
    _, _, cpu = fault_sweep.solver_for(fault_sweep.SMOKE_FAULTS, "cpu",
                                       impl="kernel")
    idx, g_dev, st_dev = run_solver(prob, data, dev, rounds,
                                    return_state=True)
    _, g_cpu, st_cpu = run_solver(prob, data, cpu, rounds, return_state=True)
    keep = (g_dev >= 1e-12) & (g_cpu >= 1e-12)
    dlog = float(np.max(np.abs(np.log10(g_dev[keep])
                               - np.log10(g_cpu[keep]))))
    log(f"[paper] faulted row on the CPU: rounds_to_tol="
        f"{rounds_to_tol(idx, g_cpu, 1e-8)} final={g_cpu[-1]:.3e}; card vs "
        f"CPU: max |d log10 gradF^2| = {dlog:.3e} over {int(keep.sum())} "
        f"samples >= 1e-12")
    if not dlog < 0.05:
        raise AssertionError("faulted row: card and CPU trajectories differ")
    for kind, rate, ref in FAULT_KIND_ROWS:
        reset_counts()
        r2t, final = fault_sweep._converge(f"faults:{kind}={rate:g},seed=0",
                                           kind_rounds, device=DEV, impl=impl)
        counts = read_counts()
        log(f"[paper] faults/{kind}={rate:g}: rounds_to_tol={r2t} (live "
            f"reference {ref}) final={final:.3e} launches="
            f"{ {k: v for k, v in counts.items() if v} }")
        if r2t is None or r2t > 1.25 * ref:
            raise AssertionError(f"faults/{kind}: rounds_to_tol {r2t}")
    # LEAD under the row's faults: K4/K5 on the faulted gossip
    graph, ex = build_graph("ring", prob.n_agents)
    est = paper_fig2._estimator("sgd", prob)
    lead = make_solver(LEAD_FAULTS if impl is None else with_impl(LEAD_FAULTS),
                       graph, ex, est, device=DEV)
    reset_counts()
    _, g_dev, st_dev = run_solver(prob, data, lead, 20, seed=999,
                                  return_state=True)
    counts = read_counts()
    cpu = make_solver(with_impl(LEAD_FAULTS), graph, ex, est, device="cpu")
    _, g_cpu, st_cpu = run_solver(prob, data, cpu, 20, seed=999,
                                  return_state=True)
    dx = float((lead.consensus_params(st_dev).cpu()
                - cpu.consensus_params(st_cpu)).abs().max())
    log(f"[paper] {LEAD_FAULTS}: card vs CPU after 20 iterations: max |dx| "
        f"= {dx:.3e}, ||gradF||^2 {g_dev[-1]:.3e} vs {g_cpu[-1]:.3e} "
        f"launches={ {k: v for k, v in counts.items() if v} }")
    if not (np.isfinite(g_dev[-1]) and dx < PAPER_DX_TOL):
        raise AssertionError("LEAD under faults: card and CPU disagree")
    if DEV == "cuda" and not (counts["quantize_tensor"] > 0
                              and counts["dequantize_tensor"] > 0):
        raise AssertionError("LEAD under faults: K4/K5 not launched")


# ---------------------------------------------------------------------------
# phase fig2: the paper's Fig.-2 comparison through the kernels
# ---------------------------------------------------------------------------

# The reference's own numbers for ``benchmarks/paper_fig2.py``: each
# method's ``solver.wire_bytes`` at n = 5 and ``run()``'s (time to 1e-8,
# floor), computed with jax 0.9.0 on a CPU.  The port draws the same data;
# its time and floor are printed beside these, and only the wire bytes
# must agree.
FIG2_REFERENCE = {
    "lt-admm-cc": (36, 12400.0, 3.35e-17),
    "lead+sgd": (18, math.inf, 2.43e-03),
    "cedas+sgd": (36, math.inf, 2.37e-03),
    "cold+sgd": (18, math.inf, 2.43e-03),
    "dpdc+sgd": (18, math.inf, 2.13e-03),
    "cold+full": (18, 16500.0, 1.27e-09),
    "dpdc+full": (18, 16500.0, 5.71e-15),
}
FIG2_ADMM_ROUNDS, FIG2_BASELINE_ITERS = 1200, 6000  # the reference's budget


def phase_fig2(admm_rounds, baseline_iters):
    """Every Fig.-2 method through ``paper_fig2.run_method`` (the
    runner's own per-method step), counters zeroed just before and read
    just after each; then 20 iterations of each against the CPU."""
    import numpy as np

    from repro_torch import paper_fig2
    from repro_torch.bench import run_solver
    from repro_torch.core.costmodel import CostModel
    from repro_torch.core.schedule import build_graph
    from repro_torch.core.solver import make_solver
    from repro_torch.problems.logistic import LogisticProblem

    prob = LogisticProblem()
    data = prob.make_data(0)
    graph, ex = build_graph("ring", prob.n_agents)
    cm = CostModel(t_g=1.0, t_c=10.0)
    counts = {}
    for name, (spec, kind) in paper_fig2.METHODS.items():
        est = paper_fig2._estimator(kind, prob)
        # impl=auto picks the kernels on the card; the CPU rehearsal asks
        # for the kernel route (the plain versions) explicitly
        solver = make_solver(spec + (",impl=kernel" if DEV == "cpu" else ""),
                             graph, ex, est, device=DEV)
        reset_counts()  # this method's run starts here
        t0 = time.perf_counter()
        _, ttt, floor = paper_fig2.run_method(name, prob, data, solver, cm,
                                              admm_rounds, baseline_iters)
        sync()
        secs = time.perf_counter() - t0
        counts[name] = read_counts()  # ... and ends here
        wire = solver.wire_bytes({"x": np.zeros(prob.n, np.float32)})
        ref_wire, ref_ttt, ref_floor = FIG2_REFERENCE[name]
        iters = admm_rounds if solver.name == "ltadmm" else baseline_iters
        log(f"[fig2] {name}: time_to_1e-8={ttt} floor={floor:.3e} "
            f"(reference {ref_ttt}, {ref_floor:.2e}) wire_bytes={wire} "
            f"iterations={iters} host_s={secs:.3f} "
            f"launches={ {k: v for k, v in counts[name].items() if v} }")
        if wire != ref_wire:
            raise AssertionError(f"{name}: wire bytes {wire} != {ref_wire}")
        if not math.isfinite(floor):
            raise AssertionError(f"{name}: floor {floor} is not finite")
        used = (("quantize_plane", "dequantize_plane")
                if solver.name == "ltadmm" else
                ("quantize_tensor", "dequantize_tensor"))
        if DEV == "cuda" and not all(counts[name][u] > 0 for u in used):
            raise AssertionError(f"{name}: kernels {used} not launched")
        if name == "lt-admm-cc" and not ttt < math.inf:
            raise AssertionError("LT-ADMM-CC did not reach 1e-8")
        # the same route on the CPU (the kernels' plain versions)
        cpu = make_solver(spec + ",impl=kernel", graph, ex, est, device="cpu")
        seed = 12345 if solver.name == "ltadmm" else 999
        _, g_cpu, st_cpu = run_solver(prob, data, cpu, 20, metric_every=10,
                                      seed=seed, return_state=True)
        _, g_dev, st_dev = run_solver(prob, data, solver, 20,
                                      metric_every=10, seed=seed,
                                      return_state=True)
        x_dev = solver.consensus_params(st_dev).cpu()
        dx = float((x_dev - cpu.consensus_params(st_cpu)).abs().max())
        log(f"[fig2] {name}: card vs CPU after 20 iterations: max |dx| = "
            f"{dx:.3e}, ||gradF||^2 {g_dev[-1]:.3e} vs {g_cpu[-1]:.3e}")
        # the card read 2.2e-8 to 7.2e-6 (baselines) and 2.0e-5
        # (LT-ADMM-CC, the ring row's qbit8 run)
        if not dx < PAPER_DX_TOL:
            raise AssertionError(f"{name}: card and CPU runs disagree")
    return counts


# ---------------------------------------------------------------------------
# phase 5: the main path at real width, then kernel timings
# ---------------------------------------------------------------------------

# label -> (spec, estimator kind, kernels the run must launch, graph,
# whether x0 is the two-leaf tree {"w1": [10, WIDE_SPLIT], "w2": [10,
# n - WIDE_SPLIT]} (else the packed plane), launches per round the run
# must show exactly (None: any))
WIDE_SPLIT = 4096
DROP_SPEC = "drop:p=0.3,base=complete,seed=0"
CHURN_SPEC = "churn:p=0.2,base=complete,seed=0"
WIDE_FAULTS = "faults=faults:drop=0.05|corrupt=1e-3|stale=0.02|crash=0.01|seed=0"
# personalization_sweep.DADA_SPEC (phase_dada holds them equal)
DADA_SPEC = ("dada:lr=0.05,mu=0.5,lambda_g=0.05,graph_every=5,"
             "degree_cap=3,batch_size=8")
WIDE_SPECS = (
    # 2 K1 a round (the x- and z-planes)
    ("qbit8", "ltadmm:compressor=qbit:bits=8", "saga",
     ("quantize_plane", "dequantize_plane"), "ring", False,
     {"quantize_plane": 2}),
    ("qbit4", "ltadmm:compressor=qbit:bits=4", "saga",
     ("quantize_plane", "dequantize_plane"), "ring", False,
     {"quantize_plane": 2}),
    # 2 K2 and 4 K3 a round, all through the pull variant (n = 2^20)
    ("randk-stride",
     "ltadmm:eta=0.5,compressor=randk:fraction=0.6,sampler=stride", "saga",
     ("randk_gather_plane", "randk_scatter_plane"), "ring", False,
     {"randk_gather_plane_pull": 2, "randk_scatter_plane_pull": 4,
      "randk_gather_plane_push": 0, "randk_scatter_plane_push": 0}),
    # 1 K4 and 1 K5 an iteration
    ("lead-qbit8", "lead:lr=0.1,compressor=qbit:bits=8", "sgd",
     ("quantize_tensor", "dequantize_tensor"), "ring", False,
     {"quantize_tensor": 1, "dequantize_tensor": 1}),
    # 1 K6 and 1 K7 an iteration, K7 through its unique variant
    ("choco-topk", "choco:compressor=topk:fraction=0.25", "sgd",
     ("sparse_gather", "sparse_scatter"), "ring", False,
     {"sparse_gather": 1, "sparse_scatter_unique": 1,
      "sparse_scatter_claim": 0}),
    # Fig. 1's RandK setting with the uniform sampler: at eta = 1 and
    # fraction 0.25 LT-ADMM-CC diverges on this problem, in the reference
    # too
    # (2 K6 and 4 K7 a round, K7 through its unique variant)
    ("randk-uniform",
     "ltadmm:eta=0.5,compressor=randk:fraction=0.6,sampler=uniform", "saga",
     ("sparse_gather", "sparse_scatter"), "ring", False,
     {"sparse_gather": 2, "sparse_scatter_unique": 4,
      "sparse_scatter_claim": 0}),
    # the packed schedule round: K1 on [10, 15, 2^20] x- and z-planes
    ("drop-qbit8", "ltadmm:compressor=qbit:bits=8", "saga",
     ("quantize_plane", "dequantize_plane"), DROP_SPEC, False,
     {"quantize_plane": 2}),
    # the tree schedule round: per leaf 2 K8 and 4 K9
    ("churn-tree-randk-block",
     "ltadmm:eta=0.5,packed=false,compressor=randk:fraction=0.6,"
     "sampler=block", "saga", ("cyclic_gather", "cyclic_scatter"),
     CHURN_SPEC, True, {"cyclic_gather": 4, "cyclic_scatter": 8}),
    # the static tree round: per leaf 2 K4 and 4 K5
    ("ring-tree-qbit8", "ltadmm:packed=false,compressor=qbit:bits=8",
     "saga", ("quantize_tensor", "dequantize_tensor"), "ring", True,
     {"quantize_tensor": 4, "dequantize_tensor": 8}),
    # the baselines' schedule gossip: 1 K8 and 1 K9 per iteration
    ("choco-drop-randk-block",
     "choco:compressor=randk:fraction=0.6,sampler=block", "sgd",
     ("cyclic_gather", "cyclic_scatter"), DROP_SPEC, False,
     {"cyclic_gather": 1, "cyclic_scatter": 1}),
    # every fault kind on the ring: the sealed, faulted schedule round
    # launches K1 and K5 as the unfaulted ring does (2 and 4 a round),
    # on [10, 2, 2^20] per-edge x- and z-planes
    ("ring-faults-qbit8", "ltadmm:compressor=qbit:bits=8," + WIDE_FAULTS,
     "saga", ("quantize_plane", "dequantize_plane"), "ring", False,
     {"quantize_plane": 2, "dequantize_plane": 4}),
    # the learned graph's compressed round: the mirrors' innovation
    # through the per-message route, 1 K4 and 1 K5 a round, and the
    # [10, 9, 2^20] gathered mirrors on the complete graph
    ("dada-qbit8", DADA_SPEC + ",compressor=qbit:bits=8", "sgd",
     ("quantize_tensor", "dequantize_tensor"), "complete", False,
     {"quantize_tensor": 1, "dequantize_tensor": 1}),
)


def wide_data(prob, dev):
    """LIBSVM-style rows: Gaussian, scaled to unit norm."""
    import torch

    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((prob.n_agents, prob.m, prob.n), generator=g, device=dev)
    a /= torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    u = torch.rand((prob.n_agents, prob.m), generator=g, device=dev)
    return {"a": a, "b": torch.where(u < 0.5, 1.0, -1.0)}


def wide_solver(label, prob, dev):
    """``(solver, x0, graph spec, kernels, launches per round)`` of the
    wide spec ``label``."""
    import torch

    from repro_torch.core.schedule import build_graph
    from repro_torch.core.solver import make_solver
    from repro_torch.paper_fig2 import _estimator

    _, spec, kind, used, gspec, tree, per_round = next(
        w for w in WIDE_SPECS if w[0] == label)
    graph, ex = build_graph(gspec, prob.n_agents)
    if tree:
        est, x0 = (tree_estimator(prob, WIDE_SPLIT),
                   tree_x0(prob, WIDE_SPLIT, dev))
    else:
        est, x0 = (_estimator(kind, prob),
                   torch.zeros((prob.n_agents, prob.n), device=dev))
    # the CPU rehearsal asks for the kernel route (the plain versions)
    spec = with_impl(spec) if DEV == "cpu" else spec
    return (make_solver(spec, graph, ex, est, device=DEV), x0, gspec, used,
            per_round)


# counter name -> (kernel id, the module holding the wrapper, its plain
# version's name in the module's ``ref``)
MAIN_PATH_WRAPPERS = {
    "quantize_plane": ("K1", "quantize", "quantize_plane_ref"),
    "randk_gather_plane": ("K2", "sparse_gather", "randk_gather_plane_ref"),
    "randk_scatter_plane": ("K3", "sparse_gather", "randk_scatter_plane_ref"),
    "quantize_tensor": ("K4", "quantize", "quantize_tensor_ref"),
    "dequantize_tensor": ("K5", "quantize", "dequantize_tensor_ref"),
    "dequantize_plane": ("K5", "quantize", "dequantize_plane_ref"),
    "sparse_gather": ("K6", "sparse_gather", "sparse_gather_ref"),
    "sparse_scatter": ("K7", "sparse_gather", "sparse_scatter_ref"),
    "cyclic_gather": ("K8", "sparse_gather", "cyclic_gather_ref"),
    "cyclic_scatter": ("K9", "sparse_gather", "cyclic_scatter_ref"),
}


def _shape_key(args, kwargs):
    """A call's tensor arguments' shapes and int arguments, in order."""
    import torch

    return tuple(tuple(a.shape) if isinstance(a, torch.Tensor) else a
                 for a in (*args, *kwargs.values())
                 if isinstance(a, torch.Tensor)
                 or (isinstance(a, int) and not isinstance(a, bool)))


def _show(key):
    return str([list(a) if isinstance(a, tuple) else a for a in key])


class MainPathTap:
    """Installed around a main-path run, each wrapper of ``wrappers``
    (default ``MAIN_PATH_WRAPPERS``) is called through a stand-in: the
    wrapper runs and counts its launch as always, and ``by_shape`` counts
    the calls per shape.  While ``checking`` is set, each call's result is
    held against its plain version on the same inputs, bit for bit, or by
    the entry's ``hold(got, want, label)`` where it names one (its
    readings land in ``readings``); the plain version's own launches, if
    any, are taken back off the counters."""

    def __init__(self, wrappers=None):
        import importlib

        self.saved = []
        self.by_shape = {}  # (name, shapes) -> calls
        self.checked = {}  # (name, shapes) -> calls held
        self.readings = {}  # name -> the holds' readings
        self.checking = False
        for name, (kid, pkg, plain, *hold) in (
                wrappers or MAIN_PATH_WRAPPERS).items():
            ops = importlib.import_module(f"repro_torch.kernels.{pkg}.ops")
            ref = importlib.import_module(f"repro_torch.kernels.{pkg}.ref")
            fn = getattr(ops, name)
            self.saved.append((ops, name, fn))
            setattr(ops, name, self._wrap(
                name, kid, fn,
                getattr(ref, plain) if isinstance(plain, str) else plain,
                hold[0] if hold else None))

    def _wrap(self, name, kid, fn, plain, hold):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            key = (name, _shape_key(args, kwargs))
            self.by_shape[key] = self.by_shape.get(key, 0) + 1
            if self.checking:
                before = read_counts()
                kw = {k: v for k, v in kwargs.items() if k != "unique"}
                want = plain(*args, **kw)
                sync()
                set_counts(before)
                if hold is not None:
                    self.readings.setdefault(name, []).append(
                        hold(out, want, f"{name} at {key[1]}"))
                for g, w in zip(*(o if isinstance(o, tuple) else (o,)
                                  for o in (out, want))):
                    if hold is not None:
                        break
                    note_err(kid, g, w)
                    if not same_bits(g, w):
                        raise AssertionError(
                            f"{kid} {name} at {key[1]} on the main path: "
                            f"differs from its plain version")
                self.checked[key] = self.checked.get(key, 0) + 1
            return out

        # the wrapper counts through its module's name, which now holds
        # ``call``: the counts live here until ``close`` hands them back
        for a in _attrs(fn):
            setattr(call, a, getattr(fn, a))
        return call

    def close(self):
        for ops, name, fn in self.saved:
            for a in _attrs(fn):
                setattr(fn, a, getattr(getattr(ops, name), a))
            setattr(ops, name, fn)


def phase_wide(rounds, warm=2, check_round=1):
    import torch

    from repro_torch.core import jaxrand
    from repro_torch.problems.logistic import LogisticProblem

    prob = LogisticProblem(n=WIDE_N)
    dev = torch.device(DEV)
    data = wide_data(prob, dev)
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    counts = {}  # per spec: launches over its main-path rounds
    shapes = {}  # per spec: (wrapper, shapes) -> calls
    means = {}  # per spec: mean round time after the warm-up
    for label, *_ in WIDE_SPECS:
        solver, x0, gspec, used, per_round = wide_solver(label, prob, dev)
        tap = MainPathTap()
        try:
            reset_counts()  # this spec's main-path run starts here
            st = solver.init(x0)
            base = jaxrand.key(12345)
            gns, times = [], []
            for i in range(rounds):
                # round 0 starts from zero messages: hold round 1's
                tap.checking = i == check_round
                sync()
                t0 = time.perf_counter()
                st = solver.step(st, data, jaxrand.fold_in(base, i))
                sync()
                times.append(time.perf_counter() - t0)
                if i in (0, rounds - 1):
                    xbar = torch.mean(
                        flat_params(solver.consensus_params(st)), dim=0)
                    gns.append(float(prob.global_grad_norm_sq(xbar, data)))
            counts[label] = read_counts()  # ... and ends here
        finally:
            tap.close()
        shapes[label] = tap.by_shape
        mean_s = sum(times[warm:]) / len(times[warm:])
        log(f"[wide] {label} on {gspec}: n={prob.n} rounds={rounds} "
            f"mean_round_ms={mean_s * 1e3:.3f} (host clock, after {warm} "
            f"warm-up rounds) gradF^2 first={gns[0]:.6e} last={gns[-1]:.6e}"
            f" launches={ {k: v for k, v in counts[label].items() if v} }")
        if tap.by_shape:
            log(f"[wide] {label}: round {check_round}'s kernel calls "
                "bit-equal to their plain versions on the same inputs: "
                + ", ".join(f"{MAIN_PATH_WRAPPERS[nm][0]} {nm} "
                            f"{_show(sh)} x{c}"
                            for (nm, sh), c in tap.checked.items()))
        unchecked = set(tap.by_shape) - set(tap.checked)
        if unchecked:
            raise AssertionError(f"wide {label}: calls at {unchecked} were "
                                 f"not in round {check_round}")
        if not (math.isfinite(gns[-1]) and gns[-1] < gns[0]):
            raise AssertionError(f"wide {label}: ||gradF||^2 did not fall")
        if DEV == "cuda" and not all(counts[label][u] > 0 for u in used):
            raise AssertionError(f"wide {label}: kernels {used} not launched")
        for kname, per in (per_round or {}).items():
            if DEV == "cuda" and counts[label][kname] != per * rounds:
                raise AssertionError(
                    f"wide {label}: {counts[label][kname]} {kname} "
                    f"launches, expected {per} per round")
        means[label] = mean_s
        del st, solver
    log(f"[wide] ring-faults-qbit8 round {means['ring-faults-qbit8'] * 1e3:.3f}"
        f" ms beside the unfaulted ring qbit8 round "
        f"{means['qbit8'] * 1e3:.3f} ms (x"
        f"{means['ring-faults-qbit8'] / means['qbit8']:.3f}, host clock)")
    if DEV == "cuda":
        log(f"[wide] max_memory_allocated="
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        del data
        torch.cuda.empty_cache()
    return counts, shapes


# ---------------------------------------------------------------------------
# phase serve: the serving path at full width (K10 in the prefill, K11 in
# the Mamba blocks' kernel path)
# ---------------------------------------------------------------------------

# arch -> (prefill batch, prefill length, greedy batch, prompt, new tokens);
# the launches per prefill follow from the config (one K10 per attention
# block: qwen3-0.6b's 28 layers, zamba2-2.7b's 9 shared-block calls) and
# its Mamba blocks give the K11 runs (zamba2-2.7b: 54)
SERVE_MODELS = {"qwen3-0.6b": (4, 2048, 4, 64, 32),
                "zamba2-2.7b": (2, 2048, 4, 32, 16)}
SERVE_EXPECT = {"qwen3-0.6b": (28, 0), "zamba2-2.7b": (9, 54)}
# f32 prefill logits against token-by-token decode_step logits, max |d|
# at every position (qwen3-0.6b, B = 1, T = 256).  The same comparison on
# the CPU at 2 layers read 3.2e-6 (logit scale 3.27); the card at full
# depth read 5.72e-6, and the limit is 17x that (PERF.md, Findings),
# under the ~1e-3 that TF32's 2^-11 rounding would give at this logit
# scale.  The reference's test_prefill_decode_consistency allows 2e-2
CONSISTENCY_T, CONSISTENCY_TOL = 256, 1e-4
SMOKE = False  # the rehearsal serves the smoke configs


def k10_plain(q, k, v, mask=None, *, causal=True, window=None):
    from repro_torch.kernels.flash_attention import ref

    return ref.flash_attention_plain(q, k, v, causal=causal, window=window)


def k11_plain(cfg, x, bmat, cmat, alog, h0=None):
    from repro_torch.kernels.ssm_scan import ref

    return ref.ssd_scan_plain(x, alog, bmat, cmat,
                              chunk=min(cfg.chunk, x.shape[1]))


# the serving path's kernels for ``MainPathTap``: held within their limits
# (K11's by ``serve_k11``, which names the variant each run takes)
SERVE_WRAPPERS = {
    "flash_attention": ("K10", "flash_attention", k10_plain, hold_k10),
}


def serve_model(arch_id, dtype=None):
    """(arch, cfg, params): the config with ``use_flash``, the port's
    init_params(key(0)) weights on the device, in ``dtype`` (default the
    config's)."""
    import dataclasses

    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.core import jaxrand
    from repro_torch.launch.steps import model_specs
    from repro_torch.models import transformer as tr
    from repro_torch.models.common import init_params

    arch = ARCHS[arch_id]
    cfg = arch.make_smoke() if SMOKE else arch.make(None)
    cfg = dataclasses.replace(cfg, use_flash=True, dtype=dtype or cfg.dtype)
    t0 = time.perf_counter()
    params = tr.model_params(cfg, init_params(
        jaxrand.key(0, DEV), model_specs(arch, cfg), dtype=cfg.dtype))
    sync()
    n = sum(p.numel() for p in params.parameters())
    log(f"[serve] {arch_id}: {n} weights, "
        f"{n * torch.finfo(cfg.dtype).bits / 8e9:.3f} GB in {cfg.dtype}, "
        f"drawn by init_params on {DEV} in {time.perf_counter() - t0:.2f} s")
    return arch, cfg, params


def host_ms(fn, iters):
    """Mean host-clock ms of ``fn()`` after one warm-up call, each call
    ended by a synchronize."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t0) * 1e3 / iters


def profile_window(fn):
    """torch.profiler over ``fn()``: (device ms by kernel name, wall ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.name] = (by_kernel.get(e.name, 0.0)
                                 + e.time_range.elapsed_us() / 1e3)
    return by_kernel, wall


def prefill_ms(fn):
    """Host-clock ms of the prefill ``fn`` with K10's tensor-core variant
    (the wrapper's own route) and with its CUDA-core kernel in its place
    (the route forced to "cc" for this comparison only), timed in
    turns tc, cc, cc, tc on this card: {variant: [ms, ms]}."""
    from repro_torch.kernels.flash_attention import ops

    route, times = ops.route, {"tc": [], "cc": []}
    try:
        for variant in ("tc", "cc", "cc", "tc"):
            ops.route = route if variant == "tc" else (lambda *a: "cc")
            times[variant].append(host_ms(fn, 3))
    finally:
        ops.route = route
    return times


def held_cc_prefill(arch_id, fn, n_attn, last):
    """The prefill ``fn`` once with ``route`` forced to "cc", as
    ``prefill_ms`` times it, under a ``MainPathTap``: every K10 call held
    within one bf16 ulp of its plain version and, on the card, exactly
    ``n_attn`` launches of the CUDA-core kernel and none of the
    tensor-core one.  Logs its last logits against ``last``, the
    tensor-core prefill's."""
    import torch

    from repro_torch.kernels.flash_attention import ops

    kid, pkg, plain, _ = SERVE_WRAPPERS["flash_attention"]
    before = read_counts()
    tap = MainPathTap({"flash_attention": (
        kid, pkg, plain, lambda g, w, lab: hold_k10(g, w, lab, "cc"))})
    tap.checking = True
    route = ops.route
    try:
        ops.route = lambda *a: "cc"
        with torch.no_grad():
            cc_last = fn()
        sync()
    finally:
        ops.route = route
        tap.close()
    after = read_counts()
    moved = {n: after[f"flash_attention_{n}"] - before[f"flash_attention_{n}"]
             for n in ("tc", "cc")}
    readings = tap.readings.get("flash_attention", [])
    d = float((cc_last.float() - last.float()).abs().max())
    log(f"[serve] {arch_id} prefill with the CUDA-core K10 forced: "
        f"launches {moved}, {len(readings)} calls held against their plain "
        f"version: {sorted(set(readings))[:4]}; last logits vs the "
        f"tensor-core prefill's max |d| {d:.4e}")
    if len(readings) != n_attn or (DEV == "cuda"
                                   and moved != {"tc": 0, "cc": n_attn}):
        raise AssertionError(f"{arch_id}: forced-cc prefill launched "
                             f"{moved}, held {len(readings)}, expected "
                             f"{n_attn} CUDA-core")


def profile_prefill(label, fn, wall_ms):
    """One prefill under the profiler: device time by kernel, K10's share
    of the device busy time and of the prefill's (unprofiled) wall time,
    and the device's idle share of that wall time."""
    by_kernel, _ = profile_window(fn)
    busy = sum(by_kernel.values())
    k10 = sum(ms for name, ms in by_kernel.items() if "flash_kernel" in name)
    log(f"[serve] {label} prefill profile: device busy {busy:.3f} ms, K10 "
        f"{k10:.3f} ms = {k10 / busy:.1%} of the device time and "
        f"{k10 / wall_ms:.1%} of the prefill's {wall_ms:.3f} ms; idle "
        f"share {1 - busy / wall_ms:.3f}")
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]:
        log(f"[serve] {label} kernel {ms:9.4f} ms {ms / busy:6.1%}  "
            f"{name[:100]}")


def profile_decode(label, arch, cfg, params, batch, steps=4):
    """Greedy decode steps under the profiler: device busy time against
    the wall time (a step's host work shows as idle device time)."""
    import torch

    from repro_torch.launch.steps import build_serve

    serve_fn, init_cache = build_serve(arch, cfg)
    cache = init_cache(batch, 2 * steps, torch.device(DEV))
    tok = torch.zeros((batch,), dtype=torch.long, device=DEV)

    def run(first):
        for pos in range(first, first + steps):
            serve_fn(params, cache, {"token": tok, "pos": pos})

    run(0)
    by_kernel, wall = profile_window(lambda: run(steps))
    busy = sum(by_kernel.values())
    log(f"[serve] {label} decode profile over {steps} steps (B={batch}): "
        f"wall {wall / steps:.3f} ms a step, device busy "
        f"{busy / steps:.3f} ms a step, idle share {1 - busy / wall:.3f}")


def phase_serve():
    """Each served model at full width: the prefill step through K10
    (counts zeroed just before and read just after; every K10 call held
    against its plain version), its Mamba blocks' inputs run again through
    K11 (every call held), the prefill without the kernel, qwen3-0.6b's f32
    prefill against token-by-token decoding, and the greedy server."""
    import dataclasses

    import torch

    from repro_torch.core import jaxrand
    from repro_torch.launch import serve
    from repro_torch.launch.steps import build_prefill
    from repro_torch.models.mamba import Mamba

    counts = {}
    for arch_id, (pb, pt, gb, gp, gg) in SERVE_MODELS.items():
        if SMOKE:
            pb, pt, gb, gp, gg = 2, 64, 2, 8, 4
        arch, cfg, params = serve_model(arch_id)
        n_attn = cfg.n_units * (cfg.pattern.count("attn")
                                + int(cfg.shared_attn))
        n_mamba = cfg.n_units * cfg.pattern.count("mamba")
        if not SMOKE and (n_attn, n_mamba) != SERVE_EXPECT[arch_id]:
            raise AssertionError(f"{arch_id}: {n_attn} attention and "
                                 f"{n_mamba} Mamba blocks")
        tokens = jaxrand.randint(jaxrand.key(1, DEV), (pb, pt), 0, cfg.vocab)
        prefill = build_prefill(arch, cfg)
        mamba_in = []
        hooks = [m.register_forward_hook(
            lambda mod, args, out: mamba_in.append((mod, args[0])))
            for m in params.modules() if isinstance(m, Mamba)]
        tap = MainPathTap(SERVE_WRAPPERS)
        tap.checking = True
        try:
            reset_counts()  # this model's prefill starts here
            with torch.no_grad():
                last = prefill(params, {"tokens": tokens})
            sync()
            after = read_counts()  # ... and ends here
            n_k10, n_tc = (after["flash_attention"],
                           after["flash_attention_tc"])
        finally:
            tap.close()
            for h in hooks:
                h.remove()
        calls = sum(c for (nm, _), c in tap.by_shape.items()
                    if nm == "flash_attention")
        readings = tap.readings.get("flash_attention", [])
        log(f"[serve] {arch_id} prefill B={pb} T={pt}: K10 launches {n_k10}"
            f" ({n_tc} of the tensor-core variant), calls {calls} "
            f"(attention blocks {n_attn}); every call held against its "
            f"plain version: {sorted(set(readings))[:4]}")
        if calls != n_attn or len(readings) != n_attn:
            raise AssertionError(f"{arch_id}: {calls} K10 calls, "
                                 f"{len(readings)} held, {n_attn} blocks")
        if DEV == "cuda" and not n_k10 == n_tc == n_attn:
            raise AssertionError(f"{arch_id}: {n_k10} K10 launches ({n_tc} "
                                 f"tensor-core) in the prefill, expected "
                                 f"{n_attn} tensor-core")
        if tuple(last.shape) != (pb, 1, cfg.vocab) or not bool(
                torch.isfinite(last.float()).all()):
            raise AssertionError(f"{arch_id}: prefill logits bad")
        counts[arch_id] = {"flash_attention": n_tc}
        held_cc_prefill(arch_id, lambda: prefill(params, {"tokens": tokens}),
                        n_attn, last)
        with torch.no_grad():
            if DEV == "cuda":
                times = prefill_ms(lambda: prefill(params,
                                                   {"tokens": tokens}))
                ms = sum(times["tc"]) / 2
                cc = sum(times["cc"]) / 2
                profile_prefill(
                    arch_id, lambda: prefill(params, {"tokens": tokens}), ms)
                log(f"[serve] {arch_id} prefill: {ms:.3f} ms, "
                    f"{pb * pt / ms * 1e3:.1f} tok/s (host clock, after a "
                    f"warm-up); with the CUDA-core K10 in its place "
                    f"{cc:.3f} ms, {pb * pt / cc * 1e3:.1f} tok/s (turns "
                    f"tc {times['tc'][0]:.3f}, cc {times['cc'][0]:.3f}, cc "
                    f"{times['cc'][1]:.3f}, tc {times['tc'][1]:.3f} ms)")
            # the same prefill without the kernel (dense sdpa)
            plain = build_prefill(arch, dataclasses.replace(
                cfg, use_flash=False))(
                params, {"tokens": tokens})
            d = float((last.float() - plain.float()).abs().max())
            agree = float((last.argmax(-1) == plain.argmax(-1)).float()
                          .mean())
            log(f"[serve] {arch_id} prefill use_flash=False vs True: last "
                f"logits max |d| {d:.4e} (scale "
                f"{float(plain.float().abs().max()):.3f}), argmax agreement "
                f"{agree:.3f}")
            del plain
            if mamba_in:
                counts[arch_id]["ssd_chunked"] = serve_k11(arch_id, cfg,
                                                           mamba_in, n_mamba)
            del mamba_in
            if arch_id == "qwen3-0.6b":
                del params
                counts["f32"] = consistency(arch_id)
                _, _, params = serve_model(arch_id)
            prompt = jaxrand.randint(jaxrand.key(0, DEV), (gb, gp), 0,
                                     cfg.vocab)
            serve.generate(arch, cfg, params, prompt, 2)  # warm-up
            out, secs = serve.generate(arch, cfg, params, prompt, gg)
            log(f"[serve] {arch_id} greedy server B={gb} prompt={gp} "
                f"new={gg}: {secs * 1e3 / gg:.3f} ms per decode step, "
                f"{gb * gg / secs:.1f} tok/s (host clock, after a warm-up); "
                f"tokens: {' '.join(map(str, out[0].tolist()))}")
            if tuple(out.shape) != (gb, gg):
                raise AssertionError(f"{arch_id}: greedy tokens {out.shape}")
            if DEV == "cuda":
                profile_decode(arch_id, arch, cfg, params, gb)
        del params, last
        if DEV == "cuda":
            torch.cuda.empty_cache()
    return counts


@contextlib.contextmanager
def forced_k11(variant):
    """Route K11 to ``variant`` inside the block: the script swaps
    ``route`` in the wrapper module, as ``forced_push`` does for K2/K3."""
    from repro_torch.kernels.ssm_scan import ops

    saved = ops.route
    ops.route = lambda *args, **kwargs: variant
    try:
        yield
    finally:
        ops.route = saved


def serve_k11(arch_id, cfg, mamba_in, n_mamba):
    """Each Mamba block's prefill input through ``mamba_forward(...,
    use_kernel=True)``, twice: as ``route`` sends it (the tensor-core
    variant), then with the CUDA-core variant forced; each run counted
    (zeroed before, read after) and every call held against its plain
    version.  The jnp path's distance is printed as a reading only (in
    bf16 its cumulative decay is rounded to bf16).  On the card, each
    variant's 54 calls are profiled again without the checks: K11's
    device time and the idle share.  Returns {variant: launches}."""
    import functools

    launches = {}
    for variant in ("tc", "cc"):
        tap = MainPathTap({"ssd_chunked": (
            "K11", "ssm_scan", k11_plain,
            functools.partial(hold_k11, variant=variant))})
        tap.checking = True
        try:
            with (forced_k11("cc") if variant == "cc"
                  else contextlib.nullcontext()):
                reset_counts()  # the Mamba blocks' kernel path starts here
                outs = [mod(x, use_kernel=True) for mod, x in mamba_in]
                sync()
                after = read_counts()  # ... and ends here
        finally:
            tap.close()
        readings = tap.readings.get("ssd_chunked", [])
        n_tc, n_cc = after["ssd_chunked_tc"], after["ssd_chunked_cc"]
        launches[variant] = n_tc if variant == "tc" else n_cc
        log(f"[serve] {arch_id} Mamba blocks through K11"
            f"{' (CUDA-core variant forced)' if variant == 'cc' else ''}: "
            f"launches {after['ssd_chunked']} (tensor-core {n_tc}, CUDA-core "
            f"{n_cc}), calls {len(outs)} (blocks {n_mamba}), every call "
            f"held: {sorted(set(readings))[:3]}")
        if len(outs) != n_mamba or len(readings) != n_mamba:
            raise AssertionError(f"{arch_id}: {len(readings)} K11 calls held"
                                 f", {n_mamba} blocks")
        want = (n_mamba, 0) if variant == "tc" else (0, n_mamba)
        if DEV == "cuda" and (n_tc, n_cc) != want:
            raise AssertionError(f"{arch_id}: K11 launches tensor-core {n_tc}"
                                 f", CUDA-core {n_cc}, expected {want}")
        if variant == "tc":
            dist = []
            for (mod, x), y in zip(mamba_in, outs):
                y_jnp = mod(x, use_kernel=False)
                dist.append((float((y.float() - y_jnp.float()).abs().max()),
                             float(y.float().abs().max())))
            worst = max(dist)
            log(f"[serve] {arch_id} K11 path vs the jnp path in {cfg.dtype} "
                f"(reading only): max |d| {worst[0]:.4e} at output scale "
                f"{worst[1]:.3f}; mean over blocks "
                f"{sum(d for d, _ in dist) / len(dist):.4e}")
        del outs
    if DEV == "cuda":
        for variant in ("tc", "cc"):
            profile_k11(arch_id, mamba_in, variant)
    return launches


# K11's CUDA kernels by variant, as a profile names them
K11_KERNELS = {"tc": ("ssd_state_kernel", "ssd_pass_kernel",
                      "ssd_output_kernel"),
               "cc": ("ssd_kernel<",)}


def profile_k11(arch_id, mamba_in, variant):
    """torch.profiler over the Mamba blocks' kernel path (one warm-up pass
    first): K11's device time by kernel, the window's wall and device
    busy time, and the idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def run():
        with (forced_k11("cc") if variant == "cc"
              else contextlib.nullcontext()):
            for mod, x in mamba_in:
                mod(x, use_kernel=True)

    run()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        sync()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        for k in K11_KERNELS[variant]:
            if k in e.name:
                by_name[k] = by_name.get(k, 0.0) + e.time_range.elapsed_us()
    k11 = sum(by_name.values()) / 1e3
    log(f"[serve] {arch_id} K11 profile ({variant}), {len(mamba_in)} Mamba "
        f"blocks: wall {wall * 1e3:.3f} ms, device busy {busy:.3f} ms, idle "
        f"share {1 - busy / (wall * 1e3):.3f}; K11 {k11:.3f} ms on the device"
        f" ({k11 / len(mamba_in):.4f} ms a block: "
        + ", ".join(f"{k.rstrip('<')} {v / 1e3 / len(mamba_in):.4f}"
                    for k, v in sorted(by_name.items())) + ")")
    if not by_name:
        raise AssertionError(f"K11 ({variant}) left no kernel in the "
                             "profile")


def consistency(arch_id):
    """The f32 prefill's logits at every position against token-by-token
    ``decode_step`` logits (the reference's test_prefill_decode_consistency
    at full width).  Returns the f32 prefill's K10 launches, all of the
    CUDA-core variant (counts zeroed just before it, read just after)."""
    import torch

    from repro_torch.core import jaxrand
    from repro_torch.launch.steps import build_serve
    from repro_torch.models import transformer as tr

    arch, cfg, params = serve_model(arch_id, dtype=torch.float32)
    t = 16 if SMOKE else CONSISTENCY_T
    tokens = jaxrand.randint(jaxrand.key(1, DEV), (1, t), 0, cfg.vocab)
    with torch.no_grad():
        reset_counts()  # the f32 prefill starts here
        full = tr.forward(params, cfg, tokens=tokens)
        sync()
        after = read_counts()  # ... and ends here
        step, init_cache = build_serve(arch, cfg)
        cache = init_cache(1, t, tokens.device)
        worst = 0.0
        for pos in range(t):
            lg, cache = step(params, cache, {"token": tokens[:, pos],
                                             "pos": pos})
            worst = max(worst, float((lg[:, 0] - full[:, pos]).abs().max()))
    log(f"[serve] {arch_id} f32 prefill vs decode_step over {t} positions: "
        f"max |d| {worst:.4e} (limit {CONSISTENCY_TOL}; logit scale "
        f"{float(full.abs().max()):.3f})")
    if not worst <= CONSISTENCY_TOL:
        raise AssertionError(f"{arch_id}: prefill and decode disagree by "
                             f"{worst}")
    n_attn = cfg.n_units * cfg.pattern.count("attn")
    log(f"[serve] {arch_id} f32 prefill: K10 launches "
        f"{after['flash_attention']} ({after['flash_attention_cc']} of the "
        f"CUDA-core variant, attention blocks {n_attn})")
    if DEV == "cuda" and not (after["flash_attention"]
                              == after["flash_attention_cc"] == n_attn):
        raise AssertionError(f"{arch_id}: f32 prefill K10 launches {after}")
    return after["flash_attention_cc"]


def time_serve_kernels(counts):
    """K10 at each served model's prefill shape, bf16 as the prefill gives
    them (the tensor-core variant, with the CUDA-core kernel's bare time
    on the same inputs beside it), and at the f32 prefill's shape
    (the CUDA-core variant): wrapper, bare launch, plain version, bound
    and SDPA on the same tensors; then K11 (``time_k11``)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as flops

    dev, bf = torch.device("cuda"), torch.bfloat16
    rows = []
    f32_case = (("qwen3 f32 prefill", 1, 16, 8, CONSISTENCY_T, 128),
                "f32", torch.float32)
    for (label, b, h, kh, t, dh), arch_id, dt in (
            *((case, arch_id, bf) for case, arch_id in zip(K10_CASES,
                                                           SERVE_MODELS)),
            f32_case):
        q = torch.randn((b, t, h, dh), device=dev, dtype=dt)
        k = torch.randn((b, t, kh, dh), device=dev, dtype=dt)
        v = torch.randn((b, t, kh, dh), device=dev, dtype=dt)
        out = torch.empty_like(q)
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        pairs = b * h * t * (t + 1) // 2  # the unmasked causal half
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, t, t, h, kh, dh, 1, 0, 1.0 / math.sqrt(dh))
        # the timed inputs held too (each row's max_abs_err has a reading
        # even when the kernels phase did not run), and in bf16 the
        # CUDA-core kernel's bare launches timed beside the tensor-core one
        want = k10_plain(q, k, v, causal=True)
        got, variant = k10_call(q, k, v, True, None,
                                "tc" if dt == bf else "cc")
        log(f"[time] K10 ({variant}) {label}: "
            f"{hold_k10(got, want, label, variant)}")
        cc_ms = cuda_ms(lambda: _build.launch(
            "flash_attention", *ptrs, int(dt == bf)))
        if dt == bf:
            log(f"[time] K10 (cc, bare) {label}: "
                f"{hold_k10(out, want, label + ' cc', 'cc')}")
        del got, want
        common = dict(
            ms=cuda_ms(lambda: flops.flash_attention(q, k, v, causal=True)),
            plain_ms=cuda_ms(lambda: k10_plain(q, k, v, causal=True),
                             iters=3, warmup=1),
            nbytes=2 * q.element_size() * (b * t * h * dh + b * t * kh * dh),
            int_ops=0,
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)),
            launches_of=(f"{arch_id} prefill B={b} T={t}" if dt == bf else
                         f"qwen3-0.6b f32 prefill B={b} T={t}"))
        if dt == bf:
            # q.k^T, p_hi.v and p_lo.v: three products of bf16 operands on
            # the tensor cores, one exp per pair on the SFUs
            add_row(
                rows, f"K10-tc flash_attention_tc {label} [{b}, {t}, {h}, "
                f"{dh}] kv {kh} causal bf16",
                "src/repro_torch/csrc/flash_attention_sm90.cu",
                "src/repro/kernels/flash_attention/kernel.py:84",
                counts[arch_id]["flash_attention"],
                kernel_ms=cuda_ms(lambda: _build.launch(
                    "flash_attention_tc", *ptrs)),
                fp_ops=0, bf16_ops=3 * 2 * dh * pairs, sfu_ops=pairs,
                cc_kernel_ms=cc_ms,
                sass=K10_SASS.get(f"kD={dh} kBK={128 if dh <= 128 else 64}"),
                **common)
        else:
            # both products with an f32 operand on the CUDA cores
            add_row(
                rows, f"K10 flash_attention {label} [{b}, {t}, {h}, {dh}] "
                f"kv {kh} causal f32",
                "src/repro_torch/csrc/flash_attention.cu",
                "src/repro/kernels/flash_attention/kernel.py:84",
                counts["f32"], kernel_ms=cc_ms, fp_ops=2 * 2 * dh * pairs,
                max_abs_err_bf16=ERRS.get("K10-cc"), **common)
        del q, k, v, out, qt, kt, vt
    rows += time_k11(counts)
    return rows


def time_k11(counts):
    """K11 at zamba2's SSD shape in bf16: the tensor-core variant's wrapper
    and bare launch (the CUDA-core kernel's bare launch on the same inputs
    in turns beside it), the plain version, and the bound of the work
    each design does; then the CUDA-core variant's wrapper forced.  Also
    prints what the tensor-core launches look like to the runtime."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.ssm_scan import ops as ssmops
    from repro_torch.kernels.ssm_scan import ref as ssmref
    from repro_torch.models.mamba import SSMConfig

    dev, bf = torch.device("cuda"), torch.bfloat16
    b, t, nh, hd, ng, ds, chunk = K11_CASE
    cfg = SSMConfig(nh * hd // 2, d_state=ds, head_dim=hd, n_groups=ng,
                    chunk=chunk)
    x, bm, cm, alog = ssd_inputs(dev, b, t, nh, hd, ng, ds, bf)
    want = k11_plain(cfg, x, bm, cm, alog)
    for variant in ("tc", "cc"):
        got = k11_call(cfg, x, bm, cm, alog, variant, variant)
        log(f"[time] K11 ({variant}) zamba2: "
            f"{hold_k11(got, want, 'zamba2 timed', variant)}")
    del got, want
    info = ssmops.tc_launch_info(b, t, nh, ng, hd, ds, chunk)
    log(f"[time] K11-tc launches as the runtime reports them (threads, "
        f"dynamic shared memory, registers, local bytes, resident blocks "
        f"per SM, heads a block, blocks): {json.dumps(info)}")
    y = torch.empty_like(x)
    hout = torch.empty((b, nh, ds, hd), device=dev)
    scratch = torch.empty(ssmops.tc_scratch_bytes(b, t, nh, hd, ds, chunk),
                          dtype=torch.uint8, device=dev)
    ptrs = (x.data_ptr(), alog.data_ptr(), bm.data_ptr(), cm.data_ptr(),
            y.data_ptr(), hout.data_ptr())
    dims = (b, t, nh, ng, hd, ds, chunk, bm.stride(1), cm.stride(1))
    tc_ms, cc_ms, tc_turns, cc_turns = turns(
        lambda: _build.launch("ssd_scan_tc", *ptrs, scratch.data_ptr(),
                              *dims),
        lambda: _build.launch("ssd_scan", *ptrs, *dims, 1))
    plain_ms = cuda_ms(lambda: k11_plain(cfg, x, bm, cm, alog), iters=3,
                       warmup=1)
    nc, tri = t // chunk, chunk * (chunk + 1) // 2
    heads = b * nh * nc  # (batch, chunk, head) tiles
    # x, y, alog, B, C once each, h_final; the tensor-core design adds the
    # chunk states' round trip (S in f32 and h_in's two bf16 pieces, each
    # written once and read once)
    nbytes = (2 * (2 * b * t * nh * hd + b * t * nh + 2 * b * t * ng * ds)
              + 4 * b * nh * ds * hd)
    state_bytes = 4 * 4 * heads * ds * hd
    pieces = ssmref.TC_PIECES
    # C B^T's lower triangle once per (batch, chunk, group) with two bf16
    # operands; per tile (G X), C h_in and Bw^T X, each times its pieces
    tc_bf16 = (2 * b * nc * ng * tri * ds
               + heads * (pieces["g"] * 2 * tri * hd
                          + pieces["h_in"] * 2 * chunk * ds * hd
                          + pieces["bw"] * 2 * chunk * ds * hd))
    # exps: L's triangle, exp(cum_Q - cum_s) and exp(cum_t); f32 on the
    # CUDA cores: G = C B^T o L, Bw, the exp(cum_t) scaling and the pass
    tc_sfu = heads * (tri + 2 * chunk)
    tc_fp = heads * (tri + chunk * ds + chunk * hd + 2 * ds * hd)
    with_state, _ = bound_ms(nbytes + state_bytes, 0, tc_fp, tc_bf16, tc_sfu)
    common = dict(plain_ms=plain_ms, nbytes=nbytes, int_ops=0,
                  library_ms=None,
                  launches_of="zamba2-2.7b's 54 Mamba blocks, kernel path")
    rows = []
    add_row(
        rows, f"K11-tc ssd_scan_tc [{b}, {nh}, {t}, {hd}] DS {ds} chunk "
        f"{chunk} bf16", "src/repro_torch/csrc/ssd_scan_sm90.cu",
        "src/repro/kernels/ssm_scan/kernel.py:81",
        counts["zamba2-2.7b"]["ssd_chunked"]["tc"],
        cuda_ms(lambda: ssmops.ssd_chunked(cfg, x, bm, cm, alog)), tc_ms,
        fp_ops=tc_fp, bf16_ops=tc_bf16, sfu_ops=tc_sfu, cc_kernel_ms=cc_ms,
        kernel_ms_turns=tc_turns, cc_kernel_ms_turns=cc_turns,
        bound_with_state_ms=with_state, launch_info=info, **common)
    log(f"[time] K11-tc bound with the chunk states' round trip "
        f"({state_bytes} bytes more): {with_state:.4f} ms")
    # the CUDA-core design: the lower triangle of C.B^T with two bf16
    # operands; (C B^T o L) X, C.h and the decayed B^T X with one f32
    # operand on the CUDA cores
    with forced_k11("cc"):
        cc_wrapper_ms = cuda_ms(lambda: ssmops.ssd_chunked(cfg, x, bm, cm,
                                                           alog))
    add_row(
        rows, f"K11-cc ssd_scan [{b}, {nh}, {t}, {hd}] DS {ds} chunk {chunk}"
        " bf16", "src/repro_torch/csrc/ssd_scan.cu",
        "src/repro/kernels/ssm_scan/kernel.py:81",
        counts["zamba2-2.7b"]["ssd_chunked"]["cc"], cc_wrapper_ms, cc_ms,
        fp_ops=2 * heads * (tri * hd + 2 * chunk * ds * hd),
        bf16_ops=2 * heads * tri * ds,
        max_abs_err_f32=ERRS.get("K11-cc-f32"),
        **{**common, "launches_of": "zamba2-2.7b's 54 Mamba blocks, "
           "CUDA-core variant forced"})
    return rows


# kernel id -> the names of its CUDA kernels (csrc) in a profile
PROFILED_KERNELS = (("K1", ("quantize_rows<8, repro::PlaneKappa>",
                            "quantize_rows<4, repro::PlaneKappa>")),
                    ("K4", ("quantize_rows<8, repro::LeafKappa>",
                            "quantize_rows<4, repro::LeafKappa>")),
                    ("K5", ("dequantize_rows<8, false",
                            "dequantize_rows<4, false")),
                    ("K5 plane", ("dequantize_rows<8, true",
                                  "dequantize_rows<4, true")),
                    ("K2", ("randk_gather_",)),
                    ("K3", ("randk_scatter_", "randk_claim")),
                    ("K6", ("::gather_kernel<",)),
                    ("K7", ("::bin_kernel<", "::fill_kernel<")))


@contextlib.contextmanager
def fault_ranges():
    """While open, the fault path's seal (``compression.seal_plane``),
    verify (``compression.verify_plane_kinds``) and inject
    (``FaultPlane.inject``, inside the armed exchange) each run inside a
    torch.profiler range ``fault:<part>``."""
    import torch

    from repro_torch.core import compression, faults

    saved = []
    for owner, attr, part in ((compression, "seal_plane", "seal"),
                              (compression, "verify_plane_kinds", "verify"),
                              (faults.FaultPlane, "inject", "inject")):
        fn = getattr(owner, attr)

        def call(*a, _fn=fn, _part=part, **kw):
            with torch.profiler.record_function(f"fault:{_part}"):
                return _fn(*a, **kw)

        saved.append((owner, attr, fn))
        setattr(owner, attr, call)
    try:
        yield
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def phase_profile(label, rounds=3):
    """torch.profiler over ``rounds`` rounds of the wide run of spec
    ``label`` (after two warm-up rounds): device time by operator, and
    the device's idle share of the window's wall time; on a faulted spec
    also the device time inside the seal, verify and inject ranges
    (``fault_ranges``).  Returns (wall, device busy) ms a round."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import jaxrand
    from repro_torch.problems.logistic import LogisticProblem

    prob = LogisticProblem(n=WIDE_N)
    data = wide_data(prob, torch.device("cuda"))
    solver, x0, gspec, _, _ = wide_solver(label, prob, torch.device("cuda"))
    st = solver.init(x0)
    base = jaxrand.key(12345)
    for i in range(2):
        st = solver.step(st, data, jaxrand.fold_in(base, i))
    torch.cuda.synchronize()
    faulted = "faults" in label
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, (
            fault_ranges() if faulted else contextlib.nullcontext()):
        t0 = time.perf_counter()
        for i in range(2, 2 + rounds):
            st = solver.step(st, data, jaxrand.fold_in(base, i))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0]
    # top-level operators only: a kernel's time also counts under its
    # aten op, so sum the CUDA kernels (device type) for the busy time
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    # a record_function range also shows on the device timeline, as the
    # span from its first kernel's start to its last one's end: not a
    # kernel of its own
    spans = [e for e in kernels if e.name.startswith("fault:")]
    kernels = [e for e in kernels if not e.name.startswith("fault:")]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    log(f"[profile] {label}: {rounds} rounds on {gspec} n={WIDE_N}: wall "
        f"{wall * 1e3:.3f} "
        f"ms, device busy {busy * 1e3:.3f} ms, idle share "
        f"{1 - busy / wall:.3f}")
    by_kernel = {}
    for e in kernels:
        by_kernel[e.name] = (by_kernel.get(e.name, 0.0)
                             + e.time_range.elapsed_us() / 1e3)
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]:
        log(f"[profile] kernel {ms / rounds:9.4f} ms/round "
            f"{ms / 1e3 / busy:6.1%}  {name[:110]}")
    # the port's own kernels by id (csrc kernel names), their share of the
    # device's busy time
    for kid, tags in PROFILED_KERNELS:
        ms = sum(t for name, t in by_kernel.items()
                 if any(tag in name for tag in tags))
        calls = sum(1 for e in kernels if any(tag in e.name for tag in tags))
        if calls:
            log(f"[profile] {label}: {kid} {ms / rounds:.4f} "
                f"ms/round in {calls // rounds} launches/round, "
                f"{ms / 1e3 / busy:.1%} of device busy, round "
                f"{wall * 1e3 / rounds:.3f} ms")
    ops = sorted(events, key=lambda e: -e.device_time_total)[:15]
    for e in ops:
        log(f"[profile] op {e.device_time_total / 1e3 / rounds:9.4f} ms/round"
            f" calls/round {e.count // rounds:4d}  {e.key[:80]}")
    if faulted:
        # a range's device time: its kernels, those that ran inside its
        # spans (one stream, so no other kernel runs there)
        total = 0.0
        for key in ("fault:seal", "fault:verify", "fault:inject"):
            mine = [a.time_range for a in spans if a.name == key]
            ms = sum(e.time_range.elapsed_us() for e in kernels
                     if any(r.start <= e.time_range.start
                            and e.time_range.end <= r.end
                            for r in mine)) / 1e3 / rounds
            span = sum(r.elapsed_us() for r in mine) / 1e3 / rounds
            total += ms
            log(f"[profile] {label}: {key} {ms:.4f} ms/round of kernels "
                f"in {len(mine) // rounds} spans/round of {span:.4f} ms "
                f"on the device timeline, {ms / 1e3 / (busy / rounds):.1%} "
                f"of device busy")
        log(f"[profile] {label}: seal+verify+inject {total:.4f} ms/round, "
            f"{total / 1e3 / (busy / rounds):.1%} of the round's device "
            f"busy {busy * 1e3 / rounds:.4f} ms")
    return wall * 1e3 / rounds, busy * 1e3 / rounds


def add_row(rows, name, source, replaces, launches, ms, kernel_ms, plain_ms,
            nbytes, int_ops, fp_ops, library_ms, rounds=None, bf16_ops=0,
            sfu_ops=0, **extra):
    """Append the ``kernels`` line's row of one kernel at one shape and log
    it; ``rounds`` (the wide runs') adds launches per round."""
    b, by = bound_ms(nbytes, int_ops, fp_ops, bf16_ops, sfu_ops)
    per = {} if rounds is None else {"launches_per_round": launches / rounds}
    rows.append({"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches, **per,
                 "max_abs_err": ERRS[name.split()[0]], "ms": ms,
                 "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                 "bound_ms": b, "bound_by": by, "library_ms": library_ms,
                 **extra})
    log(f"[time] {name}: wrapper {ms:.4f} ms, bare launch "
        f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b:.4f} ms "
        f"({by}), library "
        f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'}, "
        f"launches {launches}"
        + ("" if rounds is None else f" in {rounds} rounds")
        + ("" if "cc_kernel_ms" not in extra else
           f"; the CUDA-core kernel on the same inputs "
           f"{extra['cc_kernel_ms']:.4f} ms")
        + ("" if "first_ms" in extra or "first_kernel_ms" not in extra else
           f"; the first design on the same inputs: bare "
           f"{extra['first_kernel_ms']:.4f} ms")
        + ("" if "as_compiled_ms" not in extra else
           f"; as compiled {extra['as_compiled_ms']:.4f} ms")
        + ("" if "host_ms" not in extra else
           f"; host time a wrapper call {extra['host_ms']:.4f} ms (first "
           f"design {extra['first_host_ms']:.4f} ms)")
        + ("" if "first_ms" not in extra else
           f"; the first design on the same inputs: wrapper "
           f"{extra['first_ms']:.4f} ms, bare {extra['first_kernel_ms']:.4f}"
           " ms"
           + ("" if "first_fill_kernel_ms" not in extra else
              f", bare with its zero fill "
              f"{extra['first_fill_kernel_ms']:.4f} ms")
           + f" (turns {extra['ms_turns']} / {extra['first_ms_turns']})"
           + ("" if "variant" not in extra else
              f"; {extra['variant']} variant, launches by variant "
              f"{extra['launches_by_variant']}"))
        + ("" if "push_ms" not in extra else
           f"; {extra['variant']} variant, launches by variant "
           f"{extra['launches_by_variant']}; the push kernels on the "
           f"same inputs: wrapper {extra['push_ms']:.4f} ms, bare "
           f"{extra['push_kernel_ms']:.4f} ms (turns {extra['ms_turns']} / "
           f"{extra['push_ms_turns']}, bare {extra['kernel_ms_turns']} / "
           f"{extra['push_kernel_ms_turns']}); block sampler wrapper "
           f"{extra['block_ms']:.4f} ms, bare {extra['block_kernel_ms']:.4f}"
           " ms")
        + ("" if CARD is None else f" [{CARD}]"))


def host_ms(fn, iters=20, warmup=3):
    """Mean host time of ``fn()`` over ``iters`` calls that the card runs
    behind: near ``cuda_ms(fn)``, the host sets the pace."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t
    torch.cuda.synchronize()
    return t / iters * 1e3


def turns(a, b):
    """CUDA-event ms of ``a`` and ``b`` timed in turns a, b, b, a: each
    one's mean and its two readings."""
    ta, tb = [cuda_ms(a)], [cuda_ms(b)]
    tb.append(cuda_ms(b))
    ta.append(cuda_ms(a))
    return sum(ta) / 2, sum(tb) / 2, ta, tb


@contextlib.contextmanager
def forced_push():
    """Route K2/K3 to the push variant inside the block: the script swaps
    ``variant`` in the wrapper module; the package has no such knob."""
    from repro_torch.kernels.sparse_gather import ops

    saved = ops.variant
    ops.variant = lambda n, k, strides: "push"
    try:
        yield
    finally:
        ops.variant = saved


def time_k23(seed, x, sid, rid, sid32, rid32, k, counts):
    """K2/K3 rows at the z-plane [20, 2^20], k = 0.6 n, stride sampler:
    the pull variant's wrapper and bare launch, the push kernels
    forced on the same inputs (wrapper with its zero fill, bare onto a
    plane zeroed once), both timed in turns; the block sampler's pull
    kernels; the plain versions, ``torch.gather`` / ``torch.scatter`` on
    the materialised index rows and the bound."""
    import torch

    from repro_torch.kernels import _build, prng
    from repro_torch.kernels.sparse_gather import ops as sgops
    from repro_torch.kernels.sparse_gather import ref as sgref

    m, n = x.shape
    dev = x.device
    rows = []
    by = {kname: {kind: counts["randk-stride"][f"{kname}_{kind}"]
                  for kind in ("pull", "push")}
          for kname in ("randk_gather_plane", "randk_scatter_plane")}
    ids = (sid32.data_ptr(), rid32.data_ptr())
    stride = prng.coprime_strides(n)
    block = (1,)
    gain = n / k
    v = sgops.randk_gather_plane(seed, sid, rid, x, k=k, strides=stride)
    es = prng.fold(seed, prng.u32(sid), prng.u32(rid))
    idx = prng.affine_indices(es, n, k, stride)
    vg = torch.tensor(gain, dtype=torch.float32, device=dev) * v
    zeros = torch.zeros((m, n), device=dev)
    plane = torch.zeros((m, n), device=dev)
    vout = torch.empty((m, k), device=dev)
    pout = torch.empty((m, n), device=dev)

    def gather_bare(kind, strides):
        return lambda: _build.launch(
            f"randk_gather_{kind}", x.data_ptr(), m, n, k, seed[0], seed[1],
            *ids, _build.stride_table(strides), len(strides),
            vout.data_ptr())

    def scatter_bare(kind, strides):
        tables = (_build.stride_table(strides),) + (
            (_build.stride_table(sgops.inverse_strides(n, strides)),)
            if kind == "pull" else ())
        tail = ((pout.data_ptr(),) if kind == "pull"
                else (None, plane.data_ptr()))
        return lambda: _build.launch(
            f"randk_scatter_{kind}", v.data_ptr(), m, n, k, float(gain),
            seed[0], seed[1], *ids, *tables, len(strides), *tail)

    def gather(strides):
        return lambda: sgops.randk_gather_plane(seed, sid, rid, x, k=k,
                                                strides=strides)

    def scatter(strides):
        return lambda: sgops.randk_scatter_plane(seed, sid, rid, v, n=n,
                                                 gain=gain, strides=strides)

    def forced(fn):
        def run():
            with forced_push():
                fn()
        return run

    # the bare launches' outputs, once, against the plain versions
    for kind in ("pull", "push"):
        gather_bare(kind, stride)()
        scatter_bare(kind, stride)()
        sync()
        if not (same_bits(vout, v) and same_bits(
                pout if kind == "pull" else plane,
                sgref.randk_scatter_plane_ref(seed, sid, rid, v, n=n,
                                              gain=gain, strides=stride))):
            raise AssertionError(f"K2/K3 bare {kind} launch differs")
    if {sgops.variant(n, k, st) for st in (stride, block)} != {"pull"}:
        raise AssertionError("K2/K3 at the wide shape: not the pull variant")
    for kid, kname, fns, plain, library, nbytes, fops, line in (
            ("K2", "randk_gather_plane", (gather, gather_bare),
             lambda: sgref.randk_gather_plane_ref(seed, sid, rid, x, k=k,
                                                  strides=stride),
             lambda: torch.gather(x, 1, idx), 2 * m * k * 4, 0, 173),
            ("K3", "randk_scatter_plane", (scatter, scatter_bare),
             lambda: sgref.randk_scatter_plane_ref(seed, sid, rid, v, n=n,
                                                   gain=gain,
                                                   strides=stride),
             lambda: torch.scatter(zeros, 1, idx, vg),
             m * k * 4 + m * n * 4, m * k, 222)):
        wrap, bare = fns
        ms, push_ms, ms_turns, push_turns = turns(
            wrap(stride), forced(wrap(stride)))
        kms, push_kms, kms_turns, push_kturns = turns(
            bare("pull", stride), bare("push", stride))
        add_row(
            rows, f"{kid} {kname} stride [20, 2^20] k={k}",
            "src/repro_torch/csrc/randk_plane.cu",
            f"src/repro/kernels/sparse_gather/kernel.py:{line}",
            counts["randk-stride"][kname], ms, kms,
            cuda_ms(plain, iters=3, warmup=1), nbytes,
            IDX_OPS * m * k + 3 * TF_OPS * m, fops, cuda_ms(library),
            rounds=WIDE_ROUNDS, variant="pull", launches_by_variant=by[kname],
            push_ms=push_ms, push_kernel_ms=push_kms,
            ms_turns=ms_turns, push_ms_turns=push_turns,
            kernel_ms_turns=kms_turns, push_kernel_ms_turns=push_kturns,
            block_ms=cuda_ms(wrap(block)),
            block_kernel_ms=cuda_ms(bare("pull", block)))
    return rows


def time_k67(x, counts):
    """K6/K7 rows at the main path's two shapes: the RandK-uniform z-plane
    [20, 2^20], k = 0.6 n (int64 rows, a ``jaxrand.permutation`` prefix,
    for both kernels), and CHOCO TopK's [10, 2^20], k = n / 4 (K6 on the
    int64 rows of a ``torch.sort`` prefix, K7 on the int32 rows of the
    wire payload, as ``TopK.compress`` and ``decompress`` hand them); each
    read in place.  The new kernels' wrapper and bare launch (K7 into
    scratch allocated once), the first designs (``YARDSTICK``) on the
    same inputs in turns: their wrapper (the int32 conversion, for K7 the
    zero fill too, then the kernel) and bare launch (K7 onto a plane
    zeroed once, and with the fill); the plain versions, ``torch.gather``
    / ``torch.scatter`` on the same rows (int64: the library takes no
    other), and the bound (the rows read once at their width, the values
    read and written once; K7 writes the plane)."""
    import torch

    from repro_torch.core import jaxrand
    from repro_torch.kernels import _build
    from repro_torch.kernels.sparse_gather import ops as sgops
    from repro_torch.kernels.sparse_gather import ref as sgref

    dev = x.device
    n = x.shape[1]
    rows = []
    for run, m, frac in (("randk-uniform", 20, 0.6), ("choco-topk", 10, 0.25)):
        k = round(frac * n)
        xm = x[:m].contiguous()
        if run == "randk-uniform":
            keys = jaxrand.split(jaxrand.key(6), m).to(dev)
            idx = jaxrand.permutation(keys, n)[..., :k]
            idx7 = idx
            gain, what = n / k, "uniform"
        else:
            idx = torch.sort(xm.abs(), dim=-1, descending=True,
                             stable=True).indices[..., :k]
            idx7 = idx.to(torch.int32)  # the wire payload
            gain, what = 1.0, "topk"
        ld, ld7 = idx.stride(0), idx7.stride(0)
        wide7 = int(idx7.dtype == torch.int64)
        r32 = idx.to(torch.int32).contiguous()
        v = sgops.sparse_gather(xm, idx)
        vg = torch.tensor(gain, dtype=torch.float32, device=dev) * v
        gout = torch.empty((m, k), device=dev)
        out = torch.empty((m, n), device=dev)
        plane = torch.zeros((m, n), device=dev)
        zeros = torch.zeros((m, n), device=dev)
        *_, pw, sw = sgops.bin_layout(m, n, k, "unique")
        scratch = torch.empty(pw + sw, dtype=torch.int32, device=dev)

        def gather_first():
            r = idx.to(torch.int32).contiguous()
            o = torch.empty((m, k), device=dev)
            YARDSTICK("sparse_gather_first", xm.data_ptr(), m, n,
                      r.data_ptr(), k, o.data_ptr())()

        def scatter_first():
            r = idx7.to(torch.int32).contiguous()
            o = torch.zeros((m, n), device=dev)
            YARDSTICK("sparse_scatter_first", v.data_ptr(), r.data_ptr(), m,
                      n, k, float(gain), None, o.data_ptr())()

        scatter_first_bare = YARDSTICK(
            "sparse_scatter_first", v.data_ptr(), r32.data_ptr(), m, n, k,
            float(gain), None, plane.data_ptr())

        def scatter_first_fill():
            plane.zero_()
            scatter_first_bare()

        fns = {
            "K6": (lambda: sgops.sparse_gather(xm, idx),
                   lambda: _build.launch("sparse_gather", xm.data_ptr(), m, n,
                                         idx.data_ptr(), 1, ld, k,
                                         gout.data_ptr()),
                   gather_first,
                   YARDSTICK("sparse_gather_first", xm.data_ptr(), m, n,
                             r32.data_ptr(), k, gout.data_ptr())),
            "K7": (lambda: sgops.sparse_scatter(v, idx7, n, gain,
                                                unique=True),
                   lambda: _build.launch(
                       "sparse_scatter", v.data_ptr(), idx7.data_ptr(), wide7,
                       ld7, m, n, k, float(gain), 0, scratch.data_ptr(),
                       scratch.data_ptr() + 4 * pw, out.data_ptr()),
                   scatter_first, scatter_first_fill)}
        # the bare launches' outputs, once, against the plain versions
        fns["K6"][1]()
        fns["K7"][1]()
        scatter_first_fill()
        sync()
        want = sgref.sparse_scatter_ref(v, idx7, n, gain)
        if not (same_bits(gout, sgref.sparse_gather_ref(xm, idx))
                and same_bits(out, want) and same_bits(plane, want)):
            raise AssertionError(f"K6/K7 bare launches at {run}: mismatch")
        for kid, kname, line, plain, library, nbytes, fops in (
                ("K6", "sparse_gather", 47,
                 lambda: sgref.sparse_gather_ref(xm, idx),
                 lambda: torch.gather(xm, 1, idx),
                 m * k * (idx.element_size() + 4 + 4), 0),
                ("K7", "sparse_scatter", 75,
                 lambda: sgref.sparse_scatter_ref(v, idx7, n, gain),
                 lambda: torch.scatter(zeros, 1, idx, vg),
                 m * k * (idx7.element_size() + 4) + m * n * 4, m * k)):
            wrap, bare, first, first_bare = fns[kid]
            ms, first_ms, ms_turns, first_turns = turns(wrap, first)
            kms, first_kms, kms_turns, first_kturns = turns(bare, first_bare)
            extra = {"ms_turns": ms_turns, "first_ms": first_ms,
                     "first_ms_turns": first_turns,
                     "kernel_ms_turns": kms_turns,
                     "first_kernel_ms": first_kms,
                     "first_kernel_ms_turns": first_kturns,
                     "index_dtype": str((idx if kid == "K6" else idx7).dtype)}
            if kid == "K7":
                # the first design's bare time as earlier tables gave it,
                # without the fill
                extra["first_kernel_ms"] = cuda_ms(scatter_first_bare)
                extra["first_fill_kernel_ms"] = first_kms
                extra["first_fill_kernel_ms_turns"] = first_kturns
                del extra["first_kernel_ms_turns"]
                extra["variant"] = "unique"
                extra["launches_by_variant"] = {
                    kind: counts[run][f"sparse_scatter_{kind}"]
                    for kind in ("unique", "claim")}
            add_row(
                rows, f"{kid} {kname} {what} [{m}, 2^20] k={k} "
                f"{extra['index_dtype'].replace('torch.', '')} rows",
                "src/repro_torch/csrc/gather_scatter.cu",
                f"src/repro/kernels/sparse_gather/kernel.py:{line}",
                counts[run][kname], ms, kms,
                cuda_ms(plain, iters=3, warmup=1), nbytes, 0, fops,
                cuda_ms(library), rounds=WIDE_ROUNDS, launches_of=run,
                **extra)
        del xm, idx, idx7, r32, v, vg, gout, out, plane, zeros, scratch
    return rows


def time_quant(rows, kid, name, source, replaces, run, counts, bits, elems,
               wrap, bare, first, first_bare, plain, nbytes, int_ops, fp_ops):
    """A K1 or K4 row: the fused kernel's wrapper and bare entry (scale
    included; scratch allocated once, zeroed by the entry) beside the
    first design's wrapper (the scale pass, then its kernel) and bare
    kernel (the scale given), in turns; the plain version; the bound (x
    read once, q and scale written once, a Threefry block and 6 f32 ops an
    element); the element body's issue estimate from its SASS; and each
    wrapper's host time a call (``host_ms``)."""
    ms, first_ms, ms_turns, first_turns = turns(wrap, first)
    kms, first_kms, kms_turns, first_kturns = turns(bare, first_bare)
    body = BODY_SASS[f"{kid} b={bits}"]
    issue_ms = body["issue_clocks"] * elems / (132 * 1.98e9) * 1e3
    compiled_ms = body["compiled_clocks"] * elems / (132 * 1.98e9) * 1e3
    log(f"[sass] {name}: the element body's issue estimate {issue_ms:.4f} "
        f"ms ({body['issue_clocks']:.3f} clocks an element per SM), as "
        f"compiled {compiled_ms:.4f} ms ({body['compiled_clocks']:.3f}), "
        f"beside the bound {bound_ms(nbytes, int_ops, fp_ops)[0]:.4f} ms")
    add_row(rows, name, source, replaces, counts[run][
        "quantize_plane" if kid == "K1" else "quantize_tensor"], ms, kms,
        cuda_ms(plain, iters=2, warmup=1), nbytes, int_ops, fp_ops, None,
        rounds=WIDE_ROUNDS, launches_of=run, ms_turns=ms_turns,
        first_ms=first_ms, first_ms_turns=first_turns,
        kernel_ms_turns=kms_turns, first_kernel_ms=first_kms,
        first_kernel_ms_turns=first_kturns, element_sass=body,
        element_issue_ms=issue_ms, as_compiled_ms=compiled_ms,
        host_ms=host_ms(wrap), first_host_ms=host_ms(first))


def time_kernels(seed, k0_inputs, counts, shapes):
    """Each kernel at the main path's shapes (the z-plane [20, 2^20] of
    the wide run; RandK at fraction 0.6; K8/K9 also at each shape the
    wide runs gave them): the wrapper (``ms``), the bare launch on inputs
    the wrapper would have prepared (``kernel_ms``), the plain version,
    the library call, and the bound.  ``counts`` holds the launches of
    each compressor's main-path run, ``shapes`` its calls per shape."""
    import torch

    from repro_torch.core import jaxrand
    from repro_torch.kernels import _build, prng
    from repro_torch.kernels.quantize import ops as qops
    from repro_torch.kernels.quantize import ref as qref
    from repro_torch.kernels.sparse_gather import ops as sgops
    from repro_torch.kernels.sparse_gather import ref as sgref

    if TF_OPS is None:
        phase_sass()
    qprobe = load_tool("quantize_probe")
    dev = torch.device("cuda")
    sid, rid = z_plane_ids(dev)
    m, n = 20, WIDE_N
    x = torch.randn((m, n), device=dev)
    k = round(0.6 * n)
    rows = []

    def bare(entry, *args):
        return cuda_ms(lambda: _build.launch(entry, *args))

    # K0 at its test shape: 8 seeds x 2^20 counters; it has no launch of
    # its own on the main path, so its launches are those of K1-K4
    s, r, c = k0_inputs["sids"], k0_inputs["rids"], k0_inputs["ctr"]
    nb, nc = s.numel(), c.numel()
    out = [torch.empty(shape, dtype=torch.int32, device=dev)
           for shape in ((nb, nc), (nb,), (nb,))]
    add_row(
        rows, "K0 threefry (threefry_bits entry)",
        "src/repro_torch/csrc/threefry.cuh",
        "src/repro/kernels/prng.py:65",
        sum(cnt[kk] for cnt in counts.values()
            for kk in ("quantize_plane", "randk_gather_plane",
                       "randk_scatter_plane", "quantize_tensor")),
        cuda_ms(lambda: prng.threefry_bits(seed, s, r, c, n=ODD_N,
                                           n_strides=64)),
        bare("threefry_bits", seed[0], seed[1], s.data_ptr(), r.data_ptr(),
             c.data_ptr(), nb, nc, ODD_N, 64, *(t.data_ptr() for t in out)),
        cuda_ms(lambda: prng._threefry_bits_ref(seed, s, r, c, ODD_N, 64),
                iters=3, warmup=1),
        4 * nc + 8 * nb + 4 * nb * nc + 8 * nb,
        TF_OPS * (nb * nc + 3 * nb), 0, None,
        rounds=WIDE_ROUNDS * len(counts),
        launches_of="K1-K4, which inline K0 (all wide runs)",
        as_compiled_ms=bound_ms(0, TF_COMPILED * (nb * nc + 3 * nb))[0],
        first_kernel_ms=cuda_ms(QUANT_FIRST(
            "threefry_bits_first", seed[0], seed[1], s.data_ptr(),
            r.data_ptr(), c.data_ptr(), nb, nc, ODD_N, 64,
            *(t.data_ptr() for t in out))))

    sid32, rid32 = qops._plane_ids(sid, (m,)), qops._plane_ids(rid, (m,))
    # K1: the z-plane [20, 2^20] (b = 8 and 4) and drop0.3's x/z-plane
    # [10, 15, 2^20] as [150, 2^20] rows
    mb = 150
    sidb = (torch.arange(mb, device=dev) // 15).to(torch.int32)
    ridb = (torch.arange(mb, device=dev) % 15).to(torch.int32)
    for mm, bits, run, what, xs, ss, rr in (
            (m, 8, "qbit8", "[20, 2^20]", x, sid32, rid32),
            (m, 4, "qbit4", "[20, 2^20]", x, sid32, rid32),
            (mb, 8, "drop-qbit8", "[150, 2^20] (drop0.3)", None, sidb, ridb)):
        xs = torch.randn((mb, n), device=dev) if xs is None else xs
        wire = qops.wire_len(n, bits)
        q = torch.empty((mm, wire), device=dev,
                        dtype=torch.int8 if bits == 8 else torch.uint8)
        sc, given = torch.empty((mm,), device=dev), qref.row_scale(xs)
        scr = qops.scratch(mm, dev)
        time_quant(
            rows, "K1", f"K1 quantize_plane b={bits} {what}",
            "src/repro_torch/csrc/quantize_plane.cu",
            "src/repro/kernels/quantize/kernel.py:148", run, counts, bits,
            mm * n,
            lambda: qops.quantize_plane(seed, ss, rr, xs, bits=bits),
            lambda: _build.launch(
                "quantize_plane", xs.data_ptr(), mm, n, bits, seed[0],
                seed[1], ss.data_ptr(), rr.data_ptr(), sc.data_ptr(),
                q.data_ptr(), wire, scr.data_ptr()),
            lambda: qprobe.first_plane(QUANT_FIRST, seed, ss, rr, xs, bits),
            QUANT_FIRST("quantize_plane_first", xs.data_ptr(), mm, n, bits,
                        seed[0], seed[1], ss.data_ptr(), rr.data_ptr(),
                        given.data_ptr(), q.data_ptr(), wire),
            lambda: qref.quantize_plane_ref(seed, ss, rr, xs, bits=bits),
            mm * n * 4 + mm * wire + 8 * mm, TF_OPS * (mm * n + 2 * mm),
            6 * mm * n)
        del xs, q, scr

    # K2/K3: the pull variant the main path runs, and the push
    # kernels forced on the same inputs in turns (pull, push, push, pull)
    rows += time_k23(seed, x, sid, rid, sid32, rid32, k, counts)

    # K4/K5 on the baselines' x messages [10, 2^20] (LEAD qbit8), and K4
    # on the ring tree round's big leaf [20, 2^20 - 4096]
    for ma, na, run in ((10, n, "lead-qbit8"),
                        (20, n - WIDE_SPLIT, "ring-tree-qbit8")):
        xa = (x[:ma] if na == n else x[:, :na]).contiguous()
        keys = jaxrand.split(jaxrand.key(5), ma)
        kd = qops._key_words(keys, (ma,), dev)
        sca, given = torch.empty((ma,), device=dev), qref.row_scale(xa)
        qa = torch.empty((ma, na), device=dev, dtype=torch.int8)
        scr = qops.scratch(ma, dev)
        time_quant(
            rows, "K4", f"K4 quantize_tensor b=8 [{ma}, {na}]",
            "src/repro_torch/csrc/quantize_leaf.cu",
            "src/repro/kernels/quantize/kernel.py:73", run, counts, 8,
            ma * na,
            lambda: qops.quantize_tensor(keys, xa, bits=8),
            lambda: _build.launch("quantize_leaf", xa.data_ptr(), ma, na, 8,
                                  kd.data_ptr(), sca.data_ptr(),
                                  qa.data_ptr(), na, scr.data_ptr()),
            # the first design's wrapper too takes the keys from the host
            lambda: qprobe.first_leaf(
                QUANT_FIRST, qops._key_words(keys, (ma,), dev), xa, 8),
            QUANT_FIRST("quantize_leaf_first", xa.data_ptr(), ma, na, 8,
                        kd.data_ptr(), given.data_ptr(), qa.data_ptr(), na),
            lambda: qref.quantize_tensor_ref(keys, xa, bits=8),
            ma * na * 4 + ma * na + 8 * ma + 4 * ma, TF_LEAF_OPS * ma * na,
            6 * ma * na)
    # K5 on LEAD's [10, 2^20] messages (its multiply form) and, in its
    # division form (the plane route's dequantize_plane), on drop0.3's
    # [150, 2^20] planes, b = 8; the bare kernel and its first design (one
    # element a thread a step, tools/quantize_probe.py) in turns
    for mk, plane, run, what in ((10, 0, "lead-qbit8", "dequantize_tensor"),
                                 (mb, 1, "drop-qbit8", "dequantize_plane")):
        xk = torch.randn((mk, n), device=dev)
        sk = (torch.arange(mk, device=dev) // 15).to(torch.int32)
        qk, sck = qops.quantize_plane(seed, sk, sk, xk, bits=8)
        del xk
        outk = torch.empty((mk, n), device=dev)
        fn = getattr(qops, what)
        plain = (qref.dequantize_plane_ref if plane
                 else qref.dequantize_tensor_ref)
        args = (qk.data_ptr(), mk, n, 8, sck.data_ptr(), outk.data_ptr(), n,
                plane)
        kms, first_kms, kms_turns, first_kturns = turns(
            lambda: _build.launch("dequantize_leaf", *args),
            QUANT_FIRST("dequantize_leaf_first", *args))
        add_row(
            rows, f"K5 {what} b=8 [{mk}, 2^20]"
            + (" (drop0.3)" if plane else ""),
            "src/repro_torch/csrc/quantize_leaf.cu",
            "src/repro/kernels/quantize/kernel.py:188"
            if not plane else "src/repro/kernels/quantize/ops.py:71",
            counts[run][what],
            cuda_ms(lambda: fn(qk, sck, n=n, bits=8)), kms,
            cuda_ms(lambda: plain(qk, sck, n=n, bits=8), iters=2, warmup=1),
            mk * n + 4 * mk + mk * n * 4, 0, 2 * mk * n, None,
            rounds=WIDE_ROUNDS, launches_of=run, kernel_ms_turns=kms_turns,
            first_kernel_ms=first_kms, first_kernel_ms_turns=first_kturns)
        del qk, outk

    # K6/K7 at the RandK-uniform z-plane and CHOCO TopK's x-plane, beside
    # the first designs on the same inputs
    rows += time_k67(x, counts)

    # K8/K9 (RandK block's per-message route) on [20, 2^20] at k = 0.6 n,
    # the shape of the K2/K3 and K6/K7 rows, with the launches of every
    # shape; then at each shape the wide runs gave them, with the
    # launches at that shape.  The library calls take the window as
    # prebuilt index rows.
    runs = ("churn-tree-randk-block", "choco-drop-randk-block")
    # kernel -> (m, n, k) -> {run: launches at that shape}; a K8 call's
    # key is (x [..., n], off, k), a K9 call's (v [..., k], off, n)
    main = {"cyclic_gather": {}, "cyclic_scatter": {}}
    for lab in runs:
        for (nm, sh), c in shapes[lab].items():
            if nm in main:
                m_, last = math.prod(sh[0][:-1]), sh[0][-1]
                mnk = ((m_, last, sh[2]) if nm == "cyclic_gather"
                       else (m_, sh[2], last))
                main[nm].setdefault(mnk, {})[lab] = c
    at = sorted(set(main["cyclic_gather"]) | set(main["cyclic_scatter"]))
    for mc, nc, kb, at_shape in ([(m, n, round(0.6 * n), False)]
                                 + [(*mnk, True) for mnk in at]):
        where = "this shape" if at_shape else "all shapes"
        xc = torch.randn((mc, nc), device=dev)
        offs = jaxrand.randint(jaxrand.split(jaxrand.key(mc), mc), (), 0,
                               nc).to(dev)
        widx = (offs[:, None] + torch.arange(kb, device=dev)) % nc
        cout = torch.empty((mc, kb), device=dev)
        for kname, kid, line in (("cyclic_gather", "K8", 110),
                                 ("cyclic_scatter", "K9", 257)):
            by_run = (dict(main[kname].get((mc, nc, kb), {})) if at_shape
                      else {lab: counts[lab][kname] for lab in runs})
            extra = {"launches_of": where, "launches_by_run": by_run}
            if not at_shape:
                extra["launches_by_shape"] = {
                    f"{list(mnk)}": sum(r.values())
                    for mnk, r in main[kname].items()}
            if kname == "cyclic_gather":
                fn = (lambda: sgops.cyclic_gather(xc, offs, kb),
                      lambda: _build.launch("cyclic_gather", xc.data_ptr(),
                                            offs.data_ptr(), mc, nc, kb,
                                            cout.data_ptr()),
                      lambda: sgref.cyclic_gather_ref(xc, offs, kb),
                      lambda: torch.gather(xc, 1, widx))
                nbytes, iops, fops = 2 * mc * kb * 4 + 8 * mc, 2 * mc * kb, 0
            else:
                vb = sgops.cyclic_gather(xc, offs, kb)
                gain = nc / kb
                vbg = torch.tensor(gain, dtype=torch.float32,
                                   device=dev) * vb
                zc = torch.zeros((mc, nc), device=dev)
                pc = torch.empty((mc, nc), device=dev)
                fn = (lambda: sgops.cyclic_scatter(vb, offs, nc, gain),
                      lambda: _build.launch("cyclic_scatter", vb.data_ptr(),
                                            offs.data_ptr(), mc, nc, kb,
                                            float(gain), pc.data_ptr()),
                      lambda: sgref.cyclic_scatter_ref(vb, offs, nc, gain),
                      lambda: torch.scatter(zc, 1, widx, vbg))
                nbytes = mc * kb * 4 + mc * nc * 4 + 8 * mc
                iops, fops = 2 * mc * nc, 2 * mc * kb
            add_row(
                rows, f"{kid} {kname} [{mc}, {nc}] k={kb}",
                "src/repro_torch/csrc/cyclic.cu",
                f"src/repro/kernels/sparse_gather/kernel.py:{line}",
                sum(by_run.values()), cuda_ms(fn[0]), cuda_ms(fn[1]),
                cuda_ms(fn[2], iters=3, warmup=1), nbytes, iops, fops,
                cuda_ms(fn[3]), rounds=WIDE_ROUNDS * max(1, len(by_run)),
                **extra)
        del xc, widx, cout
    # dada-qbit8 gives K4/K5 LEAD's [10, 2^20] shape: its launches beside
    # LEAD's in those rows
    for row in rows:
        for what in ("quantize_tensor", "dequantize_tensor"):
            if row["name"].startswith((f"K4 {what} b=8 [10, ",
                                       f"K5 {what} b=8 [10, ")):
                row["launches_dada_qbit8"] = counts["dada-qbit8"][what]
                log(f"[time] {row['name']}: dada-qbit8 launched it "
                    f"{row['launches_dada_qbit8']} times in its "
                    f"{WIDE_ROUNDS} wide rounds (LEAD {row['launches']})")
    return rows


# ---------------------------------------------------------------------------
# phase obs: the telemetry counters, the trace, the perf-smoke run
# ---------------------------------------------------------------------------

# every solver of the reference's tests/test_obs.py:40, on the ring,
# drop0.3 and churn0.2, and nested faults on drop0.3
OBS_SOLVER_SPECS = (
    "ltadmm:tau=3,compressor=qbit:bits=8",
    "dsgd:lr=0.1",
    "choco:lr=0.1,compressor=qbit:bits=8",
    "lead:lr=0.1,compressor=qbit:bits=8",
    "cold:lr=0.1,compressor=randk:fraction=0.5,sampler=block",
    "cedas:lr=0.1,compressor=qbit:bits=4",
    "dpdc:lr=0.1,compressor=qbit:bits=8",
    "dada:lr=0.1,mu=0.5,lambda_g=0.1,graph_every=2,degree_cap=2,"
    "compressor=qbit:bits=8",
)
OBS_FAULTS = "faults=faults:drop=0.1|corrupt=5e-3|stale=0.05|crash=0.02|seed=0"
OBS_GRAPHS = (("ring", ""), (DROP_SPEC, ""), (CHURN_SPEC, ""),
              (DROP_SPEC, OBS_FAULTS))
# the perf-smoke rows (benchmarks/BENCH_BASELINE.json): spec -> BENCH
# telemetry (tx_bytes_max_agent, tx_msgs_total, participations_total),
# rounds_to_tol and wire bytes
OBS_BENCH = {"ring": ((21600, 24000, 6000), 100, 36),
             "drop:p=0.3,base=complete,seed=0": ((70884, 73932, 6000), 20,
                                                 118),
             CHURN_SPEC: ((75546, 70264, 4797), 20, 126)}
# the wrapped round beside the unwrapped one: wide labels, and the same
# recipes at the paper's size
OBS_TIMED = (("qbit8", "ring", ""), ("drop-qbit8", DROP_SPEC, ""),
             ("ring-faults-qbit8", "ring", WIDE_FAULTS))
OBS_ROUNDS = 600  # the perf-smoke rows' rounds
PERF_SMOKE = None  # (payload, BENCH path, seconds) of the one run


def obs_solver(spec, gspec, dev, wrapped=True, prob=None):
    """``(solver, data on dev, x0)`` of ``spec`` on the paper's problem
    (or ``prob``), through the kernel route (``impl=kernel``), with the
    telemetry wrapper where ``wrapped``."""
    import torch

    from repro_torch.bench import saga
    from repro_torch.core.schedule import build_graph
    from repro_torch.core.solver import make_solver
    from repro_torch.obs import telemetry
    from repro_torch.paper_fig2 import _estimator
    from repro_torch.problems.logistic import LogisticProblem

    prob = prob or LogisticProblem()
    graph, ex = build_graph(gspec, prob.n_agents)
    est = saga(prob) if spec.startswith("ltadmm") else _estimator("sgd",
                                                                 prob)
    if "compressor=" in spec:
        spec = with_impl(spec)
    s = make_solver(spec, graph, ex, est, device=dev)
    if wrapped:
        s = telemetry.with_telemetry(s)
    data = {k: v.to(dev) for k, v in prob.make_data(0).items()}
    return s, data, torch.zeros((prob.n_agents, prob.n), device=dev)


def obs_parity(rounds=4):
    """The tx-parity matrix through the kernels: every round, the busiest
    agent's measured tx bytes equal ``wire_bytes(params, t)``, and every
    counter field equals the CPU run's (masks and payload shapes, not the
    trajectory, set the counters)."""
    import numpy as np

    from repro_torch.core import jaxrand
    from repro_torch.obs.telemetry import counters

    params = {"x": np.zeros(5, np.float32)}
    for gspec, fl in OBS_GRAPHS:
        for spec in OBS_SOLVER_SPECS:
            spec = spec + ("," + fl if fl else "")
            runs = {}
            for dev in (DEV, "cpu"):
                s, data, x0 = obs_solver(spec, gspec, dev)
                st = s.init(x0)
                snaps = [counters(st)]
                for t in range(rounds):
                    st = s.step(st, data, jaxrand.key(t))
                    snaps.append(counters(st))
                runs[dev] = (s, snaps)
            s, snaps = runs[DEV]
            for t in range(rounds):
                tx = int((snaps[t + 1]["tx_bytes"]
                          - snaps[t]["tx_bytes"]).max())
                if tx != s.wire_bytes(params, t=t):
                    raise AssertionError(
                        f"obs {spec} on {gspec}: round {t} measured {tx} "
                        f"B != wire_bytes {s.wire_bytes(params, t=t)}")
            for a, b in zip(snaps, runs["cpu"][1]):
                for f in a:
                    if not np.array_equal(a[f], b[f]):
                        raise AssertionError(f"obs {spec} on {gspec}: {f} "
                                             "differs from the CPU run")
        log(f"[obs] tx parity on {gspec}{' + faults' if fl else ''}: "
            f"{len(OBS_SOLVER_SPECS)} solvers x {rounds} rounds, the busiest"
            f" agent's measured bytes == wire_bytes(params, t) each round,"
            f" every counter == the CPU run's")


def run_perf_smoke(rounds):
    """``repro_torch.perf_smoke`` once per script (the obs and harness
    phases share it), into the gitignored build directory."""
    global PERF_SMOKE
    if PERF_SMOKE is None:
        from repro_torch import perf_smoke

        path = os.path.join(ROOT, "build", "perf_smoke", "bench.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        t0 = time.perf_counter()
        payload = perf_smoke.perf_smoke(
            path, device=DEV, impl="kernel", rounds=rounds,
            kernel_iters=20 if DEV == "cuda" else 2)
        PERF_SMOKE = (payload, path, time.perf_counter() - t0)
    return PERF_SMOKE


def obs_bench_rows(rounds):
    """The perf-smoke rows' BENCH telemetry dicts, exact (at 600 rounds;
    the rehearsal's shorter run holds the ring row's per-round counts)."""
    payload, path, secs = run_perf_smoke(rounds)
    log(f"[obs] perf_smoke {rounds} rounds: {secs:.1f} s, backend "
        f"{payload['backend']}, device {payload['device']}, power limit "
        f"{payload['power_limit']}")
    for row in payload["results"]:
        log(f"[obs] BENCH {row['name']}: rounds_to_tol="
            f"{row['rounds_to_tol']} wire={row['wire_bytes_per_round']} "
            f"cold {row['cold_wall_s']} s warm {row['warm_wall_s']} s "
            f"telemetry={row.get('telemetry')}")
        if row["name"] == "dada/complete16/learned-graph":
            r2t, wire, _ = DADA_PERF_REFERENCE
            if ("telemetry" in row or row["rounds_to_tol"] != r2t
                    or row["wire_bytes_per_round"] != wire):
                raise AssertionError(f"BENCH {row['name']}: {row}")
        if row["spec"] not in OBS_BENCH:
            continue
        tel = row["telemetry"]
        (tx, msgs, parts), r2t, wire = OBS_BENCH[row["spec"]]
        got = (tel["tx_bytes_max_agent"], tel["tx_msgs_total"],
               tel["participations_total"])
        if rounds == OBS_ROUNDS:
            want = (tx, msgs, parts)
        elif row["spec"] == "ring":
            want = (36 * rounds, 40 * rounds, 10 * rounds)
        else:
            want = got
        if (got != want or tel["rx_dropped_total"] or tel["naks_total"]
                or tel["rounds"] != rounds
                or row["wire_bytes_per_round"] != wire
                or (rounds == OBS_ROUNDS and row["rounds_to_tol"] != r2t)):
            raise AssertionError(f"BENCH {row['name']}: {row}, expected "
                                 f"telemetry {want}, rounds_to_tol {r2t}, "
                                 f"{wire} B")
    if payload["backend"] != DEV:
        raise AssertionError(f"BENCH backend {payload['backend']}")
    for k in payload["kernels"]:
        log(f"[obs] BENCH {k['name']}: {k['us_per_call']} us "
            f"({k['derived']})")


def obs_fault_row(rounds):
    """The combined-fault row telemetry-wrapped on the card and on the
    CPU: every counter field equal (the fault masks and schedules set
    them)."""
    import numpy as np

    from repro_torch import fault_sweep
    from repro_torch.bench import run_solver
    from repro_torch.obs import telemetry
    from repro_torch.perf_smoke import telemetry_dict

    tel = {}
    for dev in (DEV, "cpu"):
        prob, data, solver = fault_sweep.solver_for(
            fault_sweep.SMOKE_FAULTS, device=dev, impl="kernel")
        s = telemetry.with_telemetry(solver)
        _, _, st = run_solver(prob, data, s, rounds, metric_every=10,
                              return_state=True)
        tel[dev] = telemetry.counters(st)
    for f in tel["cpu"]:
        if not np.array_equal(tel[DEV][f], tel["cpu"][f]):
            raise AssertionError(f"fault row {f}: {tel[DEV][f]} != the CPU "
                                 f"run's {tel['cpu'][f]}")
    d = telemetry_dict(tel[DEV])
    kinds = {f: int(tel[DEV][f].sum()) for f in
             ("rx_crc_rejects", "rx_tag_rejects", "rx_dropped", "naks")}
    if kinds["rx_dropped"] != kinds["rx_crc_rejects"] + kinds[
            "rx_tag_rejects"]:
        raise AssertionError(f"fault kinds do not partition: {kinds}")
    log(f"[obs] admm/ring/q8+saga+faults wrapped, {rounds} rounds: {d}, "
        f"{kinds}; every field equal to the CPU run's")


def obs_bit_identity(prob, data, rounds=3):
    """ring-faults-qbit8 at n = 2^20: the wrapped trajectory is the
    unwrapped one, every state leaf ``torch.equal``."""
    import torch

    from repro_torch.core import jaxrand
    from repro_torch.obs import telemetry

    plain, x0, *_ = wide_solver("ring-faults-qbit8", prob, torch.device(DEV))
    wrapped = telemetry.with_telemetry(
        wide_solver("ring-faults-qbit8", prob, torch.device(DEV))[0])
    sp, sw = plain.init(x0), wrapped.init(x0)
    base = jaxrand.key(12345)
    for i in range(rounds):
        sp = plain.step(sp, data, jaxrand.fold_in(base, i))
        sw = wrapped.step(sw, data, jaxrand.fold_in(base, i))
    for f in sp._fields:
        a, b = getattr(sp, f), getattr(sw.inner, f)
        same = (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b)
        if not same:
            raise AssertionError(f"wrapped ring-faults-qbit8: {f} differs")
    log(f"[obs] ring-faults-qbit8 n={prob.n}: {rounds} wrapped rounds "
        "bit-identical to the unwrapped ones (torch.equal on every state "
        f"leaf); counters {telemetry.counters(sw)['tx_bytes'].tolist()}")


def sync_warnings(fn):
    """Host syncs ``fn()`` makes, as torch's sync debug mode warns them
    (the mode is process-wide: restored in ``finally``)."""
    import warnings

    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            fn()
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return len([x for x in w if "synchroniz" in str(x.message)])


def device_launches(fn):
    """Device activities (kernels, copies, fills) of one ``fn()`` in
    torch.profiler: the fewest over three profiled calls (the same round
    read 28 activities more in one profile than in another)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    counts = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts.append(sum(1 for e in prof.events() if e.device_type
                          == torch.autograd.DeviceType.CUDA))
    return min(counts)


def timed_round(fn, iters):
    """Mean host-clock ms of ``fn()`` over ``iters`` calls, the card
    synchronised before and after."""
    for _ in range(2):
        fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t0) * 1e3 / iters


def obs_overhead(wide_prob, wide_data_):
    """The wrapped round beside the unwrapped one (host clock, turns
    plain, wrapped, wrapped, plain) at the paper's size and at n = 2^20;
    on the card the sync warnings of one round each (must be equal) and
    the tap's device launches a round (profiled round, wrapped less
    unwrapped)."""
    import torch

    from repro_torch.core import jaxrand
    from repro_torch.obs import telemetry

    dev = torch.device(DEV)
    key = jaxrand.key(3)
    for label, gspec, fl in OBS_TIMED:
        spec = "ltadmm:compressor=qbit:bits=8" + ("," + fl if fl else "")
        for size in ("paper", "wide"):
            if size == "paper":
                plain, data, x0 = obs_solver(spec, gspec, dev, wrapped=False)
                iters = 100 if DEV == "cuda" else 5
            else:
                plain, x0, *_ = wide_solver(label, wide_prob, dev)
                data, iters = wide_data_, 10 if DEV == "cuda" else 2
            wrapped = telemetry.with_telemetry(plain)
            sp, sw = plain.init(x0), wrapped.init(x0)
            sp = plain.step(sp, data, key)  # k = 1: past the first round
            sw = wrapped.step(sw, data, key)

            def run_p():
                return plain.step(sp, data, key)

            def run_w():
                return wrapped.step(sw, data, key)

            p1 = timed_round(run_p, iters)
            w1 = timed_round(run_w, iters)
            w2 = timed_round(run_w, iters)
            p2 = timed_round(run_p, iters)
            p, w = (p1 + p2) / 2, (w1 + w2) / 2
            extra = ""
            if DEV == "cuda":
                sp_w, sw_w = sync_warnings(run_p), sync_warnings(run_w)
                lp, lw = device_launches(run_p), device_launches(run_w)
                if sw_w != sp_w:
                    raise AssertionError(
                        f"{label} {size}: the wrapped round makes {sw_w} "
                        f"host syncs, the unwrapped one {sp_w}")
                extra = (f"; sync warnings a round {sp_w} vs {sw_w}; device"
                         f" launches a round {lp} vs {lw}: the tap's {lw - lp}")
            log(f"[obs] {label} {size} (n={x0.shape[1]}): round {p:.4f} ms "
                f"unwrapped ({p1:.4f}, {p2:.4f}), {w:.4f} ms wrapped ({w1:.4f},"
                f" {w2:.4f}): {100 * (w / p - 1):+.2f} % (host clock, "
                f"{iters} rounds a reading){extra}")
            del sp, sw, plain, wrapped


def phase_obs(rounds=OBS_ROUNDS):
    import torch

    from repro_torch.obs import summary, trace
    from repro_torch.problems.logistic import LogisticProblem

    path = os.path.join(ROOT, "build", "obs", "obs.trace.jsonl")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t0 = time.perf_counter()
    with trace.Tracer(path) as tracer:
        with tracer.span("tx-parity"):
            obs_parity()
        with tracer.span("perf-smoke"):
            obs_bench_rows(rounds)
        with tracer.span("fault-row"):
            obs_fault_row(rounds)
        prob = LogisticProblem(n=WIDE_N)
        data = wide_data(prob, torch.device(DEV))
        with tracer.span("bit-identity"):
            obs_bit_identity(prob, data)
            sync()
        with tracer.span("overhead"):
            obs_overhead(prob, data)
            sync()
        tracer.counter("obs", phases=5)
        del data
    for line in summary.summarize(trace.load_events(path)).splitlines():
        log(f"[obs] trace {line}")
    log(f"[obs] phase {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase dada: learned collaboration graphs at the paper's size
# ---------------------------------------------------------------------------

# The live reference on the CPU (jax 0.9.0; benchmarks/
# personalization_sweep.py): the perf row (rounds_to_tol at tol 2e-3,
# wire bytes, final metric at round 400) and the sweep's rows at 300
# rounds, separation -> (consensus loss, dada loss, edge P, edge R).
# Under jax's older Threefry mode the perf row gives 200 (the BENCH
# file's) and the sweep 0.6325 / 0.4542 at separation 3.
DADA_PERF_REFERENCE = (190, 62, 9.721844689920545e-04)
DADA_SWEEP_REFERENCE = {
    0.0: (0.6943814754486084, 0.7090305685997009, 0.2, 0.125),
    1.0: (0.6455972790718079, 0.4964939057826996, 1.0, 1.0),
    3.0: (0.6352057456970215, 0.44385233521461487, 1.0, 1.0)}
DADA_LOSS_TOL = 2e-3  # |test loss - the reference's|
DADA_METRIC_RTOL = 1e-3  # the perf metric, card vs CPU, at every sample


def phase_dada(perf_rounds=400, sweep_rounds=300):
    """The dada perf row on the card (cold, then warm) and its metric
    trajectory against the CPU run's; then the personalization sweep's
    rows against the live reference's.  The paper-size spec compresses
    with the identity: no kernel of the port runs here (the wide phase's
    dada-qbit8 launches K4/K5)."""
    import numpy as np

    from repro_torch import personalization_sweep as ps

    if ps.DADA_SPEC != DADA_SPEC:
        raise AssertionError(f"DADA_SPEC {DADA_SPEC} != {ps.DADA_SPEC}")
    t0 = time.perf_counter()
    reset_counts()
    row = ps.perf_row(rounds=perf_rounds, device=DEV)
    counts = {k: v for k, v in read_counts().items() if v}
    _, idx, card, _ = ps.perf_trajectory(rounds=perf_rounds, device=DEV)
    _, _, cpu, _ = ps.perf_trajectory(rounds=perf_rounds, device="cpu")
    rel = float(np.max(np.abs(card / cpu - 1)))
    r2t, wire, final = DADA_PERF_REFERENCE
    log(f"[dada] perf row {row['name']} ({perf_rounds} rounds): "
        f"rounds_to_tol={row['rounds_to_tol']} (reference {r2t}) wire="
        f"{row['wire_bytes_per_round']} ({wire}) final="
        f"{row['final_gradnorm_sq']:.6e} (reference {final:.6e}) cold "
        f"{row['cold_wall_s']} s warm {row['warm_wall_s']} s; the metric "
        f"at round {idx[r2t // 10 - 1] if perf_rounds >= r2t else '-'}: "
        f"{card[min(r2t, perf_rounds) // 10 - 1]:.6e}; card vs CPU at "
        f"every sample: max relative {rel:.3e}; launches {counts}")
    if (row["wire_bytes_per_round"] != wire or rel > DADA_METRIC_RTOL
            or (perf_rounds >= r2t and row["rounds_to_tol"] != r2t)):
        raise AssertionError(f"dada perf row {row}")
    if perf_rounds == 400 and abs(row["final_gradnorm_sq"] / final
                                  - 1) > DADA_METRIC_RTOL:
        raise AssertionError(f"dada final {row['final_gradnorm_sq']}")
    t1 = time.perf_counter()
    for name, cons, dd, p, r in ps.run(print_rows=False,
                                       rounds=sweep_rounds, device=DEV):
        sep = float(name.rpartition("=")[2])
        want = DADA_SWEEP_REFERENCE[sep]
        log(f"[dada] {name}: consensus {cons:.6f} dada {dd:.6f} edge P/R "
            f"{p:.3f}/{r:.3f} (reference {want[0]:.6f} {want[1]:.6f} "
            f"{want[2]:.3f}/{want[3]:.3f}; {sweep_rounds} rounds)")
        if sweep_rounds == 300 and not (
                abs(cons - want[0]) < DADA_LOSS_TOL
                and abs(dd - want[1]) < DADA_LOSS_TOL):
            raise AssertionError(f"{name}: {cons}, {dd}")
        if sep > 0 and sweep_rounds == 300 and (p, r) != (1.0, 1.0):
            raise AssertionError(f"{name}: edge P/R {p}/{r}")
    log(f"[dada] sweep {time.perf_counter() - t1:.1f} s; phase "
        f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase harness: the paper's harnesses (Fig. 1, Table I, sweeps, perf-smoke)
# ---------------------------------------------------------------------------

# The live reference on the CPU (jax 0.9.0), 1500 rounds sampled every 50:
# name -> (rounds_to_tol at 1e-8, wire bytes, rate per round); the CPU test
# (tests/test_torch_harness.py) holds the port's run to the reference's
FIG1_REFERENCE = {"q8": (100, 36, -0.07008361434936523),
                  "q4": (100, 28, -0.07011503982543946),
                  "randk_k3": (100, 48, -0.070930362701416),
                  "identity": (100, 80, -0.07003121566772462)}
FIG1_KERNELS = {"q8": ("quantize_plane", "dequantize_plane"),
                "q4": ("quantize_plane", "dequantize_plane"),
                "randk_k3": ("sparse_gather", "sparse_scatter"),
                "identity": ()}
TABLE1_REFERENCE = [
    ("table1/lead", 55.0), ("table1/cedas", 105.0),
    ("table1/cold_dpdc_sgd", 55.0), ("table1/cold_dpdc_full", 550.0),
    ("table1/lt-admm-cc", 124.0), ("table1/wire_bytes_f32", 16000000),
    ("table1/wire_bytes_q8", 4000016), ("table1/wire_bytes_q4", 2000016),
    ("table1/wire_bytes_randk25", 4000000)]
# the reference's sweeps at their default rounds: name -> (wire bytes,
# t/round, rate per round); every final ||grad F||^2 there is below 1.2e-16
SWEEP_REFERENCE = {
    "topology/ring": (36, 124.0, -0.07112550961856787),
    "topology/star": (162, 122.0, -0.15944538688369198),
    "topology/complete": (162, 194.0, -1.1302548293780568),
    "topology/erdos0.4": (90, 136.0, -0.21343785871493273),
    "topology/smallworld0.2": (108, 152.0, -0.5536274091434863),
    "schedule/ring": (36, 124.0, -0.07112550961856787),
    "schedule/cycle:ring,star": (99, 123.0, -0.12669095180118964),
    "schedule/complete": (162, 194.0, -1.1302548293780568),
    "schedule/drop0.1:complete": (153, 184.375, -0.9388447541456952),
    "schedule/drop0.3:complete": (118, 165.625, -0.701639337299251),
    "schedule/drop0.5:complete": (89, 147.875, -0.43982203301643663),
    "schedule/gossip3:ring": (15, 110.0, -0.019937820475299066),
    "schedule/churn0.2:complete": (126, 141.825, -0.6180307469909048),
    "schedule/burst0.2-0.5:complete": (103, 126.58749999999999,
                                       -0.4867644877849888),
    "schedule/sample0.5:complete": (58, 72.0, -0.16821179841884334)}
# participation_sweep's rows (participation, rounds_to_tol at 1e-10,
# t/round, wire bytes) at its 5000 rounds; each reaches 1e-10 by round
# 190, so the card runs PARTICIPATION_ROUNDS
PARTICIPATION_REFERENCE = {
    "sample:frac=1.0,base=complete,seed=0": (1.0, 20, 194.0, 162),
    "sample:frac=0.75,base=complete,seed=0": (0.8, 40, 139.2, 118),
    "sample:frac=0.5,base=complete,seed=0": (0.5, 90, 72.0, 58),
    "sample:frac=0.25,base=complete,seed=0": (0.3, 190, 38.5125, 15)}
FIG1_ROUNDS, PARTICIPATION_ROUNDS = 1500, 300
SWEEP_RATE_TOL = 0.1  # |rate / reference's - 1|: the fit's last points
# sit just above the 1e-14 floor, where f32 rounding differs


def phase_harness(fig1_rounds=FIG1_ROUNDS, sweep_rounds=None,
                  part_rounds=PARTICIPATION_ROUNDS, smoke_rounds=OBS_ROUNDS):
    from repro_torch import (paper_fig1, paper_table1, schedule_sweep,
                             topology_sweep)
    from repro_torch.bench import linear_rate, rounds_to_tol
    from repro_torch.obs import summary, trace

    t0 = time.perf_counter()
    for name in paper_fig1.SPECS:
        reset_counts()
        t1 = time.perf_counter()
        idx, gns, wire = paper_fig1.variant(name, fig1_rounds, device=DEV,
                                            impl="kernel")
        secs = time.perf_counter() - t1
        counts = read_counts()
        r2t, rate = rounds_to_tol(idx, gns, paper_fig1.TOL), linear_rate(
            idx, gns)
        ref_r2t, ref_wire, ref_rate = FIG1_REFERENCE[name]
        log(f"[harness] fig1/{name}: rounds_to_tol={r2t} (reference "
            f"{ref_r2t}) wire={wire} ({ref_wire}) final={gns[-1]:.3e} "
            f"rate={rate:.5f} (the reference's CPU run {ref_rate:.5f}) "
            f"{fig1_rounds} rounds in {secs:.1f} s launches="
            f"{ {k: v for k, v in counts.items() if v} }")
        if (r2t, wire) != (ref_r2t, ref_wire):
            raise AssertionError(f"fig1/{name}: {r2t}, {wire} B")
        if (fig1_rounds == FIG1_ROUNDS and name != "identity"
                and not gns[-1] < 1e-12):
            raise AssertionError(f"fig1/{name}: final {gns[-1]} >= 1e-12")
        if (fig1_rounds == FIG1_ROUNDS
                and not abs(rate / ref_rate - 1) < SWEEP_RATE_TOL):
            raise AssertionError(f"fig1/{name}: rate {rate}")
        if DEV == "cuda" and not all(counts[k] for k in FIG1_KERNELS[name]):
            raise AssertionError(f"fig1/{name}: {FIG1_KERNELS[name]} not "
                                 "launched")
    rows = paper_table1.run(print_rows=False)
    if rows != TABLE1_REFERENCE:
        raise AssertionError(f"Table I {rows}")
    log(f"[harness] Table I equal to the reference's: {rows}")
    t1 = time.perf_counter()
    kw = {} if sweep_rounds is None else {"rounds": sweep_rounds}
    sweep = (topology_sweep.run(print_rows=False, device=DEV, impl="kernel",
                                **kw)
             + schedule_sweep.run(print_rows=False, device=DEV,
                                  impl="kernel", **kw))
    for name, final, rate, wire, t_round in sweep:
        ref_wire, ref_t, ref_rate = SWEEP_REFERENCE[name]
        log(f"[harness] {name}: final={final:.3e} rate={rate:.4f} "
            f"(reference {ref_rate:.4f}) wire={wire} ({ref_wire}) "
            f"t/round={t_round} ({ref_t})")
        if (wire, t_round) != (ref_wire, ref_t):
            raise AssertionError(f"{name}: {wire} B, t/round {t_round}")
        if sweep_rounds is None and not (
                final < 1e-12 and abs(rate / ref_rate - 1) < SWEEP_RATE_TOL):
            raise AssertionError(f"{name}: final {final}, rate {rate}")
    log(f"[harness] topology_sweep and schedule_sweep "
        f"({'default rounds' if sweep_rounds is None else sweep_rounds}): "
        f"{len(sweep)} rows in {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    for spec, part, r2t, t_round, wire, final in \
            schedule_sweep.participation_sweep(
                rounds=part_rounds, print_rows=False, device=DEV,
                impl="kernel"):
        want = PARTICIPATION_REFERENCE[spec]
        log(f"[harness] participation {spec}: participation={part} "
            f"rounds_to_tol={r2t} t/round={t_round} wire={wire} "
            f"final={final:.3e} (reference {want})")
        if part_rounds > want[1] and (part, r2t, t_round, wire) != want:
            raise AssertionError(f"participation {spec}")
    log(f"[harness] participation_sweep at {part_rounds} rounds (the "
        f"reference's 5000; every row reaches 1e-10 by round 190): "
        f"{time.perf_counter() - t1:.1f} s")
    payload, path, _ = run_perf_smoke(smoke_rounds)
    tpath = os.path.splitext(path)[0] + ".trace.jsonl"
    events = trace.load_events(tpath)
    names = [e["name"] for e in events]
    if names != ["cold", "warm"] * 3 + ["dada", "faults", "kernels"]:
        raise AssertionError(f"perf-smoke trace spans {names}")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.summary", tpath],
        capture_output=True, text=True, timeout=120, check=True,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    if out.stdout.rstrip("\n") != summary.summarize(events):
        raise AssertionError("python -m repro_torch.obs.summary differs")
    for line in out.stdout.splitlines():
        log(f"[harness] perf-smoke trace {line}")
    log(f"[harness] BENCH schema keys {sorted(payload)}; phase "
        f"{time.perf_counter() - t0:.1f} s")


def rehearse():
    """Every phase but device, build and timing on the CPU at a tiny
    size, the kernels replaced by their plain versions, on one CPU thread
    (the sizes gain nothing from more, and the test suite's workers share
    the cores); prints no result."""
    global WIDE_N, ODD_N, PAPER_ROUNDS, WIDE_ROUNDS, DEV, WIDE_SPLIT, SMOKE
    WIDE_N, ODD_N, PAPER_ROUNDS, WIDE_ROUNDS, DEV = 4096, 4099, 150, 4, "cpu"
    WIDE_SPLIT = 1024
    import torch

    torch.set_num_threads(1)
    from repro_torch.core import jaxrand

    seed = jaxrand.key_seed(jaxrand.fold_in(jaxrand.key(7), 13))
    check_k0(seed, "cpu")
    check_k1(seed, "cpu")
    check_k23(seed, "cpu")
    check_k45("cpu")
    check_k67("cpu")
    check_k89("cpu")
    check_k10("cpu", [(lab, 1, h, kh, 256, dh)
                      for lab, _, h, kh, _, dh in K10_CASES],
              [(lab, 1, h, kh, min(t, 256), s - t + min(t, 256), *rest)
               for lab, _, h, kh, t, s, *rest in K10_TC_CASES])
    check_k11("cpu", [(lab, 1, 256, min(nh, 8), hd, ng, ds, chunk, decay)
                      for lab, _, _, nh, hd, ng, ds, chunk, decay
                      in K11_CASES])
    phase_paper(PAPER_ROUNDS)
    phase_paper_schedules(30, kind_rounds=11)  # rounds_to_tol 20 in 30
    phase_paper_faults(PAPER_ROUNDS, 120)  # every row's 1e-8 by round 110
    phase_fig2(110, 250)  # LT-ADMM-CC reaches 1e-8 at round 100
    phase_wide(WIDE_ROUNDS)
    phase_obs(rounds=30)
    phase_dada(perf_rounds=60, sweep_rounds=20)
    phase_harness(fig1_rounds=200, sweep_rounds=20, part_rounds=20,
                  smoke_rounds=30)
    SMOKE = True
    phase_serve()
    log("[rehearse] done on the CPU; no result")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="device,build,kernels,paper,fig2,obs,dada,"
                    "harness,wide,profile,serve",
                    help="comma-separated subset of the phases, for bring-up")
    ap.add_argument("--rehearse", action="store_true",
                    help="run the phases on the CPU at a tiny size (exits 3)")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch

    if args.rehearse:
        rehearse()
        return 3
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.core import jaxrand

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, _ = phase_device()
    if "build" in phases:
        phase_build()
        phase_sass()
    seed = jaxrand.key_seed(jaxrand.fold_in(jaxrand.key(7), 13))
    k0 = None
    if "kernels" in phases:
        k0 = check_k0(seed, torch.device("cuda"))
        check_k1(seed, torch.device("cuda"))
        check_k23(seed, torch.device("cuda"))
        check_k45(torch.device("cuda"))
        check_k67(torch.device("cuda"))
        check_k89(torch.device("cuda"))
        check_k10(torch.device("cuda"))
        check_k11(torch.device("cuda"))
    if "paper" in phases:
        phase_paper(PAPER_ROUNDS)
        phase_paper_schedules(PAPER_ROUNDS)
        phase_paper_faults(PAPER_ROUNDS, PAPER_ROUNDS)
    if "fig2" in phases:
        phase_fig2(FIG2_ADMM_ROUNDS, FIG2_BASELINE_ITERS)
    if "obs" in phases:
        phase_obs()
    if "dada" in phases:
        phase_dada()
    if "harness" in phases:
        phase_harness()
    rows = None
    if "wide" in phases:
        counts, shapes = phase_wide(WIDE_ROUNDS)
        missing = [kk for kk in ("quantize_plane", "dequantize_plane",
                                 "randk_gather_plane",
                                 "randk_scatter_plane", "quantize_tensor",
                                 "dequantize_tensor", "sparse_gather",
                                 "sparse_scatter", "cyclic_gather",
                                 "cyclic_scatter")
                   if not any(c[kk] for c in counts.values())]
        if missing:
            raise AssertionError(f"main path never launched {missing}")
        if k0 is not None:
            rows = time_kernels(seed, k0, counts, shapes)
    if "profile" in phases:
        prof = {}
        for label in ("qbit8", "ring-faults-qbit8", "randk-stride",
                      "randk-uniform", "choco-topk", "drop-qbit8",
                      "churn-tree-randk-block", "choco-drop-randk-block",
                      "dada-qbit8"):
            # dada's window holds one graph round in five, its cadence
            prof[label] = phase_profile(
                label, rounds=5 if label == "dada-qbit8" else 3)
        (fw, fb), (uw, ub) = prof["ring-faults-qbit8"], prof["qbit8"]
        log(f"[profile] ring-faults-qbit8 vs qbit8: round {fw:.3f} vs "
            f"{uw:.3f} ms, device busy {fb:.3f} vs {ub:.3f} ms a round")
    if "serve" in phases:
        serve_counts = phase_serve()
        rows = (rows or []) + time_serve_kernels(serve_counts)
    if rows is not None:
        print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
