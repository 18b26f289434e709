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
  mesh. the multi-process exchange (``Exchange(topo, axis, mesh)``) in a
     one-rank NCCL world started from a FileStore (no fallback backend),
     on its (1, 1) ("data", "model") mesh: LT-ADMM-CC at the paper's size
     (qbit8 and Fig. 1's RandK stride on the ring, q8 on drop0.3; 110
     rounds) through the mesh and the host exchange, rounds_to_tol, wire
     bytes, the metric and every state leaf equal; at n = 2^20 on the
     ring (qbit8; RandK stride) 5 rounds each way with the counters zeroed
     just before and read just after (2 K1 + 4 K5; 2 K2 + 4 K3 a round on
     both), every state leaf bit-equal, the collectives a round and their
     bytes, the round beside the host round in turns, and one profiled
     mesh round with the consensus all_reduce (NCCL's kernels, launches
     and device time, the idle share); CHOCO qbit8 (K4 and K5 launched)
     and dada at the paper's size over the mesh and the host exchange
     (plain SGD; rounds_to_tol, wire bytes, the metric and every state
     leaf equal); with two cards also a two-rank
     NCCL world (5 agents a rank) held bit for bit against the one-card
     host run, else a line saying it waits for such a machine;
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
  train. the training path: ``launch/train.py --smoke --agents 4
     --rounds 3 --telemetry`` on the card and on the CPU (header
     integers, telemetry and the losses equal to the reference's; card
     vs CPU mean_loss within 1e-4, consensus_err within 1e-3 relative);
     one K5 ``dequantize_plane`` call of [12, 187,045,376] elements, past
     its C entry's limit, in row groups, every row bit-equal to the plain
     version; ``build_train`` at qwen3-0.6b's widths cut to 2 layers, f32,
     4 agents on the ring, qbit8, SVRG, 5 rounds, counters zeroed just
     before and read just after (2 K1 and 4 K5 a round), round 1's K1/K5
     calls held bit for bit against their plain versions (in column
     windows), mean_loss finite, the round time, peak memory and a
     profiled round (device busy, K1/K5's share), K1/K5 timed at the
     training planes; 3 DDP Adam steps on the same model (the loss
     falls); granite-moe-1b-a400m at full width in bf16: a prefill at
     B = 2, T = 2048 (its MoE aux loss finite) and 8 greedy steps.
  zoo. deepseek-v2-lite-16b (MLA, its leading dense layer, 64 routed
     experts) at its published widths and all 27 layers in bf16, weights
     from the port's init_params (the reference's 15,496,769,024): a
     prefill at B = 2, T = 2048 (the dense MLA branch) timed at its
     first and second call, logits and MoE aux finite, and profiled (the
     idle share, the top kernels), one at B = 1, T = 4096 (the blockwise
     branch), 8 greedy steps from an 8-token prompt; the same widths cut
     to the dense layer and one MLA + MoE unit in f32, no expert
     capacity drop: a T = 64 prefill's last logits against
     token-by-token absorbed decoding within 1e-4, argmax equal;
     xlstm-125m at its published widths and 12 layers in bf16
     (161,480,528 parameters): a prefill at B = 2, T = 2048 timed twice,
     its first 512 tokens profiled (the idle share), 8 greedy steps; in
     f32 at T = 300 (mLSTM chunks of 256, the last padded) its prefill
     against token-by-token decoding: the first position within 1e-4,
     the sLSTM recurrence's growth past it reported, and the five mLSTM
     blocks alone within 1e-3 at every position; deepseek's smoke run
     through
     ``launch/train.py`` on the card and the CPU (the reference's
     integers and losses, consensus_err card vs CPU and against the
     reference's within 1e-3 relative), counters zeroed just before the
     card's run and read just after (2 K1 and 4 K5 a round), every K1/K5
     call held bit for bit against its plain version; seamless-m4t-medium
     (the encoder-decoder) at its published widths, 12 + 12 layers in
     bf16 (715,403,264 parameters): a prefill at B = 2, T = 2048 from 512
     source frames timed at its first and second call and profiled, one
     at B = 1, T = 4096 from 1024 frames (blockwise), 8 greedy steps from
     the 512-frame memory, the same prefill with use_flash with counters
     zeroed just before and read just after (12 non-causal and 12 causal
     launches of K10's tensor-core variant, every call held against its
     plain version, the last logits beside the plain prefill's), a
     2 + 2-layer f32 cut's prefill against token-by-token decoding within
     1e-4 at every position, then K10 timed at the two new shapes.
  dryrun. ``repro_torch.launch.dryrun`` in a fake world of 256 ranks on
     ``meta`` tensors: qwen3-0.6b at full width, cut to one layer (the
     train round at tau 1), on the four shapes, its roofline terms, op
     counts and useful fraction; the served prefill (qwen3-0.6b, B 4 x
     T 2048, bf16, K10) traced on ``meta`` on a world of one and run for
     real: the trace's total_live within 10 % of the card's peak
     (``max_memory_allocated`` less what was there before, plus the
     inputs), the real run's dot_flops (``OpCounter`` on the card) equal
     to the trace's, its measured ms beside the roofline terms.
  tp. tensor-parallel serving (``build_prefill`` / ``build_serve`` with a
     mesh) in a spawned world of two ranks, one ("data", "model") mesh of
     (1, 2): with two cards an NCCL world, one card a rank; with one card
     both ranks on it over gloo (NCCL refuses two ranks on one device),
     the backend printed.  qwen3-0.6b at full width and depth and
     zamba2-2.7b at full width cut to one unit (6 Mamba blocks and the
     shared block), bf16, weights from init_params(key(0)) cut to each
     rank's shard (``shard_params``): the prefill (B = 4 / 2, T = 2048)
     with counters zeroed just before and read just after (28 / 1
     tensor-core K10 launches a rank, at the rank's heads), every K10
     call of rank 0 held against its plain version; zamba2's Mamba
     blocks' inputs through ``mamba_forward(use_kernel=True)`` on each
     rank (6 tensor-core K11 launches at the rank's 40 heads, each
     held); the gathered last logits against rank 0's one-rank run of the
     same weights, and both against the same prefill in f32
     (``TP_DRIFT_FACTOR``; the rows whose argmax differs printed with
     their f32 margins); the tensor-parallel prefill in f32 against the
     one-rank f32 prefill within ``TP_F32_TOL`` of the logits' scale;
     greedy tokens (8 / 4 steps) equal on both ranks and to the one-rank
     run's; the prefill ms in turns with the one-rank run (CUDA events;
     the tensor-parallel turn's time inside the collectives over its span
     as the idle share), the decode ms a step and the peak memory, each
     rank's; an all_reduce's host ms at a decode's and a prefill's sizes
     (``TP_COLLECTIVES``); then K10 and K11 timed at the rank's shapes.
     Then tensor-parallel training (``tp_train``): qwen3-0.6b at full
     width cut to one layer, f32, per leaf (``build_train`` with the
     mesh: 2 agents, 2 rounds, qbit8 through K4's shard form, every call
     held) and by DDP (Adam at eps ``TP_TRAIN_EPS``, held, and 1e-8,
     printed) against each rank's one-rank run.  The phase must end
     within ``TP_PHASE_S`` seconds.
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

// K4's shard form's quantise element body (quantize.cuh shard_tile): a
// group's places in the whole leaf (ShardMap of index class kClass from a
// table entry), then K4's levels and packing
template <int kBits, int kClass, int kGroups>
__device__ __forceinline__ void shard_body(const float4* x,
                                           const uint32_t* entry, uint32_t s0,
                                           uint32_t s1, float sc,
                                           uint32_t* out, int n) {
  const repro::Pair st{s0, s1};
  const repro::ShardMap<kClass> map(entry);
  constexpr int g = kBits == 8 ? 1 : 2;
#pragma unroll 1
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
#pragma unroll
    for (int h = 0; h < kGroups; ++h) {
      const int k = i + h * n;
      uint32_t at[4 * g];
      map.run(static_cast<uint32_t>(4 * g * k), at);
      out[k] = repro::pack_group<kBits>(x + g * k, sc, [&](int e) {
        return repro::jax_bits(st.x0, st.x1, at[e]);
      });
    }
  }
}

#define REPRO_SHARD_BODY(name, bits, cls)                                    \
  extern "C" __global__ void name##_one(const float4* x, const uint32_t* e,  \
                                        uint32_t s0, uint32_t s1, float sc,  \
                                        uint32_t* out, int n) {              \
    shard_body<bits, cls, 1>(x, e, s0, s1, sc, out, n);                      \
  }                                                                          \
  extern "C" __global__ void name##_two(const float4* x, const uint32_t* e,  \
                                        uint32_t s0, uint32_t s1, float sc,  \
                                        uint32_t* out, int n) {              \
    shard_body<bits, cls, 2>(x, e, s0, s1, sc, out, n);                      \
  }
REPRO_SHARD_BODY(k4s0_b8, 8, 0)
REPRO_SHARD_BODY(k4s1_b8, 8, 1)
REPRO_SHARD_BODY(k4s2_b8, 8, 2)
REPRO_SHARD_BODY(k4s3_b8, 8, 3)
REPRO_SHARD_BODY(k4s1_b4, 4, 1)
REPRO_SHARD_BODY(k4s3_b4, 4, 3)

// the division count's control: a loop that divides by a run-time value
extern "C" __global__ void divides(uint32_t d, uint32_t* out, int n) {
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += gridDim.x * blockDim.x) {
    out[j] = static_cast<uint32_t>(j) / d;
  }
}
"""

WIDE_N = 2 ** 20
ODD_N = 1_000_003
# the paper rows' rounds: every number they hold (rounds_to_tol, at most
# 125 and the faulted rows' 110, the wire bytes, the launches) is reached
# by round 125 (600 rounds until the script neared its time limit)
PAPER_ROUNDS, WIDE_ROUNDS = 200, 20
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
    K1/K4 element body and K4's shard-form body by index class (sets
    BODY_SASS; raises if the shard form's loop divides)."""
    global TF_OPS, TF_LEAF_OPS, TF_COMPILED, TF_LEAF_COMPILED
    from repro_torch.kernels import _build

    src = _build.BUILD_DIR / "threefry_probe.cu"
    cubin = src.with_suffix(".cubin")
    src.write_text(SASS_PROBE)
    subprocess.run([_build.nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
                    "-cubin", f"-I{_build._CSRC}", "-o", str(cubin), str(src)],
                   check=True, capture_output=True, timeout=300)
    counts = sass_counts(cubin, suffixes=True)
    divisions = ptx_divisions(src)
    if not divisions["divides"]:
        raise AssertionError("the PTX division count misses a division")
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
    for key, name, group in (
            ("K1 b=8", "k1_b8", 4), ("K1 b=4", "k1_b4", 8),
            ("K4 b=8", "k4_b8", 4), ("K4 shard b=8 class 0", "k4s0_b8", 4),
            ("K4 shard b=8 class 1", "k4s1_b8", 4),
            ("K4 shard b=8 class 2", "k4s2_b8", 4),
            ("K4 shard b=8 class 3", "k4s3_b8", 4),
            ("K4 shard b=4 class 1", "k4s1_b4", 8),
            ("K4 shard b=4 class 3", "k4s3_b4", 8)):
        BODY_SASS[key] = body_sass(counts[f"{name}_one"],
                                   counts[f"{name}_two"], key, group)
        log(f"[sass] {key}: {divisions[f'{name}_two']} integer divisions "
            "and remainders in its PTX")
        if key.startswith("K4 shard") and divisions[f"{name}_two"]:
            raise AssertionError(f"{key}: the element loop divides")
    k10_sass()
    k11_sass()


def ptx_divisions(src):
    """{kernel: integer div / rem instructions} of a source's PTX.  In
    SASS a division by a loop-invariant value leaves the loop (its
    reciprocal is hoisted) and the steps left in it are multiply-highs
    like any other, so the count is taken where the division is still
    one instruction."""
    import re

    from repro_torch.kernels import _build

    ptx = src.with_suffix(".ptx")
    subprocess.run([_build.nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
                    "-ptx", f"-I{_build._CSRC}", "-o", str(ptx), str(src)],
                   check=True, capture_output=True, timeout=300)
    out, fn = {}, None
    for line in ptx.read_text().splitlines():
        head = re.match(r"\.visible \.entry (\w+)\(", line.strip())
        if head:
            fn = head.group(1)
            out[fn] = 0
        elif fn and re.search(r"\b(div|rem)\.(s|u)(32|64)\b", line):
            out[fn] += 1
    return out


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
    check_k4_shard(dev)


def k4_shard_cases():
    """K4's shard form's check tree: ``(label, whole leaf shape, plan
    (sharding.LeafPlan), messages)`` a leaf: [2, 2^20] of [2, 2^21] (a
    1024 x 2048 leaf cut on its columns), zamba2-2.7b's in_proj of one
    layer by SSD head (z, x and dt cut, B|C whole: four pieces), a leaf
    cut on dim 0 (an embedding's rows) and one held whole (a norm's
    scale); on the CPU the same cuts of small leaves."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.sharding import LeafPlan

    small = SMOKE or DEV != "cuda"  # the CPU rehearsal's sizes
    if small:
        ssm = ARCHS["zamba2-2.7b"].make_smoke().ssm
        wide = ((32, 64), LeafPlan(1, ((64, True),)))
        rows = ((96, 40), LeafPlan(0, ((96, True),)))
    else:
        ssm = ARCHS["zamba2-2.7b"].make(None).ssm
        wide = ((1024, 2048), LeafPlan(1, ((2048, True),)))
        rows = ((2048, 1000), LeafPlan(0, ((2048, True),)))
    di, gs, nh = ssm.d_inner, 2 * ssm.n_groups * ssm.d_state, ssm.n_heads
    cols = 2 * di + gs + nh
    return (("wide" if small else "[2, 2^20] of [2, 2^21]",) + wide + (2,),
            (f"zamba2 in_proj [{ssm.d_model}, {cols}]", (ssm.d_model, cols),
             LeafPlan(1, ((di, True), (di, True), (gs, False), (nh, True))),
             2),
            (f"rows {list(rows[0])} on dim 0",) + rows + (2,),
            ("whole [4097]", (4097,), LeafPlan(None), 2))


def hold_tree(got, want, label):
    """``quantize_tree``'s payloads ``[(q, scale)]`` against its plain
    version's, bit for bit; returns the leaves held."""
    import torch

    for i, ((q, sc), (qw, scw)) in enumerate(zip(got, want)):
        note_err("K4-shard", q, qw)
        if not (torch.equal(q, qw) and same_scale(sc, scw)):
            raise AssertionError(f"K4 shard form {label}, leaf {i}: "
                                 f"{int((q != qw).sum())} q mismatches, "
                                 "or the scale, differ from the plain "
                                 "version")
    if len(got) != len(want):
        raise AssertionError(f"K4 shard form {label}: {len(got)} leaves")
    return len(got)


def k4_shard_tree(xs, keys, plans, bits, data=1):
    """The ranks' shard-form payloads of a tree of whole messages
    (``xs[i]`` ``[M, *shape_i]``, cut by ``plans[i]`` over a "model" axis
    of 2 and, where a plan has a ``data_dim``, a "data" axis of
    ``data``): each rank's shards, its ``tree_absmax`` (one launch, held
    against its plain version), the MAX of the cut prefix over all of
    them (the all-reduce over the agent's group), then ``quantize_tree``
    (one launch, held bit for bit).  Returns ``[(layouts, shards, [(q,
    scale)])]`` by rank, (data, model) coordinates in order."""
    import torch

    from repro_torch.kernels.quantize import ops, ref
    from repro_torch.launch.sharding import P, leaf_layout, local_shard

    m = xs[0].shape[0]
    ranks = []
    for d, r in [(d, r) for d in range(data) for r in range(2)]:
        lays, shards = [], []
        for x, plan in zip(xs, plans):
            lay = leaf_layout(plan, tuple(x.shape[1:]), r, 2, d, data)
            if plan.dim is None and (plan.data_dim is None or data == 1):
                xs_r = x.reshape(m, -1)
            else:
                spec = [None] * x.dim()
                if plan.dim is not None:
                    spec[1 + plan.dim] = "model"
                if plan.data_dim is not None:
                    spec[1 + plan.data_dim] = "data"
                xs_r = local_shard(_StandIn(2, r, data, d), P(*spec), x,
                                   plan.segments or None).reshape(m, -1)
            lays.append(lay)
            shards.append(xs_r.contiguous())
        lays = tuple(lays)
        before = ops.tree_absmax.launches
        w = ops.tree_absmax(shards, lays)
        sync()
        if DEV == "cuda" and ops.tree_absmax.launches != before + 1:
            raise AssertionError("K4 shard form: tree_absmax not one launch")
        if not torch.equal(w, ref.tree_absmax_ref(shards, lays)):
            raise AssertionError("K4 shard form: tree_absmax differs")
        ranks.append((lays, shards, w))
    cut = ops.cut_rows(ranks[0][0], m)
    top = torch.stack([w[:cut] for _, _, w in ranks]).amax(0)
    out = []
    for lays, shards, w in ranks:
        before = ops.quantize_tree.launches
        got = ops.quantize_tree(keys, shards, w, lays, bits=bits,
                                reduced=top)
        sync()
        if DEV == "cuda" and ops.quantize_tree.launches != before + 1:
            raise AssertionError("K4 shard form: not one launch")
        hold_tree(got, ref.quantize_tree_ref(keys, shards, w, lays,
                                             bits=bits, reduced=top,
                                             window=PLAIN_WINDOW),
                  f"b={bits}")
        out.append((lays, shards, got))
    return out


class _StandIn:
    """A mesh stand-in of a "model" axis of n (and "data" of ``data``)
    for ``local_shard`` and ``shard_layouts``, at coordinates (d, r)."""

    def __init__(self, n, r, data=1, d=0):
        self.shape = {"data": data, "model": n}
        self.axis_names, self._c = ("data", "model"), {"model": r, "data": d}

    def get_local_rank(self, axis):
        return self._c[axis]


def check_k4_shard(dev):
    """K4's shard form (``tree_absmax`` + ``quantize_tree``) on two ranks'
    shards of the tree of ``k4_shard_cases``, b = 8 and 4, the
    quantiser's edge rows planted: each launch bit-equal to its plain
    version, and the two shards' levels, put back at their elements'
    places in the whole leaf, bit-equal to K4 (``quantize_tensor``) of
    the whole leaf, and so are the scales (a leaf held whole: each rank's
    payload is K4's)."""
    import torch

    from repro_torch.kernels.quantize import ops, ref

    g = torch.Generator(device=dev).manual_seed(5)
    cases = k4_shard_cases()
    plans = [c[2] for c in cases]
    m = cases[0][3]
    for bits in (8, 4):
        xs = []
        for _, shape, _, _ in cases:
            x = torch.randn((m,) + shape, generator=g, device=dev)
            ref.edge_rows(x.reshape(m, -1)[:, :4096])
            xs.append(x)
        keys = torch.randint(0, 2 ** 32, (m, len(cases), 2), generator=g,
                             device=dev, dtype=torch.int64)
        pair = k4_shard_tree(xs, keys, plans, bits)
        for i, (label, _, _, _) in enumerate(cases):
            flat = xs[i].reshape(m, -1)
            qw, scw = ops.quantize_tensor(keys[:, i], flat, bits=bits)
            sync()
            whole = (qw if bits == 8
                     else ref.unpack4(qw, flat.shape[-1]).to(torch.int8))
            got = torch.full_like(whole, -128 if bits == 8 else 99)
            for lays, shards, out in pair:
                q, sc = out[i]
                n = shards[i].shape[-1]
                lv = q if bits == 8 else ref.unpack4(q, n).to(torch.int8)
                got[:, lays[i].counters(dev) if lays[i].cut else
                    slice(None)] = lv
                if not same_scale(sc, scw):
                    raise AssertionError(f"K4 shard form {label}: scale")
            if not torch.equal(got, whole):
                raise AssertionError(f"K4 shard form {label} b={bits}: "
                                     f"{(got != whole).sum()} levels differ "
                                     "from K4 of the whole leaf")
        log(f"[kernels] K4 shard form b={bits}, one tree of "
            f"{[c[0] for c in cases]}, ranks' shards "
            f"{[tuple(s.shape) for s in pair[0][1]]} / "
            f"{[tuple(s.shape) for s in pair[1][1]]} (pieces "
            f"{[lay.pieces for lay in pair[0][0]]}): each rank's "
            "tree_absmax and quantize_tree one launch, bit-equal to its "
            "plain version")
        log(f"[kernels] K4 shard form b={bits}, every leaf of the tree: "
            "the ranks' levels at their places bit-equal to K4 of the "
            "whole leaf, scales too")


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
            "tree_absmax": qops.tree_absmax,
            "quantize_tree": qops.quantize_tree,
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
                "launches_push", "launches_unique", "launches_claim",
                "launches_two_axis")


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
# LT-ADMM-CC at the reference's budget; the baselines at a third of its
# 6000 iterations (the whole script's time limit): the "+full" rows reach
# 1e-8 by iteration 150 (16500 time units) and the floors are printed
# beside the reference's, not held
FIG2_ADMM_ROUNDS, FIG2_BASELINE_ITERS = 1200, 2000


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


def wide_solver(label, prob, dev, mesh=None):
    """``(solver, x0, graph spec, kernels, launches per round)`` of the
    wide spec ``label`` (through ``mesh``'s "data" axis where given)."""
    import torch

    from repro_torch.core.schedule import build_graph
    from repro_torch.core.solver import make_solver
    from repro_torch.paper_fig2 import _estimator

    _, spec, kind, used, gspec, tree, per_round = next(
        w for w in WIDE_SPECS if w[0] == label)
    graph, ex = build_graph(gspec, prob.n_agents,
                            axis=None if mesh is None else "data", mesh=mesh)
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


def serve_model(arch_id, dtype=None, cfg=None):
    """(arch, cfg, params): the config (``cfg``, a cut of the arch's, or
    its published one) with ``use_flash``, the port's init_params(key(0))
    weights on the device, in ``dtype`` (default the config's)."""
    import dataclasses

    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.core import jaxrand
    from repro_torch.launch.steps import model_specs
    from repro_torch.models import transformer as tr
    from repro_torch.models.common import init_params

    arch = ARCHS[arch_id]
    if cfg is None:
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
        full, _ = tr.forward(params, cfg, tokens=tokens)
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

    bf = torch.bfloat16
    rows = []
    for case, arch_id in zip(K10_CASES, SERVE_MODELS):
        time_k10(rows, case, bf, counts[arch_id]["flash_attention"],
                 f"{arch_id} prefill B={case[1]} T={case[4]}")
    time_k10(rows, ("qwen3 f32 prefill", 1, 16, 8, CONSISTENCY_T, 128),
             torch.float32, counts["f32"],
             f"qwen3-0.6b f32 prefill B=1 T={CONSISTENCY_T}")
    rows += time_k11(counts["zamba2-2.7b"]["ssd_chunked"])
    return rows


def time_k10(rows, case, dt, launches, launches_of):
    """K10 at one causal shape ``case`` (label, B, H, KH, T, Dh) in
    ``dt``: bf16 through the tensor-core variant (the CUDA-core kernel's
    bare time on the same inputs beside it), f32 through the CUDA-core
    one; appends its row (``launches`` on the main path)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as flops

    dev, bf = torch.device("cuda"), torch.bfloat16
    label, b, h, kh, t, dh = case
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
        launches_of=launches_of)
    if dt == bf:
        # q.k^T, p_hi.v and p_lo.v: three products of bf16 operands on
        # the tensor cores, one exp per pair on the SFUs
        add_row(
            rows, f"K10-tc flash_attention_tc {label} [{b}, {t}, {h}, "
            f"{dh}] kv {kh} causal bf16",
            "src/repro_torch/csrc/flash_attention_sm90.cu",
            "src/repro/kernels/flash_attention/kernel.py:84",
            launches,
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
            launches, kernel_ms=cc_ms, fp_ops=2 * 2 * dh * pairs,
            max_abs_err_bf16=ERRS.get("K10-cc"), **common)
    del q, k, v, out, qt, kt, vt


def time_k11(launches, case=K11_CASE, label="zamba2",
             launches_of="zamba2-2.7b's 54 Mamba blocks"):
    """K11 at an SSD shape ``case`` (B, T, NH, HD, NG, DS, chunk) in bf16:
    the tensor-core variant's wrapper and bare launch (the CUDA-core
    kernel's bare launch on the same inputs in turns beside it), the plain
    version, and the bound of the work each design does; then the
    CUDA-core variant's wrapper forced.  ``launches``: {variant: launches
    on the main path}, ``launches_of`` the blocks they come from.  Also
    prints what the tensor-core launches look like to the runtime."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.ssm_scan import ops as ssmops
    from repro_torch.kernels.ssm_scan import ref as ssmref
    from repro_torch.models.mamba import SSMConfig

    dev, bf = torch.device("cuda"), torch.bfloat16
    b, t, nh, hd, ng, ds, chunk = case
    cfg = SSMConfig(nh * hd // 2, d_state=ds, head_dim=hd, n_groups=ng,
                    chunk=chunk)
    x, bm, cm, alog = ssd_inputs(dev, b, t, nh, hd, ng, ds, bf)
    want = k11_plain(cfg, x, bm, cm, alog)
    for variant in ("tc", "cc"):
        got = k11_call(cfg, x, bm, cm, alog, variant, variant)
        log(f"[time] K11 ({variant}) {label}: "
            f"{hold_k11(got, want, f'{label} timed', variant)}")
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
                  launches_of=f"{launches_of}, kernel path")
    rows = []
    add_row(
        rows, f"K11-tc ssd_scan_tc [{b}, {nh}, {t}, {hd}] DS {ds} chunk "
        f"{chunk} bf16", "src/repro_torch/csrc/ssd_scan_sm90.cu",
        "src/repro/kernels/ssm_scan/kernel.py:81", launches["tc"],
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
        launches["cc"], cc_wrapper_ms, cc_ms,
        fp_ops=2 * heads * (tri * hd + 2 * chunk * ds * hd),
        bf16_ops=2 * heads * tri * ds,
        max_abs_err_f32=ERRS.get("K11-cc-f32"),
        **{**common, "launches_of": f"{launches_of}, CUDA-core variant "
           "forced"})
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


def graph_ms(fn, iters=20, replays=5):
    """Device ms of ``fn()``: ``iters`` calls captured in one CUDA graph,
    replayed ``replays`` times between CUDA events, so that the host's
    launch cost is not in it (a kernel a few microseconds long is
    host-bound when launched back to back)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm: caches, the occupancy query
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def graph_turns(a, b):
    """``graph_ms`` of ``a`` and ``b`` in turns a, b, b, a: each one's
    mean and its two readings."""
    ta, tb = [graph_ms(a)], [graph_ms(b)]
    tb.append(graph_ms(b))
    ta.append(graph_ms(a))
    return sum(ta) / 2, sum(tb) / 2, ta, tb


def idle_host_ms(fn, iters=20, warmup=3):
    """Mean host time of one ``fn()`` that starts on an idle card (a
    synchronise before each call, not timed), as a call finds the card
    after a collective that waited for it."""
    import torch

    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        total += time.perf_counter() - t
    torch.cuda.synchronize()
    return total / iters * 1e3


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
FIG1_ROUNDS, PARTICIPATION_ROUNDS = 500, 300
# Fig. 1 and the sweeps' rows run past the last point their rate fit takes
# (|grad|^2 above 1e-14: Fig. 1's at round 250 of the reference's 1500,
# the ring rows' at 293 of 1200 / 1500, gossip3's at 1052 of 1500, in the
# port's CPU run), so final, rate, wire and t/round read what the
# reference's full rounds give
SWEEP_ROUNDS, SWEEP_SLOW_ROUNDS = 400, 1200
SWEEP_SLOW = ("gossip:edges=3,base=ring,seed=1",)
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
    sweep = []
    for mod, specs in ((topology_sweep, topology_sweep.DEFAULT_TOPOLOGIES),
                       (schedule_sweep, schedule_sweep.DEFAULT_SCHEDULES)):
        for spec in specs:
            rounds = sweep_rounds or (SWEEP_SLOW_ROUNDS if spec in SWEEP_SLOW
                                      else SWEEP_ROUNDS)
            sweep += mod.run([spec], rounds=rounds, print_rows=False,
                             device=DEV, impl="kernel")
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
    log(f"[harness] topology_sweep and schedule_sweep ("
        + (f"{SWEEP_ROUNDS} rounds, gossip3 {SWEEP_SLOW_ROUNDS}"
           if sweep_rounds is None else f"{sweep_rounds} rounds")
        + f"): {len(sweep)} rows in {time.perf_counter() - t1:.1f} s")
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


# ---------------------------------------------------------------------------
# phase train: the training path (launch/train.py, build_train at full
# width, K5 past its element limit, the DDP baseline, granite's MoE)
# ---------------------------------------------------------------------------

# the reference's launch/train.py at TRAIN_ARGV on the CPU (jax 0.9):
# header integers, mean_loss per round, telemetry per agent
TRAIN_ARGV = ["--smoke", "--agents", "4", "--rounds", "3", "--telemetry"]
TRAIN_REFERENCE = {"params": 361_216, "wire": 1_444_880, "ddp": 8_669_184,
                   "mean_loss": (6.2395, 6.2108, 6.1887),
                   "telemetry": {"tx_bytes": 4_334_640, "tx_msgs": 12,
                                 "grad_evals": 60, "participations": 3}}
TRAIN_LOSS_TOL = 1e-4  # |mean_loss card - CPU|, and against the reference
TRAIN_CONSENSUS_RTOL = 1e-3  # consensus_err card vs CPU, relative
TRAIN_RESUME_RTOL = 1e-5  # resumed vs uninterrupted state on the card
# the full-width run: qwen3-0.6b's widths cut to 2 layers, in f32 (what
# launch/train.py trains a full config in), launch/train.py's defaults
TRAIN_LAYERS, TRAIN_AGENTS, TRAIN_ROUNDS = 2, 4, 5
TRAIN_M, TRAIN_SEQ = 8, 64
# K1/K5 launches a ring qbit8 round: K1 on the x-plane and the z-plane,
# K5 on each one's sender-side and receiver-side reconstruction
TRAIN_PER_ROUND = {"quantize_plane": 2, "dequantize_plane": 4}
# columns a plain-version window takes (bounds its Threefry and f64
# temporaries on a [8, 1.87e8] plane)
PLAIN_WINDOW = 1 << 22


def hold_windowed(got, want, label):
    """Bit-for-bit hold of a big kernel output against its plain version,
    a window of rows at a time (``same_bits`` and ``note_err`` on the
    whole of a 6 GB plane would take several copies of it)."""
    import torch

    outs = list(zip(*(o if isinstance(o, tuple) else (o,)
                      for o in (got, want))))
    for g, w in outs:
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{label}: {tuple(g.shape)} {g.dtype} vs "
                                 f"{tuple(w.shape)} {w.dtype}")
        g2, w2 = (t.reshape(-1, t.shape[-1]) if t.dim() else t.reshape(1, 1)
                  for t in (g, w))
        for r in range(g2.shape[0]):
            a, b = g2[r], w2[r]
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            if not torch.equal(a, b):
                raise AssertionError(f"{label}: row {r} differs from its "
                                     "plain version")
    return sum(g.numel() for g, _ in outs)


def run_train_cli(argv, device):
    """``launch/train.py`` on ``argv`` on ``device``: its printed lines
    and ``run``'s summary."""
    import io

    from repro_torch.launch import train

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = train.run(train.parse_args(argv + ["--device", str(device)]))
    lines = buf.getvalue().splitlines()
    for ln in lines:
        log(f"[train] {device}: {ln}")
    return lines, out


def train_smoke_parity():
    """The smoke run on the card and on the CPU: the header integers and
    telemetry equal to each other and to the reference's, mean_loss and
    consensus_err every round within tolerance."""
    ref = TRAIN_REFERENCE
    runs = {}
    for dev in (DEV, "cpu"):
        t0 = time.perf_counter()
        lines, out = run_train_cli(TRAIN_ARGV, dev)
        runs[dev] = (lines, out, time.perf_counter() - t0)
    (lc, oc, tc), (lh, oh, th) = runs[DEV], runs["cpu"]
    header = [ln for ln in lc if ln.startswith("# ")]
    if header != [ln for ln in lh if ln.startswith("# ")]:
        raise AssertionError(f"train smoke: headers differ {header}")
    for key in ("params", "wire", "ddp"):
        if not oc[key] == oh[key] == ref[key]:
            raise AssertionError(f"train smoke: {key} {oc[key]} / {oh[key]}"
                                 f", the reference's {ref[key]}")
    if oc["telemetry"] != oh["telemetry"]:
        raise AssertionError("train smoke: telemetry differs card vs CPU")
    for key, per in ref["telemetry"].items():
        if oc["telemetry"][key] != [per] * 4:
            raise AssertionError(f"train smoke: telemetry {key} "
                                 f"{oc['telemetry'][key]}, expected {per}")
    worst_l = worst_c = 0.0
    for r, (c, h, want) in enumerate(zip(oc["rounds"], oh["rounds"],
                                         ref["mean_loss"])):
        dl = abs(c["mean_loss_full"] - h["mean_loss_full"])
        dc = abs(c["consensus_err"] / h["consensus_err"] - 1)
        worst_l, worst_c = max(worst_l, dl), max(worst_c, dc)
        if (dl > TRAIN_LOSS_TOL or dc > TRAIN_CONSENSUS_RTOL
                or abs(c["mean_loss_full"] - want) > TRAIN_LOSS_TOL):
            raise AssertionError(f"train smoke round {r}: card {c}, CPU {h},"
                                 f" the reference's mean_loss {want}")
    log(f"[train] smoke run ({' '.join(TRAIN_ARGV)}): params "
        f"{oc['params']:,}, wire {oc['wire']:,} B/agent/round, DDP "
        f"equivalent {oc['ddp']:,}, telemetry equal to the reference's; "
        f"card vs CPU max |d mean_loss| {worst_l:.3e}, max relative "
        f"d consensus_err {worst_c:.3e}; {tc:.2f} s on {DEV}, {th:.2f} s on "
        "the CPU")


def train_resume():
    """``--checkpoint-every 1`` then ``--resume`` from round 2's state on
    the device: the resumed run's last round and state against the
    uninterrupted run's, bit for bit where they are (the CPU's are, by
    tests/test_torch_train.py), else within TRAIN_RESUME_RTOL of each
    leaf's largest |value| (the card's atomics may reorder a sum)."""
    import tempfile

    import numpy as np

    from repro_torch.checkpoint.store import flatten_with_paths, to_numpy

    argv = TRAIN_ARGV[:-1]
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck")
        _, whole = run_train_cli(argv + ["--checkpoint", ck,
                                         "--checkpoint-every", "1"], DEV)
        _, resumed = run_train_cli(argv + ["--checkpoint", ck, "--resume",
                                           ck + ".state"], DEV)
    a, b = (flatten_with_paths(o["state"]) for o in (whole, resumed))
    worst, same = 0.0, True
    for k in a:
        x, y = to_numpy(a[k]), to_numpy(b[k])
        if x.dtype.kind != "f":
            same &= bool(np.array_equal(x, y))
            continue
        same &= bool(np.array_equal(x.view(np.uint32), y.view(np.uint32)))
        scale = max(float(np.abs(x).max()), 1e-30)
        worst = max(worst, float(np.abs(x - y).max()) / scale)
    if worst > TRAIN_RESUME_RTOL:
        raise AssertionError(f"train resume: state {worst:.3e} off")
    log(f"[train] --resume on {DEV}: the resumed state "
        + ("bit-identical to" if same else
           f"within {worst:.3e} (of each leaf's max) of")
        + " the uninterrupted run's")


def train_k5_past_limit(n):
    """One ``dequantize_plane`` call of more elements than K5's C entry
    takes ([12, n], the complete graph's z-plane at the full-width n):
    the wrapper splits it in row groups, and every row equals the plain
    version's, bit for bit."""
    import torch

    from repro_torch.kernels.quantize import ops as qops
    from repro_torch.kernels.quantize import ref as qref

    m = 12
    if m * n < qops.DQ_MOST_ELEMENTS:
        raise AssertionError(f"[{m}, {n}] is below K5's limit")
    g = torch.Generator(device=DEV).manual_seed(3)
    q = torch.randint(-127, 128, (m, n), dtype=torch.int8, device=DEV,
                      generator=g)
    scale = torch.rand((m,), device=DEV, generator=g) + 0.5
    reset_counts()
    sync()
    t0 = time.perf_counter()
    out = qops.dequantize_plane(q, scale, n=n, bits=8)
    sync()
    secs = time.perf_counter() - t0
    launches = read_counts()["dequantize_plane"]
    spans = [(g.start, g.stop) for g in qops.row_groups(m, n)]
    groups = len(spans)
    if launches != groups or groups < 2:
        raise AssertionError(f"K5 past its limit: {launches} launches, "
                             f"{groups} row groups")
    for r in range(m):
        want = qref.dequantize_plane_ref(q[r:r + 1], scale[r:r + 1], n=n,
                                         bits=8, window=PLAIN_WINDOW)
        if not same_bits(out[r:r + 1], want):
            raise AssertionError(f"K5 past its limit: row {r} differs")
        del want
    log(f"[train] K5 dequantize_plane at [{m}, {n}] ({m * n:,} elements, "
        f"past the C entry's {qops.DQ_MOST_ELEMENTS:,}): {launches} "
        f"launches (row groups {spans}), every row equal to the plain "
        f"version's bit for bit; {secs * 1e3:.1f} ms (host clock, first "
        "call)")
    del q, out


def train_full_width():
    """``build_train`` at full width: qwen3-0.6b cut to TRAIN_LAYERS, 4
    agents on the ring, qbit8, SVRG, launch/train.py's defaults; counts
    zeroed just before the rounds and read just after; round 1's K1 and
    K5 calls held bit for bit against their plain versions; mean_loss
    finite every round; round time, device busy, peak memory and K1/K5's
    share of a profiled round.  Returns ``(arch, cfg)``."""
    import dataclasses
    import functools

    import torch

    from repro_torch.common.trees import tree_map
    from repro_torch.configs import ARCHS
    from repro_torch.core import jaxrand
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.kernels.quantize import ref as qref
    from repro_torch.launch import steps, train
    from repro_torch.models.common import init_params, param_count

    arch = ARCHS["qwen3-0.6b"]
    rounds, m_local, seq = TRAIN_ROUNDS, TRAIN_M, TRAIN_SEQ
    if SMOKE:
        cfg = arch.make_smoke()
        rounds, m_local, seq = 3, 4, 16
    else:
        cfg = dataclasses.replace(train.train_config(arch, smoke=False),
                                  n_layers=TRAIN_LAYERS)
    args = train.parse_args(["--device", str(DEV)])
    # the CPU rehearsal asks for the kernel route (the plain versions)
    recipe = steps.TrainRecipe(
        tau=args.tau, gamma=args.gamma, beta=args.beta,
        batch_size=args.batch_size, topology="ring",
        compressor=f"qbit:bits={args.bits}"
        + (",impl=kernel" if DEV == "cpu" else ""))
    step_fn, init_fn, solver = steps.build_train(
        arch, cfg, TRAIN_AGENTS, "ltadmm", recipe, device=DEV)
    loss = steps.model_loss(arch, cfg)
    specs = steps.model_specs(arch, cfg)
    n = param_count(specs)
    log(f"[train] full width: {cfg.name} d_model {cfg.d_model}, heads "
        f"{cfg.attn.n_heads}/{cfg.attn.n_kv_heads} of {cfg.attn.head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, tied, qk-norm; depth cut "
        f"{arch.make(None).n_layers if not SMOKE else cfg.n_layers} -> "
        f"{cfg.n_layers} layers; {cfg.dtype}; N = {n:,} parameters; "
        f"{TRAIN_AGENTS} agents, ring, qbit8, SVRG, tau {recipe.tau}, batch "
        f"{recipe.batch_size}, m_local {m_local}, seq {seq}")
    if DEV == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=seq,
                            n_agents=TRAIN_AGENTS, m_local=m_local,
                            heterogeneity=args.heterogeneity)
    data = {"tokens": ds.sample(jaxrand.key(0)).to(DEV)}
    t0 = time.perf_counter()
    params0 = init_params(jaxrand.key(1, DEV), specs)
    state = init_fn(tree_map(lambda t: t[None].expand(
        (TRAIN_AGENTS,) + t.shape).clone(), params0))
    sync()
    log(f"[train] full width: weights drawn and state built in "
        f"{time.perf_counter() - t0:.2f} s; wire "
        f"{solver.wire_bytes(params0):,} B/agent/round")
    del params0
    plain = {"quantize_plane": ("K1", "quantize", functools.partial(
                 qref.quantize_plane_ref, window=PLAIN_WINDOW),
                 hold_windowed),
             "dequantize_plane": ("K5", "quantize", functools.partial(
                 qref.dequantize_plane_ref, window=PLAIN_WINDOW),
                 hold_windowed)}
    tap = MainPathTap(plain)
    times, losses = [], []
    try:
        reset_counts()  # the main-path run starts here
        for i in range(rounds):
            tap.checking = i == 1
            sync()
            t0 = time.perf_counter()
            state = step_fn(state, data, 1000 + i)
            sync()
            times.append(time.perf_counter() - t0)
            tap.checking = False
            losses.append(train.mean_loss(solver, loss, state,
                                          data["tokens"]))
        counts = read_counts()  # ... and ends here
    finally:
        tap.close()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"train full width: mean_loss {losses}")
    if DEV == "cuda":
        for kname, per in TRAIN_PER_ROUND.items():
            if counts[kname] != per * rounds:
                raise AssertionError(
                    f"train full width: {counts[kname]} {kname} launches "
                    f"in {rounds} rounds, expected {per} a round")
    held = ", ".join(f"{MAIN_PATH_WRAPPERS[nm][0]} {nm} {_show(sh)} x{c}"
                     for (nm, sh), c in tap.checked.items())
    if not tap.checked or set(tap.by_shape) != set(tap.checked):
        raise AssertionError("train full width: calls outside round 1: "
                             f"{set(tap.by_shape) - set(tap.checked)}")
    mean_ms = sum(times[2:]) / len(times[2:]) * 1e3
    log(f"[train] full width: {rounds} rounds, mean_loss {losses}, round "
        f"times {[round(t * 1e3, 1) for t in times]} ms, mean after 2 "
        f"warm-ups (round 1 held its kernel calls) {mean_ms:.1f} ms (host "
        f"clock); launches {({k: v for k, v in counts.items() if v})}; "
        f"round 1's calls held bit for bit against their plain versions: "
        f"{held}")
    if DEV == "cuda":
        peak = torch.cuda.max_memory_allocated()
        by_kernel, wall = profile_window(
            lambda: step_fn(state, data, 1000 + rounds))
        busy = sum(by_kernel.values())
        share = {kid: sum(t for nm, t in by_kernel.items()
                          if any(tag in nm for tag in tags))
                 for kid, tags in PROFILED_KERNELS
                 if kid in ("K1", "K5 plane")}
        log(f"[train] full width: peak memory {peak / 1e9:.2f} GB "
            f"(max_memory_allocated); a profiled round: wall {wall:.1f} ms, "
            f"device busy {busy:.1f} ms (idle share {1 - busy / wall:.3f}; "
            f"{1 - busy / mean_ms:.3f} of the unprofiled mean round); "
            + ", ".join(f"{kid} {ms:.3f} ms ({ms / busy:.1%} of busy)"
                        for kid, ms in share.items()) + f" [{CARD}]")
        for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
            log(f"[train] kernel {ms:9.3f} ms {ms / busy:6.1%}  {name[:100]}")
        time_train_quant(state.x, state.z, solver)
    del state
    if DEV == "cuda":
        torch.cuda.empty_cache()
    return arch, cfg, data["tokens"][0, :2]


def time_train_quant(x, z, solver):
    """K1 and K5 (division form) at the training planes' shapes, the
    wrappers by CUDA events beside their bounds (x read once, q and
    scale written once; K1 also a Threefry block and 6 f32 ops an
    element)."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.quantize import ops as qops
    from repro_torch.kernels.quantize import ref as qref

    seed = (7, 11)
    for what, plane in (("x-plane", x), ("z-plane", z)):
        mm, n = plane.numel() // plane.shape[-1], plane.shape[-1]
        ids = torch.arange(mm, dtype=torch.int32,
                           device=plane.device).reshape(plane.shape[:-1])
        q, sc = qops.quantize_plane(seed, ids, ids, plane, bits=8)
        k1 = cuda_ms(lambda: qops.quantize_plane(seed, ids, ids, plane,
                                                 bits=8), iters=5, warmup=1)
        k5 = cuda_ms(lambda: qops.dequantize_plane(q, sc, n=n, bits=8),
                     iters=5, warmup=1)
        # the bare C entries on prepared inputs (one launch each: below
        # K5's element limit)
        flat, idf = plane.reshape(mm, n), ids.reshape(-1)
        q2, sc2 = torch.empty_like(q), torch.empty_like(sc)
        scr, out = qops.scratch(mm, plane.device), torch.empty_like(flat)
        k1b = cuda_ms(lambda: _build.launch(
            "quantize_plane", flat.data_ptr(), mm, n, 8, seed[0], seed[1],
            idf.data_ptr(), idf.data_ptr(), sc2.data_ptr(), q2.data_ptr(), n,
            scr.data_ptr()), iters=5, warmup=1)
        k5b = cuda_ms(lambda: _build.launch(
            "dequantize_leaf", q.data_ptr(), mm, n, 8, sc.data_ptr(),
            out.data_ptr(), n, 1), iters=5, warmup=1)
        p1, p5 = (cuda_ms(fn, iters=1, warmup=0) for fn in (
            lambda: qref.quantize_plane_ref(seed, ids, ids, plane, bits=8,
                                            window=PLAIN_WINDOW),
            lambda: qref.dequantize_plane_ref(q, sc, n=n, bits=8,
                                              window=PLAIN_WINDOW)))
        b1 = bound_ms(mm * n * 4 + mm * n + 8 * mm,
                      (TF_OPS or Pipes(0)) * (mm * n + 2 * mm), 6 * mm * n)
        b5 = bound_ms(mm * n + 4 * mm + 4 * mm * n, 0, 2 * mm * n)
        log(f"[train] K1 quantize_plane b=8 {what} {list(plane.shape)}: "
            f"wrapper {k1:.4f} ms, bare {k1b:.4f} ms, plain (windowed) "
            f"{p1:.4f} ms, bound {b1[0]:.4f} ms ({b1[1]}); K5 "
            f"dequantize_plane: wrapper {k5:.4f} ms, bare {k5b:.4f} ms, "
            f"plain {p5:.4f} ms, bound {b5[0]:.4f} ms ({b5[1]}) [{CARD}]")
        del q, sc, q2, sc2, scr, out


def train_ddp(arch, cfg, batch):
    """3 Adam steps of ``build_ddp_train`` on the same model and one
    fixed batch: the loss falls."""
    from repro_torch.core import jaxrand
    from repro_torch.launch import steps
    from repro_torch.models.common import init_params

    step_fn, opt = steps.build_ddp_train(arch, cfg, lr=1e-3)
    params = init_params(jaxrand.key(1, DEV), steps.model_specs(arch, cfg))
    st = opt.init(params)
    losses, times = [], []
    for i in range(3):
        sync()
        t0 = time.perf_counter()
        params, st, lv = step_fn(params, st, {"tokens": batch}, i)
        sync()
        times.append(time.perf_counter() - t0)
        losses.append(float(lv))
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"train DDP: losses {losses} do not fall")
    # Adam's bias corrections, 1 - b ** t in f32 (t an int32 counter), on
    # the device against the CPU's (XLA's on the CPU, bit for bit, for
    # these t: tests/test_torch_train.py)
    import torch

    t = torch.arange(1, 2001, dtype=torch.int32)
    ulps = 0
    for b in (0.9, 0.999):
        got, want = (1.0 - torch.pow(torch.tensor(b, device=d),
                                     t.to(d).float()) for d in (DEV, "cpu"))
        ulps = max(ulps, int((got.cpu().view(torch.int32).long()
                              - want.view(torch.int32).long()).abs().max()))
    log(f"[train] DDP Adam lr 1e-3, batch {list(batch.shape)}: losses "
        f"{losses}, step times {[round(t * 1e3, 1) for t in times]} ms; "
        f"Adam's 1 - b ** t on {DEV} vs the CPU, t = 1..2000: at most "
        f"{ulps} ulp apart")


def timed_prefill(cfg, params, tokens, label, calls=2):
    """``calls`` prefills (``transformer.forward``) of ``tokens``: their
    host-clock seconds, the logits and the MoE aux finite each time."""
    import torch

    from repro_torch.models import transformer as tr

    secs = []
    with torch.no_grad():
        for _ in range(calls):
            logits = None
            sync()
            t0 = time.perf_counter()
            logits, aux = tr.forward(params, cfg, tokens=tokens)
            sync()
            secs.append(time.perf_counter() - t0)
            if not (torch.isfinite(logits).all()
                    and math.isfinite(float(aux))):
                raise AssertionError(f"{label}: non-finite logits or aux")
    return secs, float(aux)


def train_granite():
    """granite-moe-1b-a400m at its published widths, bf16 weights from
    init_params(key(0)) as serving draws them: a prefill at B = 2, T =
    2048 (its MoE aux loss finite), timed at its first and second call,
    and 8 greedy steps."""
    import dataclasses

    from repro_torch.core import jaxrand
    from repro_torch.launch import serve

    arch, cfg, params = serve_model("granite-moe-1b-a400m")
    cfg = dataclasses.replace(cfg, use_flash=False)
    b, t = (2, 64) if SMOKE else (2, 2048)
    tokens = jaxrand.randint(jaxrand.key(2, DEV), (b, t), 0, cfg.vocab)
    # the first call, then a second on the same tokens
    secs, aux = timed_prefill(cfg, params, tokens, "granite prefill")
    out, gen_s = serve.generate(arch, cfg, params, tokens[:, :8], 8)
    if not (0 <= int(out.min()) and int(out.max()) < cfg.vocab):
        raise AssertionError(f"granite greedy tokens out of range: {out}")
    log(f"[train] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k}, {cfg.dtype}: "
        f"prefill B = {b}, T = {t} in {secs[0] * 1e3:.1f} ms first call, "
        f"{secs[1] * 1e3:.1f} ms second call (host clock), aux "
        f"{aux:.6f}; 8 greedy steps from an 8-token prompt in "
        f"{gen_s * 1e3:.1f} ms: {out.tolist()}"
        + ("" if CARD is None else f" [{CARD}]"))


def phase_train():
    import torch

    t0 = time.perf_counter()
    train_smoke_parity()
    train_resume()
    if DEV == "cuda":
        train_k5_past_limit(187_045_376)
    else:
        log("[train] K5 past its limit: on the card only (the CPU runs the "
            "plain version whole)")
    arch, cfg, batch = train_full_width()
    train_ddp(arch, cfg, batch)
    if DEV == "cuda":
        torch.cuda.empty_cache()
    train_granite()
    log(f"[train] phase {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase zoo: deepseek-v2-lite-16b (MLA, the leading dense layer, MoE) and
# xlstm-125m (mLSTM, sLSTM) at their published widths, and deepseek's
# smoke training through LT-ADMM-CC
# ---------------------------------------------------------------------------

# the published configs' parameter counts (the reference's model_specs)
ZOO_PARAMS = {"deepseek-v2-lite-16b": 15_496_769_024,
              "xlstm-125m": 161_480_528,
              "seamless-m4t-medium": 715_403_264}
# the reference's launch/train.py at TRAIN_ARGV + --arch
# deepseek-v2-lite-16b on the CPU (jax 0.9.0)
ZOO_TRAIN_ARGV = TRAIN_ARGV + ["--arch", "deepseek-v2-lite-16b"]
ZOO_TRAIN_REFERENCE = {
    "params": 347_328, "wire": 1_389_328, "ddp": 8_335_872,
    "mean_loss": (6.2374, 6.2193, 6.2127),
    "consensus_err": (0.1297444850206375, 0.31731125712394714,
                      0.5175784826278687),
    "telemetry": {"tx_bytes": 4_167_984, "tx_msgs": 12, "grad_evals": 60,
                  "participations": 3}}
# xlstm-125m's f32 prefill against token-by-token decoding.  Past its
# first position the whole model cannot meet CONSISTENCY_TOL in either
# package: the sLSTM recurrence amplifies the two forms' f32 rounding
# ~1.55x a step, so by position ~24 they are O(1) apart (the reference's
# own at 6 layers on the CPU: 6.5e-4 at position 8, 1.2 at 24).  The
# five mLSTM blocks alone are held at every position: the reference's
# own chunkwise-vs-recurrent gap there reads 1.58e-4 on the CPU (the
# port's 1.66e-4) at a logit scale ~2, so the limit is 6x that
XLSTM_CONSISTENCY_T, XLSTM_CONSISTENCY_TOL = 300, 1e-3


def zoo_profile(label, fn):
    """One call of the prefill ``fn`` under the profiler: its idle share
    (a string with the wall and busy ms and the profile's own seconds)
    and the top kernels logged."""
    import torch

    t0 = time.perf_counter()
    with torch.no_grad():
        by_kernel, wall = profile_window(fn)
    busy = sum(by_kernel.values())
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]:
        log(f"[zoo] {label} kernel {ms:9.3f} ms {ms / busy:6.1%}  "
            f"{name[:100]}")
    return (f"{1 - busy / wall:.3f} (profiled call: wall {wall:.1f} ms, "
            f"device busy {busy:.1f} ms; the profile "
            f"{time.perf_counter() - t0:.1f} s)")


def zoo_generate(arch, cfg, params, prompt, gen=8):
    """``gen`` greedy steps from ``prompt`` through ``serve.generate``:
    (ms a step, tokens), the tokens in the vocabulary."""
    from repro_torch.launch import serve

    serve.generate(arch, cfg, params, prompt, 2)  # warm-up
    out, secs = serve.generate(arch, cfg, params, prompt, gen)
    if tuple(out.shape) != (prompt.shape[0], gen) or not (
            0 <= int(out.min()) and int(out.max()) < cfg.vocab):
        raise AssertionError(f"{cfg.name} greedy tokens: {out}")
    return secs * 1e3 / gen, out


def zoo_count(arch_id, params):
    n = sum(p.numel() for p in params.parameters())
    if not SMOKE and n != ZOO_PARAMS[arch_id]:
        raise AssertionError(f"{arch_id}: {n:,} parameters, the "
                             f"reference's {ZOO_PARAMS[arch_id]:,}")
    return n


def zoo_deepseek():
    """deepseek-v2-lite-16b at full width in bf16: the prefill through
    the dense MLA branch (first and second call) and the blockwise one,
    8 greedy steps."""
    import torch

    from repro_torch.core import jaxrand

    from repro_torch.models import transformer as tr

    arch_id = "deepseek-v2-lite-16b"
    arch, cfg, params = serve_model(arch_id)
    n = zoo_count(arch_id, params)
    b, t = (2, 64) if SMOKE else (2, 2048)
    tokens = jaxrand.randint(jaxrand.key(2, DEV), (b, t), 0, cfg.vocab)
    secs, aux = timed_prefill(cfg, params, tokens, f"{arch_id} prefill")
    idle = (zoo_profile(arch_id, lambda: tr.forward(params, cfg,
                                                    tokens=tokens))
            if DEV == "cuda" else "not measured on the CPU")
    t_long = 3072 if SMOKE else 4096
    long = jaxrand.randint(jaxrand.key(3, DEV), (1, t_long), 0, cfg.vocab)
    long_secs, _ = timed_prefill(cfg, params, long,
                               f"{arch_id} blockwise prefill", calls=1)
    step_ms, out = zoo_generate(arch, cfg, params, tokens[:, :8])
    log(f"[zoo] {arch_id}: {cfg.n_layers} layers ({cfg.first_dense} dense "
        f"+ {cfg.n_units} MLA+MoE), d {cfg.d_model}, MLA r "
        f"{cfg.mla.kv_lora_rank}, {cfg.moe.n_experts} experts top-"
        f"{cfg.moe.top_k} + {cfg.moe.n_shared} shared, {cfg.dtype}, {n:,} "
        f"parameters: prefill B = {b}, T = {t} (dense MLA) "
        f"{secs[0] * 1e3:.1f} ms first call, {secs[1] * 1e3:.1f} ms second "
        f"(host clock), aux {aux:.6f}, idle share {idle}; B = 1, T = "
        f"{t_long} (blockwise) "
        f"{long_secs[0] * 1e3:.1f} ms first call; 8 greedy steps from an "
        f"8-token prompt {step_ms:.1f} ms a step: {out.tolist()}"
        + ("" if CARD is None else f" [{CARD}]"))
    del params
    if DEV == "cuda":
        log(f"[zoo] {arch_id}: peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
            "(max_memory_allocated)")
        torch.cuda.empty_cache()


def zoo_decode_gaps(arch, cfg, params, tokens):
    """The f32 prefill's logits against token-by-token ``decode_step``
    logits: (max |d| at each position, the prefill's logits)."""
    import torch

    from repro_torch.launch.steps import build_serve
    from repro_torch.models import transformer as tr

    t = tokens.shape[1]
    with torch.no_grad():
        full, _ = tr.forward(params, cfg, tokens=tokens)
        step, init_cache = build_serve(arch, cfg)
        cache = init_cache(tokens.shape[0], t, tokens.device)
        gaps = []
        for pos in range(t):
            lg, cache = step(params, cache, {"token": tokens[:, pos],
                                             "pos": pos})
            gaps.append(float((lg[:, 0] - full[:, pos]).abs().max()))
    return gaps, full, lg


def zoo_deepseek_consistency():
    """deepseek-v2-lite-16b's widths cut to its dense layer and one MLA +
    MoE unit, in f32, with the capacity factor n_experts / top_k (no
    pair dropped, as in a one-token decode step): the last position's
    prefill logits against absorbed token-by-token decoding."""
    import dataclasses

    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.core import jaxrand

    arch = ARCHS["deepseek-v2-lite-16b"]
    cfg = (arch.make_smoke() if SMOKE
           else dataclasses.replace(arch.make(None), n_layers=2))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    _, cfg, params = serve_model(arch.arch_id, torch.float32, cfg)
    t = 16 if SMOKE else 64
    tokens = jaxrand.randint(jaxrand.key(1, DEV), (1, t), 0, cfg.vocab)
    gaps, full, last = zoo_decode_gaps(arch, cfg, params, tokens)
    same = bool((last[:, 0].argmax(-1) == full[:, -1].argmax(-1)).all())
    log(f"[zoo] {cfg.name} cut to {cfg.n_layers} layers ({cfg.first_dense} "
        f"dense + {cfg.n_units} MLA+MoE), f32, capacity factor "
        f"{cfg.moe.capacity_factor:.3f}: T = {t} prefill vs absorbed "
        f"decode_step, last position max |d| {gaps[-1]:.4e} (limit "
        f"{CONSISTENCY_TOL}; logit scale {float(full.abs().max()):.3f}), "
        f"argmax equal {same}; every position {max(gaps):.4e}")
    if not (gaps[-1] <= CONSISTENCY_TOL and same):
        raise AssertionError(f"{cfg.name}: prefill and absorbed decode "
                             f"disagree by {gaps[-1]}")


def zoo_xlstm():
    """xlstm-125m at full width in bf16: the prefill (twice, then its
    first 512 tokens profiled), 8 greedy steps; then f32 prefill against
    token-by-token decoding at T = XLSTM_CONSISTENCY_T."""
    import dataclasses

    import torch

    from repro_torch.core import jaxrand
    from repro_torch.models import transformer as tr

    arch_id = "xlstm-125m"
    arch, cfg, params = serve_model(arch_id)
    n = zoo_count(arch_id, params)
    b, t = (2, 64) if SMOKE else (2, 2048)
    tokens = jaxrand.randint(jaxrand.key(2, DEV), (b, t), 0, cfg.vocab)
    secs, _ = timed_prefill(cfg, params, tokens, f"{arch_id} prefill")
    idle = "not measured on the CPU"
    if DEV == "cuda":
        # the first 512 tokens: the profiler takes ~50 s to gather the
        # full prefill's ~10^5 kernel events, and each sLSTM step is the
        # same host-bound launch train at any T
        idle = zoo_profile(arch_id, lambda: tr.forward(
            params, cfg, tokens=tokens[:, :512]))
    step_ms, out = zoo_generate(arch, cfg, params, tokens[:, :8])
    log(f"[zoo] {arch_id}: {cfg.n_layers} layers {cfg.pattern} x "
        f"{cfg.n_units}, d {cfg.d_model}, {cfg.lstm.n_heads} heads of "
        f"{cfg.lstm.head_dim}, {cfg.dtype}, {n:,} parameters: prefill B = "
        f"{b}, T = {t} {secs[0] * 1e3:.1f} ms first call, "
        f"{secs[1] * 1e3:.1f} ms second (host clock), idle share at T = "
        f"512 {idle}; 8 greedy steps {step_ms:.1f} ms a step: {out.tolist()}"
        + ("" if CARD is None else f" [{CARD}]"))
    del params
    if DEV == "cuda":
        torch.cuda.empty_cache()
    # f32: the whole model, then its mLSTM blocks alone
    t = 16 if SMOKE else XLSTM_CONSISTENCY_T
    tokens = jaxrand.randint(jaxrand.key(1, DEV), (1, t), 0, cfg.vocab)
    _, cfg32, params = serve_model(arch_id, torch.float32, cfg)
    gaps, full, _ = zoo_decode_gaps(arch, cfg32, params, tokens)
    past = next((p for p, g in enumerate(gaps) if g > CONSISTENCY_TOL), None)
    log(f"[zoo] {arch_id} f32 prefill vs decode_step over {t} positions: "
        f"position 0 max |d| {gaps[0]:.4e} (limit {CONSISTENCY_TOL}), first "
        f"position past it {past}, every position {max(gaps):.4e} (logit "
        f"scale {float(full.abs().max()):.3f}; the sLSTM recurrence)")
    if not gaps[0] <= CONSISTENCY_TOL:
        raise AssertionError(f"{arch_id}: prefill and decode disagree by "
                             f"{gaps[0]} at position 0")
    del params
    k = cfg.pattern.count("mlstm")
    _, cfg_m, params = serve_model(arch_id, torch.float32, dataclasses.replace(
        cfg, n_layers=k, pattern=("mlstm",) * k))
    gaps, full, _ = zoo_decode_gaps(arch, cfg_m, params, tokens)
    log(f"[zoo] {arch_id}'s {k} mLSTM blocks alone, f32, T = {t}: prefill "
        f"(chunkwise) vs decode_step (recurrent) max |d| {max(gaps):.4e} "
        f"over every position (limit {XLSTM_CONSISTENCY_TOL}; logit scale "
        f"{float(full.abs().max()):.3f})")
    if not max(gaps) <= XLSTM_CONSISTENCY_TOL:
        raise AssertionError(f"{arch_id} mLSTM blocks: prefill and decode "
                             f"disagree by {max(gaps)}")


# seamless-m4t-medium's cells: (B, T) of the prefill and of the blockwise
# one, the source frames T / SRC_FRAMES_RATIO (``repro_torch.configs``);
# the f32 cut's encoder and decoder layers, B, source frames and T
SEAMLESS_PREFILL, SEAMLESS_LONG = (2, 2048), (1, 4096)
SEAMLESS_F32 = (2, 1, 64, 64)


def seamless_model(dtype=None, cfg=None):
    """(arch, cfg, params, n) of seamless-m4t-medium: the config (``cfg``,
    a cut of the arch's, or its published one; the smoke config in the
    rehearsal) in ``dtype`` (default the config's), the stacked tree of
    the port's init_params(key(0)) on the device, its weight count."""
    import dataclasses

    import torch

    from repro_torch.common.trees import tree_flatten
    from repro_torch.configs import ARCHS
    from repro_torch.core import jaxrand
    from repro_torch.launch.steps import model_specs
    from repro_torch.models.common import init_params

    arch = ARCHS["seamless-m4t-medium"]
    if cfg is None:
        cfg = arch.make_smoke() if SMOKE else arch.make(None)
    cfg = dataclasses.replace(cfg, dtype=dtype or cfg.dtype)
    t0 = time.perf_counter()
    params = init_params(jaxrand.key(0, DEV), model_specs(arch, cfg),
                         dtype=cfg.dtype)
    sync()
    n = sum(p.numel() for p in tree_flatten(params)[0])
    log(f"[zoo] {arch.arch_id}: {n:,} weights, "
        f"{n * torch.finfo(cfg.dtype).bits / 8e9:.3f} GB in {cfg.dtype}, "
        f"drawn by init_params on {DEV} in {time.perf_counter() - t0:.2f} s")
    return arch, cfg, params, n


def seamless_batch(cfg, b, t, seed):
    """The prefill's batch: ``src_embeds [b, t / SRC_FRAMES_RATIO, d]``
    (normals) and ``tgt_tokens [b, t]`` from two keys of ``seed``."""
    from repro_torch.configs import SRC_FRAMES_RATIO
    from repro_torch.core import jaxrand

    return {"src_embeds": jaxrand.normal(
                jaxrand.key(seed, DEV),
                (b, t // SRC_FRAMES_RATIO, cfg.d_model)),
            "tgt_tokens": jaxrand.randint(jaxrand.key(seed + 1, DEV),
                                          (b, t), 0, cfg.vocab)}


def seamless_prefill(prefill, params, batch, label, calls=2):
    """``calls`` runs of ``prefill``: their host-clock seconds and the
    last logits, of shape [B, 1, vocab] and finite each time."""
    import torch

    secs, last = [], None
    with torch.no_grad():
        for _ in range(calls):
            last = None
            sync()
            t0 = time.perf_counter()
            last = prefill(params, batch)
            sync()
            secs.append(time.perf_counter() - t0)
            b = batch["tgt_tokens"].shape[0]
            if tuple(last.shape[:2]) != (b, 1) or not bool(
                    torch.isfinite(last.float()).all()):
                raise AssertionError(f"{label}: logits {tuple(last.shape)} "
                                     "or not finite")
    return secs, last


def seamless_k10_on_path(arch, cfg, params, batch, last):
    """The prefill again with ``use_flash``, under a ``MainPathTap``
    (counts zeroed just before, read just after): one K10 call per
    encoder layer (non-causal, at the source length) and per decoder
    self-attention (causal), none for cross-attention, every call held
    against its plain version; on the card all of them launches of the
    tensor-core variant.  Logs the last logits against ``last`` (the
    prefill without the kernel).  Returns {"enc": launches, "dec":
    launches}."""
    import dataclasses

    import torch

    from repro_torch.launch.steps import build_prefill

    prefill = build_prefill(arch, dataclasses.replace(cfg, use_flash=True))
    tap = MainPathTap(SERVE_WRAPPERS)
    tap.checking = True
    try:
        reset_counts()  # the use_flash prefill starts here
        with torch.no_grad():
            flast = prefill(params, batch)
        sync()
        after = read_counts()  # ... and ends here
    finally:
        tap.close()
    b, t = batch["tgt_tokens"].shape
    s_src = batch["src_embeds"].shape[1]
    a = cfg.attn
    calls = {part: tap.by_shape.get(("flash_attention", ((b, n, a.n_heads,
                                                          a.head_dim),) * 3),
                                    0)
             for part, n in (("enc", s_src), ("dec", t))}
    total = sum(c for (nm, _), c in tap.by_shape.items()
                if nm == "flash_attention")
    readings = tap.readings.get("flash_attention", [])
    n_attn = cfg.n_enc_layers + cfg.n_dec_layers
    d = float((flast.float() - last.float()).abs().max())
    agree = float((flast.argmax(-1) == last.argmax(-1)).float().mean())
    log(f"[zoo] {arch.arch_id} prefill B={b} T={t} S_src={s_src} with "
        f"use_flash: K10 launches {after['flash_attention']} "
        f"({after['flash_attention_tc']} of the tensor-core variant), calls "
        f"{calls['enc']} non-causal at [{b}, {s_src}, {a.n_heads}, "
        f"{a.head_dim}] and {calls['dec']} causal at [{b}, {t}, "
        f"{a.n_heads}, {a.head_dim}] ({total} in all, {n_attn} "
        f"self-attention blocks), each held within its limit: "
        f"{sorted(set(readings))[:4]}; last logits vs use_flash=False max "
        f"|d| {d:.4e} (scale {float(last.float().abs().max()):.3f}), argmax "
        f"agreement {agree:.3f}")
    if (calls != {"enc": cfg.n_enc_layers, "dec": cfg.n_dec_layers}
            or total != n_attn or len(readings) != n_attn):
        raise AssertionError(f"{arch.arch_id}: K10 calls {calls}, {total} "
                             f"in all, {len(readings)} held; expected "
                             f"{n_attn}")
    if DEV == "cuda" and not (after["flash_attention"]
                              == after["flash_attention_tc"] == n_attn):
        raise AssertionError(f"{arch.arch_id}: K10 launches {after}, "
                             f"expected {n_attn} tensor-core")
    return calls


def seamless_consistency(arch):
    """The published widths cut to SEAMLESS_F32's layers, in f32: the
    prefill's logits at every position against token-by-token
    ``decode_step`` (the cross K/V cached from the encoder's memory)
    within CONSISTENCY_TOL, argmax equal at every position."""
    import dataclasses

    import torch

    from repro_torch.core import jaxrand
    from repro_torch.launch.steps import build_serve
    from repro_torch.models import encdec

    n_l, b, s_src, t = (2, 1, 16, 16) if SMOKE else SEAMLESS_F32
    cut = dataclasses.replace(arch.make_smoke() if SMOKE else arch.make(None),
                              n_enc_layers=n_l, n_dec_layers=n_l)
    _, cfg, params, _ = seamless_model(torch.float32, cut)
    src = jaxrand.normal(jaxrand.key(4, DEV), (b, s_src, cfg.d_model))
    tokens = jaxrand.randint(jaxrand.key(5, DEV), (b, t), 0, cfg.vocab)
    with torch.no_grad():
        full = encdec.forward(params, cfg, src, tokens)
        step, init_cache = build_serve(arch, cfg)
        cache = init_cache(params, encdec.encode(params, cfg, src), t)
        gaps, same = [], True
        for pos in range(t):
            lg, cache = step(params, cache, {"token": tokens[:, pos],
                                             "pos": pos})
            gaps.append(float((lg[:, 0] - full[:, pos]).abs().max()))
            same &= bool((lg[:, 0].argmax(-1) == full[:, pos].argmax(-1))
                         .all())
    log(f"[zoo] {cfg.name} cut to {n_l} + {n_l} layers, f32: prefill vs "
        f"decode_step at every position (B = {b}, S_src = {src.shape[1]}, "
        f"T = {t}): max |d| {max(gaps):.4e} (limit {CONSISTENCY_TOL}; logit "
        f"scale {float(full.abs().max()):.3f}), last position "
        f"{gaps[-1]:.4e}, argmax equal at every position {same}")
    if not (max(gaps) <= CONSISTENCY_TOL and same):
        raise AssertionError(f"{cfg.name}: prefill and decode disagree by "
                             f"{max(gaps)} (argmax equal {same})")


def zoo_seamless():
    """seamless-m4t-medium at full width in bf16 (12 + 12 layers): the
    prefill at B = 2, T = 2048 from 512 source frames timed at its first
    and second call and profiled, one at B = 1, T = 4096 from 1024 frames
    (the blockwise branch), 8 greedy steps from the 512-frame memory;
    the prefill with ``use_flash`` through K10 on the path; the f32 cut's
    prefill against decoding; then K10 timed at the two new shapes.
    Returns the kernels line's rows (on the card)."""
    import torch

    from repro_torch.configs import SRC_FRAMES_RATIO
    from repro_torch.launch.steps import build_prefill

    t_part = time.perf_counter()
    if DEV == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    arch, cfg, params, n = seamless_model()
    if not SMOKE and n != ZOO_PARAMS[arch.arch_id]:
        raise AssertionError(f"{arch.arch_id}: {n:,} parameters, the "
                             f"reference's {ZOO_PARAMS[arch.arch_id]:,}")
    b, t = (2, 64) if SMOKE else SEAMLESS_PREFILL
    batch = seamless_batch(cfg, b, t, 2)
    prefill = build_prefill(arch, cfg)
    label = f"{arch.arch_id} prefill"
    secs, last = seamless_prefill(prefill, params, batch, label)
    idle = (zoo_profile(arch.arch_id, lambda: prefill(params, batch))
            if DEV == "cuda" else "not measured on the CPU")
    b2, t2 = (1, 3072) if SMOKE else SEAMLESS_LONG
    long_secs, _ = seamless_prefill(prefill, params,
                                    seamless_batch(cfg, b2, t2, 6),
                                    f"{label} (blockwise)", calls=1)
    step_ms, out = zoo_generate(arch, cfg, params, batch["src_embeds"])
    s_src = t // SRC_FRAMES_RATIO
    log(f"[zoo] {arch.arch_id}: {cfg.n_enc_layers} + {cfg.n_dec_layers} "
        f"layers, d {cfg.d_model}, {cfg.attn.n_heads} heads of "
        f"{cfg.attn.head_dim}, vocab {cfg.vocab}, {cfg.dtype}, {n:,} "
        f"parameters: prefill B = {b}, T = {t}, S_src = {s_src} "
        f"{secs[0] * 1e3:.1f} ms first call, {secs[1] * 1e3:.1f} ms second "
        f"(host clock), idle share {idle}; B = {b2}, T = {t2}, S_src = "
        f"{t2 // SRC_FRAMES_RATIO} (blockwise) {long_secs[0] * 1e3:.1f} ms "
        f"first call; 8 greedy steps from the {s_src}-frame memory "
        f"{step_ms:.1f} ms a step: {out.tolist()}"
        + ("" if CARD is None else f" [{CARD}]"))
    calls = seamless_k10_on_path(arch, cfg, params, batch, last)
    del params, last, prefill
    if DEV == "cuda":
        torch.cuda.empty_cache()
    seamless_consistency(arch)
    peak = ("not measured on the CPU" if DEV != "cuda" else
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
            "(max_memory_allocated)")
    log(f"[zoo] {arch.arch_id} part {time.perf_counter() - t_part:.1f} s "
        f"before the kernel timing, peak memory {peak}")
    if DEV != "cuda":
        return []
    a = cfg.attn
    return time_seamless_k10(calls, ((b, s_src, a.n_heads, a.head_dim),
                                     (b, t, a.n_heads, a.head_dim)))


def time_seamless_k10(calls, shapes):
    """K10 at seamless's two prefill shapes in bf16 (the encoder's
    non-causal [B, S_src, H, Dh], the decoder's causal [B, T, H, Dh]), as
    ``time_serve_kernels`` times the served ones: the inputs held again,
    wrapper, bare tensor-core launch, bare CUDA-core launch, plain
    version, bound and scaled_dot_product_attention on the same
    tensors."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as flops

    dev, bf = torch.device("cuda"), torch.bfloat16
    rows = []
    for part, causal, (b, t, h, dh) in (("enc", False, shapes[0]),
                                        ("dec", True, shapes[1])):
        q, k, v = (torch.randn((b, t, h, dh), device=dev, dtype=bf)
                   for _ in range(3))
        out = torch.empty_like(q)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, t, t, h, h, dh, int(causal), 0, 1.0 / math.sqrt(dh))
        label = (f"seamless {'encoder' if part == 'enc' else 'decoder'} "
                 f"{'causal' if causal else 'non-causal'}")
        want = k10_plain(q, k, v, causal=causal)
        got, variant = k10_call(q, k, v, causal, None, "tc")
        log(f"[time] K10 ({variant}) {label}: "
            f"{hold_k10(got, want, label, variant)}")
        cc_ms = cuda_ms(lambda: _build.launch("flash_attention", *ptrs, 1))
        del got, want
        add_row(
            rows, f"K10-tc flash_attention_tc {label} [{b}, {t}, {h}, {dh}] "
            f"kv {h} bf16", "src/repro_torch/csrc/flash_attention_sm90.cu",
            "src/repro/kernels/flash_attention/kernel.py:84", calls[part],
            ms=cuda_ms(lambda: flops.flash_attention(q, k, v,
                                                     causal=causal)),
            kernel_ms=cuda_ms(lambda: _build.launch("flash_attention_tc",
                                                    *ptrs)),
            plain_ms=cuda_ms(lambda: k10_plain(q, k, v, causal=causal),
                             iters=3, warmup=1),
            nbytes=4 * q.element_size() * b * t * h * dh, int_ops=0,
            fp_ops=0, bf16_ops=3 * 2 * dh * pairs, sfu_ops=pairs,
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal)),
            cc_kernel_ms=cc_ms, sass=K10_SASS.get(f"kD={dh} kBK=128"),
            launches_of=f"seamless-m4t-medium use_flash prefill ({part})")
        del q, k, v, out, qt, kt, vt
    return rows


def zoo_train():
    """deepseek's smoke run through launch/train.py on the card, counts
    zeroed just before and read just after, every K1/K5 call held bit
    for bit against its plain version; then on the CPU."""
    ref = ZOO_TRAIN_REFERENCE
    tap = MainPathTap({k: MAIN_PATH_WRAPPERS[k]
                       for k in TRAIN_PER_ROUND})
    tap.checking = True
    try:
        reset_counts()  # the card's run starts here
        t0 = time.perf_counter()
        _, oc = run_train_cli(ZOO_TRAIN_ARGV, DEV)
        tc = time.perf_counter() - t0
        counts = read_counts()  # ... and ends here
    finally:
        tap.close()
    t0 = time.perf_counter()
    # the rehearsal's "card" run is already the CPU's
    oh = oc if DEV == "cpu" else run_train_cli(ZOO_TRAIN_ARGV, "cpu")[1]
    th = time.perf_counter() - t0
    for key in ("params", "wire", "ddp"):
        if not oc[key] == oh[key] == ref[key]:
            raise AssertionError(f"zoo train: {key} {oc[key]} / {oh[key]}, "
                                 f"the reference's {ref[key]}")
    for key, per in ref["telemetry"].items():
        if not oc["telemetry"][key] == oh["telemetry"][key] == [per] * 4:
            raise AssertionError(f"zoo train: telemetry {key} "
                                 f"{oc['telemetry'][key]}, expected {per}")
    worst_l = worst_c = 0.0
    for r, (c, h, loss, cerr) in enumerate(zip(
            oc["rounds"], oh["rounds"], ref["mean_loss"],
            ref["consensus_err"])):
        dl = abs(c["mean_loss_full"] - h["mean_loss_full"])
        dc = max(abs(c["consensus_err"] / h["consensus_err"] - 1),
                 abs(c["consensus_err"] / cerr - 1))
        worst_l, worst_c = max(worst_l, dl), max(worst_c, dc)
        if (dl > TRAIN_LOSS_TOL or dc > TRAIN_CONSENSUS_RTOL
                or abs(c["mean_loss_full"] - loss) > TRAIN_LOSS_TOL):
            raise AssertionError(f"zoo train round {r}: card {c}, CPU {h}, "
                                 f"the reference's {loss} / {cerr}")
    rounds = len(oc["rounds"])
    held = {}
    for (nm, _), c in tap.checked.items():
        held[nm] = held.get(nm, 0) + c
    if DEV == "cuda":
        for kname, per in TRAIN_PER_ROUND.items():
            if counts[kname] != per * rounds or held.get(kname) != counts[
                    kname]:
                raise AssertionError(
                    f"zoo train: {counts[kname]} {kname} launches, "
                    f"{held.get(kname)} held, in {rounds} rounds; expected "
                    f"{per} a round")
    log(f"[zoo] deepseek smoke run ({' '.join(ZOO_TRAIN_ARGV)}): params "
        f"{oc['params']:,}, wire {oc['wire']:,} B/agent/round, DDP "
        f"equivalent {oc['ddp']:,}, telemetry the reference's; card vs CPU "
        f"max |d mean_loss| {worst_l:.3e}, max relative d consensus_err "
        f"(card vs CPU and the reference's) {worst_c:.3e}; launches "
        f"{({k: v for k, v in counts.items() if v})}, held bit for bit "
        f"against their plain versions: {held}; {tc:.2f} s on {DEV}, "
        f"{th:.2f} s on the CPU")


def phase_zoo():
    """The zoo's parts; returns the kernels line's rows (seamless's K10
    shapes, on the card)."""
    import torch

    t0 = time.perf_counter()
    if DEV == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    rows = []
    for part in (zoo_deepseek, zoo_deepseek_consistency, zoo_xlstm,
                 zoo_seamless, zoo_train):
        t1 = time.perf_counter()
        rows += part() or []
        log(f"[zoo] {part.__name__} {time.perf_counter() - t1:.1f} s")
    log(f"[zoo] phase {time.perf_counter() - t0:.1f} s")
    return rows


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
    phase_train()
    phase_zoo()
    log("[rehearse] done on the CPU; no result")


# the mesh phase: LT-ADMM-CC through the multi-process exchange in a
# one-rank NCCL world beside the host exchange.  Paper-size rows (label,
# spec, graph) run MESH_ROUNDS rounds each way; the n = 2^20 rows (label,
# launches a round) run MESH_WIDE_ROUNDS rounds with the counters zeroed
# just before and read just after
MESH_ROUNDS = 110
MESH_PAPER = (
    ("qbit8", "ltadmm:compressor=qbit:bits=8", "ring"),
    ("randk-stride",
     "ltadmm:eta=0.5,compressor=randk:fraction=0.6,sampler=stride", "ring"),
    ("drop-q8", "ltadmm:compressor=qbit:bits=8", DROP_SPEC),
)
MESH_WIDE = (("qbit8", {"quantize_plane": 2, "dequantize_plane": 4}),
             ("randk-stride", {"randk_gather_plane": 2,
                               "randk_scatter_plane": 4}))
MESH_WIDE_ROUNDS = 5
# the gossip rows: (label, spec, graph, counters that must launch), plain
# SGD at the paper's size, MESH_ROUNDS rounds each way
MESH_GOSSIP = (
    ("choco-qbit8", "choco:compressor=qbit:bits=8", "ring",
     ("quantize_tensor", "dequantize_tensor")),
    ("dada", "dada:", "ring", ()),
)


def mesh_paper(mesh, dev):
    """Each ``MESH_PAPER`` row at the paper's size through the mesh and
    the host exchange: equal rounds_to_tol and wire bytes, every state
    leaf bit-equal at the last round; then the warm round of each path,
    timed in turns (``mesh_paper_rounds``)."""
    import numpy as np

    from repro_torch.bench import rounds_to_tol
    from repro_torch.launch import spmd_check

    for label, spec, gspec in MESH_PAPER:
        got = spmd_check.paper_run(mesh, dev, spec, gspec, MESH_ROUNDS)
        want = spmd_check.paper_run(None, dev, spec, gspec, MESH_ROUNDS)
        r2t = [rounds_to_tol(r["idx"], r["gns"], 1e-8) for r in (got, want)]
        log(f"[mesh] {label} on {gspec}: rounds_to_tol mesh {r2t[0]} host "
            f"{r2t[1]}, wire bytes {got['wire_bytes']} / "
            f"{want['wire_bytes']}")
        if r2t[0] != r2t[1] or r2t[0] is None:
            raise AssertionError(f"mesh {label}: rounds_to_tol {r2t}")
        if got["wire_bytes"] != want["wire_bytes"]:
            raise AssertionError(f"mesh {label}: wire bytes differ")
        if not np.array_equal(got["gns"], want["gns"]):
            raise AssertionError(f"mesh {label}: the metric differs")
        lo, hi = got["rows"]
        for f, v in got["state"].items():
            if not np.array_equal(v, want["state"][f][lo:hi]):
                raise AssertionError(f"mesh {label}: state leaf {f} differs")
        mesh_paper_rounds(mesh, dev, label, spec, gspec)


def mesh_gossip(mesh, dev):
    """Each ``MESH_GOSSIP`` row at the paper's size through the mesh (the
    gossip's all-gather of each leaf; dada's all-to-alls) and through the
    host exchange: rounds_to_tol, wire bytes, the sampled metric and
    every state leaf equal; its kernels launched on the mesh run."""
    import numpy as np

    from repro_torch.bench import rounds_to_tol
    from repro_torch.launch import spmd_check

    for label, spec, gspec, kernels in MESH_GOSSIP:
        t0 = time.perf_counter()
        reset_counts()
        got = spmd_check.paper_run(mesh, dev, spec, gspec, MESH_ROUNDS)
        counts = {k: v for k, v in read_counts().items() if v}
        want = spmd_check.paper_run(None, dev, spec, gspec, MESH_ROUNDS)
        r2t = [rounds_to_tol(r["idx"], r["gns"], 1e-8) for r in (got, want)]
        log(f"[mesh] {label} on {gspec} ({MESH_ROUNDS} rounds, plain "
            f"SGD): rounds_to_tol mesh {r2t[0]} host {r2t[1]}, final "
            f"metric {got['gns'][-1]:.6e} / {want['gns'][-1]:.6e}, wire "
            f"bytes {got['wire_bytes']} / {want['wire_bytes']}, mesh "
            f"launches {counts}; {time.perf_counter() - t0:.1f} s")
        if r2t[0] != r2t[1] or got["wire_bytes"] != want["wire_bytes"]:
            raise AssertionError(f"mesh {label}: {r2t}, bytes differ")
        if not np.array_equal(got["gns"], want["gns"]):
            raise AssertionError(f"mesh {label}: the metric differs")
        missing = [k for k in kernels if not counts.get(k)]
        if missing:
            raise AssertionError(f"mesh {label}: never launched {missing}")
        lo, hi = got["rows"]
        for f, v in got["state"].items():
            if not np.array_equal(v, want["state"][f][lo:hi]):
                raise AssertionError(f"mesh {label}: state leaf {f} differs")


def mesh_paper_rounds(mesh, dev, label, spec, gspec, rounds=20, turns=4):
    """The paper-size round of ``spec`` through the mesh and the host
    exchange, each warm (one round first), timed in blocks of ``rounds``
    rounds on the host clock in turns (the order flips each turn), with
    the collectives a mesh round makes."""
    import torch

    from repro_torch.core import jaxrand
    from repro_torch.launch import spmd_check

    paths = {}
    for name, m in (("host", None), ("mesh", mesh)):
        prob, solver = spmd_check.paper_solver(m, dev, spec, gspec)
        rows = slice(solver.exchange.rows.start, solver.exchange.rows.stop)
        data = {k: v.to(dev)[rows] for k, v in prob.make_data(0).items()}
        st = solver.init(torch.zeros((prob.n_agents, prob.n), device=dev)
                         [rows])
        paths[name] = [solver, data, solver.step(st, data, jaxrand.key(0))]
    sync()
    ms = {"host": [], "mesh": []}
    coll = paths["mesh"][0].exchange.collectives
    for key in coll:
        coll[key] = 0
    k = 1
    for turn in range(turns):
        order = ("host", "mesh") if turn % 2 == 0 else ("mesh", "host")
        for name in order:
            solver, data, st = paths[name]
            sync()
            t0 = time.perf_counter()
            for i in range(rounds):
                st = solver.step(st, data, jaxrand.key(k + i))
            sync()
            ms[name].append((time.perf_counter() - t0) * 1e3 / rounds)
            paths[name][2] = st
        k += rounds
    calls = coll["calls"] / (turns * rounds)
    gap = min(ms["mesh"]) - min(ms["host"])
    log(f"[mesh] {label} paper-size round ms (host clock, warm, "
        f"{rounds}-round blocks in turns; {CARD}): mesh "
        f"{', '.join(f'{t:.4f}' for t in ms['mesh'])}; host "
        f"{', '.join(f'{t:.4f}' for t in ms['host'])}; {calls:g} "
        f"collectives a mesh round; best mesh - best host {gap:.4f} ms, "
        f"{gap / calls:.4f} ms a collective")


def mesh_collective_ms(mesh, dev, calls=200):
    """Host-clock ms of one paper-size ``all_to_all_single`` ([10, 5] f32,
    int8) on the mesh's agent group, warm: issued back to back and
    synchronised at the end, and synchronised after each call."""
    import torch

    group = mesh.get_group("data")
    out = []
    for dtype in (torch.float32, torch.int8):
        x = torch.ones((10, 5), dtype=dtype, device=dev)
        recv = torch.empty_like(x)
        for _ in range(10):
            torch.distributed.all_to_all_single(recv, x, group=group)
        for each in (False, True):
            sync()
            t0 = time.perf_counter()
            for _ in range(calls):
                torch.distributed.all_to_all_single(recv, x, group=group)
                if each:
                    sync()
            sync()
            out.append(f"{dtype} {'synced' if each else 'issued'} "
                       f"{(time.perf_counter() - t0) * 1e3 / calls:.4f}")
    log(f"[mesh] one all_to_all_single on [10, 5], ms a call over {calls} "
        f"(host clock, warm; {CARD}): {'; '.join(out)}")


def mesh_wide(mesh, dev, label, per_round):
    """The n-wide ``label`` round through the mesh and the host exchange:
    the same launches a round (counters zeroed just before, read just
    after), every state leaf bit-equal, the collectives a mesh round makes
    and their bytes, the round's host-clock time beside the host round's
    (in turns), and one profiled mesh round (NCCL's kernels and device
    time, the idle share).  Returns the profile's figures."""
    from repro_torch.core import jaxrand
    from repro_torch.launch import spmd_check
    from repro_torch.problems.logistic import LogisticProblem

    rounds = MESH_WIDE_ROUNDS
    prob = LogisticProblem(n=WIDE_N)
    data = wide_data(prob, dev)
    host, x0, gspec, _, _ = wide_solver(label, prob, dev)
    on_mesh, _, _, _, _ = wide_solver(label, prob, dev, mesh=mesh)
    lo, hi = on_mesh.exchange.rows.start, on_mesh.exchange.rows.stop
    mine = {k: v[lo:hi] for k, v in data.items()}
    base = jaxrand.key(12345)
    states, counts = {}, {}
    for name, solver, d in (("host", host, data), ("mesh", on_mesh, mine)):
        st = solver.init(x0[lo:hi] if name == "mesh" else x0)
        st = solver.step(st, d, jaxrand.fold_in(base, 0))
        sync()
        reset_counts()
        coll = solver.exchange.collectives
        for key in coll:
            coll[key] = 0
        for i in range(1, 1 + rounds):
            st = solver.step(st, d, jaxrand.fold_in(base, i))
        sync()
        counts[name] = read_counts()
        if name == "mesh":
            coll = dict(coll)
        states[name] = st
    for k, per in per_round.items():
        if (counts["mesh"][k] != per * rounds
                or counts["host"][k] != per * rounds):
            raise AssertionError(
                f"mesh {label}: {k} launched {counts['mesh'][k]} (mesh) and "
                f"{counts['host'][k]} (host) times in {rounds} rounds, not "
                f"{per * rounds}")
    if counts["mesh"] != counts["host"]:
        raise AssertionError(f"mesh {label}: launches differ: "
                             f"{counts['mesh']} vs {counts['host']}")
    spmd_check.compare_states(label, states["mesh"], states["host"],
                              on_mesh.exchange.rows)
    log(f"[mesh] {label} n={WIDE_N}: {rounds} rounds, launches a round "
        f"{ {k: v // rounds for k, v in counts['mesh'].items() if v} } "
        f"(mesh = host), state bit-equal; collectives a round "
        f"{coll['calls'] / rounds:g} moving {coll['bytes'] / rounds:.0f} B "
        f"({coll['bytes_off_rank'] / rounds:.0f} B off the rank)")
    # the round's host clock, mesh and host in turns
    turns_ms = {"host": [], "mesh": []}
    k = 1 + rounds
    for _ in range(3):
        for name, solver, d in (("host", host, data),
                                ("mesh", on_mesh, mine)):
            sync()
            t0 = time.perf_counter()
            states[name] = solver.step(states[name], d,
                                       jaxrand.fold_in(base, k))
            sync()
            turns_ms[name].append((time.perf_counter() - t0) * 1e3)
        k += 1
    log(f"[mesh] {label} n={WIDE_N} round ms (host clock, in turns; "
        f"{CARD}): mesh {', '.join(f'{t:.3f}' for t in turns_ms['mesh'])}; "
        f"host {', '.join(f'{t:.3f}' for t in turns_ms['host'])}")
    return profile_mesh_round(label, on_mesh, states["mesh"], mine, base, k)


def profile_mesh_round(label, solver, st, data, base, k):
    """torch.profiler over one mesh round and the consensus all_reduce
    after it: the NCCL kernels (their device time), the NCCL operators
    torch records, device copies, busy time and the idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import admm, jaxrand

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st = solver.step(st, data, jaxrand.fold_in(base, k))
        admm.consensus_mean(st, solver.exchange)
        sync()
        wall = time.perf_counter() - t0
    # a collective's record_function range ("nccl:all_to_all") also shows
    # on the device timeline, spanning its kernels: not a kernel itself
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.name.startswith(("nccl:", "gloo:"))]
    busy = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3
    nccl_k = {}
    for e in dev_events:
        if "nccl" in e.name.lower():
            ms, n = nccl_k.get(e.name, (0.0, 0))
            nccl_k[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    copies = sum(e.time_range.elapsed_us() for e in dev_events
                 if "memcpy" in e.name.lower()) / 1e3
    ops = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CPU
                and e.name.startswith(("nccl:", "gloo:"))):
            ops[e.name] = ops.get(e.name, 0) + 1
    log(f"[mesh] {label} profiled round ({CARD}): wall {wall * 1e3:.3f} ms, "
        f"device busy {busy:.3f} ms, idle share "
        f"{1 - busy / (wall * 1e3):.3f}; NCCL kernels (ms, launches) "
        f"{ {n[:40]: (round(v[0], 4), v[1]) for n, v in nccl_k.items()} } "
        f"({sum(v[0] for v in nccl_k.values()):.4f} ms); device copies "
        f"{copies:.4f} ms; collective operators (host events) {ops}")
    if not ops and not nccl_k:
        raise AssertionError(f"mesh {label}: no collective in the profile")
    if not nccl_k:
        log(f"[mesh] {label}: the one-rank world ran its collectives "
            f"({ops}) without a device kernel named NCCL")
    return {"nccl_ms": sum(v[0] for v in nccl_k.values()), "ops": ops,
            "busy": busy, "wall": wall * 1e3}


def mesh_two_cards(dev):
    """With two cards: a two-rank NCCL world (one card a rank, 5 agents a
    rank) on the paper's ring, its states gathered to this process and
    held bit for bit against the one-card host run."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.launch import spmd_check

    if torch.cuda.device_count() < 2:
        log("[mesh] one card: the multi-card run (a two-rank NCCL world) "
            "waits for a machine with more cards")
        return
    label, spec, gspec = MESH_PAPER[0]
    with tempfile.TemporaryDirectory() as d:
        ranks = spmd_check.collect_world(spmd_check.start_world(
            "paper", 2, d, backend="nccl", spec=spec, gspec=gspec,
            rounds=MESH_ROUNDS), 2, d)
    want = spmd_check.paper_run(None, dev, spec, gspec, MESH_ROUNDS)
    for f, v in want["state"].items():
        got = np.concatenate([r["state"][f] for r in ranks])
        if not np.array_equal(got, v):
            raise AssertionError(f"two cards: state leaf {f} differs")
    log(f"[mesh] two cards ({CARD}): {label} on {gspec}, rows "
        f"{[r['rows'] for r in ranks]}, every state leaf bit-equal to the "
        f"one-card host run")


def phase_mesh():
    """A one-rank NCCL world from a FileStore on card 0, its ``(1, 1)``
    ("data", "model") mesh, the paper-size and n-wide mesh rounds against
    the host rounds, then the two-card world where there are two cards.
    A failure to start the world fails the phase."""
    import tempfile

    import torch

    from repro_torch.launch.mesh import make_host_mesh, world

    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as d, world(
            "nccl", os.path.join(d, "store"), device=dev):
        mesh = make_host_mesh()
        log(f"[mesh] nccl world of {torch.distributed.get_world_size()}, "
            f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} on "
            f"{mesh.device_type}")
        mesh_paper(mesh, dev)
        mesh_gossip(mesh, dev)
        mesh_collective_ms(mesh, dev)
        for label, per_round in MESH_WIDE:
            mesh_wide(mesh, dev, label, per_round)
    mesh_two_cards(dev)


# the dry-run phase: qwen3-0.6b's four shapes cut to DRYRUN_LAYERS (the
# train round at tau 1) in the 256-rank fake world; the served prefill's
# predicted peak must lie within DRYRUN_PEAK_RTOL of the measured one
DRYRUN_ARCH, DRYRUN_LAYERS, DRYRUN_PEAK_RTOL = "qwen3-0.6b", 1, 0.10


def phase_dryrun():
    """The dry-run tooling on the card's host: ``dryrun_one`` on the four
    shapes (cut), then the served prefill (B 4 x T 2048, bf16, K10)
    traced on ``meta`` against the same prefill run for real under the
    same counter: live bytes, dot_flops, the measured ms beside the
    roofline terms."""
    import torch

    from repro_torch.configs import SHAPES
    from repro_torch.core import jaxrand
    from repro_torch.launch import dryrun
    from repro_torch.launch.op_analysis import roofline_terms, tree_bytes
    from repro_torch.launch.steps import build_prefill, model_specs
    from repro_torch.models.common import abstract_params

    for shape in SHAPES:
        variant = {"n_layers": DRYRUN_LAYERS}
        if SHAPES[shape].kind == "train":
            variant["recipe_tau"] = 1
        rec = dryrun.dryrun_one(DRYRUN_ARCH, shape, False, verbose=False,
                                variant=variant)
        r, ops = rec["roofline"], rec["ops"]
        log(f"[dryrun] {DRYRUN_ARCH} x {shape} x {rec['mesh']} (a "
            f"{DRYRUN_LAYERS}-layer cut, {variant}): t_compute "
            f"{r['t_compute_s']:.6e} s, t_memory {r['t_memory_s']:.6e} s, "
            f"t_collective {r['t_collective_s']:.6e} s, {r['dominant']}; "
            f"dot_flops {ops['dot_flops']:.6e} (flop_counter "
            f"{rec['flop_counter_flops']:.6e}), memory v1 "
            f"{ops['memory_bytes']:.6e} v2 {ops['memory_bytes_w2']:.6e}, "
            f"collectives {ops['collective_counts']} "
            f"{ops['collective_bytes']:.6e} B, kernels {rec['kernels']}, "
            f"{rec['n_ops']} ops; useful {rec['useful_fraction']:.4f}; "
            f"total_live {rec['bytes_per_device']['total_live'] / 1e9:.3f}"
            f" GB; traced in {rec['compile_s']} s")
    pb, pt = SERVE_MODELS[DRYRUN_ARCH][:2]
    arch, cfg, params = serve_model(DRYRUN_ARCH)
    prefill = build_prefill(arch, cfg)
    tokens = jaxrand.randint(jaxrand.key(1, DEV), (pb, pt), 0, cfg.vocab)
    meta = {"tokens": torch.empty(tokens.shape, dtype=tokens.dtype,
                                  device="meta")}
    with torch.no_grad():
        pred = dryrun.analyze_step(prefill, (abstract_params(
            model_specs(arch, cfg), cfg.dtype), meta))
        inputs = list(params.parameters()) + list(params.buffers()) + [
            tokens]
        sync()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        real = dryrun.analyze_step(prefill, (params, {"tokens": tokens}))
        sync()
        measured = torch.cuda.max_memory_allocated() - base + tree_bytes(
            inputs)
        del real.out
        ms = cuda_ms(lambda: prefill(params, {"tokens": tokens}), iters=5,
                     warmup=2)
    want = pred.bytes_per_device["total_live"]
    gap = want / measured - 1
    log(f"[dryrun] {DRYRUN_ARCH} prefill B={pb} T={pt} ({CARD}): predicted "
        f"total_live {want:,} B (args {pred.bytes_per_device['args']:,}, "
        f"temp {pred.bytes_per_device['temp']:,}, out "
        f"{pred.bytes_per_device['out']:,}), measured {measured:,} B "
        f"(max_memory_allocated less {base:,} B before, plus the inputs' "
        f"{tree_bytes(inputs):,}): gap {gap:+.4f}; the trackers' peaks: "
        f"trace {pred.memory.peak:,} B, card {real.memory.peak:,} B")
    terms = roofline_terms(pred.stats)
    log(f"[dryrun] {DRYRUN_ARCH} prefill: dot_flops trace "
        f"{pred.stats.dot_flops:.6e} real {real.stats.dot_flops:.6e} "
        f"({dict(pred.counter.kernels)} / {dict(real.counter.kernels)}); "
        f"measured {ms:.4f} ms (CUDA events, mean of 5) beside t_compute "
        f"{terms['t_compute_s'] * 1e3:.4f} ms, t_memory "
        f"{terms['t_memory_s'] * 1e3:.4f} ms ({terms['dominant']}); "
        f"{pred.counter.n_ops} ops traced in {pred.seconds:.2f} s, "
        f"{real.counter.n_ops} counted on the card in {real.seconds:.2f} s")
    if abs(gap) > DRYRUN_PEAK_RTOL:
        raise AssertionError(f"the dry-run's peak {want} is {gap:+.3%} off "
                             f"the card's {measured}")
    if real.stats.dot_flops != pred.stats.dot_flops:
        raise AssertionError(f"dot_flops: trace {pred.stats.dot_flops}, "
                             f"card {real.stats.dot_flops}")
    del params, real, pred
    torch.cuda.empty_cache()


# the tp phase: tensor-parallel serving (``build_prefill`` / ``build_serve``
# with a mesh) in a world of TP_RANKS ranks, one "model" axis over them.
# arch -> (prefill B, T, greedy B, prompt, new tokens, n_layers cut or None)
TP_RANKS = 2
TP_MODELS = {"qwen3-0.6b": (4, 2048, 4, 1, 8, None),
             "zamba2-2.7b": (2, 2048, 4, 1, 4, 6)}
# K10 launches and Mamba blocks a rank: qwen3-0.6b's 28 layers; zamba2's
# one unit, 6 Mamba blocks and the shared block once
TP_EXPECT = {"qwen3-0.6b": (28, 0), "zamba2-2.7b": (1, 6)}
# the gathered last bf16 logits' distance from an f32 evaluation of the
# same weights, at most this many times the one-rank bf16 run's own: the
# reassociated sums must not drift further than bf16 rounding already
# does, plus TP_F32_RTOL of the logits' scale.  The bf16 SSD path drifts
# by units (ROADMAP Queue 3, Serving 4; PERF.md §6), so for zamba2
# this check is weak: the binding one is TP_F32_TOL, the tensor-parallel
# prefill run in f32 against the one-rank f32 prefill of the same
# weights, where no bf16 rounding hides a fault (the CPU tests hold the
# same at 1e-5 against the reference)
TP_DRIFT_FACTOR, TP_F32_RTOL = 2.0, 1e-5
TP_F32_TOL = 1e-4  # of the f32 logits' scale
# all_reduce sizes the phase times in its world after the models: a
# decode step's [4, 1, 1024] bf16, a prefill's [4, 2048, 1024] in bf16
# and in f32 (its row-parallel partials)
TP_COLLECTIVES = (((4, 1, 1024), "bfloat16"), ((4, 2048, 1024), "bfloat16"),
                  ((4, 2048, 1024), "float32"))
TP_COLLECTIVE_CALLS = 10
# tensor-parallel training in the same world: qwen3-0.6b at full width cut
# to TP_TRAIN_LAYERS, f32; TP_TRAIN_ROUNDS rounds of TP_TRAIN_SPEC with
# TP_TRAIN_AGENTS agents on the complete graph (the mesh phase covers the
# graphs) and TP_TRAIN_DDP Adam steps, against rank 0's one-rank run of
# the same weights and data
TP_TRAIN_ARCH, TP_TRAIN_LAYERS = "qwen3-0.6b", 1
TP_TRAIN_AGENTS, TP_TRAIN_ROUNDS, TP_TRAIN_DDP = 2, 2, 2
TP_TRAIN_M, TP_TRAIN_SEQ = 4, 64
TP_TRAIN_SPEC = ("ltadmm:packed=false,tau=2,batch_size=2,"
                 "compressor=qbit:bits=8")
# the losses (relative) and the state against the one-rank run's: x within
# TP_TRAIN_TOL of each leaf's scale; every other field within TP_TRAIN_TOL
# of it, or, where a level flipped under the reassociated sums (and where
# a flip fed), within the flip's bound (``_tp_state_bounds``), such
# elements at most TP_TRAIN_FLIP_SHARE of the field's
TP_TRAIN_TOL, TP_TRAIN_FLIP_SHARE, TP_TRAIN_LEVELS = 1e-5, 1e-4, 127
# the held DDP steps run Adam with eps TP_TRAIN_EPS: Adam's first update,
# g / (|g| + eps), turns a gradient's reassociation noise into a parameter
# gap a part of lr wide where |g| is within a few eps, and what that gap
# feeds reaches the second step's moments; an eps large against that
# noise holds both steps' moments and the parameters at TP_TRAIN_TOL (v,
# the gradient squared, at twice it).  Adam's default eps runs beside it
# for the count of that effect (printed, and held to the losses only)
TP_TRAIN_EPS, TP_TRAIN_ADAM_EPS = 1e-3, 1e-8
TP_PHASE_S = 90  # the phase's limit, host clock
TP_TREES_A_ROUND = 2  # the per-leaf round's message trees: x's and z's


def memory_peak(fn):
    """``(fn(), bytes allocated at the peak of the call above what was
    allocated before it)``; 0 off the card."""
    import torch

    if DEV != "cuda":
        return fn(), 0
    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    sync()
    return out, torch.cuda.max_memory_allocated() - base


@contextlib.contextmanager
def collective_events():
    """Inside the block each of ``launch.tp``'s collectives records a CUDA
    event just before and just after it (the layers call them through the
    module, so the stand-ins are seen); yields the list of (before,
    after) pairs."""
    import torch

    from repro_torch.launch import tp

    pairs = []
    saved = {n: getattr(tp, n)
             for n in ("all_reduce", "all_reduce_exact", "all_gather")}

    def wrap(fn):
        def call(*args, **kwargs):
            before = torch.cuda.Event(enable_timing=True)
            before.record()
            out = fn(*args, **kwargs)
            after = torch.cuda.Event(enable_timing=True)
            after.record()
            pairs.append((before, after))
            return out
        return call

    for name, fn in saved.items():
        setattr(tp, name, wrap(fn))
    try:
        yield pairs
    finally:
        for name, fn in saved.items():
            setattr(tp, name, fn)


def idle_in_collectives(fn):
    """``(ms, ms inside the collectives)`` of ``fn()`` on the device's
    clock (CUDA events): the span from before the call to after it, and
    the part of it between each collective's two events (the stream's
    wait for the host's exchange, gloo's copies included).  Their ratio
    stands for the device's idle share: read without torch.profiler,
    whose first session in a process starts CUPTI (seconds); it counts
    gloo's copies as idle and the launch gaps between collectives as
    busy."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with collective_events() as pairs:
        start.record()
        fn()
        end.record()
    end.synchronize()
    return (start.elapsed_time(end),
            sum(b.elapsed_time(a) for b, a in pairs))


def argmax_flips(a, b, yard):
    """The rows whose argmax differs between logits ``a`` and ``b`` ([B,
    1, V]): (row, ``yard``'s logit of b's pick less a's, ``yard``'s own
    top-2 margin), ``yard`` the f32 logits of the same weights."""
    ia, ib = a.argmax(-1).flatten(), b.argmax(-1).flatten()
    y = yard.reshape(ia.numel(), -1)
    out = []
    for r in (ia != ib).nonzero().flatten().tolist():
        top = y[r].topk(2).values
        out.append((r, float(y[r, ib[r]] - y[r, ia[r]]),
                    float(top[0] - top[1])))
    return out


def tp_collective_ms(mesh, dev):
    """Host ms of one ``all_reduce`` over the "model" group at each of
    ``TP_COLLECTIVES`` (mean of ``TP_COLLECTIVE_CALLS`` after one warm
    call, each synchronised), each sum checked."""
    import torch
    import torch.distributed as dist

    group, out = mesh.get_group("model"), {}
    for shape, dt in TP_COLLECTIVES:
        t = torch.ones(shape, dtype=getattr(torch, dt), device=dev)
        dist.all_reduce(t, group=group)
        if not bool((t == TP_RANKS).all()):
            raise AssertionError(f"all_reduce of {shape} {dt} is wrong")
        sync()
        t0 = time.perf_counter()
        for _ in range(TP_COLLECTIVE_CALLS):
            dist.all_reduce(t, group=group)
        sync()
        out[f"{list(shape)} {dt}"] = ((time.perf_counter() - t0) * 1e3
                                      / TP_COLLECTIVE_CALLS)
    return out


def tp_model(arch_id, mesh, rank, dev):
    """One model served tensor-parallel over ``mesh``'s "model" axis on
    this rank, and on rank 0 also whole: the prefill under a
    ``MainPathTap`` (counts zeroed just before, read just after; rank 0
    holds every K10 call), the Mamba blocks' inputs through K11 on each
    rank (every call held), the prefill in turns with the one-rank run,
    one profiled, and the greedy server.  Returns the rank's readings."""
    import dataclasses
    import functools

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.common.trees import tree_flatten, tree_map
    from repro_torch.configs import ARCHS
    from repro_torch.core import jaxrand
    from repro_torch.launch import serve, tp
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.launch.steps import build_prefill, model_specs
    from repro_torch.models import transformer as tr
    from repro_torch.models.common import init_params
    from repro_torch.models.mamba import Mamba

    pb, pt, gb, gp, gg, layers = TP_MODELS[arch_id]
    arch = ARCHS[arch_id]
    cfg = arch.make_smoke() if SMOKE else arch.make(None)
    if SMOKE:
        pb, pt, gb, gp, gg = 2, 64, 2, 4, 4
    elif layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    cfg = dataclasses.replace(cfg, use_flash=True)
    specs = model_specs(arch, cfg)
    marks, t0 = {}, time.perf_counter()

    def mark(name):
        sync()
        marks[name] = round(time.perf_counter() - t0, 2)

    tree = init_params(jaxrand.key(0, dev), specs, dtype=cfg.dtype)
    batch = {"tokens": jaxrand.randint(jaxrand.key(1, dev), (pb, pt), 0,
                                       cfg.vocab)}
    mark("weights")
    prompt = jaxrand.randint(jaxrand.key(0, dev), (gb, gp), 0, cfg.vocab)
    out = {"weights": sum(t.numel() for t in tree_flatten(tree)[0]),
           "blocks": (cfg.n_units * (cfg.pattern.count("attn")
                                     + int(cfg.shared_attn)),
                      cfg.n_units * cfg.pattern.count("mamba"))}
    whole = prefill1 = None
    # the same weights in f32: the yardstick, whole on rank 0, and the
    # tensor-parallel f32 prefill's shards on every rank
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    tree32 = tree_map(lambda t: t.float(), tree)
    if rank == 0:
        whole = tr.model_params(cfg, tree)  # shares the leaves
        prefill1 = build_prefill(arch, cfg)
        with torch.no_grad():
            last1, peak1 = memory_peak(lambda: prefill1(whole, batch))
            tok1, secs1 = serve.generate(arch, cfg, whole, prompt, gg)
            w32 = tr.model_params(cfg32, tree32)  # shares the leaves
            last32 = build_prefill(arch, cfg32)(w32, batch).float()
            del w32
        out["one"] = {"peak": peak1, "tokens": tok1.tolist(),
                      "decode_ms": secs1 * 1e3 / gg,
                      "weight_bytes": sum(p.numel() * p.element_size()
                                          for p in whole.parameters())}
    mark("one rank")
    shard = tr.model_params(cfg, shd.shard_params(tree, mesh, "serve",
                                                  specs))
    del tree
    out["weight_bytes"] = sum(p.numel() * p.element_size()
                              for p in shard.parameters())
    prefill = build_prefill(arch, cfg, mesh)
    mark("shard")

    mamba_in = []
    hooks = [m.register_forward_hook(
        lambda mod, args, res: mamba_in.append((mod, args[0])))
        for m in shard.modules() if isinstance(m, Mamba)]
    tap = MainPathTap(SERVE_WRAPPERS)
    tap.checking = rank == 0
    tp.reset_stats()
    try:
        reset_counts()  # the tensor-parallel prefill starts here
        with torch.no_grad():
            last, peak = memory_peak(lambda: prefill(shard, batch))
        sync()
        after = read_counts()  # ... and ends here
    finally:
        tap.close()
        for h in hooks:
            h.remove()
    out.update(peak=peak, collectives=dict(tp.stats),
               k10={n: after[f"flash_attention{n}"]
                    for n in ("", "_tc", "_cc")},
               k10_shapes={_show(k[1]): c for k, c in tap.by_shape.items()},
               k10_held=len(tap.readings.get("flash_attention", [])),
               k10_readings=sorted(set(tap.readings.get("flash_attention",
                                                        [])))[:3])
    # the tensor-parallel prefill again, in f32 (after the main path's
    # counts were read)
    shard32 = tr.model_params(cfg32, shd.shard_params(tree32, mesh,
                                                      "serve", specs))
    del tree32
    with torch.no_grad():
        tp32 = build_prefill(arch, cfg32, mesh)(shard32, batch).float()
    del shard32
    for t in (last, tp32):
        if tuple(t.shape) != (pb, 1, cfg.vocab) or not bool(
                torch.isfinite(t.float()).all()):
            raise AssertionError(f"{arch_id}: tensor-parallel logits bad")
    if rank == 0:
        lf, wf = last.float(), last1.float()
        d = float((lf - wf).abs().max())
        scale = float(wf.abs().max())
        ulp = 2.0 ** (math.floor(math.log2(scale)) - 7)
        out["logits"] = {"max_abs": d, "scale": scale, "ulps": d / ulp,
                         "tp_f32": float((lf - last32).abs().max()),
                         "one_f32": float((wf - last32).abs().max()),
                         "f32": float((tp32 - last32).abs().max()),
                         "scale32": float(last32.abs().max()),
                         "argmax_equal": bool(torch.equal(
                             lf.argmax(-1), wf.argmax(-1))),
                         "argmax_equal_f32": bool(torch.equal(
                             tp32.argmax(-1), last32.argmax(-1))),
                         "flips": argmax_flips(lf, wf, last32)}
        del last1, last32
    del last, tp32
    mark("main path")

    if mamba_in:
        tap = MainPathTap({"ssd_chunked": (
            "K11", "ssm_scan", k11_plain,
            functools.partial(hold_k11, variant="tc"))})
        tap.checking = True
        try:
            reset_counts()  # the Mamba blocks' kernel path starts here
            with use_mesh(mesh), torch.no_grad():
                ys = [mod(x, use_kernel=True) for mod, x in mamba_in]
            sync()
            after = read_counts()  # ... and ends here
        finally:
            tap.close()
        out["k11"] = {n: after[f"ssd_chunked{n}"] for n in ("", "_tc", "_cc")}
        out["k11_shapes"] = {_show(k[1]): c for k, c in tap.by_shape.items()}
        out["k11_readings"] = sorted(set(tap.readings.get("ssd_chunked",
                                                          [])))[:3]
        out["k11_held"] = len(tap.readings.get("ssd_chunked", []))
        out["mamba_blocks"] = len(mamba_in)
        del ys
    del mamba_in
    mark("K11")

    with torch.no_grad():
        if DEV == "cuda":
            # turns one, tp, one; the tp turn's time inside the
            # collectives over its span is the rank's idle share
            # (``idle_in_collectives``)
            times, held = {"one": [], "tp": []}, None
            for turn in ("one", "tp", "one"):
                dist.barrier()
                if turn == "tp":
                    ms, held = idle_in_collectives(
                        lambda: prefill(shard, batch))
                    times["tp"].append(ms)
                elif rank == 0:
                    times["one"].append(cuda_ms(
                        lambda: prefill1(whole, batch), iters=2, warmup=1))
            out.update(times=times, held=held, idle=held / times["tp"][0])
            mark("turns")
        del whole
        tokens, secs = serve.generate(arch, cfg, shard, prompt, gg,
                                      mesh=mesh)
    out["tokens"] = tokens.tolist()
    out["decode_ms"] = secs * 1e3 / gg
    mark("greedy")
    out["marks"] = marks
    seen = [None] * TP_RANKS
    dist.all_gather_object(seen, out["tokens"], group=mesh.get_group("model"))
    out["ranks_agree"] = all(t == out["tokens"] for t in seen)
    del shard
    if DEV == "cuda":
        torch.cuda.empty_cache()
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in out.items()}


def _copy_tree(tree):
    return {k: _copy_tree(v) if isinstance(v, dict) else v
            for k, v in tree.items()}


def _tp_state_fields(state):
    """The round state's fields that hold trees, by name."""
    return {f: getattr(state, f) for f in state._fields
            if isinstance(getattr(state, f), dict)}


def _round_levels(before, after):
    """One level of each message of a lean qbit8 round from ``before``
    to ``after`` (the message's max |.| / TP_TRAIN_LEVELS, as the
    quantiser's scale), by leaf on the host: the x-messages' ``[A]``
    (x_new - x̂) and the z-messages' ``[A, S]`` (z - s)."""
    from repro_torch.common.trees import tree_flatten

    def level(t, nd):
        return (t.abs().reshape(t.shape[:nd] + (-1,)).amax(-1).double()
                .cpu() / TP_TRAIN_LEVELS)

    def flat(tree):
        return tree_flatten(tree)[0]

    return ([level(x - h, 1) for x, h in zip(flat(after.x),
                                             flat(before.x_hat))],
            [level(z - s, 2) for z, s in zip(flat(before.z),
                                             flat(before.s))])


def _tp_state_bounds(levels, rrho):
    """The largest gap of each state field to the one-rank run's at an
    element where a level flipped, or that a flip fed, after the rounds
    whose ``_round_levels`` are ``levels``, on complete(2) (slot 0 the
    other agent): by field, by leaf, ``[A]`` or ``[A, S]`` on the host.
    A stochastic rounding lies within a level of its message, so where
    both runs started the round from the same state a flip is one level,
    after that at most two: x̂ (x̂_nbr its mirror) of the x-message's, s
    (s̃ its mirror) of the z-message's beside z's own gap, and z (eq. 4)
    half of s's and s̃'s and r rho times both ends' x̂'s."""
    nbr = [1, 0]
    out = None
    for k, (lx, lz) in enumerate(levels):
        m = 1 if k == 0 else 2
        new = []
        for i, (a, b) in enumerate(zip(lx, lz)):
            s = m * b + (0 if out is None else out[i]["z"])
            xh = m * a
            xn = xh[nbr][:, None]
            new.append({"x_hat": xh, "x_hat_nbr": xn, "s": s,
                        "s_tilde": s[nbr],
                        "z": 0.5 * (s + s[nbr])
                        + rrho * (xh[:, None] + xn)})
        out = new
    return {f: [b[f] for b in out] for f in out[0]}


def _shard_gaps(got, want, bound=None, small=None, scales=None):
    """A rank's shards ``got`` against the one-rank run's ``want`` (both
    flat lists, on the rank), each leaf's scale its whole leaf's (the
    max over "model", or ``scales`` where given): ``[max |d| / scale,
    elements past TP_TRAIN_TOL of it, elements, elements past it and
    past their ``bound`` (by leaf, per agent), elements past it where
    ``small`` (by leaf, a mask)]``."""
    from repro_torch.launch import tp

    worst, off, n, beyond, off_small = 0.0, 0, 0, 0, 0
    for i, (g, w) in enumerate(zip(got, want)):
        scale = (float(tp.all_reduce_max(w.abs().max()[None]))
                 if scales is None else scales[i])
        tol = TP_TRAIN_TOL * max(scale, 1e-30)
        d = (g - w).abs()
        worst = max(worst, float(d.max()) / max(scale, 1e-30))
        past = d > tol
        off += int(past.sum())
        n += d.numel()
        if bound is not None:
            b = bound[i].to(d.device, d.dtype)
            b = b.reshape(tuple(b.shape) + (1,) * (d.dim() - b.dim()))
            beyond += int((d > b * 1.001 + tol).sum())
        if small is not None:
            off_small += int((past & small[i]).sum())
    return [worst, off, n, beyond, off_small]


def _reduce_gaps(gaps, group, dev):
    """``_shard_gaps`` lists by name over the ranks of ``group``: the
    largest gap, the counts summed (a piece held whole counts once a
    rank)."""
    import torch
    import torch.distributed as dist

    top = torch.tensor([g[0] for g in gaps.values()], dtype=torch.float64,
                       device=dev)
    red = torch.tensor([g[1:] for g in gaps.values()], dtype=torch.float64,
                       device=dev)
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
    dist.all_reduce(red, group=group)
    return {f: {"max_rel": w, **dict(zip(
        ("off", "n", "beyond", "off_small"), map(int, r)))}
        for f, w, r in zip(gaps, top.tolist(), red.tolist())}


def tp_train(mesh, rank, dev):
    """Tensor-parallel training on this rank (``build_train`` per leaf and
    ``build_ddp_train`` with the mesh) after a one-rank run of the same:
    each rank runs the one-rank rounds and Adam steps on the whole
    weights (the two runs side by side on the card, their losses held
    equal across the ranks), keeps its own shard of the final state and
    of the first step's Adam moments and frees the rest.  Then both run
    tensor-parallel, the counts zeroed just before the rounds and read
    just after, every K4 shard-form call held against its plain version;
    each rank holds its shards against the one-rank ones, and the ranks'
    qbit8 / qbit4 payloads of every cut leaf, gathered, against K4 of
    the whole leaf.  Returns the rank's readings."""
    import dataclasses
    import functools

    import torch
    import torch.distributed as dist

    from repro_torch.common.trees import dict_paths, tree_flatten, tree_map
    from repro_torch.configs import ARCHS
    from repro_torch.core import compression, jaxrand
    from repro_torch.core.admm import STATE_LEAD
    from repro_torch.kernels.quantize import ops as qops
    from repro_torch.kernels.quantize import ref as qref
    from repro_torch.launch import steps, tp, train
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models.common import init_params, param_count

    arch = ARCHS[TP_TRAIN_ARCH]
    cfg = (arch.make_smoke() if SMOKE else dataclasses.replace(
        train.train_config(arch, smoke=False), n_layers=TP_TRAIN_LAYERS))
    specs = steps.model_specs(arch, cfg)
    spec = TP_TRAIN_SPEC + (",impl=kernel" if DEV == "cpu" else "")
    recipe = steps.TrainRecipe(topology="complete")
    a_n, rounds = TP_TRAIN_AGENTS, TP_TRAIN_ROUNDS
    group = mesh.get_group("model")
    marks, t0 = {}, time.perf_counter()

    def mark(name):
        sync()
        marks[name] = round(time.perf_counter() - t0, 2)

    whole = init_params(jaxrand.key(1, dev), specs)
    tokens = jaxrand.randint(jaxrand.key(2, dev),
                             (a_n, TP_TRAIN_M, TP_TRAIN_SEQ + 1), 0,
                             cfg.vocab)
    data, batch = {"tokens": tokens}, {"tokens": tokens[0, :2]}
    loss = steps.model_loss(arch, cfg)
    out = {"params": param_count(specs),
           "config": f"{cfg.name} d_model {cfg.d_model}, {cfg.n_layers} "
                     f"layer(s), vocab {cfg.vocab}, {cfg.dtype}"}
    mark("weights")

    def stacked():
        return tree_map(lambda t: t[None].expand((a_n,) + t.shape).clone(),
                        whole)

    def ddp_runs(params, keep, mesh_=None):
        """TP_TRAIN_DDP Adam steps at each eps from the same ``params``:
        {eps: (losses, [{"m", "v", "params"} after each step, as
        ``keep`` keeps them])}."""
        runs = {}
        for eps in (TP_TRAIN_EPS, TP_TRAIN_ADAM_EPS):
            built = steps.build_ddp_train(arch, cfg, lr=1e-3, mesh=mesh_,
                                          eps=eps)
            stepd, opt = built[0], built[-1]
            p = tree_map(torch.clone, params)
            o, ls, kept = opt.init(p), [], []
            for i in range(TP_TRAIN_DDP):
                p, o, lv = stepd(p, o, batch, i)
                ls.append(float(lv))
                kept.append({"m": keep(o["m"]), "v": keep(o["v"]),
                             "params": keep(p)})
            runs[eps] = (ls, kept)
        return runs

    def keep_shard(tree):
        return tree_flatten(shd.shard_params(tree_map(torch.clone, tree),
                                             mesh, "serve", specs))[0]

    # ---- the one-rank run, on each rank at once, kept as the rank's shard
    step1, init1, solver1 = steps.build_train(arch, cfg, a_n, spec, recipe,
                                              device=dev)
    if not solver1.cfg.lean or a_n != 2:
        raise AssertionError("tp train: _round_levels reads a lean round "
                             "on complete(2)")

    def one_rank():
        st, ls, levels = init1(stacked()), [], []
        for i in range(rounds):
            before, st = st, step1(st, data, 100 + i)
            levels.append(_round_levels(before, st))
            del before
            ls.append(train.mean_loss(solver1, loss, st, tokens))
        return st, ls, levels

    (st, losses1, levels), peak1 = memory_peak(one_rank)
    bounds = _tp_state_bounds(levels, solver1.cfg.r * solver1.cfg.rho)
    mark("one-rank rounds")
    one = {f: tree_flatten(shd.shard_params(_copy_tree(tree), mesh, "admm",
                                            specs, lead=STATE_LEAD[f]))[0]
           for f, tree in _tp_state_fields(st).items()}
    del st
    ddp1 = ddp_runs(whole, keep_shard)
    if DEV == "cuda":
        torch.cuda.empty_cache()
    ddp_losses1 = {eps: r[0] for eps, r in ddp1.items()}
    seen = [None] * TP_RANKS
    dist.all_gather_object(seen, (losses1, ddp_losses1), group=group)
    if any(x != (losses1, ddp_losses1) for x in seen):
        raise AssertionError(f"tp train: the ranks' one-rank runs differ: "
                             f"{seen}")
    out["one"] = {"losses": losses1, "ddp": ddp_losses1, "peak": peak1}
    mark("one rank")

    # ---- the tensor-parallel run
    step, _, init, solver = steps.build_train(arch, cfg, a_n, spec, recipe,
                                              device=dev, mesh=mesh)
    tap = MainPathTap({
        "quantize_tree": ("K4", "quantize", functools.partial(
            qref.quantize_tree_ref, window=PLAIN_WINDOW), hold_tree),
        "tree_absmax": ("K4", "quantize", "tree_absmax_ref")})
    tap.checking = True
    losses = []
    # K4's all-reduces: the int32 row-max words (the cross entropy's
    # shift, the other all_reduce_max, is a float)
    k4_reduces = [0]
    all_reduce_max = tp.all_reduce_max

    def counted(t, group=None):
        k4_reduces[0] += t.dtype == torch.int32
        return all_reduce_max(t, group)

    def tp_rounds():
        st = init(shd.shard_params(stacked(), mesh, "admm", specs, lead=1))
        for i in range(rounds):
            st = step(st, data, 100 + i)
            with use_mesh(mesh):
                losses.append(train.mean_loss(solver, loss, st, tokens))
            mark(f"tp round {i}")
        return st

    try:
        tp.all_reduce_max = counted
        reset_counts()  # the tensor-parallel rounds start here
        st, peak = memory_peak(tp_rounds)
        counts = read_counts()  # ... and end here
    finally:
        tp.all_reduce_max = all_reduce_max
        tap.close()
    held = sum(tap.checked.values())
    tree_leaves = tap.readings.get("quantize_tree", [])
    mark("tp rounds")
    ddp = ddp_runs(shd.shard_params(tree_map(torch.clone, whole), mesh,
                                    "serve", specs),
                   lambda t: tree_flatten(t)[0], mesh)
    mark("tp ddp")

    # ---- each rank's shards against the one-rank ones: the state, the
    # held Adam steps (eps TP_TRAIN_EPS) and, at Adam's default eps, the
    # first step's parameters and the second step's m, counted where the
    # first step's |g| (m / (1 - b1)) lies below 10 eps
    gaps = {}
    with use_mesh(mesh):
        for f, tree in _tp_state_fields(st).items():
            gaps[f] = _shard_gaps(tree_flatten(tree)[0], one[f],
                                  bounds.get(f))
        for i in range(TP_TRAIN_DDP):
            for k in ("m", "v", "params"):
                gaps[f"ddp_{k}{i + 1}"] = _shard_gaps(
                    ddp[TP_TRAIN_EPS][1][i][k], ddp1[TP_TRAIN_EPS][1][i][k])
        small = [g.abs() / (1 - 0.9) < 10 * TP_TRAIN_ADAM_EPS
                 for g in ddp1[TP_TRAIN_ADAM_EPS][1][0]["m"]]
        for k, i in (("params", 0), ("m", 1)):
            gaps[f"adam_eps_{k}{i + 1}"] = _shard_gaps(
                ddp[TP_TRAIN_ADAM_EPS][1][i][k],
                ddp1[TP_TRAIN_ADAM_EPS][1][i][k], small=small)
        small_n = int(sum(int(m.sum()) for m in small))
    ddp_losses = {eps: r[0] for eps, r in ddp.items()}
    del st, ddp, ddp1, one
    gaps = _reduce_gaps(gaps, group, dev)
    mark("compare")

    # ---- the rank's tree of shards compressed in one call (K4's shard
    # form, grouped), each cut leaf's payload gathered against K4 of the
    # whole leaf, a leaf held whole's against K4 itself
    names = list(dict_paths(whole))
    shards = shd.shard_params(tree_map(torch.clone, whole), mesh, "admm",
                              specs)
    leaves = tree_flatten(shards)[0]
    layouts = shd.shard_layouts(mesh, "admm", specs)
    plans = tree_flatten(shd.tp_plan(mesh, "admm", specs),
                         is_leaf=lambda t: isinstance(t, shd.LeafPlan))[0]
    keys = jaxrand.key(5)[None]
    lk = jaxrand.split(keys, len(leaves))
    n_cut = sum(lay.cut for lay in layouts)
    for bits in (8, 4):
        comp = compression.ShardedTree(
            compression.BBitQuantizer(bits=bits, impl="kernel"),
            tuple(layouts))
        with use_mesh(mesh):
            got = tree_flatten(compression.compress_tree(
                comp, keys, tree_map(lambda t: t[None], shards), nd=1),
                is_leaf=lambda t: isinstance(t, compression.Payload))[0]
        for i, (name, x, lay, plan, pl) in enumerate(zip(
                names, leaves, layouts, plans, got)):
            full = dict_paths(whole)[name].reshape(1, -1)
            qw, scw = qops.quantize_tensor(lk[:, i], full, bits=bits)
            want = (qw[0] if bits == 8 else
                    qref.unpack4(qw[0], full.shape[-1])).to(torch.int32)
            lv = (pl["q"][0] if bits == 8 else
                  qref.unpack4(pl["q"][0], x.numel())).to(torch.int32)
            if lay.cut:
                parts = [torch.empty_like(lv) for _ in range(TP_RANKS)]
                dist.all_gather(parts, lv, group=group)
                lv = torch.full_like(want, 99)
                for r, part in enumerate(parts):
                    lv[shd.leaf_layout(plan, lay.shape, r,
                                       TP_RANKS).counters(dev)] = part
            if not (torch.equal(lv, want)
                    and same_scale(pl["scale"], scw)):
                raise AssertionError(
                    f"tp train: {name} b={bits}: the ranks' payload, "
                    f"gathered, differs from K4 of the whole leaf at "
                    f"{int((lv != want).sum())} levels")
    mark("payloads")
    out.update(losses=losses, ddp=ddp_losses, peak=peak, gaps=gaps,
               held=held, cut_leaves=n_cut, leaves=len(leaves),
               marks=marks, small=small_n,
               k4_shard={k: counts[k] for k in ("quantize_tree",
                                                "tree_absmax")},
               k4_reduces=k4_reduces[0], tree_leaves=tree_leaves,
               k5=counts["dequantize_tensor"],
               k4_whole=counts["quantize_tensor"])
    del whole, leaves
    if DEV == "cuda":
        torch.cuda.empty_cache()
    return out


def tp_rank(rank, backend, store_dir, dev_type, smoke, started):
    """One rank of the tp phase's world (a spawned process): the world
    from a ``FileStore``, a ``(1, TP_RANKS)`` ("data", "model") mesh,
    ``tp_model`` of each of ``TP_MODELS``; the readings go to
    ``store_dir/tp<rank>.pkl``."""
    import pickle

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh, world

    global DEV, SMOKE
    DEV, SMOKE = dev_type, smoke
    spawned = time.time() - started
    dev = torch.device("cpu")
    if dev_type == "cuda":
        dev = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    t0 = time.perf_counter()
    with world(backend, os.path.join(store_dir, "store"), rank, TP_RANKS,
               dev if backend == "nccl" else None):
        mesh = make_host_mesh(TP_RANKS, model=TP_RANKS)
        out = {"rank": rank, "backend": dist.get_backend(),
               "device": str(dev), "spawn_s": spawned,
               "start_s": time.perf_counter() - t0}
        for arch_id in TP_MODELS:
            t1 = time.perf_counter()
            out[arch_id] = tp_model(arch_id, mesh, rank, dev)
            out[arch_id]["seconds"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        out["train"] = tp_train(mesh, rank, dev)
        out["train"]["seconds"] = time.perf_counter() - t1
        out["collective_ms"] = tp_collective_ms(mesh, dev)
        dist.barrier()
    with open(os.path.join(store_dir, f"tp{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def phase_tp():
    """Tensor-parallel serving over a 2-rank "model" world: with two or
    more cards an NCCL world, one card a rank; with one card both ranks
    on it in a gloo world (NCCL refuses two ranks on one device), chosen
    by the device count and printed.  Each model's tensor-parallel
    prefill and greedy tokens against its one-rank run, its K10 / K11
    launches per variant on each rank, the prefill ms in turns with the
    one-rank run, the decode ms a step, each rank's idle share and peak
    memory.  Returns {arch: rank 0's readings} for the kernels line."""
    import pickle
    import tempfile

    import torch
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    backend = ("nccl" if DEV == "cuda" and torch.cuda.device_count()
               >= TP_RANKS else "gloo")
    where = ("one card a rank" if backend == "nccl" else
             f"all {TP_RANKS} ranks on {DEV}"
             + (" card 0" if DEV == "cuda" else ""))
    log(f"[tp] a {TP_RANKS}-rank {backend} world ({where}; "
        f"{torch.cuda.device_count() if DEV == 'cuda' else 0} cards), "
        f"mesh (1 data, {TP_RANKS} model)")
    with tempfile.TemporaryDirectory() as d:
        ctx = mp.start_processes(tp_rank, args=(backend, d, DEV, SMOKE,
                                                time.time()),
                                 nprocs=TP_RANKS, join=False,
                                 start_method="spawn")
        while not ctx.join():
            pass
        ranks = []
        for r in range(TP_RANKS):
            with open(os.path.join(d, f"tp{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    log(f"[tp] backend {ranks[0]['backend']} on {ranks[0]['device']} / "
        f"{ranks[1]['device']}; the ranks ran their first line "
        f"{max(r['spawn_s'] for r in ranks):.1f} s after the spawn, the "
        f"world started in {max(r['start_s'] for r in ranks):.1f} s; "
        f"host ms of one all_reduce a rank: "
        f"{[r['collective_ms'] for r in ranks]}"
        + ("" if CARD is None else f" [{CARD}]"))
    for arch_id in TP_MODELS:
        n_attn, n_mamba = ranks[0][arch_id]["blocks"]
        if not SMOKE and (n_attn, n_mamba) != TP_EXPECT[arch_id]:
            raise AssertionError(f"{arch_id}: {n_attn} attention and "
                                 f"{n_mamba} Mamba blocks")
        one = ranks[0][arch_id]["one"]
        for r in ranks:
            o = r[arch_id]
            line = (f"[tp] {arch_id} rank {r['rank']}: {o['weights']} "
                    f"weights, the rank's {o['weight_bytes']:,} B (one rank "
                    f"{one['weight_bytes']:,} B); prefill peak above what "
                    f"was there {o['peak']:,} B (one rank {one['peak']:,} "
                    f"B); K10 launches {o['k10']} at {o['k10_shapes']}")
            if "k11" in o:
                line += (f"; K11 launches {o['k11']} at {o['k11_shapes']}, "
                         f"{o['k11_held']} held: {o['k11_readings']}")
            line += (f"; collectives a prefill {o['collectives']}; greedy "
                     f"{o['decode_ms']:.3f} ms a step (one rank "
                     f"{one['decode_ms']:.3f}); {o['seconds']:.1f} s, host "
                     f"seconds at the end of each stage {o['marks']}")
            if "times" in o:
                line += (f"; prefill ms (CUDA events, turns one, tp, one) "
                         f"tp {o['times']['tp']}"
                         + (f", one rank {o['times']['one']}"
                            if o["times"]["one"] else "")
                         + f"; of the tp turn {o['held']:.3f} ms inside the "
                         f"collectives: idle share {o['idle']:.4f}")
            log(line + ("" if CARD is None else f" [{CARD}]"))
            if DEV == "cuda" and o["k10"] != {"": n_attn, "_tc": n_attn,
                                              "_cc": 0}:
                raise AssertionError(f"{arch_id} rank {r['rank']}: K10 "
                                     f"launches {o['k10']}, expected "
                                     f"{n_attn} tensor-core")
            if n_mamba and (o["k11_held"] != n_mamba or (
                    DEV == "cuda" and o["k11"] != {
                        "": n_mamba, "_tc": n_mamba, "_cc": 0})):
                raise AssertionError(f"{arch_id} rank {r['rank']}: K11 "
                                     f"{o['k11']}, {o['k11_held']} held, "
                                     f"expected {n_mamba} tensor-core")
            if not o["ranks_agree"] or o["tokens"] != one["tokens"]:
                raise AssertionError(f"{arch_id} rank {r['rank']}: greedy "
                                     f"tokens {o['tokens']} differ from the "
                                     f"one-rank run's {one['tokens']}")
        o = ranks[0][arch_id]
        lg = o["logits"]
        log(f"[tp] {arch_id}: gathered last logits vs the one-rank run's "
            f"max |d| {lg['max_abs']:.4e} at scale {lg['scale']:.4f} = "
            f"{lg['ulps']:.2f} bf16 ulps, argmax equal "
            f"{lg['argmax_equal']}; from the f32 prefill of the same "
            f"weights: tensor-parallel {lg['tp_f32']:.4e}, one rank "
            f"{lg['one_f32']:.4e} (limit {TP_DRIFT_FACTOR}x that + "
            f"{TP_F32_RTOL} of the scale); rows whose argmax differs "
            f"(row, f32 logit of the one-rank pick less the tensor-"
            f"parallel one's, f32 top-2 margin): {lg['flips']}; the "
            f"prefill in f32: tensor-parallel vs one rank {lg['f32']:.4e} "
            f"at scale {lg['scale32']:.4f} (limit {TP_F32_TOL} of it), "
            f"argmax equal {lg['argmax_equal_f32']}; "
            f"{o['k10_held']} K10 calls of rank 0 held: {o['k10_readings']}"
            f"; greedy tokens equal on both ranks and to the one-rank "
            f"run's: {o['tokens'][0]}")
        if o["k10_held"] != n_attn:
            raise AssertionError(f"{arch_id}: {o['k10_held']} K10 calls "
                                 f"held, expected {n_attn}")
        if lg["tp_f32"] > (TP_DRIFT_FACTOR * lg["one_f32"]
                           + TP_F32_RTOL * lg["scale"]):
            raise AssertionError(f"{arch_id}: the tensor-parallel logits "
                                 f"lie {lg['tp_f32']:.4e} from the f32 "
                                 f"prefill's, the one-rank run's "
                                 f"{lg['one_f32']:.4e}")
        if lg["f32"] > TP_F32_TOL * lg["scale32"]:
            raise AssertionError(f"{arch_id}: the tensor-parallel f32 "
                                 f"logits lie {lg['f32']:.4e} from the "
                                 f"one-rank f32 run's, over {TP_F32_TOL} "
                                 f"of {lg['scale32']:.4f}")
    tp_train_report(ranks)
    spent = time.perf_counter() - t0
    log(f"[tp] phase {spent:.1f} s (limit {TP_PHASE_S} s)")
    if spent > TP_PHASE_S:
        raise AssertionError(f"the tp phase took {spent:.1f} s, over its "
                             f"{TP_PHASE_S} s")
    return {**{arch_id: ranks[0][arch_id] for arch_id in TP_MODELS},
            "train": ranks[0]["train"]}


def tp_train_report(ranks):
    """Print the tensor-parallel training readings of both ranks and hold
    them: the losses and DDP's against the one-rank run's, the state's and
    the held Adam steps' gaps, the K4 shard-form launches (each held; one
    a pass and one all-reduce a message tree); print Adam's default-eps
    gaps."""
    one = ranks[0]["train"]["one"]

    def per_round(o):
        return {k: v / TP_TRAIN_ROUNDS for k, v in o["k4_shard"].items()}

    for r in ranks:
        o = r["train"]
        log(f"[tp] train rank {r['rank']}: {o['config']}, "
            f"{o['params']:,} parameters, {TP_TRAIN_AGENTS} agents on "
            f"complete, {TP_TRAIN_SPEC}; losses a round {o['losses']} "
            f"(one rank {one['losses']}); DDP losses by Adam eps "
            f"{o['ddp']} (one rank {one['ddp']}); K4 shard-form launches "
            f"{o['k4_shard']} ({per_round(o)} a round), leaves a launch "
            f"{sorted(set(o['tree_leaves']))}, {o['held']} calls held "
            f"against the plain versions; K4 all-reduces {o['k4_reduces']} "
            f"({o['k4_reduces'] / TP_TRAIN_ROUNDS:g} a round); K5 "
            f"{o['k5']}, whole-leaf K4 {o['k4_whole']}; the tree of "
            f"{o['leaves']} leaves in one call, {o['cut_leaves']} cut "
            f"leaves' qbit8/qbit4 payloads, gathered, bit-equal to K4 of "
            f"the whole leaf, the others' to K4; peak above what "
            f"was there {o['peak']:,} B (one rank {one['peak']:,} B); "
            f"{o['seconds']:.1f} s, host seconds at the end of each stage "
            f"{o['marks']}" + ("" if CARD is None else f" [{CARD}]"))
        pairs = [(o["losses"], one["losses"])] + [
            (o["ddp"][eps], one["ddp"][eps]) for eps in one["ddp"]]
        for a, b in pairs:
            if not all(math.isfinite(v) for v in a) or any(
                    abs(x - y) > TP_TRAIN_TOL * abs(y) for x, y in zip(a, b)):
                raise AssertionError(f"tp train rank {r['rank']}: losses "
                                     f"{a} against the one-rank {b}")
        # one message tree a compressor (x and z) a round: one launch a
        # pass and one all-reduce each, every leaf in the launch
        trees = TP_TREES_A_ROUND * TP_TRAIN_ROUNDS
        if DEV == "cuda" and o["k4_shard"] != {"quantize_tree": trees,
                                               "tree_absmax": trees}:
            raise AssertionError(f"tp train rank {r['rank']}: K4's shard "
                                 f"form launches {o['k4_shard']}, expected "
                                 f"{trees} a pass")
        if o["k4_reduces"] != trees or set(o["tree_leaves"]) != {
                o["leaves"]}:
            raise AssertionError(f"tp train rank {r['rank']}: "
                                 f"{o['k4_reduces']} K4 all-reduces, "
                                 f"leaves a call {o['tree_leaves']}")
        if o["held"] < 2 * trees:
            raise AssertionError(f"tp train rank {r['rank']}: {o['held']} "
                                 "K4 shard-form calls held")
    gaps = ranks[0]["train"]["gaps"]
    log(f"[tp] train: the tensor-parallel state after {TP_TRAIN_ROUNDS} "
        f"rounds and Adam's moments and parameters after each step (eps "
        f"{TP_TRAIN_EPS}) against the one-rank run's, field: (max |d| of "
        f"the leaf's scale, elements past {TP_TRAIN_TOL} of it, elements "
        f"past the flip bound, elements; summed over the ranks): "
        + ", ".join(f"{f} ({g['max_rel']:.3e}, {g['off']}, {g['beyond']}, "
                    f"{g['n']})" for f, g in gaps.items()
                    if not f.startswith("adam_eps")))
    small = sum(r["train"]["small"] for r in ranks)
    log(f"[tp] train: at Adam's default eps {TP_TRAIN_ADAM_EPS}: "
        + ", ".join(f"{f[9:]} {g['max_rel']:.3e} of scale, {g['off']} "
                    f"elements past {TP_TRAIN_TOL} of it, {g['off_small']} "
                    f"of them where the first step's |g| < 10 eps"
                    for f, g in gaps.items() if f.startswith("adam_eps"))
        + f"; {small} of the {gaps['ddp_m1']['n']} parameters' elements "
        "with |g| < 10 eps (summed over the ranks)")
    for f, g in gaps.items():
        if f.startswith("adam_eps"):
            continue
        limit = (2 * TP_TRAIN_TOL if f.startswith("ddp_v") else TP_TRAIN_TOL
                 if f == "x" or f.startswith("ddp_") else None)
        if limit is not None and g["max_rel"] > limit:
            raise AssertionError(f"tp train: {f} lies {g['max_rel']:.3e} "
                                 f"of its scale from the one-rank run's")
        if g["beyond"]:
            raise AssertionError(f"tp train: {g['beyond']} of {f}'s "
                                 f"elements past their flip bound")
        if g["off"] > TP_TRAIN_FLIP_SHARE * g["n"]:
            raise AssertionError(f"tp train: {g['off']} of {f}'s {g['n']} "
                                 "elements off the one-rank run's")


def time_tp_kernels(tp_counts):
    """K10 and K11 at the shapes a rank of the tp phase gives them
    (``time_k10``, ``time_k11``); the launches are rank 0's."""
    import torch

    rows = []
    for arch_id, (label, h, kh, dh) in (
            ("qwen3-0.6b", ("qwen3 tp2", 8, 4, 128)),
            ("zamba2-2.7b", ("zamba2 tp2", 16, 16, 80))):
        pb, pt = TP_MODELS[arch_id][:2]
        time_k10(rows, (label, pb, h, kh, pt, dh), torch.bfloat16,
                 tp_counts[arch_id]["k10"]["_tc"],
                 f"rank 0 of {arch_id}'s tp-2 prefill B={pb} T={pt}")
    b, t, nh, hd, ng, ds, chunk = K11_CASE
    k11 = tp_counts["zamba2-2.7b"]["k11"]
    rows += time_k11({"tc": k11["_tc"], "cc": k11["_cc"]},
                     (b, t, nh // TP_RANKS, hd, ng, ds, chunk), "zamba2 tp2",
                     "rank 0 of zamba2-2.7b's tp-2 unit, 6 Mamba blocks")
    time_k4_shard(rows, tp_counts["train"]["k4_shard"]["quantize_tree"])
    return rows


K4_SHARD_TIMED = (
    ("[2, 2^20] of [2, 2^21]", (1024, 2048), ((2048, True),), 1),
    ("qwen3 embed [2, 75,968 x 1,024] of [2, 151,936 x 1,024]",
     (151936, 1024), ((151936, True),), 0))
L2_BYTES = 50 * 2 ** 20  # the H100's L2


def time_k4_shard(rows, launches):
    """K4's shard form, grouped (``tree_absmax`` + ``quantize_tree``, b =
    8), on rank 0's shard of ``K4_SHARD_TIMED``'s leaves (2 messages,
    2 ranks): held bit for bit against its plain version and against the
    first design (PR 30's, ``tools/quantize_probe.py``), then timed in
    turns beside the first design, whole-leaf K4 on the same elements,
    each pass alone and ``torch.linalg.vector_norm(x, inf, -1)`` beside
    the max pass.  Bounds: K4's operations, and the bytes with x read
    once (the quantise pass finds x in L2) and twice (x past L2; the
    all-reduce between the passes forces the second read).  Then the
    host time of the wrappers for the tp phase's whole message tree
    (rank 0's 13 leaves of qwen3-0.6b cut to one layer) against PR 30's
    calls leaf by leaf."""
    import torch

    from repro_torch.core import jaxrand
    from repro_torch.kernels import _build
    from repro_torch.kernels.quantize import ops, ref
    from repro_torch.launch.sharding import LeafPlan, leaf_layout

    qprobe = load_tool("quantize_probe")
    call = QUANT_FIRST
    dev = torch.device("cuda")
    m = 2
    for label, shape, segments, dim in K4_SHARD_TIMED:
        lay = leaf_layout(LeafPlan(dim, segments), shape, 0, 2)
        lays = (lay,)
        x = torch.randn((m,) + lay.local_shape, device=dev).reshape(m, -1)
        n = x.shape[-1]
        keys = jaxrand.split(jaxrand.key(5), m)[:, None]

        def new():
            return ops.quantize_tree(keys, [x], ops.tree_absmax([x], lays),
                                     lays, bits=8)

        (q, sc), = new()
        (qw, scw), = ref.quantize_tree_ref(
            keys, [x], ref.tree_absmax_ref([x], lays), lays, bits=8,
            window=PLAIN_WINDOW)
        sync()
        note_err("K4-shard", q, qw)
        if not (torch.equal(q, qw) and same_scale(sc, scw)):
            raise AssertionError(f"K4 shard form at {label}: mismatch")
        # the bare launches on prepared inputs
        plan = ops.shard_plan(lays, m, x.device)
        plan.fill_x([x])
        ln, = plan.launches
        kd = ops._key_words(keys, (m, 1), dev)
        wd = torch.empty((plan.slots,), dtype=torch.int32, device=dev)
        scb = torch.empty((plan.slots,), dtype=torch.float32, device=dev)
        qb = torch.empty((plan.qbytes[8],), dtype=torch.int8, device=dev)
        base = plan.scratch.data_ptr()

        def absmax():
            _build.launch("shard_tree_absmax", ln.table.data_ptr(), 1,
                          ln.tiles, ln.xs, wd.data_ptr(), base,
                          base + 4 * (plan.slots + ln.tile0))

        def quant():
            _build.launch("shard_tree_quantize", ln.table.data_ptr(), 1,
                          ln.tiles, ln.xs, 8, kd.data_ptr(), 1, None, 0,
                          wd.data_ptr(), scb.data_ptr(), qb.data_ptr())

        def bare():
            absmax()
            quant()

        # PR 30's design, the same call
        desc = qprobe.shard_desc(lay)
        kd1 = kd.reshape(m, 2)
        wf = torch.empty((m,), dtype=torch.int32, device=dev)
        qf, scf = qprobe.first_shard(call, kd1, x, wf, desc, 8)
        sync()
        if not (torch.equal(qf, q) and same_scale(scf, sc)):
            raise AssertionError(f"K4 shard form's first design at {label}:"
                                 " differs from the grouped form")
        qfb, scfb = torch.empty_like(qf), torch.empty_like(scf)
        f_abs = call("leaf_absmax_first", x.data_ptr(), m, n, wf.data_ptr())
        f_q = call("quantize_leaf_shard_first", x.data_ptr(), m, n, 8,
                   kd1.data_ptr(), wf.data_ptr(), desc, scfb.data_ptr(),
                   qfb.data_ptr(), n)

        def first_bare():
            f_abs()
            f_q()

        # whole-leaf K4 on the same elements
        scr = ops.scratch(m, dev)
        qk = torch.empty((m, n), dtype=torch.int8, device=dev)
        sck = torch.empty((m,), dtype=torch.float32, device=dev)

        def k4_bare():
            _build.launch("quantize_leaf", x.data_ptr(), m, n, 8,
                          kd1.data_ptr(), sck.data_ptr(), qk.data_ptr(), n,
                          scr.data_ptr())

        def first():  # PR 30's wrappers: keys, words, description
            return qprobe.first_shard(
                call, ops._key_words(keys[:, 0], (m,), dev), x,
                torch.empty((m,), dtype=torch.int32, device=dev),
                qprobe.shard_desc(lay), 8)

        ms, f_ms, ms_t, f_ms_t = turns(new, first)
        ev_ms, f_ev_ms, ev_t, f_ev_t = turns(bare, first_bare)
        # the card's own time: the launches captured in a CUDA graph
        k_ms, fk_ms, k_t, fk_t = graph_turns(bare, first_bare)
        _, k4_ms, _, k4_t = graph_turns(bare, k4_bare)
        a_ms, norm_ms, a_t, norm_t = graph_turns(
            absmax, lambda: torch.linalg.vector_norm(x, float("inf"), -1))
        q_ms = graph_ms(quant)
        plain_ms = cuda_ms(lambda: ref.quantize_tree_ref(
            keys, [x], ref.tree_absmax_ref([x], lays), lays, bits=8,
            window=PLAIN_WINDOW), iters=3, warmup=1)
        once = m * n * 4 + m * n + 8 * m + 4 * m
        twice = once + m * n * 4
        ops_ = TF_LEAF_OPS * m * n
        b_once, b_twice = bound_ms(once, ops_)[0], bound_ms(twice, ops_)[0]
        x_reads = "once" if 4 * m * n <= L2_BYTES else "twice"
        add_row(
            rows, f"K4-shard tree_absmax + quantize_tree b=8 {label}",
            "src/repro_torch/csrc/quantize_leaf.cu",
            "src/repro/kernels/quantize/kernel.py:73", launches, ms, k_ms,
            plain_ms, once if x_reads == "once" else twice, ops_, 0, None,
            first_ms=f_ms, first_kernel_ms=fk_ms, ms_turns=ms_t,
            first_ms_turns=f_ms_t, kernel_ms_turns=k_t,
            first_kernel_ms_turns=fk_t, kernel_ms_by="cuda graph",
            events_kernel_ms=ev_ms, first_events_kernel_ms=f_ev_ms,
            whole_leaf_k4_ms=k4_ms,
            whole_leaf_k4_turns=k4_t, absmax_ms=a_ms, absmax_turns=a_t,
            vector_norm_ms=norm_ms, vector_norm_turns=norm_t,
            quantize_ms=q_ms, bound_x_once_ms=b_once,
            bound_x_twice_ms=b_twice, bound_x_reads=x_reads,
            absmax_bytes_ms=bound_ms(m * n * 4 + 4 * m)[0],
            launches_of="rank 0's quantize_tree calls in the tp phase's "
                        "tensor-parallel rounds (each with one "
                        "tree_absmax)")
        log(f"[time] K4-shard at {label}: x {4 * m * n:,} B, read "
            f"{x_reads} in the bound (L2 {L2_BYTES:,} B); device ms (CUDA "
            f"graph): both passes {k_ms:.4f} (turns {k_t}), PR 30's design "
            f"{fk_ms:.4f} (turns {fk_t}); whole-leaf K4 on the same "
            f"elements {k4_ms:.4f} (turns {k4_t}); the max pass {a_ms:.4f} "
            f"(turns {a_t}), vector_norm(x, inf, -1) {norm_ms:.4f} (turns "
            f"{norm_t}), its bytes' bound "
            f"{bound_ms(m * n * 4 + 4 * m)[0]:.4f}; the quantise pass "
            f"{q_ms:.4f}; launched back to back (CUDA events) both passes "
            f"{ev_ms:.4f} (turns {ev_t}), PR 30's {f_ev_ms:.4f} (turns "
            f"{f_ev_t}); bound x once {b_once:.4f}, twice {b_twice:.4f}"
            + ("" if CARD is None else f" [{CARD}]"))
        del x, qk, qb, q, qw, qf, qfb
        torch.cuda.empty_cache()
    time_k4_tree_host()


def time_k4_tree_host():
    """Host and device ms of one message tree's K4 calls: the grouped
    wrappers (``tree_absmax`` + ``quantize_tree``; no all-reduce) against
    PR 30's calls leaf by leaf (each cut leaf its keys, description,
    words and two launches of the first design; each leaf held whole a
    ``quantize_tensor``), on rank 0's shards of the tp phase's tree
    (qwen3-0.6b cut to one layer, 2 messages)."""
    import dataclasses

    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.core import jaxrand
    from repro_torch.kernels.quantize import ops
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps, train

    qprobe = load_tool("quantize_probe")
    call = QUANT_FIRST
    dev = torch.device("cuda")
    arch = ARCHS[TP_TRAIN_ARCH]
    cfg = dataclasses.replace(train.train_config(arch, smoke=False),
                              n_layers=TP_TRAIN_LAYERS)
    lays = tuple(shd.shard_layouts(_StandIn(2, 0), "admm",
                                   steps.model_specs(arch, cfg)))
    m = 2
    xs = [torch.randn((m, math.prod(lay.local_shape)), device=dev)
          for lay in lays]
    keys = jaxrand.split(jaxrand.split(jaxrand.key(5), m), len(lays))

    def grouped():
        w = ops.tree_absmax(xs, lays)
        return ops.quantize_tree(keys, xs, w, lays, bits=8)

    def per_leaf():
        out = []
        for i, (x, lay) in enumerate(zip(xs, lays)):
            if not lay.cut:
                out.append(ops.quantize_tensor(keys[:, i], x, bits=8))
                continue
            kd = ops._key_words(keys[:, i], (m,), dev)
            w = torch.empty((m,), dtype=torch.int32, device=dev)
            out.append(qprobe.first_shard(call, kd, x, w,
                                          qprobe.shard_desc(lay), 8))
        return out

    for (q, sc), (qf, scf) in zip(grouped(), per_leaf()):
        if not (torch.equal(q, qf) and same_scale(sc, scf)):
            raise AssertionError("K4 shard form: the grouped tree differs "
                                 "from PR 30's calls leaf by leaf")
    h, hf = idle_host_ms(grouped), idle_host_ms(per_leaf)
    hb, hfb = host_ms(grouped), host_ms(per_leaf)
    d, df, d_t, df_t = turns(grouped, per_leaf)
    n_cut = sum(lay.cut for lay in lays)
    log(f"[time] K4-shard, one message tree (rank 0's {len(lays)} leaves of "
        f"{cfg.name} cut to {cfg.n_layers} layer, {sum(l.cut for l in lays)}"
        f" cut, {sum(x.numel() for x in xs):,} elements): host ms a tree "
        f"from an idle card grouped {h:.4f} (2 launches), PR 30's leaf by "
        f"leaf {hf:.4f} "
        f"({2 * n_cut} shard-form launches + {len(lays) - n_cut} K4); "
        f"back to back behind a busy card {hb:.4f} against {hfb:.4f}; "
        f"CUDA-event ms {d:.4f} (turns "
        f"{d_t}) against {df:.4f} (turns {df_t})"
        + ("" if CARD is None else f" [{CARD}]"))


# ---------------------------------------------------------------------------
# The fsdp phase: FSDP over "data" in a 4-rank world
# ---------------------------------------------------------------------------

FSDP_RANKS = 4
FSDP_MESH = (2, 2)  # ("data", "model") for serving and DDP
# the multi-pod rounds' mesh ("pod", "data", "model"), a world of its own:
# every cut leaf of qwen3's tree but its norms is cut on both axes, so
# each K4 shard-form quantise launch runs index class 3
FSDP_ADMM_MESH = (2, 2, 2)
FSDP_ADMM_RANKS = math.prod(FSDP_ADMM_MESH)
# serving: qwen3-0.6b at full width and depth, bf16: prefill B x T, then
# greedy from a prompt of GP tokens for GG steps on GB rows
FSDP_SERVE = (4, 2048, 4, 1, 8)
FSDP_EXPECT_K10 = 28  # a rank's launches a prefill: one a layer
FSDP_PHASE_S = 120  # the phase's limit, host clock


def k4_two_axis_cases():
    """The two-axis check tree: ``(label, whole leaf shape, plan)`` a leaf,
    cut over a "data" axis of 2 (``data_dim``) and a "model" axis of 2:
    wq-like [1024, 2048] (data 0, model 1), an embedding [2048, 1000]
    (model 0, data 1), wo-like [16, 64, 1024] (model 0, data 2, a dim
    between), zamba2-2.7b's in_proj of one layer (data 0, four pieces on
    dim 1), a norm [2560] cut over "data" alone and one held whole; on
    the CPU the same cuts of small leaves."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.sharding import LeafPlan

    small = SMOKE or DEV != "cuda"
    ssm = (ARCHS["zamba2-2.7b"].make_smoke() if small
           else ARCHS["zamba2-2.7b"].make(None)).ssm
    di, gs, nh = ssm.d_inner, 2 * ssm.n_groups * ssm.d_state, ssm.n_heads
    cols = 2 * di + gs + nh
    wq, emb, wo = (((32, 64), (96, 40), (4, 6, 32)) if small else
                   ((1024, 2048), (2048, 1000), (16, 64, 1024)))
    return (
        (f"wq {list(wq)}: data 0, model 1", wq,
         LeafPlan(1, ((wq[1], True),), data_dim=0)),
        (f"embedding {list(emb)}: model 0, data 1", emb,
         LeafPlan(0, ((emb[0], True),), data_dim=1)),
        (f"wo {list(wo)}: model 0, data 2", wo,
         LeafPlan(0, ((wo[0], True),), data_dim=2)),
        (f"zamba2 in_proj [{ssm.d_model}, {cols}]: data 0, pieces on 1",
         (ssm.d_model, cols),
         LeafPlan(1, ((di, True), (di, True), (gs, False), (nh, True)),
                  data_dim=0)),
        (f"norm [{ssm.d_model}]: data only", (ssm.d_model,),
         LeafPlan(None, data_dim=0)),
        ("whole [4097]", (4097,), LeafPlan(None)))


def check_k4_shard2(dev):
    """K4's shard form's two-axis class (3) in one process: all four
    (data, model) shards of ``k4_two_axis_cases``' tree, b = 8 and 4, the
    quantiser's edge rows planted; each rank's ``tree_absmax`` and
    ``quantize_tree`` one launch, bit-equal to its plain version, and the
    four shards' levels, put back at their places, bit-equal to K4
    (``quantize_tensor``) of the whole leaf, scales too."""
    import torch

    from repro_torch.kernels.quantize import ops, ref

    g = torch.Generator(device=dev).manual_seed(6)
    cases = k4_two_axis_cases()
    plans = [c[2] for c in cases]
    m = 2
    for bits in (8, 4):
        xs = []
        for _, shape, _ in cases:
            x = torch.randn((m,) + shape, generator=g, device=dev)
            ref.edge_rows(x.reshape(m, -1)[:, :4096])
            xs.append(x)
        keys = torch.randint(0, 2 ** 32, (m, len(cases), 2), generator=g,
                             device=dev, dtype=torch.int64)
        quad = k4_shard_tree(xs, keys, plans, bits, data=2)
        classes = sorted({ops.shard_entry(lay)["cls"] for lays, _, _ in quad
                          for lay in lays if lay.cut})
        if 3 not in classes:
            raise AssertionError(f"K4 two-axis: classes {classes}")
        for i, (label, _, _) in enumerate(cases):
            flat = xs[i].reshape(m, -1)
            qw, scw = ops.quantize_tensor(keys[:, i], flat, bits=bits)
            sync()
            whole = (qw if bits == 8
                     else ref.unpack4(qw, flat.shape[-1]).to(torch.int8))
            got = torch.full_like(whole, -128 if bits == 8 else 99)
            for lays, shards, out in quad:
                q, sc = out[i]
                n = shards[i].shape[-1]
                lv = q if bits == 8 else ref.unpack4(q, n).to(torch.int8)
                got[:, lays[i].counters(dev) if lays[i].cut else
                    slice(None)] = lv
                if not same_scale(sc, scw):
                    raise AssertionError(f"K4 two-axis {label}: scale")
            if not torch.equal(got, whole):
                raise AssertionError(f"K4 two-axis {label} b={bits}: "
                                     f"{(got != whole).sum()} levels differ "
                                     "from K4 of the whole leaf")
        log(f"[kernels] K4 shard form b={bits}, two-axis class: one tree "
            f"of {[c[0] for c in cases]} on 4 (data, model) shards "
            f"{[tuple(s.shape) for s in quad[0][1]]} (rank (0, 0)), index "
            f"classes {classes}: each rank's tree_absmax and "
            "quantize_tree one launch, bit-equal to its plain version; the "
            "four ranks' levels at their places bit-equal to K4 of the "
            "whole leaf, scales too")


def time_k4_shard2(rows, launches):
    """The two-axis class (3) beside class 2 on the same elements: rank
    (0, 0)'s shard [2, 1024, 2048] of a [2, 2048, 4096] leaf cut over
    "data" on dim 0 and over "model" on dim 1 in two pieces, and the same
    elements as a [2, 1024, 4096] leaf's class-2 shard (the same two
    pieces, no data cut).  Both passes and the quantise pass alone,
    device time from CUDA graphs, in turns; each held against its plain
    version first."""
    import torch

    from repro_torch.core import jaxrand
    from repro_torch.kernels import _build
    from repro_torch.kernels.quantize import ops, ref
    from repro_torch.launch.sharding import LeafPlan, leaf_layout

    dev, m = torch.device("cuda"), 2
    segs = ((2048, True), (2048, True))
    lay3 = leaf_layout(LeafPlan(1, segs, data_dim=0), (2048, 4096), 0, 2,
                       0, 2)
    lay2 = leaf_layout(LeafPlan(1, segs), (1024, 4096), 0, 2)
    if (ops.shard_entry(lay3)["cls"], ops.shard_entry(lay2)["cls"]) != (3, 2):
        raise AssertionError("time_k4_shard2: the layouts' classes")
    x = torch.randn((m,) + lay3.local_shape, device=dev).reshape(m, -1)
    n = x.shape[-1]
    keys = jaxrand.split(jaxrand.key(5), m)[:, None]
    runs = {}
    for cls, lay in ((3, lay3), (2, lay2)):
        lays = (lay,)
        (q, sc), = ops.quantize_tree(keys, [x], ops.tree_absmax([x], lays),
                                     lays, bits=8)
        (qw, scw), = ref.quantize_tree_ref(
            keys, [x], ref.tree_absmax_ref([x], lays), lays, bits=8,
            window=PLAIN_WINDOW)
        sync()
        note_err("K4-shard", q, qw)
        if not (torch.equal(q, qw) and same_scale(sc, scw)):
            raise AssertionError(f"K4 shard form class {cls}: mismatch")
        plan = ops.shard_plan(lays, m, dev)
        plan.fill_x([x])
        ln, = plan.launches
        kd = ops._key_words(keys, (m, 1), dev)
        wd = torch.empty((plan.slots,), dtype=torch.int32, device=dev)
        scb = torch.empty((plan.slots,), dtype=torch.float32, device=dev)
        qb = torch.empty((plan.qbytes[8],), dtype=torch.int8, device=dev)
        base = plan.scratch.data_ptr()

        def absmax(ln=ln, wd=wd, base=base, plan=plan):
            _build.launch("shard_tree_absmax", ln.table.data_ptr(), 1,
                          ln.tiles, ln.xs, wd.data_ptr(), base,
                          base + 4 * (plan.slots + ln.tile0))

        def quant(ln=ln, kd=kd, wd=wd, scb=scb, qb=qb):
            _build.launch("shard_tree_quantize", ln.table.data_ptr(), 1,
                          ln.tiles, ln.xs, 8, kd.data_ptr(), 1, None, 0,
                          wd.data_ptr(), scb.data_ptr(), qb.data_ptr())

        def both(absmax=absmax, quant=quant):
            absmax()
            quant()

        absmax()
        runs[cls] = (both, quant, lays, plan)
    ms3, ms2, t3, t2 = graph_turns(runs[3][0], runs[2][0])
    q3, q2, qt3, qt2 = graph_turns(runs[3][1], runs[2][1])
    lays = runs[3][2]

    def wrapper():
        return ops.quantize_tree(keys, [x], ops.tree_absmax([x], lays),
                                 lays, bits=8)

    w_ms = cuda_ms(wrapper)
    plain_ms = cuda_ms(lambda: ref.quantize_tree_ref(
        keys, [x], ref.tree_absmax_ref([x], lays), lays, bits=8,
        window=PLAIN_WINDOW), iters=3, warmup=1)
    once = m * n * 4 + m * n + 8 * m + 4 * m
    ops_ = TF_LEAF_OPS * m * n
    add_row(
        rows, "K4-shard two-axis class 3 tree_absmax + quantize_tree b=8 "
        "[2, 1024 x 2048] of [2, 2048 x 4096]",
        "src/repro_torch/csrc/quantize_leaf.cu",
        "src/repro/kernels/quantize/kernel.py:73", launches, w_ms, ms3,
        plain_ms, once, ops_, 0, None, kernel_ms_by="cuda graph",
        kernel_ms_turns=t3, class2_kernel_ms=ms2, class2_kernel_ms_turns=t2,
        quantize_ms=q3, quantize_turns=qt3, class2_quantize_ms=q2,
        class2_quantize_turns=qt2,
        launches_of="rank 0's quantize_tree launches with class-3 leaves "
                    "in the fsdp phase's multi-pod rounds on (pod, data, "
                    f"model) = {FSDP_ADMM_MESH} (each with one "
                    "tree_absmax)")
    log(f"[time] K4-shard two-axis class 3 vs class 2 on the same "
        f"{m * n:,} elements, device ms (CUDA graph): both passes "
        f"{ms3:.4f} vs {ms2:.4f} (turns {t3} / {t2}), the quantise pass "
        f"{q3:.4f} vs {q2:.4f} (turns {qt3} / {qt2})"
        + ("" if CARD is None else f" [{CARD}]"))


def _gather_rows(t, mesh):
    """``t``'s rows (dim 0) gathered over ``mesh``'s "data" axis."""
    import torch
    import torch.distributed as dist

    parts = [torch.empty_like(t) for _ in range(mesh.size(0))]
    dist.all_gather(parts, t.contiguous(), group=mesh.get_group("data"))
    return torch.cat(parts, dim=0)


def fsdp_serve(mesh, rank, dev):
    """qwen3-0.6b served FSDP+TP over the (2, 2) mesh on this rank's batch
    rows, and on rank 0 also whole: the prefill under a ``MainPathTap``
    (counts zeroed just before, read just after; rank 0 holds every K10
    call), its last logits gathered over "data", the same in f32, and
    the greedy server.  Returns the rank's readings."""
    import dataclasses

    import torch

    from repro_torch.common.trees import tree_map
    from repro_torch.configs import ARCHS
    from repro_torch.core import jaxrand
    from repro_torch.launch import fsdp, serve, steps, tp
    from repro_torch.models import transformer as tr
    from repro_torch.models.common import init_params

    pb, pt, gb, gp, gg = (4, 64, 4, 1, 4) if SMOKE else FSDP_SERVE
    arch = ARCHS["qwen3-0.6b"]
    cfg = dataclasses.replace(arch.make_smoke() if SMOKE else arch.make(None),
                              use_flash=True)
    specs = steps.model_specs(arch, cfg)
    marks, t0 = {}, time.perf_counter()

    def mark(name):
        sync()
        marks[name] = round(time.perf_counter() - t0, 2)

    tree = init_params(jaxrand.key(0, dev), specs, dtype=cfg.dtype)
    batch = {"tokens": jaxrand.randint(jaxrand.key(1, dev), (pb, pt), 0,
                                       cfg.vocab)}
    prompt = jaxrand.randint(jaxrand.key(0, dev), (gb, gp), 0, cfg.vocab)
    lo, hi = steps.batch_rows(arch, cfg, mesh, pb)
    glo, ghi = steps.batch_rows(arch, cfg, mesh, gb)
    rows = {"tokens": batch["tokens"][lo:hi]}
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    tree32 = tree_map(lambda t: t.float(), tree)
    out = {"rows": (lo, hi), "layers": cfg.n_layers}
    if rank == 0:
        whole = tr.model_params(cfg, tree)
        with torch.no_grad():
            last1, peak1 = memory_peak(
                lambda: steps.build_prefill(arch, cfg)(whole, batch))
            tok1, _ = serve.generate(arch, cfg, whole, prompt, gg)
            last32 = steps.build_prefill(arch, cfg32)(
                tr.model_params(cfg32, tree32), batch).float()
        out["one"] = {"peak": peak1, "tokens": tok1.tolist(),
                      "weight_bytes": sum(p.numel() * p.element_size()
                                          for p in whole.parameters())}
        del whole
    mark("one rank")
    shard = tr.model_params(cfg, steps.serve_shard(arch, cfg, tree, mesh))
    del tree
    out["weight_bytes"] = sum(p.numel() * p.element_size()
                              for p in shard.parameters())
    prefill = steps.build_prefill(arch, cfg, mesh)
    tap = MainPathTap(SERVE_WRAPPERS)
    tap.checking = rank == 0
    fsdp.reset_stats()
    tp.reset_stats()
    try:
        reset_counts()  # the FSDP+TP prefill starts here
        with torch.no_grad():
            last, peak = memory_peak(lambda: prefill(shard, rows))
        sync()
        after = read_counts()  # ... and ends here
    finally:
        tap.close()
    out.update(peak=peak, gathers=dict(fsdp.stats),
               collectives=dict(tp.stats),
               k10={k: after[f"flash_attention{k}"]
                    for k in ("", "_tc", "_cc")},
               k10_shapes={_show(k[1]): c for k, c in tap.by_shape.items()},
               k10_held=len(tap.readings.get("flash_attention", [])),
               k10_readings=sorted(set(tap.readings.get("flash_attention",
                                                        [])))[:3])
    mark("main path")
    last = _gather_rows(last, mesh)
    shard32 = tr.model_params(cfg32, steps.serve_shard(arch, cfg32, tree32,
                                                       mesh))
    del tree32
    with torch.no_grad():
        f32 = _gather_rows(steps.build_prefill(arch, cfg32, mesh)(
            shard32, rows).float(), mesh)
    del shard32
    for t in (last, f32):
        if tuple(t.shape) != (pb, 1, cfg.vocab) or not bool(
                torch.isfinite(t.float()).all()):
            raise AssertionError("fsdp serve: the gathered logits are bad")
    if rank == 0:
        lf, wf = last.float(), last1.float()
        scale = float(wf.abs().max())
        out["logits"] = {
            "max_abs": float((lf - wf).abs().max()), "scale": scale,
            "fsdp_f32": float((lf - last32).abs().max()),
            "one_f32": float((wf - last32).abs().max()),
            "f32": float((f32 - last32).abs().max()),
            "scale32": float(last32.abs().max()),
            "argmax_equal": bool(torch.equal(lf.argmax(-1), wf.argmax(-1))),
            "flips": argmax_flips(lf, wf, last32)}
        del last1, last32
    del last, f32
    mark("f32")
    with torch.no_grad():
        tokens, secs = serve.generate(arch, cfg, shard, prompt[glo:ghi], gg,
                                      mesh=mesh)
    out["tokens"] = _gather_rows(tokens, mesh).tolist()
    out["decode_ms"] = secs * 1e3 / gg
    mark("greedy")
    out["marks"] = marks
    del shard
    if DEV == "cuda":
        torch.cuda.empty_cache()
    return out


def fsdp_ddp(mesh, rank, dev):
    """``build_ddp_train`` on the (2, 2) mesh's FSDP+TP shards (mode
    "serve"), each "data" rank its share of the batch, against one
    process's steps on the whole weights and batch (run on every rank):
    qwen3-0.6b at full width cut to one layer, f32, TP_TRAIN_DDP Adam
    steps at eps TP_TRAIN_EPS.  Returns the losses and, by step, the gaps
    of m, v and the parameters (each leaf's scale its whole leaf's)."""
    import dataclasses

    import torch

    from repro_torch.common.trees import tree_flatten, tree_map
    from repro_torch.configs import ARCHS
    from repro_torch.core import jaxrand
    from repro_torch.launch import steps, train
    from repro_torch.models.common import init_params

    arch = ARCHS[TP_TRAIN_ARCH]
    cfg = (arch.make_smoke() if SMOKE else dataclasses.replace(
        train.train_config(arch, smoke=False), n_layers=TP_TRAIN_LAYERS))
    specs = steps.model_specs(arch, cfg)
    whole = init_params(jaxrand.key(1, dev), specs)
    tokens = jaxrand.randint(jaxrand.key(2, dev), (2, TP_TRAIN_SEQ + 1), 0,
                             cfg.vocab)
    lo, hi = steps.batch_rows(arch, cfg, mesh, 2)

    def shard(tree):
        return tree_flatten(steps.serve_shard(arch, cfg, tree_map(
            torch.clone, tree), mesh))[0]

    def runs(params, batch, mesh_, keep):
        built = steps.build_ddp_train(arch, cfg, lr=1e-3, mesh=mesh_,
                                      eps=TP_TRAIN_EPS)
        stepd, opt = built[0], built[-1]
        p = tree_map(torch.clone, params)
        o, ls, kept = opt.init(p), [], []
        for i in range(TP_TRAIN_DDP):
            p, o, lv = stepd(p, o, batch, i)
            ls.append(float(lv))
            kept.append({"m": keep(o["m"]), "v": keep(o["v"]),
                         "params": keep(p)})
        return ls, kept

    def scaled(tree):
        return shard(tree), [float(t.abs().max())
                             for t in tree_flatten(tree)[0]]

    one_losses, one = runs(whole, {"tokens": tokens}, None, scaled)
    mine = steps.serve_shard(arch, cfg, tree_map(torch.clone, whole), mesh)
    losses, got = runs(mine, {"tokens": tokens[lo:hi]}, mesh,
                       lambda t: tree_flatten(t)[0])
    del mine
    gaps = {}
    for i in range(TP_TRAIN_DDP):
        for k in ("m", "v", "params"):
            want, scales = one[i][k]
            gaps[f"ddp_{k}{i + 1}"] = _shard_gaps(got[i][k], want,
                                                  scales=scales)
    del whole, one, got
    return {"losses": losses, "one_losses": one_losses, "gaps": gaps,
            "rows": (lo, hi)}


def _fsdp_admm_case(dev):
    """``fsdp_admm``'s run: ``(arch, cfg, specs, solver spec, recipe,
    whole weights, tokens [A, m, T + 1])``, the weights and tokens from
    fixed keys on ``dev``."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.core import jaxrand
    from repro_torch.launch import steps, train
    from repro_torch.models.common import init_params

    arch = ARCHS[TP_TRAIN_ARCH]
    cfg = (arch.make_smoke() if SMOKE else dataclasses.replace(
        train.train_config(arch, smoke=False), n_layers=TP_TRAIN_LAYERS))
    specs = steps.model_specs(arch, cfg)
    spec = TP_TRAIN_SPEC + (",impl=kernel" if DEV == "cpu" else "")
    recipe = steps.TrainRecipe(topology="complete")
    whole = init_params(jaxrand.key(1, dev), specs)
    tokens = jaxrand.randint(jaxrand.key(2, dev),
                             (TP_TRAIN_AGENTS, TP_TRAIN_M, TP_TRAIN_SEQ + 1),
                             0, cfg.vocab)
    return arch, cfg, specs, spec, recipe, whole, tokens


def fsdp_admm_one(dev):
    """One process's run of ``fsdp_admm``'s rounds on both agents' whole
    weights and rows, the reference the ranks hold theirs against:
    ``{"state": the final state's tree fields, "bounds": each field's
    flip bounds by leaf (``_tp_state_bounds``, numpy), "losses": the mean
    loss after each round}``."""
    from repro_torch.common.trees import tree_map
    from repro_torch.launch import steps, train

    arch, cfg, _, spec, recipe, whole, tokens = _fsdp_admm_case(dev)
    a_n = TP_TRAIN_AGENTS
    loss = steps.model_loss(arch, cfg)
    step, init, solver = steps.build_train(arch, cfg, a_n, spec, recipe,
                                           device=dev)
    st = init(tree_map(lambda t: t[None].expand((a_n,) + t.shape).clone(),
                       whole))
    del whole
    losses, levels = [], []
    for i in range(TP_TRAIN_ROUNDS):
        before, st = st, step(st, {"tokens": tokens}, 100 + i)
        levels.append(_round_levels(before, st))
        del before
        losses.append(train.mean_loss(solver, loss, st, tokens))
    bounds = _tp_state_bounds(levels, solver.cfg.r * solver.cfg.rho)
    return {"state": _tp_state_fields(st), "losses": losses,
            "bounds": {f: [b.numpy() for b in bs]
                       for f, bs in bounds.items()}}


def fsdp_admm(mesh, rank, dev, reference):
    """Per-leaf LT-ADMM-CC on the multi-pod (2, 2, 2) mesh: one agent a
    pod, FSDP+TP over its 2 x 2 ("data", "model") ranks (parameters and
    state on both axes, its m rows over "data"), qwen3-0.6b at full
    width cut to one layer, f32, TP_TRAIN_ROUNDS rounds of TP_TRAIN_SPEC
    on complete(2), against the one-rank run of both agents that
    ``reference()`` returns after the rounds (``fsdp_admm_one``, run once
    by the parent process; its state reaches the ranks through the
    card's memory, each rank keeping its shard).  The counts zeroed just before the rounds and
    read just after, every K4 shard-form call held against its plain
    version, the K4 all-reduces counted.  Returns the rank's readings."""
    import functools

    import torch

    from repro_torch.common.trees import tree_flatten, tree_map
    from repro_torch.core import admm, compression
    from repro_torch.core.admm import STATE_LEAD
    from repro_torch.kernels.quantize import ref as qref
    from repro_torch.launch import steps, tp
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import group_of, use_mesh

    arch, cfg, specs, spec, recipe, whole, tokens = _fsdp_admm_case(dev)
    a_n, rounds = TP_TRAIN_AGENTS, TP_TRAIN_ROUNDS
    marks, t0 = {}, time.perf_counter()

    def mark(name):
        sync()
        marks[name] = round(time.perf_counter() - t0, 2)

    loss = steps.model_loss(arch, cfg)
    pod = mesh.get_local_rank("pod")
    d, nd = mesh.get_local_rank("data"), mesh.size(1)
    k = TP_TRAIN_M // nd
    agent = slice(pod, pod + 1)
    scale_group = group_of(mesh, ("data", "model"))

    # ---- the FSDP run: the agent's row of the stacked weights, cut
    x0 = shd.shard_params(tree_map(lambda t: t[None].clone(), whole), mesh,
                          "admm", specs, lead=1)
    del whole
    step, _, init, solver = steps.build_train(arch, cfg, None, spec, recipe,
                                              device=dev, mesh=mesh)
    if (solver.exchange.rows.start, solver.exchange.rows.stop) != (
            pod, pod + 1):
        raise AssertionError(f"fsdp admm: rows {solver.exchange.rows}")
    data = {"tokens": tokens[agent, d * k:(d + 1) * k].contiguous()}
    tap = MainPathTap({
        "quantize_tree": ("K4", "quantize", functools.partial(
            qref.quantize_tree_ref, window=PLAIN_WINDOW), hold_tree),
        "tree_absmax": ("K4", "quantize", "tree_absmax_ref")})
    tap.checking = True
    losses, k4_reduces = [], [0]
    all_reduce_max = tp.all_reduce_max

    def counted(t, group=None):
        k4_reduces[0] += t.dtype == torch.int32
        return all_reduce_max(t, group)

    def mean_loss(st):
        """``train.mean_loss`` over the mesh: each agent's loss at the
        agents' mean x̄ (``consensus_mean`` sums over "pod")."""
        pbar = admm.consensus_mean(st, solver.exchange)
        with torch.no_grad(), use_mesh(mesh):
            return float(torch.stack([loss(pbar, {"tokens": tokens[a]})
                                      for a in range(a_n)]).mean())

    def fsdp_rounds():
        st = init(x0)
        for i in range(rounds):
            st = step(st, data, 100 + i)
            losses.append(mean_loss(st))
            mark(f"fsdp round {i}")
        return st

    try:
        tp.all_reduce_max = counted
        reset_counts()  # the FSDP rounds start here
        st, peak = memory_peak(fsdp_rounds)
        counts = read_counts()  # ... and end here
    finally:
        tp.all_reduce_max = all_reduce_max
        tap.close()
    held = sum(tap.checked.values())
    mark("fsdp rounds")
    # ---- the one-rank run's state, this rank's shard of its agent's
    one = reference()
    losses1 = one["losses"]
    bounds = {f: [torch.from_numpy(b) for b in bs]
              for f, bs in one["bounds"].items()}
    one = {f: tree_flatten(shd.shard_params(
        tree_map(lambda t: t[agent].clone(), tree), mesh, "admm", specs,
        lead=STATE_LEAD[f]))[0] for f, tree in one["state"].items()}
    mark("one-rank shards")
    gaps = {}
    for f, tree in _tp_state_fields(st).items():
        scales = [float(tp.all_reduce_max(w.abs().max()[None],
                                          scale_group)) for w in one[f]]
        gaps[f] = _shard_gaps(
            tree_flatten(tree)[0], one[f],
            [b[agent] for b in bounds[f]] if f in bounds else None,
            scales=scales)
    del st, one
    return {"losses": losses, "one_losses": losses1, "peak": peak,
            "gaps": gaps, "held": held, "k4_reduces": k4_reduces[0],
            "k4_shard": {c: counts[c] for c in (
                "quantize_tree", "quantize_tree_two_axis", "tree_absmax")},
            "k5": counts["dequantize_tensor"], "marks": marks,
            "axes": compression.cut_axes(solver.tp_layouts, mesh),
            "row_shards": solver.grad_est.row_shards}


def fsdp_rank(rank, backend, store_dir, dev_type, smoke, started, part,
              queue):
    """One rank of a world of the fsdp phase (a spawned process): the
    world from a ``FileStore``; ``part`` "serve": ``fsdp_serve`` and
    ``fsdp_ddp`` on a (2, 2) ("data", "model") mesh of FSDP_RANKS;
    "admm": ``fsdp_admm`` on the FSDP_ADMM_MESH ("pod", "data", "model")
    of FSDP_ADMM_RANKS, against the one-rank run that ``queue`` brings.
    The readings go to ``store_dir/fsdp_<part><rank>.pkl``."""
    import functools
    import pickle

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh, world

    global DEV, SMOKE
    DEV, SMOKE = dev_type, smoke
    spawned = time.time() - started
    n = FSDP_RANKS if part == "serve" else FSDP_ADMM_RANKS
    dev = torch.device("cpu")
    if dev_type == "cuda":
        dev = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    t0 = time.perf_counter()
    with world(backend, os.path.join(store_dir, f"store_{part}"), rank, n,
               dev if backend == "nccl" else None):
        if part == "serve":
            mesh = make_host_mesh(n, model=FSDP_MESH[1])
            runs = (("serve", fsdp_serve), ("ddp", fsdp_ddp))
        else:
            mesh = make_host_mesh(n, model=FSDP_ADMM_MESH[2],
                                  pods=FSDP_ADMM_MESH[0])
            runs = (("admm", functools.partial(fsdp_admm,
                                               reference=queue.get)),)
        out = {"rank": rank, "backend": dist.get_backend(),
               "device": str(dev), "spawn_s": spawned,
               "start_s": time.perf_counter() - t0,
               "coords": tuple(mesh.get_coordinate())}
        for name, fn in runs:
            t1 = time.perf_counter()
            out[name] = fn(mesh, rank, dev)
            out[name]["seconds"] = time.perf_counter() - t1
        dist.barrier()
    with open(os.path.join(store_dir, f"fsdp_{part}{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def fsdp_spawn(part, store_dir, queue=None):
    """Starts ``fsdp_rank``'s world for ``part`` (not joined): with a card
    a rank an NCCL world, else all ranks on one card (or the CPU) in a
    gloo world (NCCL refuses two ranks on one device).  Returns the
    processes' context."""
    import torch
    import torch.multiprocessing as mp

    n = FSDP_RANKS if part == "serve" else FSDP_ADMM_RANKS
    backend = ("nccl" if DEV == "cuda" and torch.cuda.device_count() >= n
               else "gloo")
    where = ("one card a rank" if backend == "nccl" else
             f"all {n} ranks on {DEV}" + (" card 0" if DEV == "cuda"
                                          else ""))
    mesh = (f"(data, model) = {FSDP_MESH}" if part == "serve" else
            f"(pod, data, model) = {FSDP_ADMM_MESH}")
    log(f"[fsdp] {part}: a {n}-rank {backend} world ({where}), {mesh}")
    return mp.start_processes(fsdp_rank, args=(backend, store_dir, DEV,
                                               SMOKE, time.time(), part,
                                               queue),
                              nprocs=n, join=False, start_method="spawn")


def fsdp_readings(store_dir, part):
    """The readings of ``part``'s ranks, in rank order."""
    import pickle

    ranks = []
    for r in range(FSDP_RANKS if part == "serve" else FSDP_ADMM_RANKS):
        with open(os.path.join(store_dir, f"fsdp_{part}{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    log(f"[fsdp] {part}: the ranks ran their first line "
        f"{max(r['spawn_s'] for r in ranks):.1f} s after the spawn, the "
        f"world started in {max(r['start_s'] for r in ranks):.1f} s")
    return ranks


def phase_fsdp():
    """FSDP over "data": K4's two-axis class first (``check_k4_shard2``,
    in this process), then a world of FSDP_RANKS for serving (qwen3-0.6b
    at full width, bf16, (2, 2) mesh: the prefill's K10 launches on every
    rank, rank 0's calls held, the gathered logits against the one-rank
    run's, the greedy tokens equal) and DDP on FSDP+TP shards, and a
    world of FSDP_ADMM_RANKS for the multi-pod per-leaf LT-ADMM-CC
    rounds, each against one process's run of the same.  The worlds run
    side by side; once the first has ended, this process runs
    ``fsdp_admm_one`` and hands its result to each rank of the second
    through a queue (the state's tensors shared, not copied; they live
    here until the ranks have ended), which they read after their
    rounds.  Returns rank 0's readings of both worlds for the kernels
    line."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    check_k4_shard2(torch.device(DEV))
    if DEV == "cuda":
        torch.cuda.empty_cache()  # the earlier phases' cached blocks
    queue = mp.get_context("spawn").Queue()
    worlds, one = [], None
    with tempfile.TemporaryDirectory() as d:
        try:
            worlds.append(fsdp_spawn("serve", d))
            worlds.append(fsdp_spawn("admm", d, queue))
            while not worlds[0].join():
                pass
            t1 = time.perf_counter()
            one = fsdp_admm_one(torch.device(DEV))
            sync()
            if DEV == "cuda":
                torch.cuda.empty_cache()  # the ranks still run beside it
            log(f"[fsdp] admm: the one-rank run took "
                f"{time.perf_counter() - t1:.1f} s in this process, after "
                f"the serving world, {t1 - t0:.1f} s into the phase")
            for _ in range(FSDP_ADMM_RANKS):
                queue.put(one)
            while not worlds[1].join():
                pass
        except BaseException:
            for ctx in worlds:
                for p in ctx.processes:
                    p.terminate()
            queue.cancel_join_thread()
            raise
        del one
        ranks = fsdp_readings(d, "serve")
        admm_ranks = fsdp_readings(d, "admm")
    card = "" if CARD is None else f" [{CARD}]"
    one = ranks[0]["serve"]["one"]
    for r in ranks:
        o = r["serve"]
        log(f"[fsdp] serve rank {r['rank']} {r['coords']}: rows {o['rows']},"
            f" the rank's weights {o['weight_bytes']:,} B (one rank "
            f"{one['weight_bytes']:,} B); prefill peak above what was there "
            f"{o['peak']:,} B (one rank {one['peak']:,} B); FSDP a prefill "
            f"{o['gathers']}; tp {o['collectives']}; K10 {o['k10']} at "
            f"{o['k10_shapes']}; greedy {o['decode_ms']:.3f} ms a step; "
            f"{o['seconds']:.1f} s, marks {o['marks']}" + card)
        n_attn = FSDP_EXPECT_K10 if not SMOKE else o["layers"]
        if DEV == "cuda" and o["k10"] != {"": n_attn, "_tc": n_attn,
                                          "_cc": 0}:
            raise AssertionError(f"fsdp serve rank {r['rank']}: K10 "
                                 f"{o['k10']}, expected {n_attn} "
                                 "tensor-core")
        if o["tokens"] != one["tokens"]:
            raise AssertionError(f"fsdp serve rank {r['rank']}: tokens "
                                 f"{o['tokens']} vs one rank's "
                                 f"{one['tokens']}")
    o = ranks[0]["serve"]
    lg = o["logits"]
    log(f"[fsdp] serve: gathered last logits vs the one-rank run's max |d| "
        f"{lg['max_abs']:.4e} at scale {lg['scale']:.4f}, argmax equal "
        f"{lg['argmax_equal']}; from the f32 prefill: FSDP+TP "
        f"{lg['fsdp_f32']:.4e}, one rank {lg['one_f32']:.4e} (limit "
        f"{TP_DRIFT_FACTOR}x + {TP_F32_RTOL} of scale); flips "
        f"{lg['flips']}; FSDP+TP f32 vs one-rank f32 {lg['f32']:.4e} at "
        f"scale {lg['scale32']:.4f} (limit {TP_F32_TOL} of it); "
        f"{o['k10_held']} K10 calls of rank 0 held: {o['k10_readings']}; "
        f"greedy tokens equal: {o['tokens'][0]}")
    if o["k10_held"] != (o["layers"] if SMOKE else FSDP_EXPECT_K10):
        raise AssertionError(f"fsdp serve: {o['k10_held']} K10 calls held")
    if lg["fsdp_f32"] > TP_DRIFT_FACTOR * lg["one_f32"] + \
            TP_F32_RTOL * lg["scale"]:
        raise AssertionError(f"fsdp serve: logits drift {lg['fsdp_f32']}")
    if lg["f32"] > TP_F32_TOL * lg["scale32"]:
        raise AssertionError(f"fsdp serve: f32 logits {lg['f32']}")
    for r in ranks:
        o = r["ddp"]
        log(f"[fsdp] ddp rank {r['rank']}: rows {o['rows']}, losses "
            f"{o['losses']} (one rank {o['one_losses']}); {o['seconds']:.1f}"
            " s" + card)
        if any(abs(a - b) > TP_TRAIN_TOL * abs(b) for a, b in zip(
                o["losses"], o["one_losses"])):
            raise AssertionError(f"fsdp ddp rank {r['rank']}: losses")
        for f, g in o["gaps"].items():
            limit = 2 * TP_TRAIN_TOL if f.startswith("ddp_v") else \
                TP_TRAIN_TOL
            if g[0] > limit:
                raise AssertionError(f"fsdp ddp rank {r['rank']}: {f} lies "
                                     f"{g[0]:.3e} of its scale off")
    log("[fsdp] ddp gaps (max |d| of scale) by rank: "
        + "; ".join(f"{r['rank']}: " + ", ".join(
            f"{f} {g[0]:.3e}" for f, g in r["ddp"]["gaps"].items())
            for r in ranks))
    trees = TP_TREES_A_ROUND * TP_TRAIN_ROUNDS
    for r in admm_ranks:
        o = r["admm"]
        log(f"[fsdp] admm rank {r['rank']}: losses {o['losses']} (one rank "
            f"{o['one_losses']}) at {r['coords']}; K4 shard-form launches "
            f"{o['k4_shard']} "
            f"({ {c: v / TP_TRAIN_ROUNDS for c, v in o['k4_shard'].items()} }"
            f" a round), {o['held']} calls held; K4 all-reduces "
            f"{o['k4_reduces']} ({o['k4_reduces'] / TP_TRAIN_ROUNDS:g} a "
            f"round) over {o['axes']}; K5 {o['k5']}; rows cut in "
            f"{o['row_shards']}; peak {o['peak']:,} B; gaps (max |d| of "
            f"scale, off, n, past the flip bound) "
            + ", ".join(f"{f} {g[0]:.3e}/{g[1]}/{g[2]}/{g[3]}"
                        for f, g in o["gaps"].items())
            + f"; {o['seconds']:.1f} s, marks {o['marks']}" + card)
        if any(abs(a - b) > TP_TRAIN_TOL * abs(b) for a, b in zip(
                o["losses"], o["one_losses"])):
            raise AssertionError(f"fsdp admm rank {r['rank']}: losses")
        # every quantise launch holds class-3 leaves (the two-axis form)
        if DEV == "cuda" and o["k4_shard"] != {
                "quantize_tree": trees, "quantize_tree_two_axis": trees,
                "tree_absmax": trees}:
            raise AssertionError(f"fsdp admm rank {r['rank']}: K4 shard "
                                 f"launches {o['k4_shard']}")
        if o["axes"] != ("data", "model"):
            raise AssertionError(f"fsdp admm rank {r['rank']}: K4's scales "
                                 f"all-reduced over {o['axes']}")
        if o["k4_reduces"] != trees or o["held"] < 2 * trees:
            raise AssertionError(f"fsdp admm rank {r['rank']}: "
                                 f"{o['k4_reduces']} K4 all-reduces, "
                                 f"{o['held']} held")
        for f, g in o["gaps"].items():
            if f == "x" and g[0] > TP_TRAIN_TOL:
                raise AssertionError(f"fsdp admm: x lies {g[0]:.3e} off")
            if g[3]:
                raise AssertionError(f"fsdp admm: {g[3]} of {f}'s elements "
                                     "past their flip bound")
            if g[1] > TP_TRAIN_FLIP_SHARE * g[2]:
                raise AssertionError(f"fsdp admm: {g[1]} of {f}'s {g[2]} "
                                     "elements off the one-rank run's")
    spent = time.perf_counter() - t0
    log(f"[fsdp] phase {spent:.1f} s (limit {FSDP_PHASE_S} s)")
    if spent > FSDP_PHASE_S:
        raise AssertionError(f"the fsdp phase took {spent:.1f} s, over its "
                             f"{FSDP_PHASE_S} s")
    return {**ranks[0], "admm": admm_ranks[0]["admm"]}


def time_fsdp_kernels(r0):
    """K10 at the FSDP+TP rank's prefill shape, and the two-axis class of
    K4's shard form beside class 2; the launches are rank 0's (K4's: its
    quantise launches with class-3 leaves in the multi-pod rounds)."""
    import torch

    rows = []
    pb, pt = FSDP_SERVE[:2]
    b = pb // FSDP_MESH[0]
    time_k10(rows, ("qwen3 fsdp2 tp2", b, 16 // FSDP_MESH[1],
                    8 // FSDP_MESH[1], pt, 128), torch.bfloat16,
             r0["serve"]["k10"]["_tc"],
             f"rank 0 of qwen3-0.6b's FSDP+TP prefill B={pb} T={pt} on "
             f"(data, model) = {FSDP_MESH}")
    time_k4_shard2(rows, r0["admm"]["k4_shard"]["quantize_tree_two_axis"])
    return rows


@contextlib.contextmanager
def phase_clock(name, spent):
    """Adds the host-clock seconds of the block to ``spent[name]``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="device,build,kernels,paper,mesh,fig2,obs,"
                    "dada,harness,wide,profile,serve,train,zoo,dryrun,tp,"
                    "fsdp",
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
    t_main, spent = time.perf_counter(), {}
    name, _ = phase_device()
    if "build" in phases:
        with phase_clock("build", spent):
            phase_build()
            phase_sass()
    seed = jaxrand.key_seed(jaxrand.fold_in(jaxrand.key(7), 13))
    k0 = None
    if "kernels" in phases:
        with phase_clock("kernels", spent):
            k0 = check_k0(seed, torch.device("cuda"))
            check_k1(seed, torch.device("cuda"))
            check_k23(seed, torch.device("cuda"))
            check_k45(torch.device("cuda"))
            check_k67(torch.device("cuda"))
            check_k89(torch.device("cuda"))
            check_k10(torch.device("cuda"))
            check_k11(torch.device("cuda"))
    if "paper" in phases:
        with phase_clock("paper", spent):
            phase_paper(PAPER_ROUNDS)
            phase_paper_schedules(PAPER_ROUNDS)
            phase_paper_faults(PAPER_ROUNDS, PAPER_ROUNDS)
    if "mesh" in phases:
        with phase_clock("mesh", spent):
            phase_mesh()
    if "fig2" in phases:
        with phase_clock("fig2", spent):
            phase_fig2(FIG2_ADMM_ROUNDS, FIG2_BASELINE_ITERS)
    if "obs" in phases:
        with phase_clock("obs", spent):
            phase_obs()
    if "dada" in phases:
        with phase_clock("dada", spent):
            phase_dada()
    if "harness" in phases:
        with phase_clock("harness", spent):
            phase_harness()
    rows = None
    if "wide" in phases:
        with phase_clock("wide", spent):
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
            with phase_clock("timing", spent):
                rows = time_kernels(seed, k0, counts, shapes)
    if "profile" in phases:
        with phase_clock("profile", spent):
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
        with phase_clock("serve", spent):
            serve_counts = phase_serve()
            rows = (rows or []) + time_serve_kernels(serve_counts)
    if "train" in phases:
        with phase_clock("train", spent):
            torch.cuda.empty_cache()
            phase_train()
    if "zoo" in phases:
        with phase_clock("zoo", spent):
            torch.cuda.empty_cache()
            rows = (rows or []) + phase_zoo()
    if "dryrun" in phases:
        with phase_clock("dryrun", spent):
            torch.cuda.empty_cache()
            phase_dryrun()
    if "tp" in phases:
        with phase_clock("tp", spent):
            torch.cuda.empty_cache()
            tp_counts = phase_tp()
        with phase_clock("tp timing", spent):
            rows = (rows or []) + time_tp_kernels(tp_counts)
    if "fsdp" in phases:
        with phase_clock("fsdp", spent):
            torch.cuda.empty_cache()
            fsdp_r0 = phase_fsdp()
        with phase_clock("fsdp timing", spent):
            rows = (rows or []) + time_fsdp_kernels(fsdp_r0)
    log(f"[time] host-clock seconds by phase: "
        + ", ".join(f"{k} {v:.1f}" for k, v in spent.items())
        + f"; main {time.perf_counter() - t_main:.1f}")
    if rows is not None:
        print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
