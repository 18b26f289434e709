"""Kernel microbenchmarks of the port's communication path (port of
``benchmarks/kernels_bench.py``): the same rows and ``derived`` strings
(achieved wire-compression ratio, FLOP counts), timed through the port's
kernel wrappers, by CUDA events on the card (microseconds a call over
``iters`` calls after one warm-up) and by host clock with the plain
versions on the CPU.

``run(fast=True)`` times only the communication kernels: K4 (the
per-message quantizer), K6, K8, K9, K2, K3 and K1's plane; ``fast=False``
adds K10 and K11 at the reference's shapes.  The perf-smoke run
(``repro_torch.perf_smoke``) folds the fast rows into its BENCH JSON:

    PYTHONPATH=src python -m repro_torch.kernels_bench
"""
from __future__ import annotations

import argparse
import types

import torch

from repro_torch.core import jaxrand
from repro_torch.device import resolve_device
from repro_torch.kernels import prng
from repro_torch.kernels.quantize import ops as q_ops
from repro_torch.kernels.sparse_gather import ops as sg_ops
from repro_torch.obs.trace import timeit


def cases(dev, fast=False):
    """``(row name, call, derived, wrapper)`` per row: ``call()`` runs the
    row's kernel once through ``wrapper`` (whose ``launches`` counts it)."""
    key = jaxrand.key(0)
    x = jaxrand.normal(key, (1 << 16,)).to(dev)
    out = []
    for bits in (8, 4):
        q, _ = q_ops.quantize_tensor(key, x, bits=bits)
        out.append((f"kernel/quantize{bits}_64k",
                    lambda b=bits: q_ops.quantize_tensor(key, x, bits=b),
                    f"wire_ratio={x.nbytes / q.nbytes:.2f}",
                    q_ops.quantize_tensor))

    # sparse gather/scatter: the RandK/TopK per-message path
    k16 = 1 << 14
    idx = jaxrand.permutation(key, 1 << 16)[:k16].to(dev)
    off = torch.tensor(12345, dtype=torch.int64)
    vals = x[:k16]
    out += [
        ("kernel/sparse_gather_64k_k16k",
         lambda: sg_ops.sparse_gather(x, idx),
         f"wire_ratio={(1 << 16) / k16:.2f}", sg_ops.sparse_gather),
        ("kernel/cyclic_gather_64k_k16k",
         lambda: sg_ops.cyclic_gather(x, off, k16),
         f"wire_ratio={(1 << 16) / k16:.2f}", sg_ops.cyclic_gather),
        ("kernel/cyclic_scatter_64k_k16k",
         lambda: sg_ops.cyclic_scatter(vals, off, 1 << 16, gain=4.0),
         "gain=n/k", sg_ops.cyclic_scatter),
    ]

    # fused plane path: ALL [A, S, N] messages of a round in one launch,
    # randomness derived in the kernel from the counter PRNG
    a, s, n, k = 4, 2, 1 << 14, 1 << 12
    seed = jaxrand.key_seed(jaxrand.key(1))
    sids = torch.arange(a, dtype=torch.int32, device=dev)[:, None].expand(
        a, s)
    rids = torch.arange(s, dtype=torch.int32, device=dev)[None, :].expand(
        a, s)
    xp = jaxrand.normal(key, (a, s, n)).to(dev)
    vp = xp[..., :k].contiguous()
    strides = prng.coprime_strides(n)
    out += [
        ("kernel/fused_randk_plane_8x16k",
         lambda: sg_ops.randk_gather_plane(seed, sids, rids, xp, k=k,
                                           strides=strides),
         f"wire_ratio={n / k:.2f} launches=1", sg_ops.randk_gather_plane),
        ("kernel/fused_randk_scatter_8x16k",
         lambda: sg_ops.randk_scatter_plane(seed, sids, rids, vp, n=n,
                                            gain=n / k, strides=strides),
         "gain=n/k", sg_ops.randk_scatter_plane),
        ("kernel/fused_quant8_plane_8x16k",
         lambda: q_ops.quantize_plane(seed, sids, rids, xp, bits=8),
         "wire_ratio=4.00 launches=1", q_ops.quantize_plane),
    ]
    if fast:
        return out

    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssm_scan import ops as ssm_ops

    b, t, h, dh = 1, 512, 4, 64
    qa = jaxrand.normal(key, (b, t, h, dh)).to(dev)
    ka = jaxrand.normal(key, (b, t, 2, dh)).to(dev)
    flops = 4 * b * h * t * t * dh / 2  # causal
    out.append(("kernel/flash_512",
                lambda: flash_ops.flash_attention(qa, ka, ka),
                f"causal_flops={flops:.3g}", flash_ops.flash_attention))

    # the reference's [B, H, T, P] scan inputs in the model's [B, T, H, P]
    x2 = (jaxrand.normal(key, (1, 512, 4, 64)) * 0.3).to(dev)
    al = (-jaxrand.normal(key, (1, 512, 4)).abs() * 0.2).to(dev)
    bm = (jaxrand.normal(key, (1, 512, 4, 16)) * 0.3).to(dev)
    cfg = types.SimpleNamespace(chunk=128)
    out.append(("kernel/ssd_512",
                lambda: ssm_ops.ssd_chunked(cfg, x2, bm, bm, al),
                "chunk=128", ssm_ops.ssd_chunked))
    return out


def _us(fn, dev, iters):
    if dev.type != "cuda":
        return timeit(fn, iters=iters)
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters * 1e3


def run(print_rows=True, fast=False, device=None, iters=20):
    """Rows ``(name, us_per_call, derived)``, as the reference's."""
    dev = resolve_device(device)
    rows = [(name, _us(fn, dev, iters), derived)
            for name, fn, derived, _ in cases(dev, fast)]
    if print_rows:
        for r in rows:
            print(f"# kernels {r[0]:24s} {r[1]:.1f}us {r[2]}")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--fast", action="store_true",
                    help="the communication kernels only")
    args = ap.parse_args(argv)
    run(fast=args.fast, device=args.device)


if __name__ == "__main__":
    main()
