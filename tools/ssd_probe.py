#!/usr/bin/env python3
"""Split the tensor-core K11 (``csrc/ssd_scan_sm90.cu``) into its three
launches and time builds of it with one step changed, at zamba2-2.7b's
SSD shape ([2, 80, 2048, 64] bf16, d_state 64, one group, chunk 128).

    python3 tools/ssd_probe.py

``VARIANTS`` are copies of the package's source with one line replaced
(the probe fails if the line is not there):

* ``accurate_exp``: the outputs kernel's exps in L as ``expf`` rather
  than ``__expf`` (the SFU's ex2 of x log2(e));
* ``serialised``: the lo pieces' G X products under a branch on the
  warpgroup (``live``; its G is zeros there, so the result is the same):
  ptxas then serialises every wgmma of the kernel (its note C7520);
* ``hb_quarter``: the launcher plans for four times the resident blocks,
  so each block walks a quarter of the heads (more blocks, more waves);
* ``one_block_an_sm``: the outputs kernel's launch bounds ask for one
  resident block an SM, not two, so ptxas may give it up to 255
  registers a thread;
* ``no_exp``, ``no_gx``, ``no_ch`` (diagnostics, their results not held):
  L taken as 1; the G X products skipped (G is still built: its
  registers stay fenced); the C h_in products skipped.  What each saves
  is what that step costs.

Each build is one ``nvcc`` (the package's flags), all started together,
loaded with ``ctypes`` through its C entry ``ssd_scan_tc``.  Every build
runs on the same inputs; the builds that compute K11 are held to the
plain version's limits first (y one bf16 ulp, h_final 1e-5 of its max).
Then each build's bare launch is timed by CUDA events twice, the builds
in order and then in reverse, and torch.profiler gives each of its three
kernels' device time over 20 launches.  Needs a CUDA card and nvcc;
prints one JSON object as its last line.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

CASE = (2, 2048, 80, 64, 1, 64, 128)  # (B, T, NH, HD, NG, DS, chunk)
_EXP = "ex[r][0] = __expf(ct[r] - cs0);"
_EXP1 = "ex[r][1] = __expf(ct[r] - cs1);"
_LO = "        wgmma_rs(y, glo[kk], dx, 1);"
_GX = """        wgmma_rs(y, ghi[kk], dx, 1);
""" + _LO
_CH = """      wgmma_rs(y, cf[kk], desc_mn(base + L::kH, kk), 1);
      wgmma_rs(y, cf[kk], desc_mn(base + L::kH + kPieceBytes, kk), 1);"""
_SLOTS = "const long long slots = static_cast<long long>(sms) * per_sm;"
_BOUNDS = "__launch_bounds__(OutTiles<kQ>::kThreads, 2)"
# name -> ([(the package's text, its text in the copy)], held)
VARIANTS = {
    "base": ([], True),
    "accurate_exp": ([(_EXP, _EXP.replace("__expf", "expf")),
                      (_EXP1, _EXP1.replace("__expf", "expf"))], True),
    "serialised": ([(_LO, _LO.replace("wgmma_rs", "if (live) wgmma_rs"))],
                   True),
    "hb_quarter": ([(_SLOTS, _SLOTS.replace("per_sm;", "per_sm * 4;"))],
                   True),
    "one_block_an_sm": ([(_BOUNDS, _BOUNDS.replace(", 2)", ", 1)"))], True),
    "no_exp": ([(_EXP, "ex[r][0] = 1.f;"), (_EXP1, "ex[r][1] = 1.f;")],
               False),
    "no_gx": ([(_GX, "")], False),
    "no_ch": ([(_CH, "")], False),
}
KERNELS = ("ssd_state_kernel", "ssd_pass_kernel", "ssd_output_kernel")


def build(out_dir):
    """One library per variant, all nvcc processes started together;
    returns {name: path}."""
    from repro_torch.kernels import _build

    src = (_build._CSRC / "ssd_scan_sm90.cu").read_text()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, (edits, _) in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"{name}.so")
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, f"-I{_build._CSRC}", "-o",
               lib, cu]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        # ptxas's registers at zamba2's instantiation, and its notes that
        # it serialised a kernel's wgmmas (C7520)
        lines = log.splitlines()
        regs = []
        for i, line in enumerate(lines):
            if "Compiling" in line and "ILi128ELi64E" in line:
                used = next((u for u in lines[i + 1:] if "Used" in u), "")
                regs.append(used.split("Used")[-1].split(",")[0].strip())
        serial = sorted({k for line in lines if "C7520" in line
                         for k in KERNELS if k in line})
        print(f"[ssd_probe] {name} ptxas: states, outputs at [128, 64]: "
              f"{regs}; wgmmas serialised in {serial or 'no kernel'}")
        libs[name] = lib
    return libs


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build
    from repro_torch.kernels.ssm_scan import ops, ref
    from repro_torch.kernels.tolerance import bf16_ulps

    if not torch.cuda.is_available():
        print("ssd_probe: CUDA is not available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    libs = build(str(_build.BUILD_DIR / "ssd_probe"))
    dev = torch.device("cuda")
    b, t, nh, hd, ng, ds, chunk = CASE
    g = torch.Generator(device=dev).manual_seed(11)
    x = (0.5 * torch.randn((b, t, nh, hd), generator=g, device=dev)).bfloat16()
    alog = (-0.2 * torch.randn((b, t, nh), generator=g, device=dev).abs()
            ).bfloat16()
    xbc = (0.5 * torch.randn((b, t, nh * hd + 2 * ng * ds), generator=g,
                             device=dev)).bfloat16()
    bm = xbc[..., nh * hd:nh * hd + ng * ds].reshape(b, t, ng, ds)
    cm = xbc[..., nh * hd + ng * ds:].reshape(b, t, ng, ds)
    y = torch.empty_like(x)
    h = torch.empty((b, nh, ds, hd), device=dev)
    scratch = torch.empty(ops.tc_scratch_bytes(b, t, nh, hd, ds, chunk),
                          dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    args = (x.data_ptr(), alog.data_ptr(), bm.data_ptr(), cm.data_ptr(),
            y.data_ptr(), h.data_ptr(), scratch.data_ptr(), b, t, nh, ng, hd,
            ds, chunk, bm.stride(1), cm.stride(1), stream)
    calls = {}
    for name, path in libs.items():
        fn = ctypes.CDLL(path).ssd_scan_tc
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def call(fn=fn, name=name):
            rc = fn(*args)
            if rc:
                raise RuntimeError(f"{name}: CUDA error {rc}")
        calls[name] = call
    yw, hw = ref.ssd_scan_plain(x, alog, bm, cm, chunk=chunk)
    scale = float(yw.float().abs().max())
    result = {"card": card, "case": CASE, "variants": {}}
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        held = VARIANTS[name][1]
        ulps = bf16_ulps(y, yw, 1e-5 * scale)
        rel_h = float((h - hw).abs().max() / hw.abs().max())
        if held and not (ulps <= 1 and rel_h <= 1e-5):
            raise AssertionError(f"{name}: {ulps} ulps, h rel {rel_h}")
        result["variants"][name] = {"held": held, "y_ulps": ulps,
                                    "h_rel": rel_h, "ms": []}

    def cuda_ms(fn, iters=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / iters

    order = list(calls)
    for name in order + order[::-1]:
        result["variants"][name]["ms"].append(cuda_ms(calls[name]))
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                call()
            torch.cuda.synchronize()
        per = {k: 0.0 for k in KERNELS}
        for ev in prof.events():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            for k in KERNELS:
                if k in ev.name:
                    per[k] += ev.time_range.elapsed_us() / 1e3 / 20
        r = result["variants"][name]
        r["kernels_ms"] = per
        print(f"[ssd_probe] {name}{'' if r['held'] else ' (not held)'}: bare "
              f"{r['ms'][0]:.4f} / {r['ms'][1]:.4f} ms; states "
              f"{per['ssd_state_kernel']:.4f}, pass "
              f"{per['ssd_pass_kernel']:.4f}, outputs "
              f"{per['ssd_output_kernel']:.4f} ms; y {r['y_ulps']:.3f} "
              f"ulp, h rel {r['h_rel']:.3e} [{card}]", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
