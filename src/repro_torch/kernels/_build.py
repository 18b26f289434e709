"""Build the hand-written CUDA kernels at first use and call them.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), loaded with ``ctypes``.  The libraries land in
``build/repro_torch/`` at the root of the checkout, named by a hash of
their sources, so an unchanged source is never rebuilt.  ``build()``
starts one ``nvcc`` per source, all at once.

Every C entry point launches on the stream it is given (PyTorch's current
stream), allocates nothing, and returns ``cudaGetLastError()``; ``launch``
raises when that is not 0.  Nothing here runs at import time: the CPU
tests import every module of the port on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v")

_P, _I, _U, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, \
    ctypes.c_float, ctypes.c_longlong

# C entry point -> (source stem, argument types without the final stream)
ENTRIES = {
    "threefry_bits": ("threefry_bits",
                      (_U, _U, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P)),
    "quantize_plane": ("quantize_plane",
                       (_P, _I, _I, _I, _U, _U, _P, _P, _P, _P, _I, _P)),
    "randk_gather_pull": ("randk_plane",
                          (_P, _I, _I, _I, _U, _U, _P, _P, _P, _I, _P)),
    "randk_gather_push": ("randk_plane",
                          (_P, _I, _I, _I, _U, _U, _P, _P, _P, _I, _P)),
    "randk_scatter_pull": ("randk_plane",
                           (_P, _I, _I, _I, _F, _U, _U, _P, _P, _P, _P, _I,
                            _P)),
    "randk_scatter_push": ("randk_plane",
                           (_P, _I, _I, _I, _F, _U, _U, _P, _P, _P, _I, _P,
                            _P)),
    "quantize_leaf": ("quantize_leaf",
                      (_P, _I, _I, _I, _P, _P, _P, _I, _P)),
    "dequantize_leaf": ("quantize_leaf", (_P, _I, _I, _I, _P, _P, _I, _I)),
    "shard_tree_absmax": ("quantize_leaf", (_P, _I, _U, _P, _P, _P, _P)),
    "shard_tree_quantize": ("quantize_leaf",
                            (_P, _I, _U, _P, _I, _P, _I, _P, _U, _P, _P,
                             _P)),
    "sparse_gather": ("gather_scatter", (_P, _I, _I, _P, _I, _L, _I, _P)),
    "sparse_scatter": ("gather_scatter",
                       (_P, _P, _I, _L, _I, _I, _I, _F, _I, _P, _P, _P)),
    "cyclic_gather": ("cyclic", (_P, _P, _I, _I, _I, _P)),
    "cyclic_scatter": ("cyclic", (_P, _P, _I, _I, _I, _F, _P)),
    "flash_attention": ("flash_attention",
                        (_P, _P, _P, _P) + (_I,) * 8 + (_F, _I)),
    "flash_attention_tc": ("flash_attention_sm90",
                           (_P, _P, _P, _P) + (_I,) * 8 + (_F,)),
    "ssd_scan": ("ssd_scan", (_P,) * 6 + (_I,) * 10),
    "ssd_scan_tc": ("ssd_scan_sm90", (_P,) * 7 + (_I,) * 9),
    "ssd_scan_tc_info": ("ssd_scan_sm90", (_I,) * 7 + (_P,)),
}
SOURCES = tuple(sorted({stem for stem, _ in ENTRIES.values()}))

_libs: dict = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _lib_path(stem: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cuh")) + [_CSRC / f"{stem}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile every source that has no up-to-date library, one ``nvcc``
    per source started together.  Returns ``{stem: (seconds, ptxas
    report)}`` for the sources compiled in this call."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem in SOURCES:
        out = _lib_path(stem)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{stem}.cu")]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    report = {}
    for stem, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {stem}.cu:\n{log}")
        os.replace(tmp, out)
        report[stem] = (secs, log)
    return report


def _lib(stem: str):
    lib = _libs.get(stem)
    if lib is None:
        path = _lib_path(stem)
        if not path.exists():
            build()
        lib = ctypes.CDLL(str(path))
        for entry, (src, argtypes) in ENTRIES.items():
            if src == stem:
                fn = getattr(lib, entry)
                fn.argtypes = list(argtypes) + [_P]
                fn.restype = _I
        _libs[stem] = lib
    return lib


def launch(entry: str, *args) -> None:
    """Call C entry ``entry`` on PyTorch's current stream; raise if the
    launch reported a CUDA error."""
    stem, argtypes = ENTRIES[entry]
    if len(args) != len(argtypes):
        # ctypes would pass extra arguments on, shifting the stream's
        raise TypeError(f"{entry} takes {len(argtypes)} arguments before "
                        f"the stream, got {len(args)}")
    fn = getattr(_lib(stem), entry)
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA error {rc} at launch")


def check_tensor(name, t, dtype, device, shape=None) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` CUDA tensor on
    ``device`` (and of ``shape`` when given)."""
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor on {device}, "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")


def rows(t, name, dtype):
    """``t [..., w]`` as contiguous ``[M, w]`` rows of ``dtype`` on its CUDA
    device (raises otherwise): ``(lead shape, w, rows)``."""
    lead, w = tuple(t.shape[:-1]), t.shape[-1]
    tf = t.reshape(-1, w)
    check_tensor(name, tf, dtype, t.device)
    return lead, w, tf


def id_ptr(ids, m: int, device) -> int | None:
    """Pointer of an int32 id vector of length ``m`` (uint32 bit patterns),
    or None for "use the default id" (0 for senders, BROADCAST for
    receivers)."""
    if ids is None:
        return None
    check_tensor("ids", ids, torch.int32, device, (m,))
    return ids.data_ptr()


@functools.lru_cache(maxsize=64)
def stride_table(strides: tuple):
    """Host int32 array of the stride table (the C launcher copies it into
    a kernel argument, so it never lives in device memory, and never
    writes it: one array per static table serves every launch)."""
    if not 1 <= len(strides) <= 64:
        raise ValueError(f"stride table must hold 1..64 entries, got "
                         f"{len(strides)}")
    return (ctypes.c_int32 * len(strides))(*strides)
