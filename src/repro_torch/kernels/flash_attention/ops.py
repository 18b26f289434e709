"""Wrapper of the flash-attention kernel (K10) in the model zoo's
[B,T,H,Dh] layout, with the reference's support predicate
(``src/repro/kernels/flash_attention/ops.py``).

On a CUDA tensor ``flash_attention`` launches one of K10's two variants,
which read q, k and v in place (no transposes, no repeated kv heads, no
padded copies), by the rule of ``route``:

* ``"tc"`` (``csrc/flash_attention_sm90.cu``): bf16 on the tensor cores,
  fed by TMA; for every bf16 shape ``supported`` admits whose rows TMA can
  address as 4-D tensor maps: Dh a multiple of 8 (the maps' head stride,
  Dh * 2 bytes, and every stride above it then a multiple of 16 bytes) and
  q, k, v 16-byte aligned.  Columns of Dh not a multiple of 16 are padded
  by TMA's zero fill.
* ``"cc"`` (``csrc/flash_attention.cu``): f32 on the CUDA cores, and the
  bf16 shapes TMA cannot take (Dh not a multiple of 8, or a misaligned
  base).

The rule is on the shape and the pointers, decided before the launch; a
launch that the chosen kernel refuses raises.  On a CPU tensor the
wrapper runs the plain version (``ref.py``), as the reference runs Pallas
in interpret mode off the TPU.  On a ``meta`` or fake tensor (a dry-run's
trace of the card's route) it returns an output of the kernel's shape and
dtype and launches nothing.  Both routes report the call to the active
``launch.op_analysis.OpCounter`` as one op "K10" with its products
(``products``) in ``dot_flops``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref
from repro_torch.launch import op_analysis

DEFAULT_Q_BLOCK = 128
MAX_HEAD_DIM = 256


def supported(q, k, v, mask) -> bool:
    # the kernel handles causal/window masks itself; arbitrary mask
    # tensors are not supported
    if mask is not None:
        return False
    b, t, h, dh = q.shape
    return t % min(DEFAULT_Q_BLOCK, t) == 0 and dh <= MAX_HEAD_DIM


def route(q, k, v) -> str:
    """K10's variant for these CUDA tensors: "tc" or "cc" (module doc)."""
    tma = q.shape[-1] % 8 == 0 and all(a.data_ptr() % 16 == 0
                                       for a in (q, k, v))
    return "tc" if q.dtype == torch.bfloat16 and tma else "cc"


def products(q, k, v, *, causal=True, window=None) -> float:
    """K10's multiply-adds times 2 over the (query, key) pairs its mask
    admits (``ref._mask``: row i takes the keys j <= i when causal, i - j
    < window with a window): QK^T and PV, as the reference counts two
    dots.  Row i admits the keys [lo(i), hi(i)) with hi(i) = min(i + 1, S)
    (S when not causal) and lo(i) = max(i - window + 1, 0); rows past
    S + window - 2 admit none, and the sums of hi and lo over the rest
    have closed forms."""
    b, t, h, dh = q.shape
    s, dv = k.shape[1], v.shape[-1]
    n = t if window is None else min(t, s + window - 1)
    if n <= 0:
        return 0.0
    his = (n * (n + 1) // 2 if n <= s else s * (s + 1) // 2 + (n - s) * s
           ) if causal else n * s
    m = 0 if window is None else max(n - window, 0)
    return 2.0 * b * h * (his - m * (m + 1) // 2) * (dh + dv)


def flash_attention(q, k, v, mask=None, *, causal=True, window=None):
    """q [B,T,H,Dh]; k,v [B,S,KH,Dh] -> [B,T,H,Dh] in q's dtype (f32 or
    bf16; the softmax and both products exact in f32, sums in f32)."""
    del mask
    if q.device.type == "cpu":
        return ref.flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
    if op_analysis.is_abstract(q):
        return op_analysis.kernel_op(
            "K10", (q, k, v), torch.empty_like(q),
            products(q, k, v, causal=causal, window=window), q.dtype)
    b, t, h, dh = q.shape
    s, kh = k.shape[1], k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    _build.check_tensor("q", q, q.dtype, q.device)
    _build.check_tensor("k", k, q.dtype, q.device, (b, s, kh, dh))
    _build.check_tensor("v", v, q.dtype, q.device, (b, s, kh, dh))
    if not supported(q, k, v, None) or kh == 0 or h % kh or s == 0:
        raise ValueError(f"unsupported shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    out = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t,
            s, h, kh, dh, int(causal), 0 if window is None else int(window),
            1.0 / math.sqrt(dh))
    if route(q, k, v) == "tc":
        _build.launch("flash_attention_tc", *args)
        flash_attention.launches_tc += 1
    else:
        _build.launch("flash_attention", *args,
                      int(q.dtype == torch.bfloat16))
        flash_attention.launches_cc += 1
    flash_attention.launches += 1
    return op_analysis.kernel_op(
        "K10", (q, k, v), out,
        lambda: products(q, k, v, causal=causal, window=window), q.dtype)


# launches of each variant; ``launches`` is their sum
flash_attention.launches = 0
flash_attention.launches_tc = 0
flash_attention.launches_cc = 0
