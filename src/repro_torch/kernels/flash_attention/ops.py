"""Wrapper of the flash-attention kernel (K10, ``csrc/flash_attention.cu``)
in the model zoo's [B,T,H,Dh] layout, with the reference's support
predicate (``src/repro/kernels/flash_attention/ops.py``).

On a CUDA tensor ``flash_attention`` launches K10, which reads q, k and v
in place (no transposes, no repeated kv heads, no padded copies); on a
CPU tensor it runs the plain version (``ref.py``), as the reference runs
Pallas in interpret mode off the TPU.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

DEFAULT_Q_BLOCK = 128
MAX_HEAD_DIM = 256


def supported(q, k, v, mask) -> bool:
    # the kernel handles causal/window masks itself; arbitrary mask
    # tensors are not supported
    if mask is not None:
        return False
    b, t, h, dh = q.shape
    return t % min(DEFAULT_Q_BLOCK, t) == 0 and dh <= MAX_HEAD_DIM


def flash_attention(q, k, v, mask=None, *, causal=True, window=None):
    """q [B,T,H,Dh]; k,v [B,S,KH,Dh] -> [B,T,H,Dh] in q's dtype (f32 or
    bf16; the softmax and both products in f32)."""
    del mask
    if q.device.type == "cpu":
        return ref.flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
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
    _build.launch("flash_attention", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), b, t, s, h, kh, dh,
                  int(causal), 0 if window is None else int(window),
                  1.0 / math.sqrt(dh), int(q.dtype == torch.bfloat16))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
