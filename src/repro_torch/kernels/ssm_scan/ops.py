"""Wrapper of the SSD-scan kernel (K11, ``csrc/ssd_scan.cu``) in the model
zoo's layout (``src/repro/kernels/ssm_scan/ops.py``):
``models.mamba.ssd_chunked(..., use_kernel=True)`` dispatches here.

The reference's wrapper repeats the groups to heads and moves the head
axis forward before its kernel; K11 reads x [B,T,NH,HD], alog [B,T,NH]
and the groups [B,T,NG,DS] in place and writes y in the same layout, so
nothing is copied.  On a CPU tensor the plain version (``ref.py``) runs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssm_scan import ref

SMEM_LIMIT = 232_448  # bytes of shared memory a block may use (H100)


def smem_bytes(chunk: int, hd: int, ds: int) -> int:
    """K11's dynamic shared memory: x, Bᵀ, Cᵀ, the masked C Bᵀ ∘ L tile
    and the state h in f32, and three chunk-length vectors."""
    return 4 * (chunk * hd + 2 * ds * chunk + chunk * chunk + ds * hd
                + 3 * chunk)


def _token_stride(name, a, shape):
    """Elements between consecutive tokens of ``a`` (``shape`` [B, T, ...]
    with the dims after T contiguous and B spaced T tokens apart): the
    groups arrive as column slices of the conv output, read in place."""
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(a.shape)} != {tuple(shape)}")
    st, inner = a.stride(), 1
    for d in range(len(shape) - 1, 1, -1):
        if shape[d] > 1 and st[d] != inner:
            raise ValueError(f"{name}: the dims after T must be contiguous")
        inner *= shape[d]
    if st[1] < inner or (shape[0] > 1 and st[0] != shape[1] * st[1]):
        raise ValueError(f"{name}: unsupported strides {st}")
    return st[1]


def ssd_chunked(cfg, x, bmat, cmat, alog, h0=None):
    """Same contract as ``models.mamba.ssd_chunked`` (h0 must be None:
    the kernel owns the initial state; T a multiple of the chunk).
    Returns y [B,T,NH,HD] in x's dtype and h_final [B,NH,DS,HD] f32."""
    if h0 is not None:
        raise ValueError("the kernel path owns the scan state: h0 must be "
                         "None")
    b, t, nh, hd = x.shape
    ng, ds = bmat.shape[2], bmat.shape[3]
    chunk = min(cfg.chunk, t)
    if t % chunk:
        raise ValueError(f"T={t} must be a multiple of the chunk {chunk}")
    if x.device.type == "cpu":
        return ref.ssd_scan_plain(x, alog, bmat, cmat, chunk=chunk)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    _build.check_tensor("x", x, x.dtype, x.device)
    _build.check_tensor("alog", alog, x.dtype, x.device, (b, t, nh))
    for name, a in (("bmat", bmat), ("cmat", cmat)):
        if a.device != x.device or a.dtype != x.dtype:
            raise TypeError(f"{name} must be {x.dtype} on {x.device}")
    b_stride = _token_stride("bmat", bmat, (b, t, ng, ds))
    c_stride = _token_stride("cmat", cmat, (b, t, ng, ds))
    if ng == 0 or nh % ng or chunk % 4 or hd % 4 or ds % 4 \
            or smem_bytes(chunk, hd, ds) > SMEM_LIMIT:
        raise ValueError(f"unsupported shapes: chunk {chunk}, head_dim {hd},"
                         f" d_state {ds}, heads {nh}, groups {ng}")
    y = torch.empty_like(x)
    h = torch.empty((b, nh, ds, hd), dtype=torch.float32, device=x.device)
    _build.launch("ssd_scan", x.data_ptr(), alog.data_ptr(),
                  bmat.data_ptr(), cmat.data_ptr(), y.data_ptr(),
                  h.data_ptr(), b, t, nh, ng, hd, ds, chunk, b_stride,
                  c_stride,
                  int(x.dtype == torch.bfloat16))
    ssd_chunked.launches += 1
    return y, h


ssd_chunked.launches = 0
