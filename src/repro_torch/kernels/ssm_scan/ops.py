"""Wrapper of the SSD-scan kernel (K11) in the model zoo's layout
(``src/repro/kernels/ssm_scan/ops.py``):
``models.mamba.ssd_chunked(..., use_kernel=True)`` dispatches here.

The reference's wrapper repeats the groups to heads and moves the head
axis forward before its kernel; K11 reads x [B,T,NH,HD], alog [B,T,NH]
and the groups [B,T,NG,DS] in place and writes y in the same layout, so
nothing is copied.  On a CUDA tensor ``ssd_chunked`` launches one of two
variants, by the rule of ``route``:

* ``"tc"`` (``csrc/ssd_scan_sm90.cu``): bf16 on the tensor cores, split
  over (batch, chunk, head) in three launches (the chunks' own states,
  the pass across chunks, the outputs); for chunks of 32, 64 or 128
  steps, head_dim 32 or 64, d_state a multiple of 16 up to 64, and x, B
  and C 16-byte aligned with token strides of B and C a multiple of 8
  elements.  It takes a scratch of ``tc_scratch_bytes``.
* ``"cc"`` (``csrc/ssd_scan.cu``): f32 on the CUDA cores, one block per
  (head, batch) walking the chunks, and the bf16 shapes "tc" refuses.

The rule is on the shape and the pointers, decided before the launch.
``variant`` forces one (the card tests and the timing do); a launch that
the chosen kernel refuses raises, nothing falls back.  On a CPU tensor the
plain version (``ref.py``) runs.  On a ``meta`` or fake tensor (a
dry-run's trace of the card's route) the outputs come with the kernel's
shapes and dtypes and nothing launches.  Both routes report the call to
the active ``launch.op_analysis.OpCounter`` as one op "K11" with the
chunked scan's products (``products``) in ``dot_flops``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssm_scan import ref
from repro_torch.launch import op_analysis

SMEM_LIMIT = 232_448  # bytes of shared memory a block may use (H100)
TC_CHUNKS = (32, 64, 128)
TC_HEAD_DIMS = (32, 64)


def smem_bytes(chunk: int, hd: int, ds: int) -> int:
    """The CUDA-core K11's dynamic shared memory: x, Bᵀ, Cᵀ, the masked
    C Bᵀ ∘ L tile and the state h in f32, and three chunk-length
    vectors."""
    return 4 * (chunk * hd + 2 * ds * chunk + chunk * chunk + ds * hd
                + 3 * chunk)


def tc_scratch_bytes(b: int, t: int, nh: int, hd: int, ds: int,
                     chunk: int) -> int:
    """The tensor-core K11's scratch: each (batch, chunk, head)'s own state
    in f32 and its h_in as two bf16 pieces ([DS, HD] each), and
    exp(cum_Q)."""
    slots = b * (t // chunk) * nh
    return 8 * slots * ds * hd + 4 * slots


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


def route(x, bmat, cfg, cmat=None) -> str:
    """K11's variant for these tensors: "tc" or "cc" (module doc).
    ``cmat`` defaults to ``bmat`` (the Mamba block's C sits beside B in
    the same conv output, at the same stride)."""
    cmat = bmat if cmat is None else cmat
    t, hd = x.shape[1], x.shape[3]
    ds = bmat.shape[3]
    chunk = min(cfg.chunk, t)
    rows = all(a.data_ptr() % 16 == 0 and a.stride(1) % 8 == 0
               for a in (bmat, cmat))
    tc = (x.dtype == torch.bfloat16 and chunk in TC_CHUNKS
          and hd in TC_HEAD_DIMS and ds % 16 == 0 and 16 <= ds <= 64
          and x.data_ptr() % 16 == 0 and rows)
    return "tc" if tc else "cc"


def products(b, t, nh, hd, ds, chunk) -> float:
    """The chunked scan's multiply-adds times 2: per chunk of Q steps and
    head, C Bᵀ (Q x Q x DS), its masked product with x (Q x Q x HD), the
    chunk's state Bᵀ x (DS x HD x Q) and the outputs from the carried
    state C h (Q x DS x HD)."""
    q = min(chunk, t)
    per = 2.0 * (q * q * ds + q * q * hd + 2 * q * ds * hd)
    return per * b * nh * (t // q)


def ssd_chunked(cfg, x, bmat, cmat, alog, h0=None, *, variant=None):
    """Same contract as ``models.mamba.ssd_chunked`` (h0 must be None:
    the kernel owns the initial state; T a multiple of the chunk).
    Returns y [B,T,NH,HD] in x's dtype and h_final [B,NH,DS,HD] f32.
    ``variant`` ("tc" or "cc") overrides ``route`` on the card."""
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
    flops = products(b, t, nh, hd, ds, chunk)
    if op_analysis.is_abstract(x):
        return op_analysis.kernel_op(
            "K11", (x, alog, bmat, cmat), (
                torch.empty_like(x),
                torch.empty((b, nh, ds, hd), dtype=torch.float32,
                            device=x.device)), flops, x.dtype)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    _build.check_tensor("x", x, x.dtype, x.device)
    _build.check_tensor("alog", alog, x.dtype, x.device, (b, t, nh))
    for name, a in (("bmat", bmat), ("cmat", cmat)):
        if a.device != x.device or a.dtype != x.dtype:
            raise TypeError(f"{name} must be {x.dtype} on {x.device}")
    b_stride = _token_stride("bmat", bmat, (b, t, ng, ds))
    c_stride = _token_stride("cmat", cmat, (b, t, ng, ds))
    if ng == 0 or nh % ng:
        raise ValueError(f"{nh} heads do not share {ng} groups evenly")
    if variant not in (None, "tc", "cc"):
        raise ValueError(f"variant must be 'tc' or 'cc', got {variant!r}")
    best = route(x, bmat, cfg, cmat)
    variant = best if variant is None else variant
    shape = (f"chunk {chunk}, head_dim {hd}, d_state {ds}, heads {nh}, "
             f"groups {ng}, {x.dtype}")
    if variant == "tc" and best != "tc":
        raise ValueError(f"the tensor-core K11 does not take {shape}")
    if variant == "cc" and (chunk % 4 or hd % 4 or ds % 4
                            or smem_bytes(chunk, hd, ds) > SMEM_LIMIT):
        raise ValueError(f"unsupported shapes: {shape}")
    y = torch.empty_like(x)
    h = torch.empty((b, nh, ds, hd), dtype=torch.float32, device=x.device)
    args = (x.data_ptr(), alog.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
            y.data_ptr(), h.data_ptr())
    if variant == "tc":
        scratch = torch.empty(tc_scratch_bytes(b, t, nh, hd, ds, chunk),
                              dtype=torch.uint8, device=x.device)
        _build.launch("ssd_scan_tc", *args, scratch.data_ptr(), b, t, nh,
                      ng, hd, ds, chunk, b_stride, c_stride)
        ssd_chunked.launches_tc += 1
    else:
        _build.launch("ssd_scan", *args, b, t, nh, ng, hd, ds, chunk,
                      b_stride, c_stride, int(x.dtype == torch.bfloat16))
        ssd_chunked.launches_cc += 1
    ssd_chunked.launches += 1
    return op_analysis.kernel_op("K11", (x, alog, bmat, cmat), (y, h), flops,
                                 x.dtype)


# launches of each variant; ``launches`` is their sum
ssd_chunked.launches = 0
ssd_chunked.launches_tc = 0
ssd_chunked.launches_cc = 0


def tc_launch_info(b, t, nh, ng, hd, ds, chunk) -> dict:
    """What the tensor-core K11 launches for this shape, as the CUDA
    runtime reports it (``cudaFuncGetAttributes`` and the occupancy API):
    per kernel its threads, registers and resident blocks per SM; for the
    states and outputs kernels also the dynamic shared memory, local
    (spilled) bytes, heads a block walks and the grid's blocks."""
    import ctypes

    out = (ctypes.c_int * 18)()
    _build.launch("ssd_scan_tc_info", b, t, nh, ng, hd, ds, chunk,
                  ctypes.addressof(out))
    v = list(out)
    keys = ("threads", "smem_bytes", "registers", "local_bytes",
            "blocks_per_sm", "heads_per_block", "blocks")
    return {"states": dict(zip(keys, v[0:7])),
            "pass": dict(zip(("threads", "registers", "blocks_per_sm"),
                             v[7:10])),
            "outputs": dict(zip(keys, v[10:17])), "sms": v[17]}
