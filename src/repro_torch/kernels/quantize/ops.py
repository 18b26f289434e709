"""Wrappers of the fused plane quantizer (K1, ``csrc/quantize_plane.cu``).

``quantize_plane`` launches the CUDA kernel on a CUDA tensor and runs the
plain version (``ref.py``) on a CPU tensor, as the reference runs Pallas
in interpret mode off the TPU.  ``dequantize_plane`` is plain PyTorch, as
in the reference (``quantize/ops.py:71``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quantize import ref


def wire_len(n: int, bits: int) -> int:
    """Wire bytes of one quantized message of n elements."""
    return n if bits == 8 else -(-n // 2)


def _check_bits(bits):
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")


def quantize_plane(seed, sids, rids, x, *, bits=8):
    """Quantize every message of ``x [..., n]`` (f32) in one launch, the
    stochastic-rounding bits derived in the kernel from ``(seed, sender,
    receiver, element)``.  ``seed`` is the round's pair of uint32 ints;
    ``sids``/``rids`` are per-message ids (int32 tensors holding uint32
    bit patterns, broadcastable to the lead shape) and ``rids=None`` marks
    one-to-all messages.  Returns ``(q [..., wire_len], scale [...])``."""
    _check_bits(bits)
    if x.device.type == "cpu":
        return ref.quantize_plane_ref(seed, sids, rids, x, bits=bits)
    lead, n = tuple(x.shape[:-1]), x.shape[-1]
    xf = x.reshape(-1, n)
    _build.check_tensor("x", xf, torch.float32, x.device)
    m, wire = xf.shape[0], wire_len(n, bits)
    sid = _plane_ids(sids, lead)
    rid = _plane_ids(rids, lead)
    scale = ref.row_scale(xf)
    q = torch.empty((m, wire), device=x.device,
                    dtype=torch.int8 if bits == 8 else torch.uint8)
    _build.launch(
        "quantize_plane", xf.data_ptr(), m, n, bits, seed[0], seed[1],
        _build.id_ptr(sid, m, x.device), _build.id_ptr(rid, m, x.device),
        scale.data_ptr(), q.data_ptr(), wire,
    )
    quantize_plane.launches += 1
    return q.reshape(lead + (wire,)), scale.reshape(lead)


quantize_plane.launches = 0


def _plane_ids(ids, lead):
    """Per-message ids for the kernels: int32 ``[M]`` (None stays None)."""
    if ids is None:
        return None
    try:
        ids = ids.broadcast_to(lead)
    except RuntimeError as e:
        raise ValueError(f"ids of shape {tuple(ids.shape)} do not broadcast "
                         f"to the messages' shape {lead}") from e
    return ids.reshape(-1).to(torch.int32).contiguous()


def dequantize_plane(q, scale, *, n, bits=8):
    """Elementwise inverse of ``quantize_plane``: ``scale * q / levels``."""
    _check_bits(bits)
    levels = float(2 ** (bits - 1) - 1)
    qf = q if bits == 8 else ref.unpack4(q, n)
    return scale[..., None] * qf.to(torch.float32) / levels
