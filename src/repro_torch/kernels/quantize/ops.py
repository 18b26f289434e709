"""Wrappers of the fused plane quantizer (K1, ``csrc/quantize_plane.cu``)
and of the per-message quantize/dequantize kernels (K4/K5,
``csrc/quantize_leaf.cu``).

Each wrapper launches its CUDA kernel on a CUDA tensor and runs the plain
version (``ref.py``) on a CPU tensor, as the reference runs Pallas in
interpret mode off the TPU.  ``dequantize_plane`` is plain PyTorch, as in
the reference (``quantize/ops.py:71``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, prng
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
    lead, n, xf = _build.rows(x, "x", torch.float32)
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


def quantize_tensor(keys, x, *, bits=8):
    """Quantize every message of ``x [..., n]`` (f32) in one launch, the
    counterpart of the reference's per-message ``quantize_tensor``
    (``quantize/ops.py:86``) batched over the lead dims.  ``keys [..., 2]``
    (``core.jaxrand`` keys, one per message): message m's rounding bits are
    ``jax.random.bits(keys[m], (n_pad,))``, drawn in the kernel.  Returns
    ``(q [..., wire_len], scale [...])``."""
    _check_bits(bits)
    if x.device.type == "cpu":
        return ref.quantize_tensor_ref(keys, x, bits=bits)
    lead, n, xf = _build.rows(x, "x", torch.float32)
    m, wire = xf.shape[0], wire_len(n, bits)
    kd = _key_words(keys, lead, x.device)
    scale = ref.row_scale(xf)
    q = torch.empty((m, wire), device=x.device,
                    dtype=torch.int8 if bits == 8 else torch.uint8)
    _build.launch("quantize_leaf", xf.data_ptr(), m, n, bits, kd.data_ptr(),
                  scale.data_ptr(), q.data_ptr(), wire)
    quantize_tensor.launches += 1
    return q.reshape(lead + (wire,)), scale.reshape(lead)


quantize_tensor.launches = 0


def _key_words(keys, lead, device):
    """``[..., 2]`` keys -> contiguous int32 ``[M, 2]`` uint32 bit patterns
    on ``device``, converted where the keys lie (host keys: one copy)."""
    if tuple(keys.shape) != lead + (2,):
        raise ValueError(f"keys of shape {tuple(keys.shape)} do not match "
                         f"the messages' shape {lead}")
    words = (keys.reshape(-1, 2) & prng.MASK).to(torch.int32)
    return words.to(device).contiguous()


def dequantize_tensor(q, scale, *, n, bits=8):
    """Inverse of ``quantize_tensor`` in one launch: ``(scale * q) *
    f32(1 / levels)`` per message, as the reference's compiled
    ``dequantize_tensor`` computes it (``quantize/ops.py:104``).
    ``q [..., wire_len]``, ``scale [...]``; returns ``[..., n]`` f32."""
    _check_bits(bits)
    if q.device.type == "cpu":
        return ref.dequantize_tensor_ref(q, scale, n=n, bits=bits)
    lead, wire, qf = _build.rows(q, "q",
                                 torch.int8 if bits == 8 else torch.uint8)
    if wire != wire_len(n, bits):
        raise ValueError(f"q holds {wire} bytes per message, not "
                         f"{wire_len(n, bits)} for n={n}, bits={bits}")
    m = qf.shape[0]
    sc = scale.reshape(-1)
    _build.check_tensor("scale", sc, torch.float32, q.device, (m,))
    out = torch.empty((m, n), dtype=torch.float32, device=q.device)
    _build.launch("dequantize_leaf", qf.data_ptr(), m, n, bits,
                  sc.data_ptr(), out.data_ptr(), wire)
    dequantize_tensor.launches += 1
    return out.reshape(lead + (n,))


dequantize_tensor.launches = 0


def dequantize_plane(q, scale, *, n, bits=8):
    """Elementwise inverse of ``quantize_plane``: ``scale * q / levels``."""
    _check_bits(bits)
    levels = float(2 ** (bits - 1) - 1)
    qf = q if bits == 8 else ref.unpack4(q, n)
    return scale[..., None] * qf.to(torch.float32) / levels
