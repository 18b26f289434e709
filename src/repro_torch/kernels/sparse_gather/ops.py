"""Wrappers of the fused RandK plane kernels (K2 gather, K3 scatter;
``csrc/randk_plane.cu``).

On a CUDA tensor each wrapper launches its kernel; on a CPU tensor it
runs the plain version (``ref.py``), as the reference runs Pallas in
interpret mode off the TPU.  The index set of every message is derived
in the kernel from ``(seed, sender, receiver)``: ``seed`` is the round's
pair of uint32 ints, ``sids``/``rids`` are per-message ids (int32 tensors
holding uint32 bit patterns; ``rids=None`` marks one-to-all messages) and
``strides`` the static stride table (``(1,)`` for the block sampler).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quantize.ops import _plane_ids
from repro_torch.kernels.sparse_gather import ref


def indices_unique(n: int, k: int, strides: tuple) -> bool:
    """True when no row's index set can repeat an index: the int32 sum
    ``off + j * stride`` never wraps, or n divides 2^32 (a power of two)
    so the wrap leaves the residues mod n intact."""
    if k > n:
        return False
    return n & (n - 1) == 0 or (n - 1) + (k - 1) * max(strides) < 2 ** 31


def _rows(t, name):
    lead, w = tuple(t.shape[:-1]), t.shape[-1]
    tf = t.reshape(-1, w)
    _build.check_tensor(name, tf, torch.float32, t.device)
    return lead, w, tf


def randk_gather_plane(seed, sids, rids, x, *, k, strides):
    """RandK compress of every message of ``x [..., n]``: ``[..., k]``."""
    if x.device.type == "cpu":
        return ref.randk_gather_plane_ref(seed, sids, rids, x, k=k,
                                          strides=strides)
    lead, n, xf = _rows(x, "x")
    m = xf.shape[0]
    sid, rid = _plane_ids(sids, lead), _plane_ids(rids, lead)
    out = torch.empty((m, k), dtype=torch.float32, device=x.device)
    _build.launch(
        "randk_gather_plane", xf.data_ptr(), m, n, k, seed[0], seed[1],
        _build.id_ptr(sid, m, x.device), _build.id_ptr(rid, m, x.device),
        _build.stride_table(strides), len(strides), out.data_ptr(),
    )
    randk_gather_plane.launches += 1
    return out.reshape(lead + (k,))


randk_gather_plane.launches = 0


def randk_scatter_plane(seed, sids, rids, v, *, n, gain, strides):
    """RandK decompress of ``v [..., k]``: ``gain * v`` written at each
    message's index set on a zero ``[..., n]`` plane."""
    if v.device.type == "cpu":
        return ref.randk_scatter_plane_ref(seed, sids, rids, v, n=n,
                                           gain=gain, strides=strides)
    lead, k, vf = _rows(v, "v")
    m = vf.shape[0]
    sid, rid = _plane_ids(sids, lead), _plane_ids(rids, lead)
    out = torch.zeros((m, n), dtype=torch.float32, device=v.device)
    winner = (None if indices_unique(n, k, strides) else
              torch.full((m, n), -1, dtype=torch.int32, device=v.device))
    _build.launch(
        "randk_scatter_plane", vf.data_ptr(), m, n, k, float(gain), seed[0],
        seed[1], _build.id_ptr(sid, m, v.device),
        _build.id_ptr(rid, m, v.device), _build.stride_table(strides),
        len(strides), None if winner is None else winner.data_ptr(),
        out.data_ptr(),
    )
    randk_scatter_plane.launches += 1
    return out.reshape(lead + (n,))


randk_scatter_plane.launches = 0
