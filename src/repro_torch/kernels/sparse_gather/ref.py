"""Plain PyTorch versions of the fused RandK plane kernels (K2, K3), of
the arbitrary-index gather/scatter kernels (K6, K7), of the cyclic-window
gather/scatter kernels (K8, K9), and the last-writer scatter shared with
the per-message torch route."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import prng
from repro_torch.kernels.quantize.ref import BLOCK, _pad_last, plane_ids


def scatter_last(idx, vals, n: int):
    """``zeros(n).at[idx].set(vals)`` per row, keeping the LAST j where an
    index repeats, as the reference's scatter does (the int32 wrap of the
    affine index set can repeat indices).  An index outside [0, n) is
    skipped, as K7 skips it.  ``idx``/``vals`` are ``[M, k]``; returns
    ``[M, n]``."""
    m, k = idx.shape
    ok = (idx >= 0) & (idx < n)
    j = torch.where(ok, torch.arange(k, device=idx.device), -1)
    win = torch.full((m, n), -1, dtype=torch.int64, device=idx.device)
    win.scatter_reduce_(1, torch.where(ok, idx, 0), j, reduce="amax")
    hit = win >= 0
    out = torch.zeros((m, n), dtype=vals.dtype, device=vals.device)
    out[hit] = torch.gather(vals, 1, win.clamp_min(0))[hit]
    return out


def _plane_indices(seed, sids, rids, lead, n, k, strides, device):
    s = plane_ids(sids, lead, 0, device)
    r = plane_ids(rids, lead, prng.BROADCAST, device)
    return prng.affine_indices(prng.fold(seed, s, r), n, k, strides)


def randk_gather_plane_ref(seed, sids, rids, x, *, k, strides):
    """K2's plain version: each message's index set materialised."""
    lead, n = tuple(x.shape[:-1]), x.shape[-1]
    idx = _plane_indices(seed, sids, rids, lead, n, k, strides, x.device)
    out = torch.gather(x.reshape(-1, n), 1, idx)
    return out.reshape(lead + (k,))


def randk_scatter_plane_ref(seed, sids, rids, v, *, n, gain, strides):
    """K3's plain version: ``gain * v`` scattered onto zero planes."""
    lead, k = tuple(v.shape[:-1]), v.shape[-1]
    idx = _plane_indices(seed, sids, rids, lead, n, k, strides, v.device)
    g = torch.tensor(gain, dtype=torch.float32, device=v.device)
    out = scatter_last(idx, g * v.reshape(-1, k).to(torch.float32), n)
    return out.to(v.dtype).reshape(lead + (n,))


def sparse_gather_ref(x, idx):
    """K6's plain version with its wrapper (``sparse_gather/ops.py:33``):
    the index rows padded with 0 to a multiple of BLOCK, gathered, sliced
    to k; 0 for an index outside [0, n), as K6 gives.  ``x [..., n]``,
    ``idx [..., k]`` (int32 or int64); returns ``[..., k]``."""
    lead, n, k = tuple(idx.shape[:-1]), x.shape[-1], idx.shape[-1]
    ip = _pad_last(idx.reshape(-1, k).to(torch.int64),
                   -(-k // BLOCK) * BLOCK, 0)
    ok = (ip >= 0) & (ip < n)
    out = torch.gather(x.reshape(-1, n), 1, torch.where(ok, ip, 0))
    out = torch.where(ok, out, torch.zeros((), dtype=out.dtype,
                                           device=out.device))[:, :k]
    return out.reshape(lead + (k,))


def sparse_scatter_ref(v, idx, n: int, gain=1.0):
    """K7's plain version (``sparse_gather/ops.py:43``): ``zeros(n).at[idx]
    .set(gain * v)`` per row, the last j winning where an index repeats.
    ``v``/``idx [..., k]``; returns ``[..., n]``."""
    lead, k = tuple(v.shape[:-1]), v.shape[-1]
    g = torch.tensor(gain, dtype=v.dtype, device=v.device)
    out = scatter_last(idx.reshape(-1, k).to(torch.int64),
                       (g * v).reshape(-1, k), n)
    return out.reshape(lead + (n,))


def _window(off, lead, n, k, device):
    """Each message's cyclic window ``(off mod n + j) mod n``, ``[M, k]``."""
    o = torch.remainder(off.reshape(-1).to(device=device,
                                             dtype=torch.int64), n)
    if o.numel() != math.prod(lead):
        raise ValueError(f"off of shape {tuple(off.shape)} != {lead}")
    return (o[:, None] + torch.arange(k, device=device)) % n


def cyclic_gather_ref(x, off, k: int):
    """K8's plain version: ``out[..., j] = x[..., (off + j) mod n]`` for
    j < k.  ``x [..., n]``, ``off [...]``; returns ``[..., k]``."""
    lead, n = tuple(x.shape[:-1]), x.shape[-1]
    idx = _window(off, lead, n, k, x.device)
    return torch.gather(x.reshape(-1, n), 1, idx).reshape(lead + (k,))


def cyclic_scatter_ref(v, off, n: int, gain=1.0):
    """K9's plain version: ``gain * v`` (gain rounded to f32) written at
    each message's window on a zero plane, then ``+ 0.0``: the reference's
    kernel folds two halves of a doubled plane, which turns a -0.0 value
    into +0.0 (its jnp route keeps -0.0).  ``v [..., k]``, ``off [...]``;
    returns ``[..., n]``."""
    lead, k = tuple(v.shape[:-1]), v.shape[-1]
    idx = _window(off, lead, n, k, v.device)
    g = torch.tensor(gain, dtype=torch.float32, device=v.device)
    out = torch.zeros((idx.shape[0], n), dtype=torch.float32, device=v.device)
    out.scatter_(1, idx, g * v.reshape(-1, k).to(torch.float32))
    return (out + 0.0).reshape(lead + (n,))
