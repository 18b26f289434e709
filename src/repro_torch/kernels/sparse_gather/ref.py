"""Plain PyTorch versions of the fused RandK plane kernels (K2, K3) and
the last-writer scatter shared with the per-message route."""
from __future__ import annotations

import torch

from repro_torch.kernels import prng
from repro_torch.kernels.quantize.ref import plane_ids


def scatter_last(idx, vals, n: int):
    """``zeros(n).at[idx].set(vals)`` per row, keeping the LAST j where an
    index repeats, as the reference's scatter does (the int32 wrap of the
    affine index set can repeat indices).  ``idx``/``vals`` are
    ``[M, k]``; returns ``[M, n]``."""
    m, k = idx.shape
    j = torch.arange(k, device=idx.device).expand(m, k)
    win = torch.full((m, n), -1, dtype=torch.int64, device=idx.device)
    win.scatter_reduce_(1, idx, j, reduce="amax")
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
