"""Plain PyTorch versions of the flash-attention kernel (K10).

``flash_attention_plain`` repeats K10's arithmetic in f32 in the order of
the reference's Pallas kernel (``src/repro/kernels/flash_attention/
kernel.py:30``): kv blocks of 128 in order, an online softmax with a
-1e30 fill and ``where(mask, p, 0)``, ``l`` floored at 1e-30, one true
division at the end, the result rounded to q's dtype.  Query rows are
independent, so all of them go through each kv block at once (the
reference's 128-row q blocks compute the same values).  The padded kv
columns of the reference are left out: they would add exact zeros.
``flash_attention_tc_plain`` repeats the arithmetic of K10's tensor-core
variant (``csrc/flash_attention_sm90.cu``), p split into two bf16 halves.
``attention_ref`` is the dense oracle (``ref.py:10``).
"""
from __future__ import annotations

import math

import torch

KV_BLOCK = 128
_NEG_INF = -1e30


def _mask(rows, cols, causal, window):
    m = torch.ones((rows.shape[0], cols.shape[0]), dtype=torch.bool,
                   device=rows.device)
    if causal:
        m &= rows[:, None] >= cols[None, :]
    if window is not None:
        m &= (rows[:, None] - cols[None, :]) < window
    return m


def flash_attention_plain(q, k, v, *, causal=True, window=None,
                          kv_block=KV_BLOCK):
    """q [B,T,H,Dh]; k,v [B,S,KH,Dh] -> [B,T,H,Dh] in q's dtype (the
    layout of ``ops.flash_attention``)."""
    b, t, h, dh = q.shape
    s, kh = k.shape[1], k.shape[2]
    g = h // kh
    qf = q.float().transpose(1, 2)  # [B,H,T,Dh]
    kf = k.float().transpose(1, 2).repeat_interleave(g, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(g, dim=1)
    scale = 1.0 / math.sqrt(dh)
    dev = q.device
    rows = torch.arange(t, device=dev)
    acc = torch.zeros((b, h, t, dh), dtype=torch.float32, device=dev)
    m = torch.full((b, h, t, 1), _NEG_INF, dtype=torch.float32, device=dev)
    lsum = torch.zeros((b, h, t, 1), dtype=torch.float32, device=dev)
    for k0 in range(0, s, kv_block):
        kb, vb = kf[:, :, k0:k0 + kv_block], vf[:, :, k0:k0 + kv_block]
        mask = _mask(rows, k0 + torch.arange(kb.shape[2], device=dev),
                     causal, window)
        sc = torch.matmul(qf, kb.transpose(-1, -2)) * scale
        sc = torch.where(mask, sc, _NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.where(mask, torch.exp(sc - m_new), 0.0)
        corr = torch.exp(m - m_new)
        lsum = lsum * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p, vb)
        m = m_new
    out = acc / torch.clamp_min(lsum, 1e-30)
    return out.to(q.dtype).transpose(1, 2)


def flash_attention_tc_plain(q, k, v, *, causal=True, window=None):
    """The tensor-core K10's arithmetic for bf16 q, k, v in the layout of
    ``ops.flash_attention``: kv tiles of 128 columns (64 above Dh 128) in
    order; q.k^T in f32 (products of bf16 values are exact in f32); the
    scores in log2 units (scale * log2 e, one f32 constant) and -inf
    where masked; an online softmax in exp2 from m = -1e30; l the f32 row
    sum of p; p.v as p_hi.v + p_lo.v with p_hi = bf16(p) and p_lo =
    bf16(p - p_hi), each product in f32; out = acc / max(l, 1e-30),
    rounded to q's dtype.  The kernel skips kv tiles wholly masked for its
    128-row q block; here they give p = 0 and a correction of 1, the same
    values."""
    b, t, h, dh = q.shape
    s, kh = k.shape[1], k.shape[2]
    g = h // kh
    qf = q.float().transpose(1, 2)  # [B,H,T,Dh]
    kf = k.float().transpose(1, 2).repeat_interleave(g, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(g, dim=1)
    scale_log2 = torch.tensor(1.0 / math.sqrt(dh) * 1.4426950408889634,
                              dtype=torch.float32)
    kv_block = KV_BLOCK if dh <= 128 else KV_BLOCK // 2
    dev = q.device
    rows = torch.arange(t, device=dev)
    acc = torch.zeros((b, h, t, dh), dtype=torch.float32, device=dev)
    m = torch.full((b, h, t, 1), _NEG_INF, dtype=torch.float32, device=dev)
    lsum = torch.zeros((b, h, t, 1), dtype=torch.float32, device=dev)
    for k0 in range(0, s, kv_block):
        kb, vb = kf[:, :, k0:k0 + kv_block], vf[:, :, k0:k0 + kv_block]
        mask = _mask(rows, k0 + torch.arange(kb.shape[2], device=dev),
                     causal, window)
        sc = torch.matmul(qf, kb.transpose(-1, -2)) * scale_log2
        sc = torch.where(mask, sc, -math.inf)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.exp2(sc - m_new)
        corr = torch.exp2(m - m_new)
        lsum = lsum * corr + p.sum(dim=-1, keepdim=True)
        p_hi = p.bfloat16().float()
        p_lo = (p - p_hi).bfloat16().float()
        acc = acc * corr + torch.matmul(p_hi, vb) + torch.matmul(p_lo, vb)
        m = m_new
    out = acc / torch.clamp_min(lsum, 1e-30)
    return out.to(q.dtype).transpose(1, 2)


def attention_ref(q, k, v, *, causal=True, window=None):
    """Dense oracle.  q [B,H,T,Dh]; k,v [B,KH,S,Dh] -> [B,H,T,Dh] (GQA
    broadcast)."""
    b, h, t, dh = q.shape
    kh, s = k.shape[1], k.shape[2]
    g = h // kh
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    scores = torch.einsum("bhtd,bhsd->bhts", q, k).float() / math.sqrt(dh)
    mask = _mask(torch.arange(t, device=q.device),
                 torch.arange(s, device=q.device), causal, window)
    scores = torch.where(mask, scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhts,bhsd->bhtd", probs, v.float()).to(q.dtype)
