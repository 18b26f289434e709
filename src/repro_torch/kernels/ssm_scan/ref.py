"""Plain PyTorch versions of the SSD-scan kernel (K11).

``ssd_scan_plain`` repeats K11's arithmetic in f32 chunk after chunk, in
the order of the reference's Pallas kernel (``src/repro/kernels/ssm_scan/
kernel.py:27``), batched over (batch, head): ``cum = cumsum(alog)``, the
intra-chunk term ``(C Bᵀ ∘ L) X`` with ``L = where(s <= t, exp(cum_t -
cum_s), 0)``, plus ``exp(cum_t) · C_t h_in``, then ``h ← exp(cum_Q) h +
(B ∘ exp(cum_Q - cum_s))ᵀ X``.  It reads the model layout, as K11 does.
``ssd_scan_tc_model`` is the tensor-core K11's arithmetic
(``csrc/ssd_scan_sm90.cu``) in plain PyTorch: the chunk-parallel split
and the bf16 pieces of each product's f32 operand (``TC_PIECES``), for
the CPU tests.  ``ssd_scan_ref`` is the reference's per-step recurrence
oracle (``ref.py:12``), in its head-major layout.
"""
from __future__ import annotations

import torch


def ssd_scan_plain(x, alog, bmat, cmat, *, chunk):
    """x [B,T,NH,HD] (dt-scaled), alog [B,T,NH], bmat/cmat [B,T,NG,DS]
    (groups broadcast to heads, head h in group h // (NH/NG)); T % chunk
    == 0, zero initial state.  Returns y [B,T,NH,HD] in x's dtype and the
    final state h [B,NH,DS,HD] in f32."""
    b, t, nh, hd = x.shape
    ng, ds = bmat.shape[2], bmat.shape[3]
    rep = nh // ng
    xf = x.float().permute(0, 2, 1, 3)  # [B,NH,T,HD]
    al = alog.float().permute(0, 2, 1)  # [B,NH,T]
    bm = bmat.float().repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    cm = cmat.float().repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    h = torch.zeros((b, nh, ds, hd), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, t, chunk):
        xc, a = xf[:, :, c0:c0 + chunk], al[:, :, c0:c0 + chunk]
        bc, cc = bm[:, :, c0:c0 + chunk], cm[:, :, c0:c0 + chunk]
        cum = torch.cumsum(a, dim=-1)  # [B,NH,Q]
        lfac = torch.where(tri, torch.exp(cum[..., :, None]
                                          - cum[..., None, :]), 0.0)
        cb = torch.matmul(cc, bc.transpose(-1, -2))  # [B,NH,Q,Q]
        y = torch.matmul(cb * lfac, xc)
        y = y + torch.exp(cum)[..., None] * torch.matmul(cc, h)
        ys.append(y)
        bw = bc * torch.exp(cum[..., -1:] - cum)[..., None]
        h = torch.exp(cum[..., -1])[..., None, None] * h \
            + torch.matmul(bw.transpose(-1, -2), xc)
    y = torch.cat(ys, dim=2).to(x.dtype).permute(0, 2, 1, 3).contiguous()
    return y, h


# bf16 pieces of each f32 operand in the tensor-core K11: G = C Bᵀ ∘ L (in
# G X) and h_in (in C h_in) two, Bw = B ∘ exp(cum_Q - cum_s) (in Bwᵀ X)
# three; C Bᵀ has two bf16 operands and no split
TC_PIECES = {"g": 2, "h_in": 2, "bw": 3}


def bf16_pieces(v, n):
    """``v`` (f32) as ``n`` bf16 values (returned in f32) whose sum
    approximates it: each the bf16 rounding of what the earlier ones
    left, about 8 more significant bits a piece."""
    out = []
    for _ in range(n):
        p = v.to(torch.bfloat16).float()
        out.append(p)
        v = v - p
    return out


def _split_matmul(a, b, n, left):
    """``a @ b`` with the f32 operand (``a`` if ``left`` else ``b``) split
    in ``n`` bf16 pieces, one f32 product a piece, summed in f32."""
    if left:
        return sum(torch.matmul(p, b) for p in bf16_pieces(a, n))
    return sum(torch.matmul(a, p) for p in bf16_pieces(b, n))


def ssd_scan_tc_model(x, alog, bmat, cmat, *, chunk, pieces=None):
    """The tensor-core K11's decomposition, same contract as
    ``ssd_scan_plain``: (a) each chunk's own state S_c = Bwᵀ X and
    exp(cum_Q); (b) h_c = exp(cum_Q) h_{c-1} + S_c across the chunks, each
    chunk's h_in kept; (c) y = exp(cum_t) (C h_in) + (C Bᵀ ∘ L) X.  Each
    product's f32 operand goes in ``pieces`` bf16 pieces (default
    ``TC_PIECES``)."""
    pieces = TC_PIECES if pieces is None else pieces
    b, t, nh, hd = x.shape
    ng, ds = bmat.shape[2], bmat.shape[3]
    rep = nh // ng
    xf = x.float().permute(0, 2, 1, 3)  # [B,NH,T,HD]
    al = alog.float().permute(0, 2, 1)  # [B,NH,T]
    bm = bmat.float().repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    cm = cmat.float().repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    chunks = [slice(c0, c0 + chunk) for c0 in range(0, t, chunk)]
    cums = [torch.cumsum(al[:, :, c], dim=-1) for c in chunks]
    # (a) the chunks' own states, exp(cum_Q)
    states = [_split_matmul((bm[:, :, c] * torch.exp(
        cum[..., -1:] - cum)[..., None]).transpose(-1, -2), xf[:, :, c],
        pieces["bw"], left=True) for c, cum in zip(chunks, cums)]
    # (b) the pass across the chunks
    h = torch.zeros((b, nh, ds, hd), dtype=torch.float32, device=x.device)
    h_in = []
    for s, cum in zip(states, cums):
        h_in.append(h)
        h = torch.exp(cum[..., -1])[..., None, None] * h + s
    # (c) the outputs
    ys = []
    for c, cum, hc in zip(chunks, cums, h_in):
        cc = cm[:, :, c]
        g = torch.where(tri, torch.matmul(cc, bm[:, :, c].transpose(-1, -2))
                        * torch.exp(cum[..., :, None] - cum[..., None, :]),
                        0.0)
        y = torch.exp(cum)[..., None] * _split_matmul(cc, hc,
                                                      pieces["h_in"],
                                                      left=False)
        ys.append(y + _split_matmul(g, xf[:, :, c], pieces["g"], left=True))
    y = torch.cat(ys, dim=2).to(x.dtype).permute(0, 2, 1, 3).contiguous()
    return y, h


def ssd_scan_ref(x, alog, bmat, cmat):
    """Per-step recurrence h_t = exp(alog_t) h_{t-1} + B_t ⊗ x_t,
    y_t = C_t · h_t.  x [B,NH,T,HD]; alog [B,NH,T]; bmat/cmat
    [B,NH,T,DS].  Returns y in x's dtype and h_final f32 [B,NH,DS,HD]."""
    b, nh, t, hd = x.shape
    ds = bmat.shape[-1]
    h = torch.zeros((b, nh, ds, hd), dtype=torch.float32, device=x.device)
    xf, af, bf, cf = (a.float() for a in (x, alog, bmat, cmat))
    ys = []
    for i in range(t):
        h = torch.exp(af[:, :, i])[..., None, None] * h + torch.einsum(
            "bhs,bhd->bhsd", bf[:, :, i], xf[:, :, i])
        ys.append(torch.einsum("bhs,bhsd->bhd", cf[:, :, i], h))
    return torch.stack(ys, dim=2).to(x.dtype), h
