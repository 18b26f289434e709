"""xLSTM blocks: mLSTM (matrix memory, parallel-trainable) and sLSTM
(scalar memory, true recurrence), Beck et al., arXiv:2405.04517: the
counterpart of ``src/repro/models/xlstm.py``.

mLSTM's prefill is the chunkwise-parallel form with log-space gate
stabilisation; its decode is the O(1) recurrent form with the matrix
memory C [B, H, Dh, Dh].  sLSTM is sequential by construction (its gates
depend on h_{t-1}): the prefill loops over time where the reference runs
``lax.scan``.  Each ``astype`` of the reference sits in the same place,
so a bf16 config rounds where the reference's does; in particular the
mLSTM decode multiplies the bf16 cache by the f32 gates, so from its
first step the cache holds ``c`` and ``n`` in f32, as the reference's
does (each step returns new ``c``, ``n`` and ``m``; the sLSTM cache
keeps its dtypes).

Both are pre-norm residual blocks with an input up-projection (factor 2)
and a gated down-projection (no separate FFN).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec

_SENTINEL = -1e30  # finite: exp(-inf) would NaN the backward pass


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    d_model: int
    n_heads: int = 4
    expand: int = 2

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_heads


def _inv_sqrt_dim(q, dh: int):
    """``q / dh ** 0.5`` as jax divides by a Python float: the divisor
    rounded to q's dtype first (bf16 holds sqrt(384) as 19.625)."""
    return q / torch.tensor(dh ** 0.5, dtype=q.dtype, device=q.device)


def _out_norm(params, h, dtype):
    """The blocks' RMS norm over the inner width: f32 statistics, the
    result cast to the activations' dtype, then scaled."""
    var = torch.mean(torch.square(h.float()), dim=-1, keepdim=True)
    return (h * torch.rsqrt(var + 1e-6)).to(dtype) * params["norm"]


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_specs(cfg: XLSTMConfig):
    d, di, nh, dh = cfg.d_model, cfg.d_inner, cfg.n_heads, cfg.head_dim
    return {
        "w_up": ParamSpec((d, 2 * di), ("embed", "ssm_inner")),  # x | gate
        "wq": ParamSpec((di, nh, dh), ("ssm_inner", "heads", "head")),
        "wk": ParamSpec((di, nh, dh), ("ssm_inner", "heads", "head")),
        "wv": ParamSpec((di, nh, dh), ("ssm_inner", "heads", "head")),
        "w_i": ParamSpec((di, nh), ("ssm_inner", "heads")),  # input gate
        "w_f": ParamSpec((di, nh), ("ssm_inner", "heads")),  # forget gate
        "b_i": ParamSpec((nh,), ("heads",), init="zeros"),
        "b_f": ParamSpec((nh,), ("heads",), init="ones"),
        "norm": ParamSpec((di,), ("ssm_inner",), init="ones"),
        "w_down": ParamSpec((di, d), ("ssm_inner", "embed")),
    }


def _mlstm_gates(params, xi):
    """Raw (pre-activation) gates from the inner activations, f32
    [B, T, nh]."""
    itil = torch.einsum("bti,ih->bth", xi, params["w_i"]) + params["b_i"]
    ftil = torch.einsum("bti,ih->bth", xi, params["w_f"]) + params["b_f"]
    return itil.float(), ftil.float()


def _mlstm_chunk(carry, qn, kn, vn, ii, lf, tri):
    """One chunk of the chunkwise form: the outputs ``h [b, qc, nh, dh]``
    and the memory (C, n, m) carried to the chunk's end."""
    c0, n0, m0 = carry  # [b,nh,dh,dh], [b,nh,dh], [b,nh]
    fcum = torch.cumsum(lf, dim=1)  # F_t [b,qc,nh]
    # intra log-weights D[t,s] = F_t - F_s + i_s  (s <= t)
    dmat = fcum[:, :, None, :] - fcum[:, None, :, :] + ii[:, None, :, :]
    dmat = torch.where(tri[None, :, :, None], dmat, _SENTINEL)
    inter_log = m0[:, None, :] + fcum  # [b,qc,nh]
    m_t = torch.maximum(torch.amax(dmat, dim=2), inter_log)
    m_t = torch.clamp_min(m_t, _SENTINEL)
    dexp = torch.exp(dmat - m_t[:, :, None, :])  # [b,qc,qc,nh]
    w_inter = torch.exp(inter_log - m_t)  # [b,qc,nh]

    sc = torch.einsum("bthk,bshk->btsh", qn, kn).float() * dexp
    num = torch.einsum("btsh,bshk->bthk", sc.to(vn.dtype), vn)
    num = num + w_inter[..., None].to(vn.dtype) * torch.einsum(
        "bthk,bhlk->bthl", qn, c0)
    den = torch.sum(sc, dim=2) + w_inter * torch.einsum(
        "bthk,bhk->bth", qn, n0).float()
    # the guard's exponent clamped: for very negative m_t exp(-m_t)
    # overflows f32 and NaNs the backward pass
    den = torch.maximum(torch.abs(den),
                        torch.exp(torch.clamp_max(-m_t, 30.0)))
    h = num / den[..., None].to(vn.dtype)

    # ---- state update to the chunk's end ---------------------------------
    f_all = fcum[:, -1, :]  # F_Q
    m1 = torch.maximum(m0 + f_all, torch.amax(f_all[:, None, :] - fcum + ii,
                                              dim=1))
    w_old = torch.exp(m0 + f_all - m1)  # [b,nh]
    w_new = torch.exp(f_all[:, None, :] - fcum + ii - m1[:, None, :])
    c1 = c0 * w_old[..., None, None].to(c0.dtype) + torch.einsum(
        "bsh,bshk,bshl->bhkl", w_new.to(vn.dtype), vn, kn).to(c0.dtype)
    n1 = n0 * w_old[..., None].to(n0.dtype) + torch.einsum(
        "bsh,bshk->bhk", w_new.to(kn.dtype), kn).to(n0.dtype)
    return (c1, n1, m1), h.to(vn.dtype)


def mlstm_forward(params, cfg: XLSTMConfig, x, chunk=256):
    """Chunkwise-parallel form (the official xLSTM chunked schedule):
    within a chunk the quadratic stabilised-gate product, across chunks
    the matrix memory (C, n, m) carried by a loop; O(chunk^2) live
    memory instead of O(T^2).  T is padded with zeros to a multiple of
    the chunk, the input gate with the sentinel.  x [B,T,d] ->
    [B,T,d]."""
    b, t, _ = x.shape
    nh, dh = cfg.n_heads, cfg.head_dim
    up = torch.einsum("btd,de->bte", x, params["w_up"])
    xi, gate = torch.chunk(up, 2, dim=-1)
    q = _inv_sqrt_dim(torch.einsum("bti,ihk->bthk", xi, params["wq"]), dh)
    k = torch.einsum("bti,ihk->bthk", xi, params["wk"])
    v = torch.einsum("bti,ihk->bthk", xi, params["wv"])
    itil, ftil = _mlstm_gates(params, xi)
    logf = F.logsigmoid(ftil)  # [b,t,nh]

    qc = min(chunk, t)
    pad = (-t) % qc
    if pad:
        # zero contribution: the input gate at the sentinel, log f = 0
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        logf = F.pad(logf, (0, 0, 0, pad))
        itil = F.pad(itil, (0, 0, 0, pad), value=_SENTINEL)
    tri = torch.tril(torch.ones((qc, qc), dtype=torch.bool,
                                device=x.device))
    carry = (torch.zeros((b, nh, dh, dh), dtype=v.dtype, device=x.device),
             torch.zeros((b, nh, dh), dtype=v.dtype, device=x.device),
             torch.full((b, nh), _SENTINEL, dtype=torch.float32,
                        device=x.device))
    hs = []
    for s0 in range(0, t + pad, qc):
        sl = slice(s0, s0 + qc)
        carry, h = _mlstm_chunk(carry, q[:, sl], k[:, sl], v[:, sl],
                                itil[:, sl], logf[:, sl], tri)
        hs.append(h)
    h = torch.cat(hs, dim=1).reshape(b, t + pad, cfg.d_inner)[:, :t]
    h = _out_norm(params, h, x.dtype) * F.silu(gate)
    return torch.einsum("bti,id->btd", h, params["w_down"])


def mlstm_init_cache(cfg: XLSTMConfig, batch: int, dtype, device=None):
    nh, dh = cfg.n_heads, cfg.head_dim
    return {
        "c": torch.zeros((batch, nh, dh, dh), dtype=dtype, device=device),
        "n": torch.zeros((batch, nh, dh), dtype=dtype, device=device),
        "m": torch.full((batch, nh), _SENTINEL, dtype=torch.float32,
                        device=device),  # stabiliser
    }


def mlstm_decode(params, cfg: XLSTMConfig, cache, x, pos):
    """One recurrent step.  Returns ``(y, {"c", "n", "m"})``, new tensors:
    ``c`` and ``n`` come out in f32 (the cache times the f32 gates)."""
    del pos
    b = x.shape[0]
    dh = cfg.head_dim
    up = torch.einsum("btd,de->bte", x, params["w_up"])
    xi, gate = torch.chunk(up, 2, dim=-1)
    q = _inv_sqrt_dim(torch.einsum("bti,ihk->bhk", xi, params["wq"]), dh)
    k = torch.einsum("bti,ihk->bhk", xi, params["wk"])
    v = torch.einsum("bti,ihk->bhk", xi, params["wv"])
    itil, ftil = _mlstm_gates(params, xi)
    itil, ftil = itil[:, 0], ftil[:, 0]  # [b, nh]

    logf = F.logsigmoid(ftil)
    m_new = torch.maximum(logf + cache["m"], itil)
    fgate = torch.exp(logf + cache["m"] - m_new)[..., None]
    igate = torch.exp(itil - m_new)[..., None]
    c = cache["c"] * fgate[..., None] + igate[..., None] * torch.einsum(
        "bhk,bhl->bhkl", v, k)
    n = cache["n"] * fgate + igate * k
    num = torch.einsum("bhkl,bhl->bhk", c, q.to(c.dtype))
    den = torch.maximum(
        torch.abs(torch.einsum("bhl,bhl->bh", n, q.to(n.dtype)))[..., None],
        torch.exp(-m_new)[..., None])
    h = (num / den).reshape(b, 1, cfg.d_inner)
    h = _out_norm(params, h, x.dtype) * F.silu(gate)
    y = torch.einsum("bti,id->btd", h, params["w_down"])
    return y, {"c": c, "n": n, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_specs(cfg: XLSTMConfig):
    # head-major and replicated in the reference (a true recurrence); the
    # axis names are its
    d, di, nh, dh = cfg.d_model, cfg.d_inner, cfg.n_heads, cfg.head_dim
    return {
        "w_in": ParamSpec((d, nh, 4 * dh), ("embed", None, None)),  # z,i,f,o
        "r": ParamSpec((nh, dh, 4 * dh), (None, None, None)),
        "b": ParamSpec((nh, 4 * dh), (None, None), init="zeros"),
        "norm": ParamSpec((di,), (None,), init="ones"),
        "w_down": ParamSpec((di, d), (None, "embed")),
    }


def slstm_init_cache(cfg: XLSTMConfig, batch: int, dtype, device=None):
    shape = (batch, cfg.n_heads, cfg.head_dim)
    return {
        "c": torch.zeros(shape, dtype=dtype, device=device),
        "n": torch.ones(shape, dtype=dtype, device=device),
        "h": torch.zeros(shape, dtype=dtype, device=device),
        "m": torch.zeros(shape, dtype=torch.float32, device=device),
    }


def _slstm_cell(params, state, wx_t):
    """One recurrence step.  wx_t [B, nh, 4*dh] (the input's part)."""
    rec = torch.einsum("bhk,hkl->bhl", state["h"], params["r"])
    raw = wx_t + rec + params["b"]
    zt, it, ft, ot = torch.chunk(raw, 4, dim=-1)
    zt = torch.tanh(zt)
    ot = torch.sigmoid(ot)
    it = it.float()
    logf = F.logsigmoid(ft.float())
    m_new = torch.maximum(logf + state["m"], it)
    i_s = torch.exp(it - m_new).to(zt.dtype)
    f_s = torch.exp(logf + state["m"] - m_new).to(zt.dtype)
    c = f_s * state["c"] + i_s * zt
    n = f_s * state["n"] + i_s
    h = ot * c / torch.clamp_min(torch.abs(n), 1e-6)
    return {"c": c, "n": n, "h": h, "m": m_new}


def slstm_forward(params, cfg: XLSTMConfig, x):
    """The recurrence, one step a token.  x [B,T,d] -> [B,T,d]."""
    b, t, _ = x.shape
    wx = torch.einsum("btd,dhe->bthe", x, params["w_in"])  # [b,t,nh,4dh]
    state = slstm_init_cache(cfg, b, x.dtype, x.device)
    hs = []
    for i in range(t):
        state = _slstm_cell(params, state, wx[:, i])
        hs.append(state["h"])
    h = torch.stack(hs, dim=1).reshape(b, t, cfg.d_inner)
    h = _out_norm(params, h, x.dtype)
    return torch.einsum("bti,id->btd", h, params["w_down"])


def slstm_decode(params, cfg: XLSTMConfig, cache, x, pos):
    """One recurrence step; returns ``(y, the new state)``."""
    del pos
    b = x.shape[0]
    wx = torch.einsum("btd,dhe->bthe", x, params["w_in"])[:, 0]
    st = _slstm_cell(params, cache, wx)
    h = _out_norm(params, st["h"].reshape(b, 1, cfg.d_inner), x.dtype)
    return torch.einsum("bti,id->btd", h, params["w_down"]), st
