"""Mixture-of-Experts FFN with sort-based capacity dispatch, the
counterpart of ``src/repro/models/moe.py``.

* The router runs in f32; top-k keeps ``jax.lax.top_k``'s order (values
  descending, ties to the lower expert), through a stable descending
  sort (``torch.topk`` does not promise that order).
* Capacity C = ceil(tokens * top_k / E * capacity_factor), at least
  top_k; the pairs past an expert's capacity, in the stable order of
  the dispatch sort, are dropped (their gate weight becomes 0, the kept
  gates are not renormalized again), as the reference's ``mode="drop"``
  scatter drops them.
* Experts run batched over ``[E, C, d]`` buffers gathered by index;
  shared experts (DeepSeek-style) are a dense SwiGLU on every token.
* The Switch-style load-balance loss comes back beside the output.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0  # shared experts (each of size d_ff_expert)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


def moe_specs(cfg: MoEConfig):
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    specs = {
        "router": ParamSpec((d, e), ("embed", "experts")),
        "wg": ParamSpec((e, d, f), ("experts", "embed", "ffn")),
        "wu": ParamSpec((e, d, f), ("experts", "embed", "ffn")),
        "wd": ParamSpec((e, f, d), ("experts", "ffn", "embed")),
    }
    if cfg.n_shared:
        fs = cfg.n_shared * f
        specs["shared"] = {
            "wg": ParamSpec((d, fs), ("embed", "ffn")),
            "wu": ParamSpec((d, fs), ("embed", "ffn")),
            "wd": ParamSpec((fs, d), ("ffn", "embed")),
        }
    return specs


def _capacity(n_tokens: int, cfg: MoEConfig) -> int:
    c = math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(int(c), cfg.top_k)


def top_k(probs, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending order, equal values in index order."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_forward(params, cfg: MoEConfig, x):
    """x [B, T, d] -> (y [B, T, d], aux_loss f32 scalar)."""
    b, t, d = x.shape
    n = b * t
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(n, cfg)
    xf = x.reshape(n, d)
    dev = x.device

    logits = torch.einsum("nd,de->ne", xf, params["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gates, sel = top_k(probs, k)  # [n, k]
    gates = gates / torch.clamp_min(torch.sum(gates, dim=-1, keepdim=True),
                                    1e-9)

    # ---- load-balance auxiliary loss (Switch-style) -----------------------
    me = torch.mean(probs, dim=0)  # mean router prob per expert
    ce = torch.mean(torch.sum(F.one_hot(sel, e).float(), dim=1),
                    dim=0)  # fraction of tokens routed per expert
    aux = cfg.router_aux_weight * e * torch.sum(me * ce)

    # ---- sort-based dispatch ----------------------------------------------
    eid = sel.reshape(-1)  # [n*k]
    order = torch.argsort(eid, stable=True)  # group pairs by expert
    eid_sorted = eid[order]
    counts = torch.bincount(eid, minlength=e)
    starts = torch.cumsum(counts, dim=0) - counts  # exclusive cumsum
    pairs = torch.arange(n * k, device=dev)
    within = pairs - starts[eid_sorted]  # rank inside the expert
    # slot in the [E*C] buffer of each (token, choice), -1 if dropped
    slot_sorted = torch.where(within < cap, eid_sorted * cap + within, -1)
    slots = torch.empty_like(slot_sorted)
    slots[order] = slot_sorted  # order is a permutation: no collision
    kept = slots >= 0

    # the expert buffer [E*C, d]: each kept pair's token, row n (zeros)
    # in the slots no pair fills
    buf_src = torch.full((e * cap,), n, dtype=torch.int64, device=dev)
    buf_src[slots[kept]] = (pairs // k)[kept]
    xf_pad = torch.cat([xf, xf.new_zeros((1, d))], dim=0)
    buf = xf_pad[buf_src].reshape(e, cap, d)

    # ---- expert computation (batched over E) ------------------------------
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, params["wg"]))
    h = h * torch.einsum("ecd,edf->ecf", buf, params["wu"])
    out = torch.einsum("ecf,efd->ecd", h, params["wd"]).reshape(e * cap, d)

    # ---- combine ------------------------------------------------------------
    out_pad = torch.cat([out, out.new_zeros((1, d))], dim=0)
    picked = out_pad[torch.where(kept, slots, e * cap)]  # [n*k, d]
    w = torch.where(kept, gates.reshape(-1), 0.0).to(picked.dtype)
    y = torch.sum((picked * w[:, None]).reshape(n, k, d), dim=1)

    if cfg.n_shared:
        sp = params["shared"]
        hs = F.silu(xf @ sp["wg"]) * (xf @ sp["wu"])
        y = y + hs @ sp["wd"]
    return y.reshape(b, t, d), aux
