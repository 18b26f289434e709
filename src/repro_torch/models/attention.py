"""GQA attention (with qk-norm / QKV-bias / sliding-window options) and
DeepSeek-style MLA (multi-head latent attention), the counterpart of
``src/repro/models/attention.py``.

Both expose:
    *_specs(cfg)                               parameter ParamSpec tree
    *_forward(params, cfg, x, positions)       full-sequence (prefill)
    *_init_cache(cfg, batch, max_len, ...)     decode cache (zeros)
    *_decode(params, cfg, cache, x, pos)       one-token decode

Sliding-window decode uses a ring-buffer cache of length ``window`` with
an absolute-position side array (slots with pos_id < 0 are invalid).
Unlike the reference, which returns a new cache, the decodes write the
new token's entries into the cache in place (no copy of the cache per
token).  ``gqa_forward(..., kv=memory)`` is the encoder-decoder's
cross-attention.  With ``seq_shard_axis`` set, the blockwise path splits
the query rows over that axis of the ambient mesh (``launch.mesh.use_mesh``)
and gathers the output back (``_seq_sharded_blockwise``).

Tensor parallelism (``launch.tp``): GQA reads from ``wq``'s shape whether
it holds the rank's heads (``sharding.shard_params``).  wq, wk and wv are
column-parallel over heads and kv_heads, wo row-parallel, its partials
summed over the "model" axis (``reduce``; a parallel block sums them with
its FFN's).  Where the axis divides the heads but not the KV heads (8 on
16), every rank computes all KV heads and its query heads read their own
groups' (``_rank_kv``); where it divides neither, attention runs whole on
every rank.  The decode cache holds the rank's KV heads.  In training
the block's input enters the region through ``tp.enter`` and the leaves
held whole that each rank uses on its own heads (the qk-norm scales, and
wk/wv and their biases where the KV heads are whole) sum their gradients
over the axis (``tp.sum_grad``, ``_region_params``).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.launch import tp
from repro_torch.models.common import ParamSpec, apply_rope, rmsnorm

_NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: int | None = None  # None = full causal
    causal: bool = True  # False for encoder self-attention
    # the ambient mesh's axis that splits the query rows on the blockwise
    # path (None: unsharded)
    seq_shard_axis: str | None = None


def gqa_specs(cfg: AttnConfig):
    d, h, kh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    specs = {
        "wq": ParamSpec((d, h, dh), ("embed", "heads", "head")),
        "wk": ParamSpec((d, kh, dh), ("embed", "kv_heads", "head")),
        "wv": ParamSpec((d, kh, dh), ("embed", "kv_heads", "head")),
        "wo": ParamSpec((h, dh, d), ("heads", "head", "embed")),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((h, dh), ("heads", "head"), init="zeros")
        specs["bk"] = ParamSpec((kh, dh), ("kv_heads", "head"), init="zeros")
        specs["bv"] = ParamSpec((kh, dh), ("kv_heads", "head"), init="zeros")
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((dh,), ("head",), init="ones")
        specs["k_norm"] = ParamSpec((dh,), ("head",), init="ones")
    return specs


def _project_qkv(params, cfg: AttnConfig, x, positions):
    q = torch.einsum("btd,dhk->bthk", x, params["wq"])
    k = torch.einsum("btd,dhk->bthk", x, params["wk"])
    v = torch.einsum("btd,dhk->bthk", x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if cfg.qk_norm:
        q = rmsnorm({"scale": params["q_norm"]}, q)
        k = rmsnorm({"scale": params["k_norm"]}, k)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def heads_sharded(params, cfg: AttnConfig) -> bool:
    """Whether ``params`` hold the rank's query heads only."""
    return tp.sharded(params["wq"].shape[-2], cfg.n_heads)


def _rank_kv(cfg: AttnConfig, q_heads: int, k, v):
    """The K/V heads that the rank's ``q_heads`` query heads read, where
    the query heads are sharded and ``k``/``v`` hold every KV head: a
    slice of whole groups (the rank's heads span whole groups, or lie in
    one), else one KV head per query head (a gather).  Otherwise ``k``
    and ``v`` as they are."""
    h, kh = cfg.n_heads, cfg.n_kv_heads
    if q_heads == h or k.shape[2] != kh:
        return k, v
    g = h // kh
    h0 = tp.rank() * q_heads
    if q_heads % g == 0 or g % q_heads == 0:
        sl = slice(h0 // g, h0 // g + max(q_heads // g, 1))
        return k[:, :, sl], v[:, :, sl]
    idx = torch.arange(h0, h0 + q_heads, device=k.device) // g
    return k.index_select(2, idx), v.index_select(2, idx)


def _region_params(params, cfg: AttnConfig):
    """``params`` for a forward on the rank's query heads under autograd:
    the leaves held whole whose gradient on a rank is a partial (the
    qk-norm scales; wk, wv, bk, bv where every rank computes all KV
    heads and reads only its groups') wrapped in ``tp.sum_grad``."""
    if not torch.is_grad_enabled():
        return params
    whole_kv = params["wk"].shape[-2] == cfg.n_kv_heads
    keys = ("q_norm", "k_norm") + (("wk", "wv", "bk", "bv") if whole_kv
                                   else ())
    out = {k: params[k] for k in params.keys()}
    for k in keys:
        if k in out:
            out[k] = tp.sum_grad(out[k])
    return out


def _out_proj(params, out, partial: bool, reduce: bool):
    """``out [B,T,H,Dh]`` through wo.  With the rank's heads
    (``partial``) the product is row-parallel: its partial
    (``tp.partial_mm``), summed over the axis where ``reduce``."""
    if not partial:
        return torch.einsum("bthk,hkd->btd", out, params["wo"])
    wo = params["wo"]
    y = tp.partial_mm(out.reshape(*out.shape[:2], -1),
                      wo.reshape(-1, wo.shape[-1]))
    return tp.all_reduce(y, out.dtype) if reduce else y


def sdpa(q, k, v, mask):
    """Grouped scaled-dot-product attention.

    q [B,T,H,Dh]; k,v [B,S,KH,Dh]; mask broadcastable to [B,1,1,T,S] or
    None.
    """
    b, t, h, dh = q.shape
    kh = k.shape[2]
    g = h // kh
    qg = q.reshape(b, t, kh, g, dh)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k).float()
    scores = scores / math.sqrt(dh)
    if mask is not None:
        scores = torch.where(mask, scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v)
    return out.reshape(b, t, h, dh)


def sdpa_blockwise(q, k, v, *, causal=True, window=None,
                   q_block=512, kv_block=1024, q_offset=0):
    """Flash-structured attention in plain PyTorch: online softmax over
    KV blocks for each Q block, O(block^2) live memory instead of O(T*S).
    With a sliding window only the KV blocks that hold a key the window
    admits are touched (non-causal: every block from the window's first
    key on); without one every KV block is visited and masked.  (The
    reference walks back ceil(window/kv_block)+1 blocks from the Q block's
    own index, which skips or repeats KV blocks when q_block != kv_block.)
    ``q_offset``: the absolute position of q's first row (a sequence
    shard's), against keys at positions 0..S-1."""
    b, t, h, dh = q.shape
    s, kh, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = h // kh
    q_block, kv_block = min(q_block, t), min(kv_block, s)
    if t % q_block or s % kv_block:
        raise ValueError(f"T={t}, S={s} must be multiples of the blocks "
                         f"({q_block}, {kv_block})")
    nq, nk = t // q_block, s // kv_block
    scale = 1.0 / math.sqrt(dh)
    dev = q.device
    outs = []
    for iq in range(nq):
        qc = q[:, iq * q_block:(iq + 1) * q_block].reshape(
            b, q_block, kh, g, dh)
        acc = torch.zeros((b, q_block, kh, g, dv), dtype=torch.float32,
                          device=dev)
        m = torch.full((b, q_block, kh, g), -math.inf, device=dev)
        lsum = torch.zeros((b, q_block, kh, g), device=dev)
        q0 = q_offset + iq * q_block
        qpos = q0 + torch.arange(q_block, device=dev)
        first, last = 0, nk - 1
        if window is not None:
            first = max(q0 - window + 1, 0) // kv_block
            if causal:
                last = min((q0 + q_block - 1) // kv_block, last)
        for ik in range(first, last + 1):
            kc = k[:, ik * kv_block:(ik + 1) * kv_block]
            vc = v[:, ik * kv_block:(ik + 1) * kv_block]
            kpos = ik * kv_block + torch.arange(kv_block, device=dev)
            sc = (torch.einsum("bqkgd,bskd->bqkgs", qc, kc) * scale).float()
            msk = torch.ones((q_block, kv_block), dtype=torch.bool,
                             device=dev)
            if causal:
                msk &= qpos[:, None] >= kpos[None, :]
            if window is not None:
                msk &= (qpos[:, None] - kpos[None, :]) < window
            msk5 = msk[None, :, None, None, :]
            sc = torch.where(msk5, sc, _NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            p = torch.where(msk5, p, 0.0)
            corr = torch.exp(m - m_new)
            lsum = lsum * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqkgs,bskd->bqkgd", p.to(vc.dtype), vc).float()
            m = m_new
        out = acc / torch.clamp_min(lsum[..., None], 1e-30)
        outs.append(out.to(q.dtype).reshape(b, q_block, h, dv))
    return torch.cat(outs, dim=1)


def causal_mask(t, s, window=None, offset=0, device=None):
    """[1,1,1,t,s] boolean mask.  offset = (absolute pos of q_0) - (of k_0)."""
    qi = torch.arange(t, device=device)[:, None] + offset
    ki = torch.arange(s, device=device)[None, :]
    m = qi >= ki
    if window is not None:
        m &= (qi - ki) < window
    return m[None, None, None]


BLOCKWISE_THRESHOLD = 2048  # switch to flash-structured attention above this


def _seq_sharded_blockwise(q, k, v, *, causal, window, axis):
    """Sequence-parallel attention over ``axis`` of the ambient mesh: the
    rank at position p computes query rows ``[p·T/n, (p+1)·T/n)`` with
    ``sdpa_blockwise`` at that offset (K/V whole on every rank), then the
    rows are ``all_gather``ed along T, since torch has no lazy re-shard.
    T not divisible by n: the unsharded path, as the reference."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import axes_of, current_mesh

    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError(
            f"seq_shard_axis={axis!r} needs an ambient mesh "
            "(launch.mesh.use_mesh)")
    n = axes_of(mesh).shape[axis]
    t = q.shape[1]
    if t % n:
        return sdpa_blockwise(q, k, v, causal=causal, window=window)
    tl = t // n
    p = mesh.get_local_rank(axis)
    local = sdpa_blockwise(q[:, p * tl:(p + 1) * tl], k, v, causal=causal,
                           window=window, q_offset=p * tl).contiguous()
    parts = [torch.empty_like(local) for _ in range(n)]
    dist.all_gather(parts, local, group=mesh.get_group(axis))
    return torch.cat(parts, dim=1)


def gqa_forward(params, cfg: AttnConfig, x, positions, *, kv=None,
                kv_positions=None, use_flash=False, impl="auto",
                reduce=True):
    """Full-sequence attention.  ``kv`` [B, S, d] makes it cross-attention
    (the encoder-decoder's): q from ``x``, k/v from ``kv``, the biases
    where ``qkv_bias`` is set, no RoPE, no qk-norm, never causal.
    ``kv_positions`` is accepted and unused, as in the reference.

    ``use_flash`` runs K10 on self-attention (``kv`` None) where
    ``flash_ops.supported`` admits the shapes, as the reference does.
    Otherwise ``impl``: "dense", "blockwise", or "auto" (blockwise when
    max(T, S) > BLOCKWISE_THRESHOLD).

    With the rank's heads (tensor parallelism) the output is summed over
    the "model" axis; ``reduce=False`` returns the rank's partial instead
    (in f32 for 16-bit activations on the card).  ``x`` then enters the
    region through ``tp.enter`` (a no-op outside autograd)."""
    del kv_positions
    partial = heads_sharded(params, cfg)
    if partial:
        x = tp.enter(x)
        params = _region_params(params, cfg)
    if kv is None:
        q, k, v = _project_qkv(params, cfg, x, positions)
        k, v = _rank_kv(cfg, q.shape[2], k, v)
        causal = cfg.causal
    else:
        q = torch.einsum("btd,dhk->bthk", x, params["wq"])
        k = torch.einsum("bsd,dhk->bshk", kv, params["wk"])
        v = torch.einsum("bsd,dhk->bshk", kv, params["wv"])
        if cfg.qkv_bias:
            q = q + params["bq"]
            k, v = k + params["bk"], v + params["bv"]
        causal = False
    if use_flash and kv is None:
        from repro_torch.kernels.flash_attention import ops as flash_ops

        if flash_ops.supported(q, k, v, None):
            out = flash_ops.flash_attention(
                q, k.contiguous(), v.contiguous(), causal=causal,
                window=cfg.sliding_window)
            return _out_proj(params, out, partial, reduce)
    if impl not in ("dense", "blockwise", "auto"):
        raise ValueError(f"impl {impl!r}: dense | blockwise | auto")
    if impl == "blockwise" or (
            impl == "auto"
            and max(q.shape[1], k.shape[1]) > BLOCKWISE_THRESHOLD):
        if cfg.seq_shard_axis is not None and kv is None:
            out = _seq_sharded_blockwise(q, k, v, causal=causal,
                                         window=cfg.sliding_window,
                                         axis=cfg.seq_shard_axis)
        else:
            out = sdpa_blockwise(q, k, v, causal=causal,
                                 window=cfg.sliding_window)
    else:
        # no mask, so no window, without causality (as the reference)
        mask = (causal_mask(q.shape[1], k.shape[1], cfg.sliding_window,
                            device=q.device) if causal else None)
        out = sdpa(q, k, v, mask)
    return _out_proj(params, out, partial, reduce)


# ---------------------------------------------------------------------------
# Decode cache (full-length or sliding-window ring buffer)
# ---------------------------------------------------------------------------


def gqa_cache_len(cfg: AttnConfig, max_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, max_len)
    return max_len


def gqa_init_cache(cfg: AttnConfig, batch: int, max_len: int, dtype,
                   device=None, kv_heads=None):
    """The zero cache; ``kv_heads``: the rank's KV heads (default all)."""
    s = gqa_cache_len(cfg, max_len)
    kh, dh = kv_heads or cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, s, kh, dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, s, kh, dh), dtype=dtype, device=device),
        "pos_ids": torch.full((s,), -1, dtype=torch.int32, device=device),
    }


def gqa_decode(params, cfg: AttnConfig, cache, x, pos: int, reduce=True):
    """One-token decode.  x [B,1,d]; pos the (int) position of x.  Writes
    the token's key and value into ``cache`` in place; returns
    ``(y, cache)`` (``reduce`` as in ``gqa_forward``)."""
    positions = torch.full((1, 1), pos, device=x.device)
    q, k, v = _project_qkv(params, cfg, x, positions)
    s = cache["k"].shape[1]
    slot = pos % s  # == pos for full-length caches
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    cache["pos_ids"][slot] = pos
    pos_ids = cache["pos_ids"]
    valid = (pos_ids >= 0) & (pos_ids <= pos)
    kc, vc = _rank_kv(cfg, q.shape[2], cache["k"], cache["v"])
    out = sdpa(q, kc, vc, valid[None, None, None, None, :])
    return _out_proj(params, out, heads_sharded(params, cfg), reduce), cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): low-rank latent KV cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0
    sliding_window: int | None = None


def mla_specs(cfg: MLAConfig):
    d, h, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    return {
        "wq": ParamSpec((d, h, qk), ("embed", "heads", "head")),
        "w_dkv": ParamSpec((d, r), ("embed", None)),
        "kv_norm": ParamSpec((r,), (None,), init="ones"),
        "w_uk": ParamSpec((r, h, cfg.qk_nope_dim), (None, "heads", "head")),
        "w_uv": ParamSpec((r, h, cfg.v_head_dim), (None, "heads", "head")),
        "w_kr": ParamSpec((d, cfg.qk_rope_dim), ("embed", None)),
        "wo": ParamSpec((h, cfg.v_head_dim, d), ("heads", "head", "embed")),
    }


def _mla_common(params, cfg: MLAConfig, x, positions):
    """The latent ``c [B, T, r]`` (through ``kv_norm``), the shared roped
    key ``k_rope [B, T, 1, rope]`` and the query's two parts."""
    c = torch.einsum("btd,dr->btr", x, params["w_dkv"])
    c = rmsnorm({"scale": params["kv_norm"]}, c)
    k_rope = torch.einsum("btd,de->bte", x, params["w_kr"])[:, :, None, :]
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)
    q = torch.einsum("btd,dhk->bthk", x, params["wq"])
    q_nope = q[..., :cfg.qk_nope_dim]
    q_rope = apply_rope(q[..., cfg.qk_nope_dim:], positions, cfg.rope_theta)
    return c, k_rope, q_nope, q_rope


def _mla_scale(cfg: MLAConfig) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)


def mla_forward(params, cfg: MLAConfig, x, positions, use_flash=False):
    """Full-sequence MLA.  ``use_flash`` is ignored, as the reference
    ignores it (no MLA flash variant).  Up to BLOCKWISE_THRESHOLD tokens
    the two score terms are added in the activation dtype, then cast to
    f32 (so in bf16 the sum is rounded first, as the reference's is);
    past it the shared rope key is broadcast over the heads and
    concatenated with the per-head keys (192-wide keys beside 128-wide
    values) for ``sdpa_blockwise``.  With a sliding window that branch is
    held to the dense path, not to the reference's blockwise walk, which
    skips or repeats KV blocks (``sdpa_blockwise``; ROADMAP Queue 3)."""
    del use_flash
    c, k_rope, q_nope, q_rope = _mla_common(params, cfg, x, positions)
    k_nope = torch.einsum("btr,rhk->bthk", c, params["w_uk"])
    v = torch.einsum("btr,rhk->bthk", c, params["w_uv"])
    b, t = x.shape[0], x.shape[1]
    if t > BLOCKWISE_THRESHOLD:
        k_eff = torch.cat([k_nope, k_rope.expand(b, t, cfg.n_heads,
                                                 cfg.qk_rope_dim)], dim=-1)
        q_eff = torch.cat([q_nope, q_rope], dim=-1)
        out = sdpa_blockwise(q_eff, k_eff, v, causal=True,
                             window=cfg.sliding_window)
        return torch.einsum("bthk,hkd->btd", out, params["wo"])
    scores = (torch.einsum("bthk,bshk->bhts", q_nope, k_nope)
              + torch.einsum("bthk,bsk->bhts", q_rope, k_rope[:, :, 0])
              ).float() * _mla_scale(cfg)
    mask = causal_mask(t, t, cfg.sliding_window, device=x.device)[:, :, 0]
    scores = torch.where(mask, scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhts,bshk->bthk", probs, v)
    return torch.einsum("bthk,hkd->btd", out, params["wo"])


def mla_cache_len(cfg: MLAConfig, max_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, max_len)
    return max_len


def mla_init_cache(cfg: MLAConfig, batch: int, max_len: int, dtype,
                   device=None):
    s = mla_cache_len(cfg, max_len)
    return {
        "c": torch.zeros((batch, s, cfg.kv_lora_rank), dtype=dtype,
                         device=device),
        "k_rope": torch.zeros((batch, s, cfg.qk_rope_dim), dtype=dtype,
                              device=device),
        "pos_ids": torch.full((s,), -1, dtype=torch.int32, device=device),
    }


def mla_decode(params, cfg: MLAConfig, cache, x, pos: int):
    """Absorbed-matmul decode: the scores against the latent cache itself
    (q_nope absorbed through w_uk, the output through w_uv), so a step's
    work and cache traffic scale with kv_lora_rank, not the heads.
    Writes the token's latent and rope key into ``cache`` in place (slot
    ``pos % S``); returns ``(y, cache)``."""
    positions = torch.full((1, 1), pos, device=x.device)
    c, k_rope, q_nope, q_rope = _mla_common(params, cfg, x, positions)
    s = cache["c"].shape[1]
    slot = pos % s  # == pos for full-length caches
    cache["c"][:, slot] = c[:, 0]
    cache["k_rope"][:, slot] = k_rope[:, 0, 0]
    cache["pos_ids"][slot] = pos
    cc, ckr, pos_ids = cache["c"], cache["k_rope"], cache["pos_ids"]
    q_lat = torch.einsum("bthk,rhk->bthr", q_nope, params["w_uk"])
    scores = (torch.einsum("bthr,bsr->bhts", q_lat, cc)
              + torch.einsum("bthk,bsk->bhts", q_rope, ckr)
              ).float() * _mla_scale(cfg)
    valid = (pos_ids >= 0) & (pos_ids <= pos)
    scores = torch.where(valid[None, None, None], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out_lat = torch.einsum("bhts,bsr->bthr", probs, cc)
    out = torch.einsum("bthr,rhk->bthk", out_lat, params["w_uv"])
    return torch.einsum("bthk,hkd->btd", out, params["wo"]), cache
