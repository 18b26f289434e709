"""Encoder-decoder transformer (SeamlessM4T-style speech-to-text backbone),
the counterpart of ``src/repro/models/encdec.py``.

The modality frontend (mel spectrogram and conv feature extractor) is a
stub, as in the reference: the encoder takes precomputed frame embeddings
``[B, S_src, d]``.  The encoder's self-attention is non-causal; the
decoder is a causal transformer with cross-attention into the encoder's
output.  Decoding keeps a self-attention KV cache per layer plus the
cross-attention K/V computed once from the memory.

Parameters are the reference's stacked tree (``model_specs``; the
encoder and decoder layers stacked along a leading axis, drawn by
``common.init_params``); each layer runs on views of the stacked
tensors, so autograd reaches the stacked leaves.  With ``use_flash`` the
encoder's and the decoder's self-attention run K10; cross-attention
never does (``attention.gqa_forward``).

Two behaviours of the reference are kept: ``forward`` adds the
cross-attention biases ``bq``/``bk``/``bv`` where ``qkv_bias`` is set,
but ``init_cache`` and ``decode_step`` leave them out (the seamless
configs have no biases, so serving agrees); and a sliding window reaches
the non-causal attention only past BLOCKWISE_THRESHOLD tokens, where
``sdpa_blockwise`` masks by it (the dense path applies no mask).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models.common import (
    embed,
    embedding_specs,
    make_norm,
    softmax_xent,
    unembed,
)
from repro_torch.models.transformer import (_ffn, _ffn_specs, _index,
                                            _remat, _stack_specs)


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    name: str
    n_enc_layers: int
    n_dec_layers: int
    d_model: int
    vocab: int
    d_ff: int
    attn: Any  # AttnConfig (the decoder's self-attention; causal)
    norm: str = "rms"
    dtype: Any = torch.float32
    remat: bool = True
    tie_embeddings: bool = True
    use_flash: bool = False

    @property
    def enc_attn(self):
        return dataclasses.replace(self.attn, causal=False)


def _enc_block_specs(cfg: EncDecConfig):
    ns, _ = make_norm(cfg.norm, cfg.d_model)
    return {
        "ln1": dict(ns),
        "attn": attn_lib.gqa_specs(cfg.enc_attn),
        "ln2": dict(ns),
        "ffn": _ffn_specs(cfg.d_model, cfg.d_ff),
    }


def _dec_block_specs(cfg: EncDecConfig):
    ns, _ = make_norm(cfg.norm, cfg.d_model)
    return {
        "ln1": dict(ns),
        "self_attn": attn_lib.gqa_specs(cfg.attn),
        "ln_x": dict(ns),
        "cross_attn": attn_lib.gqa_specs(cfg.attn),
        "ln2": dict(ns),
        "ffn": _ffn_specs(cfg.d_model, cfg.d_ff),
    }


def model_specs(cfg: EncDecConfig):
    return {
        "embed": embedding_specs(cfg.vocab, cfg.d_model),
        "enc": _stack_specs(_enc_block_specs(cfg), cfg.n_enc_layers),
        "dec": _stack_specs(_dec_block_specs(cfg), cfg.n_dec_layers),
        "enc_norm": make_norm(cfg.norm, cfg.d_model)[0],
        "final_norm": make_norm(cfg.norm, cfg.d_model)[0],
    }


def _enc_block(params, cfg: EncDecConfig, x, positions):
    _, norm = make_norm(cfg.norm, cfg.d_model)
    h = norm(params["ln1"], x)
    x = x + attn_lib.gqa_forward(params["attn"], cfg.enc_attn, h, positions,
                                 use_flash=cfg.use_flash)
    h = norm(params["ln2"], x)
    return x + _ffn(params["ffn"], h)


def encode(params, cfg: EncDecConfig, src_embeds):
    """src_embeds [B, S, d] -> encoder memory [B, S, d] (RoPE on the
    source positions; each layer under remat where the config asks)."""
    _, norm = make_norm(cfg.norm, cfg.d_model)
    x = src_embeds.to(cfg.dtype)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for u in range(cfg.n_enc_layers):
        body = _remat(cfg, functools.partial(_enc_block,
                                             _index(params["enc"], u), cfg))
        x = body(x, positions)
    return norm(params["enc_norm"], x)


def _dec_block(params, cfg: EncDecConfig, x, memory, positions):
    _, norm = make_norm(cfg.norm, cfg.d_model)
    h = norm(params["ln1"], x)
    x = x + attn_lib.gqa_forward(params["self_attn"], cfg.attn, h, positions,
                                 use_flash=cfg.use_flash)
    h = norm(params["ln_x"], x)
    x = x + attn_lib.gqa_forward(params["cross_attn"], cfg.attn, h,
                                 positions, kv=memory)
    h = norm(params["ln2"], x)
    return x + _ffn(params["ffn"], h)


def forward(params, cfg: EncDecConfig, src_embeds, tgt_tokens):
    """Teacher-forced training forward.  Returns logits [B, T, V]."""
    memory = encode(params, cfg, src_embeds)
    _, norm = make_norm(cfg.norm, cfg.d_model)
    x = embed(params["embed"], tgt_tokens).to(cfg.dtype)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for u in range(cfg.n_dec_layers):
        body = _remat(cfg, functools.partial(_dec_block,
                                             _index(params["dec"], u), cfg))
        x = body(x, memory, positions)
    x = norm(params["final_norm"], x)
    return unembed(params["embed"], x)


def loss_fn(params, cfg: EncDecConfig, batch):
    """batch: {"src_embeds": [B, S, d], "tgt_tokens": [B, T+1]}; teacher
    forcing on ``[:, :-1]`` against ``[:, 1:]``."""
    tgt = batch["tgt_tokens"]
    logits = forward(params, cfg, batch["src_embeds"], tgt[:, :-1])
    return softmax_xent(logits, tgt[:, 1:])


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def init_cache(params, cfg: EncDecConfig, memory, max_len: int):
    """The decode cache, stacked over the decoder layers as the
    reference's vmap lays it out: ``{"self": gqa_init_cache's {"k", "v"
    [L, B, S, KH, Dh], "pos_ids" [L, S]}, "cross_k", "cross_v" [L, B,
    S_src, KH, Dh]}``, the cross K/V projected once from ``memory`` [B,
    S_src, d] and cast to ``cfg.dtype`` (no bias, as the reference)."""
    b = memory.shape[0]
    layers = [_index(params["dec"], u)["cross_attn"]
              for u in range(cfg.n_dec_layers)]
    selfs = [attn_lib.gqa_init_cache(cfg.attn, b, max_len, cfg.dtype,
                                     memory.device)
             for _ in layers]
    return {
        "self": {k: torch.stack([c[k] for c in selfs]) for k in selfs[0]},
        "cross_k": torch.stack([
            torch.einsum("bsd,dhk->bshk", memory, p["wk"]).to(cfg.dtype)
            for p in layers]),
        "cross_v": torch.stack([
            torch.einsum("bsd,dhk->bshk", memory, p["wv"]).to(cfg.dtype)
            for p in layers]),
    }


def decode_step(params, cfg: EncDecConfig, cache, token, pos: int):
    """One-token decode: token [B] at the int ``pos``.  Writes each
    layer's self-attention key and value into ``cache`` in place; the
    cross-attention is the dense ``sdpa`` over the cached K/V with its q
    and output projections (no bias).  Returns (logits [B, 1, V],
    cache)."""
    _, norm = make_norm(cfg.norm, cfg.d_model)
    x = embed(params["embed"], token[:, None]).to(cfg.dtype)
    for u in range(cfg.n_dec_layers):
        p = _index(params["dec"], u)
        h = norm(p["ln1"], x)
        a, _ = attn_lib.gqa_decode(p["self_attn"], cfg.attn,
                                   _index(cache["self"], u), h, pos)
        x = x + a
        h = norm(p["ln_x"], x)
        q = torch.einsum("btd,dhk->bthk", h, p["cross_attn"]["wq"])
        out = attn_lib.sdpa(q, cache["cross_k"][u], cache["cross_v"][u],
                            None)
        x = x + torch.einsum("bthk,hkd->btd", out, p["cross_attn"]["wo"])
        h = norm(p["ln2"], x)
        x = x + _ffn(p["ffn"], h)
    x = norm(params["final_norm"], x)
    return unembed(params["embed"], x), cache
