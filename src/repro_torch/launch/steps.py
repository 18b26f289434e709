"""Step builders, the inference half of ``src/repro/launch/steps.py``:
``build_prefill`` and ``build_serve`` for the decoder-only models.

There is no mesh and no partition spec here (ROADMAP item 15), and no
train step yet (item 16); the encoder-decoder waits for item 16 too.
"""
from __future__ import annotations

from repro_torch.models import transformer as tr


def _lm_only(arch_def):
    if arch_def.kind == "encdec":
        raise NotImplementedError(
            f"{arch_def.arch_id}: the encoder-decoder waits for ROADMAP "
            "item 16")


def model_specs(arch_def, cfg):
    _lm_only(arch_def)
    return tr.model_specs(cfg)


def build_prefill(arch_def, cfg):
    """``prefill(params, batch) -> logits [B, 1, vocab]`` of the last
    position; ``batch`` holds ``tokens [B, T]`` or ``embeds [B, T, d]``.
    With ``cfg.use_flash`` the attention runs the flash kernel (K10)."""
    _lm_only(arch_def)

    def prefill(params, batch):
        logits = tr.forward(params, cfg, tokens=batch.get("tokens"),
                            embeds=batch.get("embeds"))
        return logits[:, -1:, :]

    return prefill


def build_serve(arch_def, cfg):
    """``(serve, init_cache)``: ``serve(params, cache, batch) -> (logits
    [B, 1, vocab], cache)`` decodes one token (``batch["token"] [B]`` at
    the int ``batch["pos"]``), updating ``cache`` in place;
    ``init_cache(batch_size, max_len, device)`` makes its zero cache."""
    _lm_only(arch_def)

    def serve(params, cache, batch):
        return tr.decode_step(params, cfg, cache, token=batch["token"],
                              pos=batch["pos"])

    def init_cache(batch_size, max_len, device=None):
        return tr.init_cache(cfg, batch_size, max_len, device)

    return serve, init_cache
