"""Step builders, the inference half of ``src/repro/launch/steps.py``:
``build_prefill`` and ``build_serve`` for the decoder-only models, and
the training loop's ``DivergenceWatchdog``.

There is no mesh and no partition spec here (ROADMAP item 15), and no
train step yet (item 16); the encoder-decoder waits for item 16 too.
"""
from __future__ import annotations

import collections
import math

import torch

from repro_torch.common.trees import is_namedtuple, tree_children
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


def _snapshot(tree):
    """A copy of ``tree`` whose tensors are clones: an in-place update of
    the live state cannot reach it.  Other leaves (the round counter) are
    kept as they are."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    kids = tree_children(tree)
    if kids is None:
        return tree
    vals = [_snapshot(child) for _, child in kids]
    if is_namedtuple(tree):
        return type(tree)(*vals)
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), vals))
    if isinstance(tree, (list, tuple)):
        return type(tree)(vals)
    return type(tree)(**dict(zip(sorted(tree), vals)))


class DivergenceWatchdog:
    """Divergence detection and rollback to a ring of last-good snapshots
    (the reference's ``launch/steps.py`` watchdog).

    After every logged chunk the training loop reports ``(state,
    metric)``; a NaN or inf metric, or one beyond ``blowup`` times the
    best seen, marks the window poisoned and rolls the state back to the
    OLDEST snapshot in the ring.  Healthy states are snapshotted as clones, so the ring survives
    an in-place update of the live state.  Rollback does not rewind the
    round counter: with deterministic per-round keys, rewinding would
    replay the same divergence.  More than ``max_consecutive`` rollbacks
    without a healthy window in between raise."""

    def __init__(self, depth: int = 3, blowup: float = 1e4,
                 max_consecutive: int = 3):
        assert depth >= 1 and blowup > 1.0, (depth, blowup)
        self.blowup = float(blowup)
        self.max_consecutive = max_consecutive
        self._ring = collections.deque(maxlen=depth)
        self._best = math.inf
        self._consecutive = 0
        self.rollbacks = 0

    def _bad(self, m: float) -> bool:
        if not math.isfinite(m):
            return True
        return (math.isfinite(self._best)
                and m > self.blowup * max(self._best, 1e-12))

    def observe(self, state, metric):
        """-> ``(state, rolled_back)``: the input state (now snapshotted)
        when healthy, else a copy of the last-good rollback state."""
        m = float(metric)
        if not self._bad(m):
            self._best = min(self._best, m)
            self._ring.append(_snapshot(state))
            self._consecutive = 0
            return state, False
        self.rollbacks += 1
        self._consecutive += 1
        if not self._ring:
            raise RuntimeError(
                f"divergence (metric={m}) before any healthy snapshot")
        if self._consecutive > self.max_consecutive:
            raise RuntimeError(
                f"divergence watchdog: {self._consecutive} consecutive "
                f"rollbacks without re-stabilizing (metric={m})")
        # a copy: the caller may update it in place, and the ring entry
        # must survive for a possible second rollback
        return _snapshot(self._ring[0]), True
