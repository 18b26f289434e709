"""Optimizers built from scratch, the counterpart of
``src/repro/optim/optimizers.py``: (init, update) pairs over parameter
trees (nested dicts of tensors).

    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Used by the all-reduce DDP baseline (``launch.steps.build_ddp_train``).
Every step is the reference's f32 expression in its order; Adam's bias
corrections take ``b ** t`` in f32 with t an int32 counter, as the
reference does (not in Python doubles).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.common.trees import first_leaf, tree_map


class Optimizer(NamedTuple):
    init: Any
    update: Any


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def sgd(lr: float, momentum: float = 0.0):
    def init(params):
        if momentum == 0.0:
            return ()
        return {"mu": tree_map(torch.zeros_like, params)}

    def update(grads, state, params=None):
        del params
        if momentum == 0.0:
            return tree_map(lambda g: -lr * g, grads), state
        mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
        return tree_map(lambda m: -lr * m, mu), {"mu": mu}

    return Optimizer(init, update)


def adam(lr: float, b1=0.9, b2=0.999, eps=1e-8):
    def init(params):
        dev = first_leaf(params).device
        return {"m": tree_map(torch.zeros_like, params),
                "v": tree_map(torch.zeros_like, params),
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params=None):
        del params
        t = state["t"] + 1
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, state["v"],
                     grads)
        tf = t.to(torch.float32)
        mh = 1.0 - torch.pow(_f32(b1, tf), tf)
        vh = 1.0 - torch.pow(_f32(b2, tf), tf)
        upd = tree_map(
            lambda m_, v_: -lr * (m_ / mh) / (torch.sqrt(v_ / vh) + eps),
            m, v)
        return upd, {"m": m, "v": v, "t": t}

    return Optimizer(init, update)


def adamw(lr: float, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01):
    base = adam(lr, b1, b2, eps)

    def update(grads, state, params):
        upd, state = base.update(grads, state)
        upd = tree_map(lambda u, p: u - lr * weight_decay * p, upd, params)
        return upd, state

    return Optimizer(base.init, update)


def _f32(x: float, like):
    return torch.tensor(x, dtype=torch.float32, device=like.device)
