"""Variance-reduced gradient estimators (paper eq. (8)), port of
``repro/core/vr.py`` with the agent axis written out as a batch dimension
instead of ``vmap``.

Parameters are trees with leaves ``[A, ...]``, data dicts have leaves
``[A, m, ...]`` and minibatch indices are ``[A, bs]``.  The gradient
callables are batched the same way: ``sample_grads(params, samples)``
returns one gradient per sample (``[A, B, ...]``), ``batch_grad`` and
``full_grad`` the mean over the samples (``[A, ...]``).

API: ``state = est.reset(params, data)``;
``g, state = est.estimate(state, phi, data, idx)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.common.trees import tree_map


class SagaState(NamedTuple):
    table: Any  # leaves [A, m, ...]
    mean: Any  # leaves [A, ...]


class SvrgState(NamedTuple):
    anchor: Any
    anchor_grad: Any


def take_rows(data, idx):
    """Per-agent minibatch: leaves ``[A, m, ...]`` -> ``[A, bs, ...]``."""
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return tree_map(lambda x: x[rows, idx], data)


@dataclasses.dataclass(frozen=True)
class SagaTable:
    """The paper's SAGA table of per-sample gradients, reset to the full
    gradient at the start of every local phase.

    The port refreshes the table rows IN PLACE (the table is created by
    ``reset`` and owned by one local phase), which saves a copy of the
    ``[A, m, N]`` table per local step."""

    sample_grads: Callable
    m: int

    def reset(self, params, data) -> SagaState:
        grads = self.sample_grads(params, data)
        return SagaState(table=grads,
                         mean=tree_map(lambda t: torch.mean(t, dim=1), grads))

    def estimate(self, state: SagaState, phi, data, idx):
        new_g = self.sample_grads(phi, take_rows(data, idx))
        old_g = take_rows(state.table, idx)
        g = tree_map(lambda n, o, m_: torch.mean(n - o, dim=1) + m_,
                     new_g, old_g, state.mean)
        rows = torch.arange(idx.shape[0], device=idx.device)

        def refresh(t, n):
            # one batch slot at a time: a repeated index keeps the last
            # slot's row, as the reference's scatter does
            for b in range(idx.shape[1]):
                t[rows, idx[:, b]] = n[:, b]

        tree_map(refresh, state.table, new_g)
        mean = tree_map(lambda m_, n, o: m_ + torch.sum(n - o, dim=1) / self.m,
                        state.mean, new_g, old_g)
        return g, SagaState(table=state.table, mean=mean)


@dataclasses.dataclass(frozen=True)
class SvrgAnchor:
    """Anchor (loopless-SVRG style) estimator:
    g = grad_B(phi) - grad_B(anchor) + grad(anchor).

    ``take``: how a minibatch is read from the data (``take_rows``; the
    FSDP rows' gather where an agent's rows are cut over ranks), and
    ``row_shards`` the parts the agent's rows are cut into (``m`` is the
    rank's rows times it)."""

    batch_grad: Callable
    full_grad: Callable
    take: Callable = take_rows
    row_shards: int = 1

    def reset(self, params, data) -> SvrgState:
        return SvrgState(anchor=params,
                         anchor_grad=self.full_grad(params, data))

    def estimate(self, state: SvrgState, phi, data, idx):
        batch = self.take(data, idx)
        g_phi = self.batch_grad(phi, batch)
        g_anc = self.batch_grad(state.anchor, batch)
        return tree_map(lambda a, b, c: a - b + c, g_phi, g_anc,
                        state.anchor_grad), state


@dataclasses.dataclass(frozen=True)
class FullGrad:
    """Deterministic full local gradient."""

    full_grad: Callable

    def reset(self, params, data):
        return ()

    def estimate(self, state, phi, data, idx):
        return self.full_grad(phi, data), state


@dataclasses.dataclass(frozen=True)
class PlainSgd:
    """Plain minibatch gradient (no variance reduction); ``take`` and
    ``row_shards`` as ``SvrgAnchor``'s."""

    batch_grad: Callable
    take: Callable = take_rows
    row_shards: int = 1

    def reset(self, params, data):
        return ()

    def estimate(self, state, phi, data, idx):
        return self.batch_grad(phi, self.take(data, idx)), state
