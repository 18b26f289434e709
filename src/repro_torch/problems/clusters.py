"""Planted-cluster logistic regression, the personalization testbed (port
of ``repro/problems/clusters.py``).

Agents are split into ``n_clusters`` contiguous groups; cluster ``c``
draws its own ground-truth separator ``w*_c`` and every agent in it
labels its features with that separator (plus label noise).  An
exact-consensus solver is held to ONE compromise model across the
clusters; the ``dada:`` solver (``core.graphlearn``), which learns
per-agent models and whom to average with, can fit each cluster's
optimum and recover the planted intra-cluster edges.

``separation`` scales the orthonormalised Gaussian separators: 0 gives
identical tasks (consensus is optimal), larger values ever more distinct
ones (``personalization_sweep`` walks it).  ``make_split(seed)`` draws
the reference's ``make_split(jax.random.key(seed))`` on the CPU with
``core.jaxrand`` (labels bit for bit, features and separators within a
few ulp; the QR is LAPACK's in f32, as XLA's on the CPU), then moves the
data to ``device``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import jaxrand
from repro_torch.problems.logistic import LogisticProblem


@dataclasses.dataclass(frozen=True)
class ClusteredLogisticProblem(LogisticProblem):
    """Losses, gradients and estimator APIs are ``LogisticProblem``'s
    (pointwise in the data); only the data differ: labels come from
    per-cluster separators."""

    n: int = 5
    n_agents: int = 16
    m: int = 100
    eps: float = 0.1
    n_clusters: int = 4
    separation: float = 3.0  # ||w*_c||; 0 = identical tasks
    label_noise: float = 0.5  # std of the logit noise before the sign

    def __post_init__(self):
        if self.n_agents % self.n_clusters:
            raise ValueError(f"n_agents={self.n_agents} is not a multiple "
                             f"of n_clusters={self.n_clusters}")

    # ---- planted structure -------------------------------------------------

    def cluster_of(self) -> np.ndarray:
        """``[A]`` cluster id per agent (contiguous blocks)."""
        return np.repeat(np.arange(self.n_clusters),
                         self.n_agents // self.n_clusters)

    def intra_cluster_edges(self) -> set:
        """The undirected ground-truth edges: every same-cluster pair."""
        cl = self.cluster_of()
        return {(i, j) for i in range(self.n_agents)
                for j in range(i + 1, self.n_agents) if cl[i] == cl[j]}

    def separators(self, key) -> torch.Tensor:
        """``[n_clusters, n]`` separators: the Q factor of Gaussians,
        scaled by ``separation`` (pairwise orthogonal; n >= n_clusters)."""
        w = jaxrand.normal(key, (self.n_clusters, self.n))
        q, _ = torch.linalg.qr(w.T)
        return self.separation * q.T[:self.n_clusters]

    # ---- data --------------------------------------------------------------

    def _with_sep(self, key_sep, key_data, m):
        ks = jaxrand.split(key_data, 2)
        w_star = self.separators(key_sep)
        a = jaxrand.normal(ks[0], (self.n_agents, m, self.n))
        w_agent = w_star[torch.as_tensor(self.cluster_of())]  # [A, n]
        logits = torch.einsum("amn,an->am", a, w_agent)
        noise = self.label_noise * jaxrand.normal(ks[1], tuple(logits.shape))
        b = torch.sign(logits + noise)
        return {"a": a, "b": torch.where(b == 0, 1.0, b)}

    def make_data(self, seed: int = 0, device=None):
        """The train split alone: ``make_split(seed)[0]``."""
        return self.make_split(seed, device=device)[0]

    def make_split(self, seed: int = 0, m_test: int | None = None,
                   device=None):
        """``(train, test)`` from the same separators (one fold of the
        key), so test measures fresh features of the same tasks; on
        ``device`` (kept on the CPU when None)."""
        key = jaxrand.key(seed)
        kw = jaxrand.fold_in(key, 7)
        train = self._with_sep(kw, jaxrand.fold_in(key, 0), self.m)
        test = self._with_sep(kw, jaxrand.fold_in(key, 1), m_test or self.m)
        return tuple({k: v.to(device) for k, v in d.items()}
                     for d in (train, test))

    # ---- personalization metrics -------------------------------------------

    def per_agent_test_loss(self, x, test) -> torch.Tensor:
        """``[A]`` test loss of per-agent params ``x`` (``[A, n]``, or one
        ``[n]`` consensus vector given to every agent)."""
        if x.dim() == 1:
            x = x.expand((self.n_agents,) + tuple(x.shape))
        return self.batch_loss(x, test)

    def mean_test_loss(self, x, test) -> float:
        return float(torch.mean(self.per_agent_test_loss(x, test)))
