"""Data pipeline: synthetic token streams and per-agent partitioning, the
counterpart of ``src/repro/data/pipeline.py``.

Each agent i owns a local dataset of m_local sequences (paper eq. (1));
``heterogeneity`` skews each agent's tokens toward its own band of the
vocabulary, so the local optima differ across agents.  The draws are the
reference's, bit for bit, through ``core.jaxrand``: one key per agent
from ``split``, three keys per agent for the base tokens, the band tokens
and the mask (the reference vmaps over the agents; the keys here are one
batch).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import jaxrand


@dataclasses.dataclass(frozen=True)
class SyntheticLMDataset:
    vocab: int
    seq_len: int
    n_agents: int
    m_local: int  # sequences per agent
    heterogeneity: float = 0.5  # 0 = IID, 1 = fully disjoint token ranges

    def sample(self, key):
        """tokens [A, m_local, seq_len + 1] int32, on the key's device."""
        kk = jaxrand.split(jaxrand.split(key, self.n_agents), 3)  # [A, 3, 2]
        shape = (self.m_local, self.seq_len + 1)
        band = self.vocab // self.n_agents
        lo = band * torch.arange(self.n_agents, device=key.device)
        base = jaxrand.randint(kk[:, 0], shape, 0, self.vocab)
        pref = lo[:, None, None] + jaxrand.randint(kk[:, 1], shape, 0, band)
        use_pref = jaxrand.uniform(kk[:, 2], shape) < torch.tensor(
            self.heterogeneity, dtype=torch.float32, device=key.device)
        return torch.where(use_pref, pref, base).to(torch.int32)

    def batches(self, key, n_rounds):
        for i in range(n_rounds):
            yield self.sample(jaxrand.fold_in(key, i))


def partition_for_agents(tokens, n_agents):
    """[B, ...] -> [A, B // A, ...]  (drops any remainder)."""
    m = tokens.shape[0] // n_agents
    return tokens[: m * n_agents].reshape((n_agents, m) + tuple(
        tokens.shape[1:]))
