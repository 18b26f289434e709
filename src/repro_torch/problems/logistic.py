"""The paper's numerical experiment (eq. (9)): regularised logistic
regression over N agents, with analytic gradients.

f_{i,h}(x) = log(1 + exp(-b_i^h <a_i^h, x>)) + (eps/2) ||x||^2,
f_i = (1/m) sum_h f_{i,h}.  Paper settings: N = 10 (ring), n = 5,
m = 100, |B| = 1.

Port of ``repro/problems/logistic.py``.  The gradients follow the
operation order of the reference's autodiff: with u = -b <a, x>,
df/du = exp(u - logaddexp(0, u)).  ``make_data`` draws the reference's
``make_data(jax.random.key(seed))`` with ``core.jaxrand`` (labels bit
for bit, features within a few ulp), so both packages train on the
same problem.  Parity tests feed both packages the same numpy data.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import jaxrand


def _dloss(u):
    """d/du log(1 + exp(u)) as jax differentiates ``logaddexp(0, u)``."""
    out = torch.clamp_min(u, 0.0) + torch.log1p(torch.exp(-u.abs()))
    return torch.exp(u - out)


@dataclasses.dataclass(frozen=True)
class LogisticProblem:
    n: int = 5
    n_agents: int = 10
    m: int = 100
    eps: float = 0.1

    def make_data(self, seed: int = 0, device=None):
        """``{"a": [A, m, n], "b": [A, m]}``: the reference's
        ``make_data(jax.random.key(seed))``, drawn on the CPU with the
        port's ``jax.random`` counterparts and moved to ``device`` (kept on
        the CPU when None), so every device gets the same data."""
        ka, kb = jaxrand.split(jaxrand.key(seed), 2)
        a = jaxrand.normal(ka, (self.n_agents, self.m, self.n))
        b = torch.where(jaxrand.bernoulli(kb, 0.5, (self.n_agents, self.m)),
                        1.0, -1.0)
        return {"a": a.to(device), "b": b.to(device)}

    # ---- batched per-agent gradients: x [A, n], samples [A, B, ...] ------

    def _coef(self, x, batch):
        """Per-sample scalar of the loss gradient, ``[A, B]``."""
        dot = torch.matmul(batch["a"], x[..., None])[..., 0]
        logit = batch["b"] * dot
        return -_dloss(-logit) * batch["b"]

    def sample_grads(self, x, batch):
        """One gradient per sample: ``[A, B, n]``."""
        coef = self._coef(x, batch)
        return coef[..., None] * batch["a"] + self.eps * x[:, None, :]

    def batch_grad(self, x, batch):
        """Gradient of the batch-mean loss: ``[A, n]``."""
        coef = self._coef(x, batch) / batch["b"].shape[-1]
        return torch.matmul(coef[:, None, :], batch["a"])[:, 0] + self.eps * x

    full_grad = batch_grad

    # ---- global objective F(x) = (1/N) sum_i f_i(x), x [n] ---------------

    def _flat(self, data):
        return data["a"].reshape(-1, self.n), data["b"].reshape(-1)

    def global_loss(self, x, data):
        a, b = self._flat(data)
        u = -b * (a @ x)
        return (torch.mean(torch.logaddexp(torch.zeros_like(u), u))
                + 0.5 * self.eps * torch.sum(x * x))

    def global_grad(self, x, data):
        a, b = self._flat(data)
        coef = -_dloss(-b * (a @ x)) * b / b.shape[0]
        return coef @ a + self.eps * x

    def global_grad_norm_sq(self, x, data):
        g = self.global_grad(x, data)
        return torch.sum(g * g)

    def solve_opt(self, data, iters: int = 100):
        """Newton's method on the strongly convex centralised objective.
        Returns ``(x*, ||grad||^2 before the last step)``."""
        a, b = self._flat(data)
        x = torch.zeros(self.n, dtype=a.dtype, device=a.device)
        eye = torch.eye(self.n, dtype=a.dtype, device=a.device)
        gn = None
        for _ in range(iters):
            p = _dloss(-b * (a @ x))
            g = (-p * b / b.shape[0]) @ a + self.eps * x
            h = (a.T * (p * (1 - p) / b.shape[0])) @ a + self.eps * eye
            gn = torch.sum(g * g)
            x = x - torch.linalg.solve(h, g)
        return x, gn
