"""Dense compact-form oracle for LT-ADMM, eq. (10) with exact
communication (port of ``repro/core/reference.py``).

Plain Python loops over an explicit edge dictionary: a code path as far
from ``admm.step`` as can be, which the tests hold the port's solver to
in the deterministic setting (Identity compressor, full local gradients),
on any undirected graph.
"""
from __future__ import annotations

import torch


def ring_edges(n):
    edges = set()
    for i in range(n):
        edges.add((i, (i + 1) % n))
        edges.add(((i + 1) % n, i))
    return sorted(edges)


class DenseLTADMM:
    """Exact-communication LT-ADMM (the paper's ref. [14]) oracle.

    grads: list of callables ``grad_i(x) -> full local gradient``.
    """

    def __init__(self, grads, edges, rho=0.1, beta=0.2, gamma=0.3, r=1.0,
                 tau=5):
        self.grads = grads
        self.N = len(grads)
        self.edges = list(edges)  # directed pairs (i, j)
        self.nbrs = {i: sorted(j for (a, j) in self.edges if a == i)
                     for i in range(self.N)}
        self.rho, self.beta, self.gamma, self.r, self.tau = (
            rho, beta, gamma, r, tau)

    def init(self, x0_list):
        x = [torch.as_tensor(v) for v in x0_list]
        z = {e: torch.zeros_like(x[0]) for e in self.edges}
        return x, z

    def step(self, x, z):
        rho, beta, gamma, r, tau = (self.rho, self.beta, self.gamma, self.r,
                                    self.tau)
        x_new = []
        for i in range(self.N):
            d_i = len(self.nbrs[i])
            corr = beta * (r ** 2 * rho * d_i * x[i]
                           - r * sum(z[(i, j)] for j in self.nbrs[i]))
            phi = x[i]
            for _ in range(tau):
                phi = phi - gamma * self.grads[i](phi) - corr
            x_new.append(phi)
        z_new = {}
        for (i, j) in self.edges:
            # eq. (4) with exact communication (x̂ = x, ẑ = z):
            # z_ij+ = ½(z_ij − z_ji) + rρ x_i − rρ(x_i − x_j)
            z_new[(i, j)] = (0.5 * (z[(i, j)] - z[(j, i)])
                             + r * rho * x_new[i]
                             - r * rho * (x_new[i] - x_new[j]))
        return x_new, z_new

    def run(self, x0_list, n_rounds):
        x, z = self.init(x0_list)
        hist = []
        for _ in range(n_rounds):
            x, z = self.step(x, z)
            hist.append(torch.stack(x))
        return x, z, hist
