"""Run a solver for a number of rounds and sample the optimality metric
(port of ``benchmarks/common.py:run_solver``).

Round i uses the key ``fold_in(key(seed), i)``, as the reference does,
and ||grad F(x̄)||² is computed only at the sample rounds 0, every, 2 *
every, ... (after that round's step), so the loop between samples is
pure solver steps.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.trees import tree_flatten
from repro_torch.core import jaxrand


def run_solver(prob, data, solver, rounds: int, metric_every: int = 10,
               seed: int = 12345, return_state: bool = False, x0=None):
    """Returns ``(rounds_idx, gradnorm_sq)`` numpy arrays (and the final
    state when ``return_state``).  ``data`` is moved to the solver's
    device.  ``x0``: the stacked initial params (a tree for
    ``packed=false``; zeros ``[A, n]`` when None), whose consensus mean
    packs into the problem's ``[n]`` vector."""
    data = {k: (v if isinstance(v, torch.Tensor) else
                torch.from_numpy(np.array(v))).to(solver.device)
            for k, v in data.items()}
    if x0 is None:
        x0 = torch.zeros((prob.n_agents, prob.n), device=solver.device)
    st = solver.init(x0)
    base = jaxrand.key(seed)
    idx, gns = [], []
    for i in range(rounds):
        st = solver.step(st, data, jaxrand.fold_in(base, i))
        if i % metric_every == 0:
            xbar = _flat_mean(solver.consensus_params(st))
            idx.append(i)
            gns.append(prob.global_grad_norm_sq(xbar, data))
    gns = np.asarray([float(g) for g in gns], dtype=np.float64)
    out = (np.asarray(idx), gns)
    return out + (st,) if return_state else out


def _flat_mean(params):
    """Consensus mean of stacked params, leaves flattened and joined in
    tree order into one vector."""
    return torch.cat([torch.mean(x, dim=0).reshape(-1)
                      for x in tree_flatten(params)[0]])


def rounds_to_tol(idx, gns, tol: float):
    """First sampled round with ||grad F||² <= tol, or None."""
    hit = np.nonzero(np.asarray(gns) <= tol)[0]
    return int(np.asarray(idx)[hit[0]]) if hit.size else None
