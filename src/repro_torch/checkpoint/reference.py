"""Carry the reference's solver state and data across to the port.

The reference's state arrives as numpy leaves: either the state itself
after ``tree_map(np.asarray, state)`` (LT-ADMM's named tuple, or a gossip
baseline's dict), or the arrays of a reference checkpoint (``arrays.npz``
read with numpy, keys like ``x`` or ``.x``, with ``manifest.json`` read
with json for the round counter).  No JAX is needed to read either.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.core.admm import LTADMMConfig, LTADMMState
from repro_torch.device import resolve_device

_FIELDS = LTADMMState._fields


def _by_field(arrays):
    if isinstance(arrays, Mapping):
        out = {}
        for key, val in arrays.items():
            name = str(key).rsplit("/", 1)[-1].lstrip(".")
            out[name] = val
        return out
    return {f: getattr(arrays, f) for f in _FIELDS}


def state_from_numpy(arrays, cfg: LTADMMConfig, device=None,
                     step: int | None = None) -> LTADMMState:
    """The reference's packed LT-ADMM state as the port's
    ``LTADMMState`` on ``device``.  ``u``/``u_nbr`` stay None in lean
    mode (eta == 1); ``step`` overrides the round counter (the
    checkpoint manifest's ``step``)."""
    dev = resolve_device(device)
    by = _by_field(arrays)
    optional = ({"u", "u_nbr"} if cfg.lean else set()) | (
        {"k"} if step is not None else set())
    missing = [f for f in _FIELDS if f not in by and f not in optional]
    if missing:
        raise KeyError(f"reference state lacks fields {missing}")

    def tensor(f):
        if cfg.lean and f in ("u", "u_nbr"):
            return None
        return torch.as_tensor(np.array(by[f]), device=dev)

    k = int(np.asarray(by["k"])) if step is None else int(step)
    return LTADMMState(**{f: tensor(f) for f in _FIELDS if f != "k"}, k=k)


def baseline_state_from_numpy(arrays, solver, device=None,
                              step: int | None = None) -> dict:
    """A gossip baseline's packed state (``x``, ``xhat``, ``h``, ``d``, ...
    as the solver's ``state_fields`` name them, and ``k``) as the port's
    state dict on ``device``; ``step`` overrides the round counter."""
    dev = resolve_device(device)
    by = _by_field(arrays)
    want = tuple(solver.state_fields) + (("k",) if step is None else ())
    missing = [f for f in want if f not in by]
    if missing:
        raise KeyError(f"reference {solver.name} state lacks fields "
                       f"{missing}")
    st = {f: torch.as_tensor(np.array(by[f]), device=dev)
          for f in solver.state_fields}
    st["k"] = int(np.asarray(by["k"])) if step is None else int(step)
    return st


def data_from_numpy(data, device=None) -> dict:
    """The reference's data dict (numpy leaves) as tensors on ``device``."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.array(v), device=dev)
            for k, v in data.items()}
