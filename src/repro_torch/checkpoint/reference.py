"""Carry the reference's solver state, data and model weights across to
the port.

The reference's state arrives as numpy leaves: either the state itself
after ``tree_map(np.asarray, state)`` (LT-ADMM's named tuple, static or
time-varying, faulted or not, or a gossip baseline's dict), or the arrays
of a reference checkpoint (read by ``checkpoint.store.load_checkpoint``:
keys like ``x`` or ``.x``, and ``x/w1`` or ``.x/w1`` for the leaves of
pytree parameters, the manifest's ``step`` for the round counter).  No
JAX is needed to read either.  A checkpoint also restores straight into
a port state: ``load_checkpoint(path, like_tree=solver.init(x0))``.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np

from repro_torch.checkpoint.store import load_checkpoint, to_tensor
from repro_torch.common.trees import tree_map
from repro_torch.core.admm import (LTADMMConfig, LTADMMScheduleState,
                                   LTADMMState)
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tr


def _by_field(arrays):
    """State fields by name; a checkpoint key ``x/w1`` (or ``.x/w1``)
    nests leaf ``w1`` under field ``x``."""
    if not isinstance(arrays, Mapping):
        return arrays._asdict()
    out = {}
    for key, val in arrays.items():
        field, *path = (p.lstrip(".") for p in str(key).split("/"))
        if not path:
            out[field] = val
            continue
        node = out.setdefault(field, {})
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = val
    return out


def _tensors(tree, dev):
    return tree_map(lambda a: to_tensor(a, dev), tree)


def state_from_numpy(arrays, cfg: LTADMMConfig, device=None,
                     step: int | None = None):
    """The reference's LT-ADMM state (a plane or pytree leaves) as the
    port's ``LTADMMState``, or ``LTADMMScheduleState`` when it carries
    ``x_hat_edge``, on ``device``.  ``u``/``u_nbr`` (``u_edge``) stay
    None in lean mode (eta == 1); ``step`` overrides the round counter
    (the checkpoint manifest's ``step``)."""
    dev = resolve_device(device)
    by = _by_field(arrays)
    cls = LTADMMScheduleState if "x_hat_edge" in by else LTADMMState
    lean_fields = {"u", "u_edge", "u_nbr"} if cfg.lean else set()
    optional = lean_fields | ({"k"} if step is not None else set())
    missing = [f for f in cls._fields if f not in by and f not in optional]
    if missing:
        raise KeyError(f"reference state lacks fields {missing}")
    k = int(np.asarray(by["k"])) if step is None else int(step)
    return cls(**{f: None if f in lean_fields else _tensors(by[f], dev)
                  for f in cls._fields if f != "k"}, k=k)


def baseline_state_from_numpy(arrays, solver, device=None,
                              step: int | None = None) -> dict:
    """A gossip baseline's state (``x``, ``xhat``, ``h``, ``d``, ... as
    the solver's ``state_fields`` name them, each a plane or pytree
    leaves, and ``k``) as the port's state dict on ``device``; ``step``
    overrides the round counter."""
    dev = resolve_device(device)
    by = _by_field(arrays)
    want = tuple(solver.state_fields) + (("k",) if step is None else ())
    missing = [f for f in want if f not in by]
    if missing:
        raise KeyError(f"reference {solver.name} state lacks fields "
                       f"{missing}")
    st = {f: _tensors(by[f], dev) for f in solver.state_fields}
    st["k"] = int(np.asarray(by["k"])) if step is None else int(step)
    return st


def state_from_checkpoint(path, cfg: LTADMMConfig, device=None):
    """``state_from_numpy`` of the checkpoint at ``path`` (either
    package's), the round counter from its manifest."""
    arrays, manifest = load_checkpoint(path)
    return state_from_numpy(arrays, cfg, device, step=manifest["step"])


def baseline_state_from_checkpoint(path, solver, device=None) -> dict:
    """``baseline_state_from_numpy`` of the checkpoint at ``path``."""
    arrays, manifest = load_checkpoint(path)
    return baseline_state_from_numpy(arrays, solver, device,
                                     step=manifest["step"])


def data_from_numpy(data, device=None) -> dict:
    """The reference's data dict (numpy leaves) as tensors on ``device``."""
    dev = resolve_device(device)
    return {k: to_tensor(v, dev) for k, v in data.items()}


def model_params_from_reference(np_tree, cfg, device=None):
    """The reference's model parameters (its ``init_params`` pytree after
    ``tree_map(np.asarray, params)``: nested dicts, the units stacked
    along a leading axis) as the port's modules on ``device``
    (``models.transformer.model_params``)."""
    return tr.model_params(cfg, _tensors(np_tree, resolve_device(device)))


def params_tree_from_reference(np_tree, device=None):
    """The reference's model parameters (numpy, as above) as the plain
    tree the port trains on: nested dicts of tensors on ``device``, the
    units stacked as the reference lays them out.  ``transformer.forward``
    and ``loss_fn`` take it as it is, and autograd reaches every leaf in
    that layout."""
    return _tensors(np_tree, resolve_device(device))
