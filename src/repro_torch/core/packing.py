"""Packed parameter plane: each agent's parameter tree as one contiguous
``[..., N]`` vector (port of ``repro/core/packing.py``).

The layout is static host metadata: per leaf, its shape, dtype and
``[offset, offset + size)`` segment of the plane.  A tree that is already
one flat vector has a trivial layout, and ``pack``/``unpack`` are then
reshapes.

    layout = layout_of(tree)                # per-agent tree, no agent axis
    flat   = pack(layout, tree)             # [..., N]; any leading dims
    tree   = unpack(layout, flat)           # exact inverse
    views  = leaf_views(layout, flat)       # the same leaves, as views
    est    = PackedEstimator(grad_est, layout)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.common.trees import as_tensor, tree_flatten, tree_map
from repro_torch.core.compression import Spec


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    shape: tuple
    dtype: torch.dtype
    offset: int
    size: int


@dataclasses.dataclass(frozen=True)
class PackedLayout:
    """Pack/unpack recipe: per-leaf plane segments plus the rebuild of the
    tree (compared by its slots only)."""

    slots: tuple
    size: int
    dtype: torch.dtype
    rebuild: Any = dataclasses.field(compare=False, repr=False)

    @property
    def is_trivial(self) -> bool:
        return (len(self.slots) == 1
                and self.slots[0].shape == (self.size,)
                and self.slots[0].dtype == self.dtype)


def layout_of(tree, dtype=None) -> PackedLayout:
    """Layout of a per-agent tree (tensors WITHOUT the agent axis)."""
    leaves, rebuild = tree_flatten(tree)
    if not leaves:
        raise ValueError("cannot build a packed layout for an empty tree")
    if dtype is None:
        dtype = leaves[0].dtype
        for leaf in leaves[1:]:
            dtype = torch.promote_types(dtype, leaf.dtype)
    slots, off = [], 0
    for leaf in leaves:
        size = math.prod(leaf.shape)
        slots.append(LeafSlot(tuple(leaf.shape), leaf.dtype, off, size))
        off += size
    return PackedLayout(slots=tuple(slots), size=off, dtype=dtype,
                        rebuild=rebuild)


def abstract_plane(params) -> Spec:
    """One whole-plane message of a per-agent tree (tensors or numpy
    arrays): what the packed solvers' wire accounting charges per edge."""
    lay = layout_of(tree_map(as_tensor, params))
    return Spec((lay.size,), lay.dtype)


def layout_of_stacked(x0) -> PackedLayout:
    """Layout from stacked ``[A, ...]`` params (drops the agent axis)."""
    leaves, rebuild = tree_flatten(x0)
    return layout_of(rebuild([leaf[0] for leaf in leaves]))


def pack(layout: PackedLayout, tree):
    """Tree -> ``[*lead, N]`` plane (leaves may carry common lead dims)."""
    leaves, _ = tree_flatten(tree)
    parts = []
    for leaf, slot in zip(leaves, layout.slots):
        lead = tuple(leaf.shape[:leaf.dim() - len(slot.shape)])
        if tuple(leaf.shape[len(lead):]) != slot.shape:
            raise ValueError(f"leaf shape {tuple(leaf.shape)} does not end "
                             f"with the layout shape {slot.shape}")
        parts.append(leaf.reshape(lead + (slot.size,)).to(layout.dtype))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def unpack(layout: PackedLayout, flat):
    """``[*lead, N]`` plane -> tree (exact inverse of ``pack``)."""
    if flat.shape[-1] != layout.size:
        raise ValueError(f"plane width {flat.shape[-1]} != {layout.size}")
    lead = tuple(flat.shape[:-1])
    outs = [flat[..., s.offset:s.offset + s.size].reshape(lead + s.shape)
            .to(s.dtype) for s in layout.slots]
    return layout.rebuild(outs)


def leaf_views(layout: PackedLayout, flat):
    """Per-leaf views of the plane: each leaf whose dtype is the plane's
    is a reshape of its ``[offset, offset + size)`` segment, sharing the
    plane's storage, so a write to the plane shows through (a leaf of
    another dtype is cast, a copy, as ``unpack`` gives it)."""
    return unpack(layout, flat)


def cache_layout(owner, layout: PackedLayout) -> PackedLayout:
    """Keep ``layout`` on a (frozen) solver instance, so its step and
    consensus hooks can pack and unpack without being handed the tree
    again."""
    object.__setattr__(owner, "_layout", layout)
    return layout


def cached_layout(owner, x_stacked) -> PackedLayout:
    """The layout ``cache_layout`` kept on ``owner``, or, when there is
    none (a state restored from outside, ``init`` never called), the
    trivial layout of an already flat ``[A, N]`` plane, then kept."""
    lay = getattr(owner, "_layout", None)
    if lay is None:
        if not isinstance(x_stacked, torch.Tensor):
            raise AssertionError(
                "packed solver received a pytree state without a cached "
                "layout; call solver.init(x0) first")
        lay = cache_layout(owner, layout_of(x_stacked[0]))
    return lay


@dataclasses.dataclass(frozen=True)
class PackedEstimator:
    """A ``vr.*`` estimator lifted to the packed plane: parameters and
    gradients are ``[A, N]`` planes, the estimator's own state stays in
    the model's tree."""

    est: Any
    layout: PackedLayout

    def reset(self, params_flat, data):
        return self.est.reset(unpack(self.layout, params_flat), data)

    def estimate(self, state, phi_flat, data, idx):
        g, state = self.est.estimate(state, unpack(self.layout, phi_flat),
                                     data, idx)
        return pack(self.layout, g), state
