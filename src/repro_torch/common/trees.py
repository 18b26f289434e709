"""Tree helpers (the counterpart of ``src/repro/common/trees.py``, under
its names, and the flatten/rebuild the port's layouts use).  A tree is a
tensor, or a mapping (a dict or a ``Payload``), list or tuple of trees;
mapping keys are taken in sorted order, as jax flattens them."""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def tree_flatten(tree, is_leaf=None):
    """-> (leaves, rebuild) with ``rebuild(leaves)`` the inverse.
    ``is_leaf(node)`` True stops the descent at ``node``."""
    if is_leaf is not None and is_leaf(tree):
        return [tree], lambda leaves: leaves[0]
    if isinstance(tree, Mapping):
        keys = sorted(tree)
        parts = [tree_flatten(tree[k], is_leaf) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [tree_flatten(t, is_leaf) for t in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    sizes = [len(p[0]) for p in parts]
    leaves = [leaf for p in parts for leaf in p[0]]
    # the node's type only: a rebuild kept in a layout must not pin the
    # tensors of the tree it was taken from
    cls, as_dict = type(tree), isinstance(tree, dict)
    fns = [fn for _, fn in parts]

    def rebuild(flat):
        out, i = [], 0
        for fn, n in zip(fns, sizes):
            out.append(fn(flat[i:i + n]))
            i += n
        if keys is not None:
            items = dict(zip(keys, out))
            return items if as_dict else cls(**items)
        return cls(out)

    return leaves, rebuild


def dict_paths(tree, prefix: str = "") -> dict:
    """``{"a.b.c": leaf}`` of a tree of nested dicts, keys sorted."""
    if not isinstance(tree, Mapping):
        return {prefix[:-1]: tree}
    out = {}
    for k in sorted(tree):
        out.update(dict_paths(tree[k], f"{prefix}{k}."))
    return out


def is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def tree_children(node):
    """``[(path element, child)]`` of an inner node, in jax's flatten
    order and with the reference checkpoint's path strings (``.field`` of
    a named tuple, a mapping's key, a sequence's index), or None for a
    leaf.  Unlike ``tree_flatten`` it takes named tuples (the solver
    states) apart."""
    if is_namedtuple(node):
        return [("." + f, getattr(node, f)) for f in node._fields]
    if isinstance(node, Mapping):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def as_tensor(leaf):
    """A tensor as it is; anything else (a numpy array) as a tensor."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    return torch.from_numpy(np.asarray(leaf))


def tree_map(fn, tree, *rest):
    leaves, rebuild = tree_flatten(tree)
    others = [tree_flatten(t)[0] for t in rest]
    return rebuild([fn(*xs) for xs in zip(leaves, *others)])


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def first_leaf(tree):
    return tree_flatten(tree)[0][0]


def tree_select(mask, on_tree, off_tree):
    """Per-row select: ``on_tree`` where ``mask`` (``[A]`` or ``[A, S]``,
    broadcast over each leaf's trailing dims), ``off_tree`` elsewhere."""
    def one(a, b):
        m = mask.reshape(tuple(mask.shape) + (1,) * (a.dim() - mask.dim()))
        return torch.where(m, a, b)

    return tree_map(one, on_tree, off_tree)


def tree_scale(c, a):
    return tree_map(lambda x: c * x, a)


def tree_axpy(c, a, b):
    """c * a + b."""
    return tree_map(lambda x, y: c * x + y, a, b)


def tree_lerp(a, b, eta):
    """(1 - eta) * a + eta * b."""
    return tree_map(lambda x, y: (1.0 - eta) * x + eta * y, a, b)


def tree_dot(a, b):
    """The sum over leaves of each leaf pair's flat dot product."""
    return sum(tree_flatten(tree_map(
        lambda x, y: torch.vdot(x.reshape(-1), y.reshape(-1)), a, b))[0])


def tree_sq_norm(a):
    return tree_dot(a, a)


def tree_norm(a):
    return torch.sqrt(tree_sq_norm(a))


def tree_nbytes(a):
    """Total bytes of all leaves (shapes and dtypes only)."""
    return sum(x.numel() * x.element_size() for x in tree_flatten(a)[0])


def tree_size(a):
    return sum(x.numel() for x in tree_flatten(a)[0])


def tree_cast(a, dtype):
    return tree_map(lambda x: x.to(dtype), a)


def tree_stack(trees, axis=0):
    return tree_map(lambda *xs: torch.stack(xs, dim=axis), *trees)


def tree_index(tree, idx):
    """tree[idx] along the leading axis of every leaf."""
    return tree_map(lambda x: x[idx], tree)


def tree_where(pred, a, b):
    return tree_map(lambda x, y: torch.where(pred, x, y), a, b)


def tree_broadcast_leading(tree, n):
    """The tree tiled along a new leading axis of size n (views)."""
    return tree_map(lambda x: x[None].expand((n,) + tuple(x.shape)), tree)


def tree_all_finite(a):
    return torch.stack([torch.isfinite(x).all()
                        for x in tree_flatten(a)[0]]).all()


def tree_consensus_mean(params):
    """Mean over the leading agent axis of stacked ``[A, ...]`` params."""
    return tree_map(lambda x: torch.mean(x, dim=0), params)


def tree_consensus_error(params):
    """Total squared deviation from the agent mean."""
    sq = tree_map(lambda x: torch.sum((x - torch.mean(x, dim=0)) ** 2),
                  params)
    return sum(tree_flatten(sq)[0])


def meta_like(shape, dtype) -> torch.Tensor:
    """A ``meta`` tensor (shape and dtype, no storage): the port's
    ``jax.ShapeDtypeStruct``."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def abstract_counter() -> torch.Tensor:
    """The round counter's abstract leaf, the reference's int32 scalar."""
    return meta_like((), torch.int32)
