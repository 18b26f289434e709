"""Compression operators (paper §II-B): the main-path part of
``repro/core/compression.py``.

A compressor's ``compress`` returns the wire representation (a
``Payload`` of named tensors) and ``decompress`` rebuilds the dense
message.  Implemented: ``Identity``, ``BBitQuantizer`` (the paper's C1,
``qbit``), ``RandK`` (C2, seed-synchronised: only the k values travel)
and ``TopK`` (biased, values plus indices).  ``seal_plane`` /
``verify_plane`` add and check the fault plane's crc + round-tag words.

Batching: where the reference ``vmap``s a per-message compressor, the
port passes a batch.  ``compress(keys, x)`` takes keys ``[..., 2]``
(``core.jaxrand``) and flat messages ``[..., n]``; ``decompress(keys,
payload, n)`` returns ``[..., n]``.  Random draws are bit-exact with the
reference's ``jax.random`` draws.

Backends: every compressor takes ``impl={auto,torch,kernel}``.
``torch`` is the counterpart of the reference's ``jnp``; ``kernel`` of
``pallas``: hand-written CUDA kernels, on two routes.  The fused plane
route (qbit, RandK block/stride on the packed LT-ADMM round) compresses a
whole round's messages in one launch with the randomness derived in the
kernel (K1-K3).  The per-message route (every other case: the gossip
baselines, the pytree round, RandK uniform, TopK) launches the
per-message kernels once for a batch of messages: qbit K4/K5, RandK's
block sampler K8/K9 (one offset per message, the window computed in the
kernel), RandK uniform/stride and TopK K6/K7 with their indices computed
outside the kernel, as in the reference.  ``auto`` is
``kernel`` for CUDA tensors and ``torch`` otherwise.  On a CPU tensor
the kernel wrappers run their plain versions, as Pallas runs in
interpret mode off the TPU.  The kernel route never runs the torch
route instead of a kernel.  As in the
reference, the torch and kernel qbit routes draw different rounding bits
(``jax.random.uniform`` vs raw ``jax.random.bits`` or the counter cipher).

Tensor parallelism and FSDP: ``ShardedTree`` compresses a tree whose
leaves are a rank's shards over the "model" axis, or over "data" and
"model" (``launch.sharding.shard_layouts``)
as the reference compresses the whole leaves: one message a leaf.  The
identity sends the shard; qbit quantises it at the whole leaf's scale
(the ranks' row max all-reduced with MAX over the axes, once for a
whole message tree) with each element's rounding bits drawn at its flat
index in the whole leaf (the kernel route: K4's shard form, one launch a
pass for the whole tree; the torch route: ``jaxrand.bits_at``), so the
ranks' payloads are the whole leaf's, cut.  The receiver
dequantises its shard alone (K5 as it is).  RandK and TopK select over
the whole leaf and raise on a shard (ROADMAP item 15).
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping
from typing import Any

import torch

from repro_torch.common.trees import tree_flatten, tree_map
from repro_torch.core import jaxrand
from repro_torch.kernels import prng
from repro_torch.kernels.quantize import ops as qops
from repro_torch.kernels.quantize import ref as qref
from repro_torch.kernels.sparse_gather import ops as sgops
from repro_torch.kernels.sparse_gather.ref import scatter_last

IMPLS = ("auto", "torch", "kernel")


def resolve_impl(impl: str, device) -> str:
    """``auto`` -> ``torch`` on the CPU, ``kernel`` elsewhere (the card,
    and a ``meta`` trace of the card's route); explicit ``torch``/
    ``kernel`` always win."""
    _check_impl(impl)
    if impl == "auto":
        return "torch" if torch.device(device).type == "cpu" else "kernel"
    return impl


def _check_impl(impl: str):
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


class Payload(Mapping):
    """Wire representation of a batch of messages: named tensors, plus the
    byte count of the leaves as stored."""

    __slots__ = ("_leaves",)

    def __init__(self, **leaves):
        self._leaves = dict(sorted(leaves.items()))

    def __getitem__(self, k):
        return self._leaves[k]

    def __iter__(self):
        return iter(self._leaves)

    def __len__(self):
        return len(self._leaves)

    def __repr__(self):
        inner = ", ".join(f"{k}={v!r}" for k, v in self._leaves.items())
        return f"Payload({inner})"

    @property
    def wire_bytes(self) -> int:
        return sum(v.numel() * v.element_size() for v in self._leaves.values())


@dataclasses.dataclass(frozen=True)
class Spec:
    """Shape and dtype of one message (the reference's ShapeDtypeStruct)."""

    shape: tuple
    dtype: torch.dtype = torch.float32


# ---------------------------------------------------------------------------
# Leaf-level compressors (batched over leading message dims)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Identity:
    impl: str = "auto"
    name: str = "identity"
    unbiased: bool = True

    def __post_init__(self):
        _check_impl(self.impl)

    def compress(self, keys, x) -> Payload:
        return Payload(v=x)

    def decompress(self, keys, payload, n: int):
        return payload["v"]

    def variance_p(self, shape) -> float:
        return 1.0

    def wire_bytes(self, shape, dtype) -> int:
        return math.prod(shape) * dtype.itemsize


@dataclasses.dataclass(frozen=True)
class BBitQuantizer:
    """The paper's C1: C(x) = (||x||_inf / s) sign(x) floor(s |x| /
    ||x||_inf + kappa), s = 2^(b-1) - 1, kappa ~ U[0, 1)^n."""

    bits: int = 8
    impl: str = "auto"
    name: str = "qbit"
    unbiased: bool = True

    def __post_init__(self):
        _check_impl(self.impl)
        if self.bits not in (4, 8):
            raise ValueError(
                f"wire packing implemented for bits in (4, 8), got {self.bits}")

    @property
    def levels(self) -> int:
        return 2 ** (self.bits - 1) - 1

    def compress(self, keys, x) -> Payload:
        if resolve_impl(self.impl, x.device) == "kernel":
            q, scale = qops.quantize_tensor(keys, x.to(torch.float32),
                                            bits=self.bits)
            return Payload(q=q, scale=scale)
        xf = x.to(torch.float32)
        scale = qref.row_scale(xf)
        kappa = jaxrand.uniform(keys.to(x.device), xf.shape[-1:])
        q = qref.to_int8(qref.quantize_values(xf, scale[..., None], kappa,
                                              self.levels))
        if self.bits == 4:
            q = qref.pack4(q)
        return Payload(q=q, scale=scale)

    def compress_shard(self, keys, x, layout) -> Payload:
        """``compress`` of the whole leaves whose rank's shards ``x
        [..., n_local]`` are laid out as ``layout``: the rank's part of
        each whole leaf's payload (``compress_shards`` of one leaf)."""
        return self.compress_shards(keys[..., None, :], [x], (layout,))[0]

    def compress_shards(self, keys, xs, layouts) -> list:
        """``compress`` of the whole leaves of a message tree whose rank's
        shards are ``xs`` (``[..., n_i]``, one lead shape), leaf i laid
        out as ``layouts[i]`` and keyed by ``keys[..., i, :]`` (``keys
        [..., L, 2]``): the rank's part of each whole leaf's payload.  The
        cut leaves' scales take one all-reduce with MAX for the whole
        tree, over the ambient mesh's axes that cut any leaf (the
        layouts' ``axes``, in mesh order: ``("data", "model")`` for
        FSDP+TP, the agent's whole group, where a leaf cut over one of
        them is replicated over the other); a leaf held whole keeps its
        own (every rank holds it).  The kernel route is K4's
        shard form, one launch a pass for every leaf; the torch route
        quantises leaf by leaf.  Returns the payloads in the leaves'
        order."""
        from repro_torch.launch import tp
        from repro_torch.launch.mesh import current_mesh, group_of

        xs = [x.to(torch.float32) for x in xs]
        layouts = tuple(layouts)
        m = qref.tree_rows(xs)[1]

        def reduce_max(t):
            mesh = current_mesh()
            return tp.all_reduce_max(t, group_of(mesh,
                                                 cut_axes(layouts, mesh)))

        if resolve_impl(self.impl, xs[0].device) == "kernel":
            words = qops.tree_absmax(xs, layouts)
            cut = qops.cut_rows(layouts, m)
            reduced = reduce_max(words[:cut]) if cut else None
            return [Payload(q=q, scale=sc) for q, sc in qops.quantize_tree(
                keys, xs, words, layouts, bits=self.bits, reduced=reduced)]
        cut = [i for i, lay in enumerate(layouts) if lay.cut]
        scales = {}
        if cut:
            top = reduce_max(torch.stack([qref.row_scale(xs[i])
                                          for i in cut]))
            scales = dict(zip(cut, top))
        out = []
        for i, (x, lay) in enumerate(zip(xs, layouts)):
            k = keys[..., i, :]
            if not lay.cut:
                out.append(self.compress(k, x))
                continue
            kappa = jaxrand.unit(jaxrand.bits_at(k.to(x.device),
                                                 lay.counters(x.device)))
            q = qref.to_int8(qref.quantize_values(
                x, scales[i][..., None], kappa, self.levels))
            out.append(Payload(q=qref.pack4(q) if self.bits == 4 else q,
                               scale=scales[i]))
        return out

    def decompress(self, keys, payload, n: int):
        if resolve_impl(self.impl, payload["q"].device) == "kernel":
            return qops.dequantize_tensor(payload["q"], payload["scale"],
                                          n=n, bits=self.bits)
        q = payload["q"]
        if self.bits == 4:
            q = qref.unpack4(q, n)
        return qref.dequantize_values(q, payload["scale"], self.levels)

    # -- fused plane route: one launch for all [A, S, N] messages --

    def plane_ready(self) -> bool:
        return True

    def compress_plane(self, seed, sids, rids, x) -> Payload:
        q, scale = qops.quantize_plane(seed, sids, rids, x, bits=self.bits)
        return Payload(q=q, scale=scale)

    def decompress_plane(self, seed, sids, rids, payload, n: int):
        return qops.dequantize_plane(payload["q"], payload["scale"], n=n,
                                     bits=self.bits)

    def variance_p(self, shape) -> float:
        return 1.0 + math.prod(shape) / (4.0 * self.levels ** 2)

    def wire_bytes(self, shape, dtype) -> int:
        return (math.prod(shape) * self.bits + 7) // 8 + 4


@dataclasses.dataclass(frozen=True)
class RandK:
    """The paper's C2, seed-synchronised so no index travels.  k =
    max(1, round(fraction * n)); samplers ``uniform`` (permutation),
    ``block`` (cyclic window at a random offset) and ``stride`` (seeded
    affine set with a stride from a static coprime table)."""

    fraction: float = 0.25
    sampler: str = "uniform"
    impl: str = "auto"
    name: str = "randk"
    unbiased: bool = True

    def __post_init__(self):
        _check_impl(self.impl)
        if self.sampler not in ("uniform", "block", "stride"):
            raise ValueError(
                "sampler must be one of ('uniform', 'block', 'stride'), "
                f"got {self.sampler!r}")

    def _k(self, n: int) -> int:
        return max(1, int(round(self.fraction * n)))

    def _strides(self, n: int) -> tuple:
        return (1,) if self.sampler == "block" else prng.coprime_strides(n)

    def _offset(self, keys, n: int):
        """The block sampler's per-message window offset."""
        return jaxrand.randint(keys, (), 0, n)

    def _indices(self, keys, n: int):
        k = self._k(n)
        if self.sampler == "uniform":
            return jaxrand.permutation(keys, n)[..., :k]
        if self.sampler == "stride":
            return prng.affine_indices((keys[..., 0], keys[..., 1]), n, k,
                                       self._strides(n))
        off = self._offset(keys, n)
        return (off[..., None] + torch.arange(k, device=keys.device)) % n

    def _block_kernel(self, device) -> bool:
        """The block sampler on the kernel route (K8/K9): one offset per
        message, drawn where the keys are (the host, in the solvers), so
        that no index row and no per-offset device op exists."""
        return (self.sampler == "block"
                and resolve_impl(self.impl, device) == "kernel")

    def compress(self, keys, x) -> Payload:
        n = x.shape[-1]
        if self._block_kernel(x.device):
            return Payload(v=sgops.cyclic_gather(x, self._offset(keys, n),
                                                 self._k(n)))
        idx = self._indices(keys.to(x.device), n)
        if resolve_impl(self.impl, x.device) == "kernel":
            return Payload(v=sgops.sparse_gather(x, idx))
        return Payload(v=torch.gather(x, -1, idx))

    def decompress(self, keys, payload, n: int):
        v, k = payload["v"], self._k(n)
        if self._block_kernel(v.device):
            return sgops.cyclic_scatter(v, self._offset(keys, n), n, n / k)
        idx = self._indices(keys.to(v.device), n)
        if resolve_impl(self.impl, v.device) == "kernel":
            # permutation rows are unique; the stride set only while
            # its int32 sum cannot wrap onto an earlier index
            unique = (self.sampler == "uniform" or sgops.indices_unique(
                n, k, self._strides(n)))
            return sgops.sparse_scatter(v, idx, n, n / k, unique=unique)
        gain = torch.tensor(n / k, dtype=v.dtype, device=v.device)
        lead = tuple(v.shape[:-1])
        out = scatter_last(idx.reshape(-1, idx.shape[-1]),
                           (gain * v).reshape(-1, v.shape[-1]), n)
        return out.reshape(lead + (n,))

    # -- fused plane route: index sets derived in the kernel --

    def plane_ready(self) -> bool:
        return self.sampler in ("block", "stride")

    def compress_plane(self, seed, sids, rids, x) -> Payload:
        n = x.shape[-1]
        return Payload(v=sgops.randk_gather_plane(
            seed, sids, rids, x, k=self._k(n), strides=self._strides(n)))

    def decompress_plane(self, seed, sids, rids, payload, n: int):
        return sgops.randk_scatter_plane(
            seed, sids, rids, payload["v"], n=n, gain=n / self._k(n),
            strides=self._strides(n))

    def variance_p(self, shape) -> float:
        n = math.prod(shape)
        return n / self._k(n)

    def wire_bytes(self, shape, dtype) -> int:
        return self._k(math.prod(shape)) * dtype.itemsize


@dataclasses.dataclass(frozen=True)
class TopK:
    """Biased magnitude top-k: values plus int32 indices on the wire."""

    fraction: float = 0.25
    impl: str = "auto"
    name: str = "topk"
    unbiased: bool = False

    def __post_init__(self):
        _check_impl(self.impl)

    def _k(self, n: int) -> int:
        return max(1, int(round(self.fraction * n)))

    def compress(self, keys, x) -> Payload:
        k = self._k(x.shape[-1])
        # lax.top_k order: descending, ties by lower index first (the
        # sort stays a library call: the reference sorts outside Pallas)
        idx = torch.sort(x.abs(), dim=-1, descending=True,
                         stable=True).indices[..., :k]
        if resolve_impl(self.impl, x.device) == "kernel":
            v = sgops.sparse_gather(x, idx)
        else:
            v = torch.gather(x, -1, idx)
        return Payload(v=v, idx=idx.to(torch.int32))

    def decompress(self, keys, payload, n: int):
        v = payload["v"]
        if resolve_impl(self.impl, v.device) == "kernel":
            # a top-k index set is unique by construction
            return sgops.sparse_scatter(v, payload["idx"], n, unique=True)
        lead = tuple(v.shape[:-1])
        out = scatter_last(payload["idx"].reshape(-1, v.shape[-1]).long(),
                           v.reshape(-1, v.shape[-1]), n)
        return out.reshape(lead + (n,))

    def variance_p(self, shape) -> float:
        n = math.prod(shape)
        return float(n) / self._k(n)

    def wire_bytes(self, shape, dtype) -> int:
        return self._k(math.prod(shape)) * (dtype.itemsize + 4)


# ---------------------------------------------------------------------------
# Tensor parallelism: a tree of a rank's shards over the "model" axis
# ---------------------------------------------------------------------------


def cut_axes(layouts, mesh) -> tuple:
    """The axes of ``mesh`` that cut any of ``layouts``' leaves, in mesh
    order: the group over which a tree's cut scales are all-reduced."""
    from repro_torch.launch.mesh import axes_of

    cut = {a for lay in layouts if lay.cut for a in lay.axes}
    return tuple(a for a in axes_of(mesh).axis_names if a in cut)


@dataclasses.dataclass(frozen=True)
class ShardLeaf:
    """``inner`` on a rank's shard of one leaf laid out as ``layout``
    (``kernels.quantize.ref.ShardLayout``): the rank's part of the whole
    leaf's message, decompressed alone."""

    inner: Any
    layout: Any

    def compress(self, keys, x) -> Payload:
        if isinstance(self.inner, Identity):
            return self.inner.compress(keys, x)
        if isinstance(self.inner, BBitQuantizer):
            return self.inner.compress_shard(keys, x, self.layout)
        raise NotImplementedError(
            f"{self.inner.name} on a leaf cut over the 'model' axis: its "
            "index set is drawn over the whole leaf (ROADMAP item 15); "
            "tensor-parallel training takes identity or qbit")

    def decompress(self, keys, payload, n: int):
        return self.inner.decompress(keys, payload, n)


@dataclasses.dataclass(frozen=True)
class ShardedTree:
    """``inner`` over a tree whose leaf i is a rank's shard laid out as
    ``layouts[i]`` (flatten order): a cut leaf through ``ShardLeaf``, a
    leaf held whole through ``inner`` itself (every rank sends the same
    message).  Every other attribute is ``inner``'s; the wire bytes are
    the whole leaves' (``tree_wire_bytes``)."""

    inner: Any
    layouts: tuple

    def __getattr__(self, name):
        if name in ("inner", "layouts") or name.startswith("__"):
            raise AttributeError(name)
        return getattr(self.inner, name)

    def leaf(self, i: int):
        lay = self.layouts[i]
        return ShardLeaf(self.inner, lay) if lay.cut else self.inner

    def message_nbytes(self, dtypes) -> int:
        """One message's wire bytes over every leaf, as the reference's
        whole leaves give them (``dtypes``: each leaf's)."""
        return sum(self.inner.wire_bytes(tuple(lay.shape), dt)
                   for lay, dt in zip(self.layouts, dtypes))


def _leaf_comp(comp, i: int):
    return comp.leaf(i) if isinstance(comp, ShardedTree) else comp


def message_nbytes(comp, payload, nd: int) -> int:
    """Wire bytes of ONE message of a batched payload tree (leaves with
    ``nd`` lead dims), as the reference counts them: measured on the
    payload's leaves, and for a ``ShardedTree`` the whole leaves' (the
    ranks' own bytes are what the exchange counts)."""
    from repro_torch.obs import telemetry

    if isinstance(comp, ShardedTree):
        leaves = tree_flatten(payload,
                              is_leaf=lambda t: isinstance(t, Payload))[0]
        return comp.message_nbytes([p["v"].dtype if "v" in p
                                    else torch.float32 for p in leaves])
    return telemetry.payload_nbytes(payload, nd)


# ---------------------------------------------------------------------------
# Tree-level wrappers: every leaf with its own split key
# ---------------------------------------------------------------------------


def compress_tree(comp, keys, tree, nd: int):
    """Compress every leaf of a tree whose leaves carry ``nd`` lead
    (message) dims; ``keys`` is ``[*lead, 2]``.  Leaf i uses
    ``split(key, n_leaves)[i]``, as the reference does.  A
    ``ShardedTree`` of qbit compresses all of its leaves in one call
    (``BBitQuantizer.compress_shards``)."""
    leaves, rebuild = tree_flatten(tree)
    lk = jaxrand.split(keys, len(leaves))
    flat = [x.reshape(tuple(x.shape[:nd]) + (-1,)) for x in leaves]
    if isinstance(comp, ShardedTree) and isinstance(comp.inner,
                                                    BBitQuantizer):
        return rebuild(comp.inner.compress_shards(lk, flat, comp.layouts))
    return rebuild([_leaf_comp(comp, i).compress(lk[..., i, :], x)
                    for i, x in enumerate(flat)])


def decompress_tree(comp, keys, payload_tree, like_tree, nd: int):
    """Inverse of ``compress_tree``; ``like_tree`` holds one ``Spec`` per
    leaf (the per-message shape)."""
    likes, rebuild = tree_flatten(like_tree)
    payloads, _ = tree_flatten(payload_tree,
                               is_leaf=lambda t: isinstance(t, Payload))
    lk = jaxrand.split(keys, len(likes))
    outs = []
    for i, (p, like) in enumerate(zip(payloads, likes)):
        n = math.prod(like.shape)
        d = _leaf_comp(comp, i).decompress(lk[..., i, :], p, n)
        outs.append(d.reshape(tuple(d.shape[:nd]) + tuple(like.shape))
                    .to(like.dtype))
    return rebuild(outs)


def like_per_message(stacked, nd: int = 1):
    """Tree of ``[*lead, ...]`` leaves (``nd`` lead dims) -> the tree of
    one message's ``Spec``s."""
    return tree_map(lambda x: Spec(tuple(x.shape[nd:]), x.dtype), stacked)


def tree_wire_bytes(comp, tree) -> int:
    """One message's wire bytes over the leaves of ``tree``; for a
    ``ShardedTree`` the whole leaves' (``tree`` may hold the shards)."""
    leaves = tree_flatten(tree)[0]
    if isinstance(comp, ShardedTree):
        return comp.message_nbytes([x.dtype for x in leaves])
    return sum(comp.wire_bytes(tuple(x.shape), x.dtype) for x in leaves)


# ---------------------------------------------------------------------------
# Plane-level helpers: a whole round's [..., N] messages
# ---------------------------------------------------------------------------


def use_fused(comp, device) -> bool:
    ready = getattr(comp, "plane_ready", None)
    return (ready is not None and ready()
            and resolve_impl(comp.impl, device) == "kernel")


def _lead_dims(tree, like) -> int:
    """Message dims of ``tree`` before its per-message shape ``like`` (a
    payload's leaves hold each message flat)."""
    x = tree_flatten(tree, is_leaf=lambda t: isinstance(t, Payload))[0][0]
    if isinstance(x, Payload):
        return next(iter(x.values())).dim() - 1
    return x.dim() - len(tree_flatten(like)[0][0].shape)


def plane_compress(comp, keys_fn, base_key, sids, rids, delta, like):
    """Compress every message of ``delta`` (a plane ``[..., N]`` or a tree
    of ``[..., *shape]`` leaves; ``like`` the per-message ``Spec`` or tree
    of them) and return ``(payload, reconstruction)``.

    Fused route (a single plane, kernel impl and a plane-capable
    compressor): one launch for the plane, randomness derived in the
    kernel from ``(key_seed(base_key), sender, receiver)``; ``sids``/
    ``rids`` are the per-message ids (int32 tensors on the plane's
    device, ``rids=None`` for one-to-all messages).  Otherwise (a tree
    always) the per-message route leaf by leaf with keys ``keys_fn()``
    (``[..., 2]``), bit-identical to the reference's vmapped
    ``compress_tree``."""
    if isinstance(delta, torch.Tensor) and use_fused(comp, delta.device):
        seed = jaxrand.key_seed(base_key)
        n = math.prod(like.shape)
        p = comp.compress_plane(seed, sids, rids, delta)
        return p, comp.decompress_plane(seed, sids, rids, p, n)
    nd = _lead_dims(delta, like)
    keys = keys_fn()
    p = compress_tree(comp, keys, delta, nd)
    return p, decompress_tree(comp, keys, p, like, nd)


def plane_decompress(comp, keys_fn, base_key, sids, rids, payload, like):
    """Receiver-side reconstruction of a payload plane (or tree of
    payloads): the same per-message randomness as ``plane_compress``."""
    if isinstance(payload, Payload) and use_fused(
            comp, next(iter(payload.values())).device):
        seed = jaxrand.key_seed(base_key)
        return comp.decompress_plane(seed, sids, rids, payload,
                                     math.prod(like.shape))
    return decompress_tree(comp, keys_fn(), payload, like,
                           _lead_dims(payload, like))


# ---------------------------------------------------------------------------
# Sealed payloads: additive checksum + round tag (fault detection)
# ---------------------------------------------------------------------------

# wire overhead of a sealed message: crc + tag, one 4-byte word each (int32
# tensors holding the reference's uint32 bits)
SEAL_BYTES = 8

_SEAL_KEYS = ("crc", "tag")
# a leaf's bits as a signed integer of its width, and the mask that makes
# the value unsigned after widening
_VIEW_OF_WIDTH = {1: (torch.uint8, None), 2: (torch.int16, 0xFFFF),
                  4: (torch.int32, prng.MASK)}
# elements widened at a time by the checksum: bounds its scratch (64 MB
# of int32); and the columns of a chunk whose int32 sum cannot overflow
# (255 * 2^23, 65535 * 2^15 < 2^31)
_SUM_CHUNK = 1 << 24
_COLS_CAP = {1: 1 << 23, 2: 1 << 15}


def _u32_view(leaf):
    """Bit-exact uint32 view of a leaf (narrow types widen losslessly), in
    int64: the checksum's plain definition, which the chunked
    ``_leaf_sum`` is held to (tests/test_torch_faults.py)."""
    view, mask = _VIEW_OF_WIDTH[leaf.element_size()]
    v = leaf.view(view).to(torch.int64)
    return v if mask is None else v & mask


def _leaf_sum(leaf, nd: int):
    """Sum mod 2^32 of each message's elements as uint32 (``[lead]``
    int64).  The widening runs over even column chunks of about
    ``_SUM_CHUNK`` elements, so a large plane never has a whole wide
    copy; 1- and 2-byte leaves widen to int32 (a chunk's columns are
    capped so its sum cannot overflow), 4-byte leaves to int64, reduced
    mod 2^32 at the end (the sum of signed words is congruent to the sum
    of their unsigned bits)."""
    width = leaf.element_size()
    view, mask = _VIEW_OF_WIDTH[width]
    lead = tuple(leaf.shape[:nd])
    flat = leaf.reshape(math.prod(lead), -1).view(view)
    wide = torch.int64 if width == 4 else torch.int32
    rows, n = flat.shape
    chunks = max(1, -(-rows * n // _SUM_CHUNK),
                 -(-n // _COLS_CAP.get(width, n or 1)))
    cols = max(1, -(-n // chunks))
    tot = None
    for c0 in range(0, n, cols):
        part = flat[:, c0:c0 + cols].to(wide)
        if width == 2:
            part &= mask
        s = part.sum(dim=1, dtype=wide).to(torch.int64)
        tot = s if tot is None else tot + s
    if tot is None:
        tot = torch.zeros(flat.shape[0], dtype=torch.int64,
                          device=leaf.device)
    return (tot & prng.MASK).reshape(lead)


def payload_checksum(payload, nd: int):
    """Additive mod-2^32 checksum over the data leaves of a payload whose
    leaves carry ``nd`` lead (message) dims: ``[lead]`` int64 holding the
    reference's uint32 word.  Additive on purpose: any single bit flip
    moves the sum by a nonzero power of two, and linearity lets a stale
    rewind keep the checksum valid (rejected by the tag alone)."""
    tot = None
    for k in payload:
        if k in _SEAL_KEYS:
            continue
        s = _leaf_sum(payload[k], nd)
        tot = s if tot is None else (tot + s) & prng.MASK
    return tot


def _i32(words):
    """int64 holding uint32 -> int32 with the same bits."""
    return prng.wrap_i32(words).to(torch.int32)


def seal_plane(payload, tag, nd: int):
    """Add ``crc``/``tag`` leaves (``crc = checksum + tag`` mod 2^32,
    int32 tensors holding the uint32 bits) to a batched payload; ``tag``
    is the round index (an int)."""
    csum = payload_checksum(payload, nd)
    tag_arr = torch.full(csum.shape, int(tag) & prng.MASK,
                         dtype=torch.int64, device=csum.device)
    return Payload(**dict(payload), crc=_i32(csum + tag_arr),
                   tag=_i32(tag_arr))


def verify_plane_kinds(payload, expected_tag):
    """Strip the seal and verdict each message with the failure kind split
    out: ``(data_payload, ok, crc_ok, tag_ok)``, all verdicts [lead] bool.
    ``crc_ok`` fails on dropped or corrupted payloads, ``tag_ok`` on a
    wrong-round delivery (a stale replay is checksum-consistent, so the
    tag alone rejects it).  ``ok = crc_ok & tag_ok``."""
    crc = payload["crc"].to(torch.int64) & prng.MASK
    tag = payload["tag"].to(torch.int64) & prng.MASK
    data = Payload(**{k: v for k, v in payload.items()
                      if k not in _SEAL_KEYS})
    crc_ok = ((payload_checksum(data, crc.dim()) + tag) & prng.MASK) == crc
    tag_ok = tag == (int(expected_tag) & prng.MASK)
    return data, crc_ok & tag_ok, crc_ok, tag_ok


def verify_plane(payload, expected_tag):
    """Strip the seal and verdict each message: ``(data_payload, ok)``,
    ``ok`` [lead] True iff the checksum holds and the round tag matches.
    Callers gate on ``ok``, never on the possibly-poisoned data."""
    data, ok, _, _ = verify_plane_kinds(payload, expected_tag)
    return data, ok


# ---------------------------------------------------------------------------
# Registry + spec parsing (same grammar and messages as the reference)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CompressorEntry:
    name: str
    cls: type
    params: frozenset
    doc: str = ""


def _entry(cls, doc: str) -> CompressorEntry:
    name = cls.__dataclass_fields__["name"].default
    params = frozenset(f.name for f in dataclasses.fields(cls)
                       if f.init and f.name not in ("name", "unbiased"))
    return CompressorEntry(name=name, cls=cls, params=params, doc=doc)


COMPRESSORS: dict[str, CompressorEntry] = {
    e.name: e
    for e in (
        _entry(Identity, "no compression (exact LT-ADMM)"),
        _entry(BBitQuantizer, "unbiased stochastic b-bit quantizer (C1)"),
        _entry(RandK, "seed-synchronized rand-k, zero index bytes (C2)"),
        _entry(TopK, "biased magnitude top-k (values + indices, needs EF)"),
    )
}


def compressor_entry(name: str) -> CompressorEntry:
    try:
        return COMPRESSORS[name]
    except KeyError:
        raise ValueError(f"unknown compressor {name!r}; choose from "
                         f"{sorted(COMPRESSORS)}") from None


def coerce_param(v):
    """Spec-string value -> int, then float, then bool literal, else the
    string itself."""
    if not isinstance(v, str):
        return v
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    return v


def _parse_spec(spec: str):
    name, _, rest = spec.partition(":")
    entry = compressor_entry(name)
    params = {}
    for item in rest.replace("|", ",").split(","):
        if not item:
            continue
        k, eq, v = item.partition("=")
        if not eq:
            raise ValueError(f"malformed compressor param {item!r} in spec "
                             f"{spec!r} (expected k=v)")
        params[k.strip()] = coerce_param(v.strip())
    return entry, params


def _construct(entry: CompressorEntry, params: dict):
    unknown = sorted(set(params) - entry.params)
    if unknown:
        raise ValueError(
            f"compressor {entry.name!r} got unknown param(s) {unknown}; "
            f"valid params: {sorted(entry.params)}")
    try:
        return entry.cls(**params)
    except TypeError as e:
        raise ValueError(
            f"bad params for compressor {entry.name!r}: {e}") from None


def validate_spec(spec: str) -> None:
    """Parse-time validation of a compressor spec; raises what
    ``get_compressor`` would."""
    _construct(*_parse_spec(spec))


def get_compressor(spec: str, **kw):
    """Compressor from a spec string ``name[:k=v,...]`` (``|`` may stand
    for ``,`` when nested in a solver spec)."""
    entry, params = _parse_spec(spec)
    params.update(kw)
    return _construct(entry, params)
