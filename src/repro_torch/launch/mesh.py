"""Device meshes over ``torch.distributed`` (the counterpart of
``src/repro/launch/mesh.py``).

The reference drives every device from one process and names the
devices of a ``jax`` mesh.  The port runs one process per device: a
``torch.distributed`` world whose ranks are laid out as a ``DeviceMesh``
with the reference's axis names.

* single pod: ``(16, 16)``, axes ``("data", "model")``;
* multi-pod: ``(2, 16, 16)``, axes ``("pod", "data", "model")``, where
  the "pod" axis carries LT-ADMM-CC's agent graph (``agent_axis_for``).

``make_host_mesh`` lays any initialised world out as ``("data",
"model")``; its device type follows the default group's backend (``cpu``
for gloo, ``cuda`` for NCCL).  ``world`` starts a world from a
``FileStore`` (no TCP port, no network) and destroys it on exit.
``use_mesh`` sets the ambient mesh that sequence-sharded attention reads,
as ``jax.set_mesh`` does for the reference.

The sharding rules (``launch.sharding``) read a mesh through
``axes_of``: its axis names and its ``{name: size}`` shape, so they work
as well with a stand-in that has only ``axis_names`` and ``shape``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading

import torch
import torch.distributed as dist

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """A mesh's axis names and sizes, as the sharding rules read them
    (``mesh.shape[name]``, ``mesh.axis_names``)."""

    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


def axes_of(mesh):
    """``MeshAxes`` of a ``DeviceMesh``; any other object (a stand-in with
    ``shape`` and ``axis_names``) is returned as it is."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return mesh
    return MeshAxes(tuple(names), tuple(mesh.shape))


def _device_type() -> str:
    if not dist.is_initialized():
        raise RuntimeError("no torch.distributed world is initialised: "
                           "start one first (launch.mesh.world)")
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _make_mesh(shape, axes):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh over the initialised world, which
    must hold exactly its 256 (512 with ``multi_pod``) ranks."""
    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != math.prod(shape):
        raise ValueError(
            f"the production mesh {dict(zip(axes, shape))} needs a world "
            f"of {math.prod(shape)} ranks, this one has {world}")
    return _make_mesh(shape, axes)


def make_host_mesh(n_devices=None, model=1, pods=1):
    """A ``("data", "model")`` mesh of ``(n / model, model)`` over the
    initialised world (``n`` defaults to, and must equal, its size); with
    ``pods`` > 1 the multi-pod layout ``("pod", "data", "model")`` of
    ``(pods, n / (pods * model), model)``."""
    world = dist.get_world_size() if dist.is_initialized() else 0
    n = n_devices or world
    if n != world or n % (model * pods):
        raise ValueError(f"a ({pods}, {n} / {model * pods}, {model}) mesh "
                         f"needs a world of {n} ranks with {model * pods} "
                         f"dividing it; this world has {world}")
    if pods > 1:
        return _make_mesh((pods, n // (pods * model), model),
                          ("pod", "data", "model"))
    return _make_mesh((n // model, model), ("data", "model"))


def agent_axis_for(mesh) -> str:
    """The mesh axis that carries the LT-ADMM-CC agent graph."""
    return "pod" if "pod" in axes_of(mesh).axis_names else "data"


_GROUPS = {}


def group_of(mesh, axes: tuple):
    """The process group of the ranks that share this rank's coordinates
    on every axis of ``mesh`` but ``axes``: ``mesh.get_group`` of one
    axis, else one ``new_group`` a block of the mesh, made at the first
    call on every rank at once (each rank makes every block's, in the
    same order) and cached."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), axes)
    if key not in _GROUPS:
        names = list(mesh.mesh_dim_names)
        ranks = mesh.mesh.permute(
            [i for i, n in enumerate(names) if n not in axes]
            + [names.index(a) for a in axes])
        blocks = ranks.reshape(-1, math.prod(ranks.shape[-len(axes):]))
        me = dist.get_rank()
        for block in blocks.tolist():
            g = dist.new_group(block)
            if me in block:
                _GROUPS[key] = (mesh, g)
    return _GROUPS[key][1]


@contextlib.contextmanager
def world(backend: str, store_file: str, rank: int = 0,
          world_size: int = 1, device=None):
    """Start a ``torch.distributed`` world from a ``FileStore`` at
    ``store_file`` (the ranks share the path) and destroy it on exit.
    ``device`` (a ``torch.device``) binds an NCCL rank to its card.  A
    failure to start raises: there is no fallback backend."""
    store = dist.FileStore(store_file, world_size)
    kw = {} if device is None else {"device_id": torch.device(device)}
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size, **kw)
    try:
        yield
    finally:
        dist.destroy_process_group()


_AMBIENT = threading.local()


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh inside the block (``current_mesh``),
    the counterpart of ``jax.set_mesh``."""
    prev = getattr(_AMBIENT, "mesh", None)
    _AMBIENT.mesh = mesh
    try:
        yield mesh
    finally:
        _AMBIENT.mesh = prev


def current_mesh():
    """The ambient mesh set by ``use_mesh``, or None."""
    return getattr(_AMBIENT, "mesh", None)
