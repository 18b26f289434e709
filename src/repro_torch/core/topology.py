"""Agent graph topologies and the host-simulated neighbor exchange.

Port of ``repro/core/topology.py``.  The graph tables are host numpy, as
in the reference (they are constants of the round).  Slot model: edge
state carries ``[A, S, ...]``; slot ``s`` of agent ``i`` names the edge
to ``neighbor_table()[i, s]`` where ``slot_mask()[i, s]`` is True, and
points at ``i`` itself (a masked slot) otherwise.  ``reverse_slot[s]`` is
the neighbor's slot that names the same edge.

``Exchange`` routes messages inside one process by indexing the agent
axis, or, given a mesh axis, between the ranks of a ``torch.distributed``
world: one ``all_to_all_single`` per slot and leaf, where the reference
makes one collective-permute per slot.  A masked slot delivers the
agent's own message on both paths.  A fault-armed exchange (``faults``, a
``core.faults.FaultPlane``) injects the round's seeded faults into routed
sealed payloads when a call passes ``round_index``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.common.trees import tree_map


@runtime_checkable
class Topology(Protocol):
    """Structural view of an undirected agent graph (see the module
    docstring).  Implementations are frozen dataclasses whose tables are
    host numpy."""

    n_agents: int

    @property
    def n_slots(self) -> int: ...

    # reverse_slot[s]: the neighbor's slot naming the same edge
    reverse_slot: tuple

    def neighbor_table(self) -> np.ndarray:  # [A, S] int, self where masked
        ...

    def slot_mask(self) -> np.ndarray:  # [A, S] bool
        ...

    def degrees(self) -> np.ndarray:  # [A] int
        ...


def edge_set(topo) -> set:
    """Directed edge pairs {(i, j)} of a topology (both directions)."""
    nbr, mask = topo.neighbor_table(), topo.slot_mask()
    return {
        (i, int(nbr[i, s]))
        for i in range(topo.n_agents)
        for s in range(topo.n_slots)
        if mask[i, s]
    }


def validate(topo) -> None:
    """Raise unless ``topo`` satisfies the structural invariants: every
    slot's receive map is a permutation with self-loops exactly on masked
    slots, edges are symmetric through ``reverse_slot``, and the graph is
    connected."""
    nbr, mask = topo.neighbor_table(), topo.slot_mask()
    a, s_ = topo.n_agents, topo.n_slots
    if nbr.shape != (a, s_) or mask.shape != (a, s_):
        raise ValueError(f"tables must be [{a}, {s_}], got {nbr.shape}")
    ids = np.arange(a)
    for s in range(s_):
        src = nbr[:, s]
        if (src[~mask[:, s]] != ids[~mask[:, s]]).any():
            raise ValueError(f"slot {s}: masked slot not a self-loop")
        if sorted(src.tolist()) != list(range(a)):
            raise ValueError(f"slot {s} receive map is not a permutation")
        if (src[mask[:, s]] == ids[mask[:, s]]).any():
            raise ValueError(f"slot {s} active self-loop")
    for i in range(a):
        for s in range(s_):
            if mask[i, s]:
                j, rs = int(nbr[i, s]), topo.reverse_slot[s]
                if not (mask[j, rs] and int(nbr[j, rs]) == i):
                    raise ValueError(f"edge ({i}, slot {s}) not symmetric")
    adj = {i: set() for i in range(a)}
    for (i, j) in edge_set(topo):
        adj[i].add(j)
    seen, stack = {0}, [0]
    while stack:
        for j in adj[stack.pop()]:
            if j not in seen:
                seen.add(j)
                stack.append(j)
    if len(seen) != a:
        raise ValueError(f"graph disconnected: reached {len(seen)}/{a}")


@dataclasses.dataclass(frozen=True)
class Ring:
    """Undirected ring (the paper's experiments).  Slot 0 is the (i-1)
    edge, slot 1 the (i+1) edge; two agents share a single slot-0 edge."""

    n_agents: int
    name = "ring"

    @property
    def n_slots(self) -> int:
        return 2

    @property
    def reverse_slot(self) -> tuple:
        return (0, 1) if self.n_agents == 2 else (1, 0)

    def neighbor_table(self) -> np.ndarray:
        ids = np.arange(self.n_agents)
        tab = np.stack([(ids - 1) % self.n_agents,
                        (ids + 1) % self.n_agents], axis=1)
        if self.n_agents == 2:
            tab[:, 1] = ids
        return tab

    def slot_mask(self) -> np.ndarray:
        mask = np.ones((self.n_agents, 2), dtype=bool)
        if self.n_agents == 2:
            mask[:, 1] = False
        return mask

    def degrees(self) -> np.ndarray:
        return self.slot_mask().sum(axis=1).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class Grid2D:
    """2-D torus of ``rows x cols`` agents, slots (west, east, north,
    south); agent id = r * cols + c."""

    rows: int
    cols: int
    name = "grid2d"

    def __post_init__(self):
        if self.rows < 3 or self.cols < 3:
            raise ValueError("Grid2D torus needs both sides >= 3")

    @property
    def n_agents(self) -> int:
        return self.rows * self.cols

    @property
    def n_slots(self) -> int:
        return 4

    reverse_slot = (1, 0, 3, 2)

    def neighbor_table(self) -> np.ndarray:
        r, c = np.divmod(np.arange(self.n_agents), self.cols)
        west = r * self.cols + (c - 1) % self.cols
        east = r * self.cols + (c + 1) % self.cols
        north = ((r - 1) % self.rows) * self.cols + c
        south = ((r + 1) % self.rows) * self.cols + c
        return np.stack([west, east, north, south], axis=1)

    def slot_mask(self) -> np.ndarray:
        return np.ones((self.n_agents, 4), dtype=bool)

    def degrees(self) -> np.ndarray:
        return np.full((self.n_agents,), 4, dtype=np.int64)


@functools.lru_cache(maxsize=None)
def _color_edges(n_agents: int, edges):
    """Greedy proper edge coloring -> (neighbor_table, mask); each color
    class is a matching.  ``edges`` must be a normalised hashable tuple;
    callers must not mutate the returned arrays."""
    edges = sorted({(min(i, j), max(i, j)) for (i, j) in edges})
    if any(i == j for (i, j) in edges):
        raise ValueError("self-loops not allowed")
    used = [set() for _ in range(n_agents)]
    colored, n_colors = [], 0
    for (i, j) in edges:
        c = 0
        while c in used[i] or c in used[j]:
            c += 1
        used[i].add(c)
        used[j].add(c)
        colored.append((i, j, c))
        n_colors = max(n_colors, c + 1)
    nbr = np.tile(np.arange(n_agents)[:, None], (1, max(n_colors, 1)))
    mask = np.zeros((n_agents, max(n_colors, 1)), dtype=bool)
    for (i, j, c) in colored:
        nbr[i, c], nbr[j, c] = j, i
        mask[i, c] = mask[j, c] = True
    return nbr, mask


@dataclasses.dataclass(frozen=True)
class GraphTopology:
    """Arbitrary undirected graph from an edge list (matching slots,
    ``reverse_slot[s] == s``)."""

    n_agents: int
    edges: tuple
    name: str = "graph"

    def __post_init__(self):
        es = tuple(sorted({(min(i, j), max(i, j)) for (i, j) in self.edges}))
        object.__setattr__(self, "edges", es)

    @classmethod
    def from_edges(cls, n_agents, edges, name="graph"):
        return cls(n_agents=n_agents, edges=tuple(edges), name=name)

    @property
    def n_slots(self) -> int:
        return self._tables()[0].shape[1]

    @property
    def reverse_slot(self) -> tuple:
        return tuple(range(self.n_slots))

    def _tables(self):
        return _color_edges(self.n_agents, self.edges)

    def neighbor_table(self) -> np.ndarray:
        return self._tables()[0]

    def slot_mask(self) -> np.ndarray:
        return self._tables()[1]

    def degrees(self) -> np.ndarray:
        d = np.zeros((self.n_agents,), dtype=np.int64)
        for (i, j) in self.edges:
            d[i] += 1
            d[j] += 1
        return d


def Star(n_agents: int) -> GraphTopology:
    """Hub-and-spoke: agent 0 is the hub."""
    if n_agents < 2:
        raise ValueError("star needs >= 2 agents")
    return GraphTopology.from_edges(
        n_agents, [(0, j) for j in range(1, n_agents)], name="star")


def Complete(n_agents: int) -> GraphTopology:
    """Fully connected graph K_n."""
    if n_agents < 2:
        raise ValueError("complete graph needs >= 2 agents")
    return GraphTopology.from_edges(
        n_agents,
        [(i, j) for i in range(n_agents) for j in range(i + 1, n_agents)],
        name="complete",
    )


def ErdosRenyi(n_agents: int, p: float = 0.3, seed: int = 0) -> GraphTopology:
    """G(n, p) made connected by a seeded Hamiltonian path."""
    rng = np.random.RandomState(seed)
    edges = {
        (i, j)
        for i in range(n_agents)
        for j in range(i + 1, n_agents)
        if rng.rand() < p
    }
    perm = rng.permutation(n_agents)
    for a, b in zip(perm, perm[1:]):
        edges.add((min(a, b), max(a, b)))
    return GraphTopology.from_edges(n_agents, edges, name=f"erdos{p}")


def SmallWorld(n_agents: int, k: int = 4, p: float = 0.1,
               seed: int = 0) -> GraphTopology:
    """Watts-Strogatz ring lattice with seeded rewiring, made connected by
    a seeded Hamiltonian path."""
    if k % 2 or not 2 <= k < n_agents:
        raise ValueError(f"smallworld needs even k in [2, n_agents), got {k}")
    rng = np.random.RandomState(seed)
    edges = {
        (min(i, (i + d) % n_agents), max(i, (i + d) % n_agents))
        for i in range(n_agents)
        for d in range(1, k // 2 + 1)
    }
    for e in sorted(edges):
        if rng.rand() >= p:
            continue
        i = e[0]
        cands = [j for j in range(n_agents)
                 if j != i and (min(i, j), max(i, j)) not in edges]
        if not cands:
            continue
        edges.discard(e)
        j = cands[rng.randint(len(cands))]
        edges.add((min(i, j), max(i, j)))
    perm = rng.permutation(n_agents)
    for a, b in zip(perm, perm[1:]):
        edges.add((min(a, b), max(a, b)))
    return GraphTopology.from_edges(n_agents, edges, name=f"smallworld{p}")


TOPOLOGIES = ("ring", "grid2d", "star", "complete", "erdos", "smallworld")


def make_topology(spec: str, n_agents: int):
    """Topology from a spec string ``name[:k=v,...]`` (``ring``,
    ``grid2d:rows=4``, ``erdos:p=0.4,seed=1``, ``smallworld:k=4,p=0.2``)."""
    name, _, rest = spec.partition(":")
    kw = {}
    if rest:
        for item in rest.split(","):
            k, _, v = item.partition("=")
            kw[k.strip()] = v.strip()
    known = {"ring": (), "grid2d": ("rows",), "star": (), "complete": (),
             "erdos": ("p", "seed"), "smallworld": ("k", "p", "seed")}
    if name not in known:
        raise ValueError(f"unknown topology {spec!r}; choose from {TOPOLOGIES}")
    extra = set(kw) - set(known[name])
    if extra:
        raise ValueError(
            f"topology {name!r} got unknown params {sorted(extra)}; "
            f"accepts {list(known[name])}")
    if name == "ring":
        return Ring(n_agents)
    if name == "grid2d":
        rows = int(kw.get("rows", round(np.sqrt(n_agents))))
        if n_agents % rows:
            raise ValueError(
                f"grid2d: n_agents={n_agents} not divisible by rows={rows}")
        return Grid2D(rows, n_agents // rows)
    if name == "star":
        return Star(n_agents)
    if name == "complete":
        return Complete(n_agents)
    if name == "erdos":
        return ErdosRenyi(n_agents, p=float(kw.get("p", 0.3)),
                          seed=int(kw.get("seed", 0)))
    return SmallWorld(n_agents, k=int(kw.get("k", 4)),
                      p=float(kw.get("p", 0.1)), seed=int(kw.get("seed", 0)))


@dataclasses.dataclass(frozen=True)
class _SlotRoute:
    """One slot's all-to-all on a mesh axis, from rank ``p``'s side:
    which local rows go out (grouped by destination rank, None for all
    rows in order), the split sizes, and the local row each received
    message lands on (None for all rows in order)."""

    send: torch.Tensor | None
    send_splits: list
    recv_splits: list
    dest: torch.Tensor | None
    off_rank: int  # messages of the slot that leave the rank


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _slot_routes(topo, world: int, pos: int, device) -> tuple:
    """Each slot's ``_SlotRoute`` for the rank at position ``pos`` of an
    axis of ``world`` ranks, each owning ``A / world`` contiguous agents.
    Slot s carries ``in[nbr[i, s]]`` to agent i; ``nbr[:, s]`` is a
    permutation, so every agent sends and receives one message a slot."""
    nbr = np.asarray(topo.neighbor_table(), dtype=np.int64)
    a = topo.n_agents
    b = a // world
    mine = np.arange(pos * b, (pos + 1) * b)
    routes = []
    for s in range(topo.n_slots):
        src = nbr[:, s]
        # to rank r: my agents j = src[i] for r's agents i, in i's order
        send = np.concatenate([src[r * b:(r + 1) * b][
            src[r * b:(r + 1) * b] // b == pos] for r in range(world)]) - pos * b
        send_splits = [int((src[r * b:(r + 1) * b] // b == pos).sum())
                       for r in range(world)]
        # from rank q: messages for my agents i with src[i] on q, in i's order
        from_q = src[mine] // b
        order = np.argsort(from_q, kind="stable")
        recv_splits = [int((from_q == q).sum()) for q in range(world)]
        ident = np.arange(b)
        routes.append(_SlotRoute(
            send=(None if np.array_equal(send, ident)
                  else torch.as_tensor(send, device=device)),
            send_splits=send_splits, recv_splits=recv_splits,
            dest=(None if np.array_equal(order, ident)
                  else torch.as_tensor(order, device=device)),
            off_rank=int(b - send_splits[pos])))
    return tuple(routes)


@dataclasses.dataclass(frozen=True)
class Exchange:
    """Neighbor exchange over any topology: simulated in one process, or
    between the ranks of a ``torch.distributed`` world.

    ``axis``/``mesh`` (a ``DeviceMesh`` and one of its dimension names)
    put the agents on that axis: the rank at position ``p`` of its ``W``
    ranks owns the contiguous agent rows ``rows = range(p·A/W,
    (p+1)·A/W)`` (``A % W == 0``), and every tree that enters or leaves
    the exchange holds those rows only (``[A/W, ...]``, ``[A/W, S,
    ...]``).  ``W = A`` is the reference's layout, one agent a shard;
    ``W = 1`` routes every message through the backend to the rank
    itself.  Rank ``p``'s result equals rows ``rows`` of the one-process
    result.  The other mesh axes replicate: their ranks hold the same
    rows and exchange among themselves.  ``collectives`` counts the
    collectives made, the bytes handed to them (send buffers) and, of
    those, the bytes bound for another rank (an all-to-all's messages
    for other ranks; all of an ``all_gather``'s or ``all_reduce``'s
    buffer when the axis has more than one rank); ``chip_smoke.py``
    reads and resets it.

    ``faults`` (a ``core.faults.FaultPlane``, duck-typed: this module
    never imports it) arms the slot-batched calls: with ``round_index``
    given, routed sealed payloads get that round's faults injected after
    routing (on the rank's rows, by global agent id).  Calls without it
    (the NAK control plane) stay reliable.  Index tensors and routes are
    built once per device and kept on the instance, and shared with its
    armed copies (``armed``)."""

    topo: Any
    axis: str | None = None
    mesh: Any = None
    faults: Any = None
    _index: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)
    collectives: dict = dataclasses.field(
        default_factory=lambda: {"calls": 0, "bytes": 0,
                                 "bytes_off_rank": 0},
        compare=False, repr=False)

    def __post_init__(self):
        if (self.axis is None) != (self.mesh is None):
            raise ValueError("Exchange: give a mesh axis together with its "
                             "mesh (axis= and mesh=), or neither")
        if self.mesh is not None:
            names = tuple(self.mesh.mesh_dim_names or ())
            if self.axis not in names:
                raise ValueError(f"mesh axes {names} hold no {self.axis!r}")
            w = self.mesh.size(names.index(self.axis))
            if self.topo.n_agents % w:
                raise ValueError(
                    f"{self.topo.n_agents} agents do not split into equal "
                    f"blocks over the {w} ranks of axis {self.axis!r}")

    @property
    def world(self) -> int:
        """Ranks on the agent axis (1 for the host simulation)."""
        if self.mesh is None:
            return 1
        return self.mesh.size(tuple(self.mesh.mesh_dim_names)
                              .index(self.axis))

    @property
    def position(self) -> int:
        """This rank's position on the agent axis (0 for the host
        simulation)."""
        return 0 if self.mesh is None else self.mesh.get_local_rank(
            self.axis)

    @property
    def rows(self) -> range:
        """The global agent rows this rank holds."""
        b = self.topo.n_agents // self.world
        return range(self.position * b, (self.position + 1) * b)

    def armed(self, faults):
        """This exchange with ``faults`` armed: made once per fault plane
        and kept, sharing this instance's index tensors, so arming it every
        round copies nothing to the device."""
        if faults == self.faults:
            return self
        key = ("armed", faults)
        ex = self._index.get(key)
        if ex is None:
            # the same _index and collectives
            ex = dataclasses.replace(self, faults=faults)
            self._index[key] = ex
        return ex

    def indices(self, device):
        """``(nbr [A, S], flat [A, S])`` int64 on ``device``: the sender of
        each slot, and sender * S + sender's reverse slot."""
        device = torch.device(device)
        idx = self._index.get(device)
        if idx is None:
            nbr = np.asarray(self.topo.neighbor_table(), dtype=np.int64)
            rev = np.asarray(self.topo.reverse_slot, dtype=np.int64)
            flat = nbr * self.topo.n_slots + rev[None, :]
            idx = (torch.as_tensor(nbr, device=device),
                   torch.as_tensor(flat, device=device))
            self._index[device] = idx
        return idx

    def routes(self, device):
        """Each slot's ``_SlotRoute`` on the mesh axis for this rank."""
        device = torch.device(device)
        key = ("routes", device)
        r = self._index.get(key)
        if r is None:
            r = _slot_routes(self.topo, self.world, self.position, device)
            self._index[key] = r
        return r

    def _route_slot(self, x, s: int, out):
        """Rank-local ``x [A/W, ...]`` (slot s's outgoing messages) through
        slot s's all-to-all into ``out [A/W, ...]``."""
        r = self.routes(x.device)[s]
        send = (x if r.send is None else x.index_select(0, r.send))
        send = send.contiguous()
        if send.dtype == torch.bool:  # carried as bytes on every backend
            send = send.view(torch.uint8)
        recv = torch.empty_like(send)
        torch.distributed.all_to_all_single(
            recv, send, r.recv_splits, r.send_splits,
            group=self.mesh.get_group(self.axis))
        nbytes = _nbytes(send)
        self._count(nbytes, nbytes // max(send.shape[0], 1) * r.off_rank)
        recv = recv.view(out.dtype)
        if r.dest is None:
            out.copy_(recv)
        else:
            out.index_copy_(0, r.dest, recv)

    def _count(self, nbytes: int, off_rank: int):
        """One collective handed ``nbytes`` of send buffer, ``off_rank`` of
        them bound for another rank."""
        self.collectives["calls"] += 1
        self.collectives["bytes"] += nbytes
        self.collectives["bytes_off_rank"] += off_rank

    def _mesh_batched(self, tree, per_slot):
        """``[A/W, S, ...]`` leaves: slot s gets ``per_slot(x, s)``'s
        messages routed by slot s's all-to-all."""
        n_slots = self.topo.n_slots

        def one(x):
            first = per_slot(x, 0)
            out = torch.empty((first.shape[0], n_slots) + tuple(
                first.shape[1:]), dtype=x.dtype, device=x.device)
            for s in range(n_slots):
                self._route_slot(per_slot(x, s), s, out[:, s])
            return out

        return tree_map(one, tree)

    def gather_from_neighbors(self, per_agent_tree):
        """Tuple over slots of ``[A, ...]`` messages: slot s holds what my
        slot-s neighbor broadcast (my own message on a masked slot)."""
        if self.mesh is not None:
            routed = self._mesh_batched(per_agent_tree, lambda x, s: x)
            return tuple(tree_map(lambda t, s=s: t[:, s], routed)
                         for s in range(self.topo.n_slots))
        nbr = self.topo.neighbor_table()
        return tuple(
            tree_map(lambda x, s=s: x[torch.as_tensor(nbr[:, s],
                                                      device=x.device)],
                     per_agent_tree)
            for s in range(self.topo.n_slots)
        )

    def gather_batched(self, per_agent_tree, round_index=None):
        """Broadcast exchange: leaves ``[A, ...]`` in, ``[A, S, ...]`` out,
        ``out[i, s] = in[neighbor_table()[i, s]]``."""
        if self.mesh is not None:
            return self._maybe_inject(
                self._mesh_batched(per_agent_tree, lambda x, s: x),
                round_index)
        return self._maybe_inject(
            tree_map(lambda x: x[self.indices(x.device)[0]],
                     per_agent_tree), round_index)

    def exchange_batched(self, edge_tree, round_index=None):
        """Edge-directed exchange: leaves ``[A, S, ...]`` in and out,
        ``out[i, s] = in[neighbor_table()[i, s], reverse_slot[s]]``."""
        if self.mesh is not None:
            rev = self.topo.reverse_slot
            return self._maybe_inject(
                self._mesh_batched(edge_tree, lambda x, s: x[:, rev[s]]),
                round_index)
        a, s = self.topo.n_agents, self.topo.n_slots

        def route(x):
            x2 = x.reshape((a * s,) + tuple(x.shape[2:]))
            return x2[self.indices(x.device)[1]]

        return self._maybe_inject(tree_map(route, edge_tree), round_index)

    def gather_rows(self, tree):
        """All A agents' rows of ``[A/W, ...]`` leaves, on every rank: an
        ``all_gather`` over the agent axis (the tree itself on the host
        path)."""
        if self.mesh is None:
            return tree

        def one(x):
            x = x.contiguous()
            out = torch.empty((x.shape[0] * self.world,) + tuple(
                x.shape[1:]), dtype=x.dtype, device=x.device)
            torch.distributed.all_gather_into_tensor(
                out, x, group=self.mesh.get_group(self.axis))
            self._count(_nbytes(x), _nbytes(x) if self.world > 1 else 0)
            return out

        return tree_map(one, tree)

    def agent_sum(self, tree):
        """Sum over all A agents of ``[A, ...]`` leaves (this rank's rows
        summed, then an ``all_reduce`` over the agent axis on the mesh):
        ``[...]`` on every rank."""
        def one(x):
            t = torch.sum(x, dim=0)
            if self.mesh is not None:
                torch.distributed.all_reduce(
                    t, group=self.mesh.get_group(self.axis))
                self._count(_nbytes(t), _nbytes(t) if self.world > 1 else 0)
            return t

        return tree_map(one, tree)

    def _maybe_inject(self, routed, round_index):
        """Inject round ``round_index``'s faults into the routed payloads,
        in place: routing made them fresh tensors."""
        if self.faults is None or round_index is None:
            return routed
        return self.faults.inject(routed, self.topo, round_index,
                                  inplace=True,
                                  rows=None if self.mesh is None
                                  else self.rows)


def metropolis_weights(topo) -> np.ndarray:
    """Metropolis-Hastings mixing matrix: W_ij = 1 / (1 + max(d_i, d_j))
    on edges, the diagonal absorbs the rest."""
    a = topo.n_agents
    d = topo.degrees()
    w = np.zeros((a, a))
    for (i, j) in edge_set(topo):
        w[i, j] = 1.0 / (1.0 + max(int(d[i]), int(d[j])))
    w[np.diag_indices(a)] = 1.0 - w.sum(axis=1)
    return w
