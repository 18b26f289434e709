"""Seeded fault plane: deterministic injection of unplanned failures (port
of ``repro/core/faults.py``; its docstring sets out the semantics).

A ``FaultPlane`` draws every fault from the Threefry counter PRNG of
``kernels.prng``, keyed on ``(seed, kind, round, receiver, slot)``, so a
faulty run is a pure function of its spec string and replays bit for
bit.  Spec grammar (``|`` stands for ``,`` inside a solver spec):
``faults:drop=0.05,corrupt=1e-3,stale=0.02,crash=0.01,seed=0,start=0``.

``drop``     per-message loss (payload zeroed, round tag poisoned)
``corrupt``  per-message single-bit flip at a seeded position
``stale``    per-message delivery of the previous round's tag
``crash``    per-agent per-round crash (agent inert, all its edges dark,
             its state held: "restart" resumes from the held state)
``seed``     fault stream seed; ``start`` the first faulted round

Injection happens at the ``Exchange`` boundary, after routing, on sealed
payloads (``compression.seal_plane``).  The x- and z-payloads of one round
share a link: draws are per (receiver, slot, round), so both live or die
together.  ``edge_ok`` is the oracle of the dense-gossip baselines: the
exact mask the wire path's checksum and tag checks and its NAK
symmetrisation produce.

The masks are ``[A]`` and ``[A, S]``, a few hundred bits a round, so the
port draws them on the host (the same words as the reference's device
draw) and copies each round's planes to the device once, through pinned
memory in a non-blocking copy: no round waits for the card.  The host
knows which messages a round hits, so injection touches only those: one
seeded word XOR per corrupted message, a masked fill where a message is
lost.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.common.trees import tree_flatten
from repro_torch.core import compression
from repro_torch.kernels import prng

# seed-fold salt of the fault stream; distinct from the round's message
# salts (7, 11, 13, 17) so faults never correlate with compression noise
FAULT_SALT = 23

_KIND_DROP = 0
_KIND_CORRUPT = 1
_KIND_STALE = 2
_KIND_CRASH = 3
_RATES = ("drop", "corrupt", "stale", "crash")  # by kind
_SEAL_KEYS = ("crc", "tag")

# same-width integer views: a flip needs the bits, not their meaning
_INT_OF_WIDTH = {1: torch.int8, 2: torch.int16, 4: torch.int32}


@dataclasses.dataclass(frozen=True)
class FaultPlane:
    """Seeded, rate-parameterised fault injector (see the module
    docstring).  Frozen, its fields scalars, so it hashes and nests inside
    frozen solver configs; every mask derives from ``(seed, kind, k)``.
    ``_cache`` keeps the last rounds' host draws and device planes (not a
    field of the spec: no init, no compare)."""

    drop: float = 0.0
    corrupt: float = 0.0
    stale: float = 0.0
    crash: float = 0.0
    seed: int = 0
    start: int = 0
    name: str = "faults"
    _cache: dict = dataclasses.field(default_factory=dict, init=False,
                                     compare=False, repr=False)

    def __post_init__(self):
        for kind in _RATES:
            rate = getattr(self, kind)
            if not 0.0 <= float(rate) <= 1.0:
                raise ValueError(
                    f"faults: {kind}={rate!r} outside [0, 1]")
        if int(self.start) < 0:
            raise ValueError(f"faults: start={self.start!r} negative")

    @property
    def active(self) -> bool:
        return (self.drop > 0 or self.corrupt > 0 or self.stale > 0
                or self.crash > 0)

    # -- seeded masks -----------------------------------------------------

    def _base_seed(self):
        """The stream's seed pair: the seed's low word, its high word xor
        0x9E3779B9, folded with ``FAULT_SALT``."""
        base = self._cache.get("base")
        if base is None:
            seed = int(self.seed)
            base = prng.fold_int(
                (seed & prng.MASK, ((seed >> 32) & prng.MASK) ^ 0x9E3779B9),
                FAULT_SALT)
            self._cache["base"] = base
        return base

    def _round_seed(self, kind: int, k: int):
        return prng.fold_int(self._base_seed(), kind, k)

    def _keep(self, key, val):
        """Keep ``val`` in ``_cache`` under ``key``; the cache is cleared
        once it holds ``_KEPT`` entries (a run asks for one round after
        the other)."""
        if len(self._cache) >= _KEPT:
            self._cache.clear()
        self._cache[key] = val
        return val

    def crash_mask(self, k, n_agents: int, device=None):
        """[A] bool: True where the agent is crashed for round ``k``."""
        return _tensor(_draw(self, int(k), n_agents)[0][_KIND_CRASH],
                       device)

    def node_alive(self, k, topo, device=None, rows=None):
        """[A] bool: ``~crash_mask`` of round ``k``, drawn with the
        round's message masks (one host draw serves both); the agents
        ``rows`` only where given."""
        alive = ~_host_plane(self, int(k), topo)[0]
        if rows is not None:
            alive = alive[rows.start:rows.stop]
        return _tensor(alive, device)

    def message_masks(self, k, topo, device=None):
        """Receiver-indexed [A, S] (drop, corrupt, stale) masks of round
        ``k``; ``drop`` folds in sender crashes (a crashed sender's message
        is lost on every link it feeds)."""
        _, drop, corrupt, stale, _ = _host_plane(self, int(k), topo)
        return tuple(_tensor(m, device) for m in (drop, corrupt, stale))

    # -- injection (wire path) -------------------------------------------

    def inject(self, tree, topo, k, inplace: bool = False, rows=None):
        """Apply round-``k`` faults to routed sealed payload(s): Payload
        leaves whose tensors are receiver-indexed ``[A, S, ...]``.  Drops
        zero the data leaves and poison the tag; corruption flips one
        seeded bit of the first data leaf; staleness rewinds the tag by one
        with the crc, so the checksum stays valid and the tag alone
        rejects it.  Applied corrupt, then stale, then drop.  ``inplace``:
        the data leaves are the exchange's freshly routed tensors and are
        edited where they lie (else a leaf that changes is a new
        tensor).  ``rows`` (a range of global agent ids): the payloads hold
        only those receivers' rows, as a mesh exchange's rank does."""
        payloads, rebuild = tree_flatten(
            tree, is_leaf=lambda t: isinstance(t, compression.Payload))
        return rebuild([self._inject_payload(p, topo, int(k), inplace, rows)
                        for p in payloads])

    def _inject_payload(self, p, topo, k: int, inplace: bool, rows):
        if not isinstance(p, compression.Payload):
            raise TypeError(
                f"fault injection needs sealed Payloads, got {type(p)!r}")
        leaves = dict(p)
        if any(s not in leaves for s in _SEAL_KEYS):
            raise ValueError(
                "fault injection needs sealed payloads (crc+tag leaves); "
                "route through compression.seal_plane first")
        data_keys = [n for n in sorted(leaves) if n not in _SEAL_KEYS]
        first = leaves[data_keys[0]] if data_keys else leaves["tag"]
        dev = _device_plane(self, k, topo, math.prod(first.shape[2:]),
                            first.element_size(), first.device, rows)
        owned = set()  # data leaves that are this call's own tensors
        if dev.flip is not None and data_keys:
            # dropped messages are left out: the drop zeroes them below
            leaves[data_keys[0]] = _flip_bit(leaves[data_keys[0]], dev.flip,
                                             inplace)
            owned.add(data_keys[0])
        if dev.stale is not None:
            leaves["tag"] = _minus(leaves["tag"], dev.stale)
            leaves["crc"] = _minus(leaves["crc"], dev.stale)
        if dev.drop is not None:
            for n in data_keys:
                v = leaves[n]
                m = dev.drop.reshape(dev.drop.shape + (1,) * (v.dim() - 2))
                leaves[n] = (v.masked_fill_(m, 0) if inplace or n in owned
                             else v.masked_fill(m, 0))
            # BROADCAST's bits (0xFFFFFFFF) in the int32 tag
            leaves["tag"] = leaves["tag"].masked_fill(dev.drop, -1)
            leaves["crc"] = leaves["crc"].masked_fill(dev.drop, 0)
        return compression.Payload(**leaves)

    # -- oracle (dense-gossip path) --------------------------------------

    def edge_ok(self, k, topo, device=None):
        """[A, S] bool: True where the edge survives round ``k`` at BOTH
        endpoints: exactly the act-mask refinement of the LT-ADMM wire
        path's checksum and tag checks plus NAK symmetrisation.  Masked
        slots are False."""
        return _tensor(_edge_ok_host(self, int(k), topo), device)

    def edge_dark(self, k, topo, device=None):
        """[A, S] bool: real slots suppressed by round-``k`` faults."""
        return _tensor(np.asarray(topo.slot_mask())
                       & ~_edge_ok_host(self, int(k), topo), device)


# ---------------------------------------------------------------------------
# Host draws and their device copies
# ---------------------------------------------------------------------------

_KEPT = 64  # entries of a plane's cache


def _draw(fp: FaultPlane, k: int, n: int):
    """Round ``k``'s masks at counters ``0..n-1``: ``[4, n]`` bool by kind
    (``uniform01(bits) < f32(rate)``, zero-rate kinds all False) and the
    corrupt seed's second stream ``[n]`` (int64 holding uint32), which
    places each flipped bit.  One cipher call for all kinds; kept per
    round for the largest ``n`` asked, since a counter's word does not
    depend on ``n``."""
    hit = fp._cache.get(("draw", k))
    if hit is not None and hit[0].shape[1] >= n:
        return hit[0][:, :n], hit[1][:n]
    rows = [(kind, 0) for kind in range(4) if getattr(fp, _RATES[kind]) > 0]
    if fp.corrupt > 0:
        rows.append((_KIND_CORRUPT, 1))
    masks = np.zeros((4, n), dtype=bool)
    flip = np.zeros((n,), dtype=np.int64)
    if rows:
        seeds = np.array([fp._round_seed(kind, k) for kind, _ in rows],
                         dtype=np.int64)
        bits = prng.random_bits(
            (seeds[:, :1], seeds[:, 1:]), np.arange(n, dtype=np.int64)[None],
            np.array([[stream] for _, stream in rows], dtype=np.int64))
        u = prng.uniform01(bits)
        for r, (kind, stream) in enumerate(rows):
            if stream:
                flip = bits[r].numpy()
            else:
                rate = float(np.float32(getattr(fp, _RATES[kind])))
                masks[kind] = (u[r] < rate).numpy()
        if fp.start > 0 and k < fp.start:
            masks[:] = False
    return fp._keep(("draw", k), (masks, flip))


def _host_plane(fp: FaultPlane, k: int, topo):
    """``(crash [A], drop, corrupt, stale, flip bits [A, S])`` of round
    ``k``, host numpy; ``drop`` holds sender crashes too."""
    a, s = topo.n_agents, topo.n_slots
    masks, flip = _draw(fp, k, a * s)
    crash = masks[_KIND_CRASH, :a]
    drop = masks[_KIND_DROP].reshape(a, s) | crash[topo.neighbor_table()]
    return (crash, drop, masks[_KIND_CORRUPT].reshape(a, s),
            masks[_KIND_STALE].reshape(a, s), flip.reshape(a, s))


def _edge_ok_host(fp: FaultPlane, k: int, topo):
    crash, drop, corrupt, stale, _ = _host_plane(fp, k, topo)
    nbr = topo.neighbor_table()
    rev = np.asarray(topo.reverse_slot)
    bad = drop | corrupt | stale | crash[:, None]
    bad = bad | bad[nbr, rev[None, :]]
    return ~bad & np.asarray(topo.slot_mask())


def _tensor(a, device=None):
    """Host numpy -> a tensor of its own on ``device`` (CPU when None); a
    CUDA copy goes through pinned memory, non-blocking."""
    t = torch.from_numpy(np.array(a))
    if device is None or torch.device(device).type == "cpu":
        return t
    if torch.device(device).type != "cuda":  # a meta trace
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


@dataclasses.dataclass(frozen=True)
class _DevicePlane:
    """A round's injection on the device, None where nothing happens:
    ``drop`` [A, S] bool, ``stale`` [A, S] int64 (1 where stale), ``flip``
    (element [A*S, 1], XOR word [A*S, 1]; 0 on untouched messages)."""

    drop: torch.Tensor | None
    stale: torch.Tensor | None
    flip: tuple | None


def _device_plane(fp: FaultPlane, k: int, topo, n_elem: int, width: int,
                  device, rows=None) -> _DevicePlane:
    """The injection planes of round ``k`` for a first data leaf of
    ``n_elem`` elements of ``width`` bytes a message, copied to ``device``
    in one transfer and kept (the x- and z-exchanges of a round share
    it); only the receivers ``rows`` (all when None)."""
    key = ("device", k, topo, n_elem, width, device, rows)
    hit = fp._cache.get(key)
    if hit is not None:
        return hit
    _, drop, corrupt, stale, bits = _host_plane(fp, k, topo)
    if rows is not None:
        drop, corrupt, stale, bits = (m[rows.start:rows.stop]
                                      for m in (drop, corrupt, stale, bits))
    flip = corrupt & ~drop
    nbits = 8 * width
    elem = bits % n_elem
    word = np.where(flip, np.left_shift(1, (bits // n_elem) % nbits), 0)
    word = np.where(word >= 2 ** (nbits - 1), word - 2 ** nbits, word)
    host = np.stack([drop, stale, elem, word]).astype(np.int64)
    planes = _tensor(host.reshape(4, -1), device)
    shape = drop.shape
    return fp._keep(key, _DevicePlane(
        drop=planes[0].reshape(shape).bool() if drop.any() else None,
        stale=planes[1].reshape(shape) if stale.any() else None,
        flip=((planes[2][:, None], planes[3][:, None]) if flip.any()
              else None),
    ))


def _flip_bit(leaf, flip, inplace: bool):
    """XOR one seeded word per corrupted message into ``leaf`` ([A, S,
    ...]): element ``bits % L``, bit ``(bits // L) % (8 * width)``, the
    reference's position (its ``hit`` plane has the same bits)."""
    elem, word = flip
    v = leaf if inplace else leaf.clone(memory_format=torch.contiguous_format)
    if not v.is_contiguous():
        raise ValueError("bit flips need a contiguous leaf")
    flat = v.view(_INT_OF_WIDTH[v.element_size()]).view(
        v.shape[0] * v.shape[1], -1)
    w = word.to(flat.dtype)
    flat.scatter_(1, elem, flat.gather(1, elem) ^ w)
    return v


def _minus(word, stale):
    """uint32 ``word - stale`` (mod 2^32) of an int32 tensor holding uint32
    bits."""
    return prng.wrap_i32(word.to(torch.int64) - stale).to(torch.int32)


# ---------------------------------------------------------------------------
# Registry + spec parsing (same shape as compression.COMPRESSORS)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultEntry:
    """One registered fault model: class + the spec params it accepts
    (validated before construction, so misspellings fail with the valid
    names, not a TypeError)."""

    name: str
    cls: type
    params: frozenset
    doc: str = ""


def _entry(cls, doc: str) -> FaultEntry:
    name = cls.__dataclass_fields__["name"].default
    params = frozenset(f.name for f in dataclasses.fields(cls)
                       if f.init and f.name != "name")
    return FaultEntry(name=name, cls=cls, params=params, doc=doc)


FAULTS: dict[str, FaultEntry] = {
    e.name: e
    for e in (
        _entry(FaultPlane,
               "iid seeded drops/bit-flips/stale-tags/node-crashes"),
    )
}


def fault_entry(name: str) -> FaultEntry:
    try:
        return FAULTS[name]
    except KeyError:
        raise ValueError(
            f"unknown fault model {name!r}; choose from {sorted(FAULTS)}"
        ) from None


def _parse_spec(spec: str):
    name, _, rest = spec.partition(":")
    entry = fault_entry(name)
    params = {}
    for item in rest.replace("|", ",").split(","):
        if not item:
            continue
        k, eq, v = item.partition("=")
        if not eq:
            raise ValueError(
                f"malformed fault param {item!r} in spec {spec!r} "
                f"(expected k=v)")
        params[k.strip()] = compression.coerce_param(v.strip())
    return entry, params


def _construct(entry: FaultEntry, params: dict):
    unknown = sorted(set(params) - entry.params)
    if unknown:
        raise ValueError(
            f"fault model {entry.name!r} got unknown param(s) {unknown}; "
            f"valid params: {sorted(entry.params)}")
    try:
        return entry.cls(**params)
    except TypeError as e:
        raise ValueError(
            f"bad params for fault model {entry.name!r}: {e}") from None


def validate_spec(spec: str) -> None:
    """Parse-time validation of a fault spec (the solver grammar uses it,
    so ``ltadmm:faults=faults:drp=0.1`` fails up front, naming the valid
    params)."""
    _construct(*_parse_spec(spec))


def get_faults(spec) -> FaultPlane | None:
    """FaultPlane from a spec string; passes a ``FaultPlane`` or None
    through unchanged."""
    if spec is None or isinstance(spec, FaultPlane):
        return spec
    return _construct(*_parse_spec(spec))
