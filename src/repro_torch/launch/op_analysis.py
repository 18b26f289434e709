"""Roofline terms of one traced step from the ops it dispatches: the
counterpart of ``src/repro/launch/hlo_analysis.py``.

The reference walks the optimized per-device HLO of a compiled step.  The
port has no HLO, so ``OpCounter``, a ``TorchDispatchMode``, reads the
aten and c10d ops that the step dispatches on this rank and fills an
``OpStats`` with the reference's fields:

* ``dot_flops``: 2 x prod(result) x contracted size for every
  ``mm``/``addmm``/``bmm``/``baddbmm``/``mv``/``addmv``/``dot``,
  convolution (forward and backward) and ``_scaled_dot_product_*``
  attention, as the reference's ``_dot_flops`` counts a dot; also split
  by operand dtype in ``dot_flops_by_dtype`` (the one added field), since
  the H100's peak differs by dtype.  Elementwise FLOPs are ignored.
* ``memory_bytes`` (v1): operand bytes + result bytes of every op but
  views, metadata and bare allocations (``view``, ``_unsafe_view``,
  ``permute``, ``expand``, ``as_strided``, ``detach``, ``empty``, ...).
* ``memory_bytes_w2`` (v2): 2 x result bytes of the same ops.
* ``collective_bytes`` / ``collective_counts``: the output bytes of every
  c10d collective, under the reference's HLO names (``all-to-all``,
  ``all-reduce``, ``all-gather``, ``reduce-scatter``,
  ``collective-permute``).

There are no trip-count multipliers: a ``while`` body appears once in
HLO, so the reference multiplies it by its trip count, while the port's
Python loops dispatch every iteration, and each op is counted once per
execution.

A hand-written kernel (K1-K11) is one op, the counterpart of an HLO
custom-call: its wrapper reports it through ``kernel_op`` with the bytes
its row in PERF.md counts (each input read once, each output written
once), on the card route and on the fake route alike (module ``kernels``:
a ``meta`` or fake tensor takes the fake route, which returns outputs of
the kernel's shapes and dtypes and launches nothing).  K10 and K11 also
report their products in ``dot_flops``; the reference's HLO on the TPU
misses a Pallas call's products (a custom-call is not a dot).

Tracing on ``meta`` tensors (``launch.dryrun``): the counter keeps each
op's result metadata by the op and its arguments' shapes, strides and
dtypes, and makes the outputs of a repeated op with ``torch.empty_strided``
instead of running its meta kernel again (many of which are Python); in-place
ops return their operand.  The counts are the same either way.

``MemoryTracker`` is the counterpart of ``compiled.memory_analysis()``:
the bytes of every storage the step creates, live from the op that made
it until its last tensor is released (``weakref.finalize``; autograd's
saved tensors keep theirs alive), their peak, and the ops whose results
hold it (``peak_by_op``).

``roofline_terms`` prices the counts with the H100's spec figures (not
measured): ``t_compute`` sums ``dot_flops_by_dtype[dt] / peak[dt]``.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# ---------------------------------------------------------------------------
# The card's constants (spec figures, not measured)
# ---------------------------------------------------------------------------

DEVICE = "NVIDIA H100 80GB HBM3, 700.00 W"
# dense tensor-core peaks; f32 at the CUDA cores' 67 TFLOP/s, since TF32
# is off as in the port's parity runs
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
              "float64": 67e12}
HBM_BW = 3.35e12  # bytes/s
# one 400 Gb/s NDR port a GPU: the production meshes span 32 or 64 nodes
# of eight, so every 16-wide axis crosses nodes
NET_BW = 50e9  # bytes/s

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# c10d ops (``torch.ops.c10d`` and the functional ``_c10d_functional``)
# -> the reference's HLO names; both spellings of the all-gather into one
# tensor (``all_gather_into_tensor``, ``all_gather_single``) dispatch
# ``_allgather_base_``
_C10D = {
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "send": "collective-permute", "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
}
# neither views nor metadata by their schema, but no traffic either
_NO_TRAFFIC = frozenset((
    "_unsafe_view", "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "lift_fresh", "set_", "resize_", "resize_as_",
    "_local_scalar_dense", "record_stream"))
# in-place ops that change their operand's metadata: always run
_META_INPLACE = frozenset((
    "resize_", "resize_as_", "set_", "as_strided_", "squeeze_",
    "unsqueeze_", "transpose_", "t_", "swapdims_", "swapaxes_",
    "_resize_output_"))


def _bincount_shape(args, kwargs):
    # ids below ``minlength`` (the MoE router's expert ids): the contract
    # of every caller in the port; the meta kernel does not exist, as the
    # size depends on the data
    x = args[0]
    w = args[1] if len(args) > 1 else kwargs.get("weights")
    n = args[2] if len(args) > 2 else kwargs.get("minlength", 0)
    return torch.empty((n,), dtype=torch.int64 if w is None else w.dtype,
                       device="meta")


# ops whose result shape depends on the data: on ``meta`` the shape their
# callers' contract gives
_META_SHAPES = {"bincount": _bincount_shape}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


_Tensor = torch.Tensor


def _flat(xs, out):
    for x in xs:
        if isinstance(x, _Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            _flat(x, out)
        elif isinstance(x, dict):
            _flat(x.values(), out)
    return out


def _tensors(tree):
    """The tensors of a tree of lists, tuples and dicts, as a list."""
    if isinstance(tree, _Tensor):
        return [tree]
    return _flat(tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (list, tuple)) else ()), [])


def storages(tree) -> dict:
    """``{storage id: bytes}`` of the tensors of ``tree``, each storage
    once (views share their base's)."""
    out = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        out.setdefault(st._cdata, st.nbytes())
    return out


def tree_bytes(tree) -> int:
    """Bytes of the tensors of ``tree`` (each storage once)."""
    return sum(storages(tree).values())


def is_abstract(t) -> bool:
    """A ``meta`` or fake tensor: it has shapes and dtypes and no data, so
    a kernel wrapper takes its fake route."""
    return t.device.type == "meta" or getattr(t, "fake_mode",
                                              None) is not None


# ---------------------------------------------------------------------------
# The counts
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class OpStats:
    dot_flops: float = 0.0
    memory_bytes: float = 0.0  # v1: operand + result bytes an op
    memory_bytes_w2: float = 0.0  # v2: result bytes x 2 (write + a read)
    collective_bytes: float = 0.0
    collective_counts: dict = dataclasses.field(default_factory=dict)
    dot_flops_by_dtype: dict = dataclasses.field(default_factory=dict)

    def as_dict(self):
        return {
            "dot_flops": self.dot_flops,
            "memory_bytes": self.memory_bytes,
            "memory_bytes_w2": self.memory_bytes_w2,
            "collective_bytes": self.collective_bytes,
            "collective_counts": dict(self.collective_counts),
            "dot_flops_by_dtype": dict(self.dot_flops_by_dtype),
        }


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


def _prod(xs) -> int:
    return math.prod(int(x) for x in xs)


def _conv_flops(out_shape, w_shape, transposed, in_shape) -> float:
    # 2 x (each output element) x (its Cin / groups x kernel products);
    # a transposed convolution walks its input instead
    per = _prod(w_shape[1:])
    return 2.0 * _prod(in_shape if transposed else out_shape) * per


def _attn_flops(q, k, v) -> float:
    # [B, H, T, D] x [B, H, S, D]: QK^T and PV
    b, h, t, d = q.shape
    s, dv = k.shape[-2], v.shape[-1]
    return 2.0 * b * h * t * s * (d + dv)


def dot_flops(name: str, args, out) -> float:
    """The reference's dot count for one aten op (0 for the others)."""
    if name == "mm":
        a, b = args[0], args[1]
        return 2.0 * a.shape[0] * b.shape[1] * a.shape[1]
    if name == "addmm":
        a, b = args[1], args[2]
        return 2.0 * a.shape[0] * b.shape[1] * a.shape[1]
    if name == "bmm":
        a, b = args[0], args[1]
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[2] * a.shape[2]
    if name == "baddbmm":
        a, b = args[1], args[2]
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[2] * a.shape[2]
    if name == "mv":
        return 2.0 * args[0].shape[0] * args[0].shape[1]
    if name == "addmv":
        return 2.0 * args[1].shape[0] * args[1].shape[1]
    if name in ("dot", "vdot"):
        return 2.0 * args[0].shape[0]
    if name == "convolution":
        return _conv_flops(out.shape, args[1].shape, bool(args[6]),
                           args[0].shape)
    if name == "convolution_backward":
        grad_out, inp, w = args[0], args[1], args[2]
        transposed, mask = bool(args[7]), args[10]
        one = _conv_flops(grad_out.shape, w.shape, transposed, inp.shape)
        return one * sum(bool(m) for m in mask[:2])
    if name in ("_scaled_dot_product_flash_attention",
                "_scaled_dot_product_efficient_attention",
                "_scaled_dot_product_cudnn_attention",
                "_scaled_dot_product_flash_attention_for_cpu"):
        return _attn_flops(args[0], args[1], args[2])
    if name.startswith("_scaled_dot_product") and name.endswith("backward"):
        # dQ, dK, dV and the recomputed scores: twice the forward's
        return 2.0 * _attn_flops(args[1], args[2], args[3])
    return 0.0


@dataclasses.dataclass(frozen=True)
class _FuncInfo:
    name: str
    namespace: str
    view: bool  # the result aliases an operand, read-only
    inplace: int | None  # the positional operand it writes and returns
    other: bool  # out= variants, metadata-changing and void mutations


_INFO: dict = {}


def _info(func) -> _FuncInfo:
    inf = _INFO.get(func)
    if inf is not None:
        return inf
    s = func._schema
    name = func._overloadpacket.__name__
    ns = func.namespace
    view = any(r.alias_info is not None and not r.alias_info.is_write
               for r in s.returns)
    inplace, other = None, False
    written = [r.alias_info for r in s.returns
               if r.alias_info is not None and r.alias_info.is_write]
    if written:
        for i, a in enumerate(s.arguments):
            if (a.alias_info is not None and a.alias_info.is_write
                    and a.alias_info.before_set == written[0].before_set):
                if a.kwarg_only or len(written) > 1:
                    other = True
                else:
                    inplace = i
                break
        else:
            other = True
    elif s.is_mutable:
        other = True
    if name in _META_INPLACE or ns in ("c10d", "_c10d_functional"):
        other, inplace = True, None
    inf = _INFO[func] = _FuncInfo(name, ns, view, inplace, other)
    return inf


def _op_device(ts, kwargs):
    """``(device type, fabricable)`` of an op over the tensor operands
    ``ts``: the first non-CPU operand's type, else "cpu", else a
    factory's ``device=``; fabricable when every operand is ``meta`` or
    a CPU scalar beside them."""
    dev, fab = None, True
    for t in ts:
        d = t.device.type
        if d != "meta" and (d != "cpu" or t.dim()):
            fab = False
        if dev is None or dev == "cpu":
            dev = d
    if dev is None:
        d = kwargs.get("device")
        dev = "cpu" if d is None else torch.device(d).type
    return dev, fab


def _key(x):
    if isinstance(x, _Tensor):
        return (x.shape, x.stride(), x.dtype, x.device.type)
    if isinstance(x, (list, tuple)):
        return tuple([_key(v) for v in x])
    if isinstance(x, dict):
        return tuple([(k, _key(v)) for k, v in x.items()])
    return x


def _out_spec(out):
    """Result metadata to rebuild ``out``, or None if it holds anything
    but tensors (and None entries)."""
    if isinstance(out, torch.Tensor):
        return ("t", tuple(out.shape), out.stride(), out.dtype)
    if isinstance(out, (list, tuple)):
        parts = []
        for o in out:
            if o is None:
                parts.append(None)
            elif isinstance(o, torch.Tensor):
                parts.append((tuple(o.shape), o.stride(), o.dtype))
            else:
                return None
        return ("l" if isinstance(out, list) else "s", parts)
    return None


def _make(spec):
    if spec[0] == "t":
        return torch.empty_strided(spec[1], spec[2], dtype=spec[3],
                                   device="meta")
    parts = [None if p is None else torch.empty_strided(
        p[0], p[1], dtype=p[2], device="meta") for p in spec[1]]
    return parts if spec[0] == "l" else tuple(parts)


@dataclasses.dataclass
class _OpCost:
    dot: float = 0.0
    dtype: str = ""
    v1: float = 0.0
    v2: float = 0.0
    coll: str = ""
    coll_bytes: float = 0.0
    fc: float = 0.0  # torch.utils.flop_counter's count


_ACTIVE: list = []


class OpCounter(TorchDispatchMode):
    """Counts the ops a step dispatches into ``stats`` (an ``OpStats``):
    the device's ops, on the card or in a ``meta`` trace; an op whose
    operands all lie on the CPU is the host's work and left out.
    ``memory`` (a ``MemoryTracker``) is fed every storage the step
    creates.  Also kept:
    ``n_ops``, ``kernels`` (launches of the hand-written kernels by id)
    and ``flop_counter_flops``, the total of ``torch.utils.flop_counter``'s
    formulas (``FlopCounterMode``'s) over the same ops, a cross-check of
    ``dot_flops``."""

    def __init__(self, memory=None):
        super().__init__()
        self.stats = OpStats()
        self.memory = memory
        self.n_ops = 0
        self.kernels = collections.Counter()
        self.flop_counter_flops = 0.0
        self._cache = {}

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    # ---- accounting --------------------------------------------------------

    def _add(self, c: _OpCost):
        s = self.stats
        self.n_ops += 1
        if c.dot:
            s.dot_flops += c.dot
            s.dot_flops_by_dtype[c.dtype] = (
                s.dot_flops_by_dtype.get(c.dtype, 0.0) + c.dot)
        s.memory_bytes += c.v1
        s.memory_bytes_w2 += c.v2
        if c.coll:
            s.collective_bytes += c.coll_bytes
            s.collective_counts[c.coll] = (
                s.collective_counts.get(c.coll, 0.0) + 1.0)
        self.flop_counter_flops += c.fc

    def _cost(self, func, inf: _FuncInfo, args, kwargs, out) -> _OpCost:
        from torch.utils.flop_counter import flop_registry

        c = _OpCost()
        coll = _C10D.get(inf.name) if inf.namespace in (
            "c10d", "_c10d_functional") else None
        if coll is not None:
            res = args[0] if inf.namespace == "c10d" else out
            c.coll, c.coll_bytes = coll, float(sum(
                _nbytes(t) for t in _tensors(res)))
        c.dot = dot_flops(inf.name, args, out)
        if c.dot:
            c.dtype = _dtype_name(_tensors(args)[0].dtype)
        fn = flop_registry.get(func._overloadpacket)
        if fn is not None:
            c.fc = float(fn(*args, **kwargs, out_val=out))
        if inf.view or inf.name in _NO_TRAFFIC:
            return c
        res = (args[inf.inplace] if inf.inplace is not None
               else (args[0] if coll and inf.namespace == "c10d" else out))
        rbytes = float(sum(_nbytes(t) for t in _tensors(res)))
        c.v1 = rbytes + float(sum(_nbytes(t) for t in _tensors((args,
                                                                 kwargs))))
        c.v2 = 2.0 * rbytes
        return c

    def _track(self, out, func):
        if self.memory is not None:
            if isinstance(out, _Tensor):
                self.memory.track(out, func)
            else:
                for t in _tensors(out):
                    self.memory.track(t, func)

    # ---- dispatch ----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        inf = _INFO.get(func) or _info(func)
        if inf.view:
            # a view keeps its base (and so the base's storage) alive
            return func(*args, **kwargs)
        ts = _flat(args, [])
        if kwargs:
            _flat(kwargs.values(), ts)
        dev, fab = _op_device(ts, kwargs)
        counted = dev != "cpu"
        key = None
        if dev == "meta" and fab and not inf.other:
            try:
                key = (func, _key(args), _key(kwargs) if kwargs else None)
                hit = self._cache.get(key)
            except TypeError:  # an unhashable operand
                key = hit = None
            if hit is not None:
                spec, cost = hit
                self._add(cost)
                if inf.inplace is not None:
                    return args[inf.inplace]
                out = _make(spec)
                self._track(out, func)
                return out
        shape_fn = _META_SHAPES.get(inf.name) if dev == "meta" else None
        out = (func(*args, **kwargs) if shape_fn is None
               else shape_fn(args, kwargs))
        cost = self._cost(func, inf, args, kwargs, out) if counted else None
        if counted:
            self._add(cost)
        if key is not None:
            spec = _out_spec(out)
            if spec is not None:
                self._cache[key] = (spec, cost)
        if inf.inplace is None and not inf.other:
            self._track(out, func)
        return out

    # ---- the hand-written kernels ------------------------------------------

    def kernel(self, name, inputs, outputs, flops, dtype):
        c = _OpCost()
        if flops:
            c.dot, c.dtype = float(flops), _dtype_name(dtype)
        ob = float(sum(_nbytes(t) for t in _tensors(outputs)))
        c.v1 = ob + float(sum(_nbytes(t) for t in _tensors(inputs)))
        c.v2 = 2.0 * ob
        self._add(c)
        self.kernels[name] += 1


def kernel_op(name: str, inputs, outputs, flops: float = 0.0, dtype=None):
    """Report one launch of hand-written kernel ``name`` (its wrapper calls
    this on the card route and on the fake route) to the active
    ``OpCounter``: one op reading ``inputs`` and writing ``outputs``, and
    ``flops`` products in ``dtype`` (a number, or a callable that gives
    it, called only while a counter is active, so that a launch with no
    counter pays nothing for the count).  Returns ``outputs``."""
    if _ACTIVE:
        _ACTIVE[-1].kernel(name, inputs, outputs,
                           flops() if callable(flops) else flops, dtype)
    return outputs


# ---------------------------------------------------------------------------
# Live bytes
# ---------------------------------------------------------------------------


class MemoryTracker:
    """Live bytes of the storages a step creates, and their peak (the
    dry-run's ``compiled.memory_analysis()``).  A storage is live from
    the op that made it until the last tensor made over it is released
    (a view keeps its base alive); inputs created outside are not
    counted.  ``peak_by_op``: the live bytes at the peak by the op that
    made them (the largest ``TOP_OPS``), read again each time the peak
    has grown by ``1 / 64`` of itself."""

    TOP_OPS = 12

    def __init__(self):
        self.live = 0
        self.peak = 0
        self.peak_by_op = {}
        self._read_at = 0
        self._refs = {}

    def track(self, t, op=None):
        """Count the storage of ``t``, the result of ``op``, until ``t``
        and every other result over it are released."""
        st = t.untyped_storage()
        sid = st._cdata
        ref = self._refs.get(sid)
        if ref is None:
            ref = self._refs[sid] = [st.nbytes(), 0, str(op)]
            self.live += ref[0]
            self.peak = max(self.peak, self.live)
            if self.peak > self._read_at * (1 + 1 / 64):
                self._read_at = self.peak
                by = collections.Counter()
                for nbytes, _, label in self._refs.values():
                    by[label] += nbytes
                self.peak_by_op = dict(by.most_common(self.TOP_OPS))
        ref[1] += 1
        weakref.finalize(t, self._release, sid)

    def _release(self, sid):
        ref = self._refs[sid]
        ref[1] -= 1
        if ref[1] == 0:
            self.live -= ref[0]
            del self._refs[sid]


# ---------------------------------------------------------------------------
# Roofline terms (the H100's constants; per card)
# ---------------------------------------------------------------------------


def roofline_terms(stats: OpStats) -> dict:
    by = stats.dot_flops_by_dtype or (
        {"bfloat16": stats.dot_flops} if stats.dot_flops else {})
    t_comp = sum(f / PEAK_FLOPS.get(dt, PEAK_FLOPS["float32"])
                 for dt, f in by.items())
    t_mem = (stats.memory_bytes_w2 or stats.memory_bytes) / HBM_BW
    t_coll = stats.collective_bytes / NET_BW
    dominant = max(
        ("compute", t_comp), ("memory", t_mem), ("collective", t_coll),
        key=lambda kv: kv[1],
    )[0]
    return {
        "t_compute_s": t_comp,
        "t_memory_s": t_mem,
        "t_collective_s": t_coll,
        "dominant": dominant,
    }
