"""Wrappers of the fused plane quantizer (K1, ``csrc/quantize_plane.cu``)
and of the per-message quantize/dequantize kernels (K4/K5,
``csrc/quantize_leaf.cu``), K4's shard form among them (``row_absmax``,
``quantize_shard``: a rank's shard of a leaf cut over the "model" axis).

Each wrapper launches its CUDA kernel on a CUDA tensor and runs the plain
version (``ref.py``) on a CPU tensor, as the reference runs Pallas in
interpret mode off the TPU.  K1 and K4 compute the row scales in the same
launch as the levels (``csrc/quantize.cuh``), so their wrappers only
allocate: q, scale, and the kernel's scratch (a ticket, a counter and a
max word per row), which the C entry zeroes on the stream before the
launch.  ``dequantize_plane``, a jnp expression in the reference
(``quantize/ops.py:71``), runs K5's kernel in its division form on the
card.  K5 walks its rows as one flat array in quads of 4 elements
(``DQ_*`` mirror its sizes); a call of 2^31 - 2^11 elements or more goes
in row groups, one launch each.

On a ``meta`` or fake tensor (a dry-run's trace of the card's route) a
wrapper takes its fake route: it returns outputs of the kernel's shapes
and dtypes and launches nothing.  Both routes report the call to the
active ``launch.op_analysis.OpCounter`` as one op under the kernel's id.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, prng
from repro_torch.kernels.quantize import ref
from repro_torch.launch import op_analysis


# K5's walk, as csrc/quantize_leaf.cu sizes it: the M * n elements of out
# as one flat array in quads of DQ_QUAD (one float4 store each, where out
# is 16-byte aligned), a thread DQ_QUADS quads 4 * DQ_THREADS elements
# apart, a block DQ_THREADS threads
DQ_THREADS = 256
DQ_QUAD = 4
DQ_QUADS = 2
# its element, nibble and word indices are 32-bit: the C entry refuses
# M * n at or above kDqMostElements (2^31 - 2^11), so a larger call goes
# in row groups below it
DQ_MOST_ELEMENTS = ((1 << 32) - 8 * DQ_QUADS * DQ_THREADS) // 2


def wire_len(n: int, bits: int) -> int:
    """Wire bytes of one quantized message of n elements."""
    return n if bits == 8 else -(-n // 2)


def scratch(m: int, device):
    """The fused quantiser's scratch for m rows: a ticket, then an arrival
    counter and a max word per row (uint32; zeroed by the C entry).  One
    per call, so two calls on two streams never share one."""
    return torch.empty((1 + 2 * m,), dtype=torch.int32, device=device)


def _check_bits(bits):
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")


def _q_dtype(bits):
    return torch.int8 if bits == 8 else torch.uint8


def _fake_quantize(kid, x, bits):
    """The fake route of K1/K4: ``(q [..., wire_len], scale [...])``."""
    lead, n = tuple(x.shape[:-1]), x.shape[-1]
    return op_analysis.kernel_op(kid, (x,), (
        torch.empty(lead + (wire_len(n, bits),), dtype=_q_dtype(bits),
                    device=x.device),
        torch.empty(lead, dtype=torch.float32, device=x.device)))


def _fake_dequantize(q, scale, n):
    """The fake route of K5: ``[..., n]`` f32."""
    return op_analysis.kernel_op("K5", (q, scale), torch.empty(
        tuple(q.shape[:-1]) + (n,), dtype=torch.float32, device=q.device))


def quantize_plane(seed, sids, rids, x, *, bits=8):
    """Quantize every message of ``x [..., n]`` (f32) in one launch, the
    stochastic-rounding bits derived in the kernel from ``(seed, sender,
    receiver, element)``.  ``seed`` is the round's pair of uint32 ints;
    ``sids``/``rids`` are per-message ids (int32 tensors holding uint32
    bit patterns, broadcastable to the lead shape) and ``rids=None`` marks
    one-to-all messages.  Returns ``(q [..., wire_len], scale [...])``."""
    _check_bits(bits)
    if x.device.type == "cpu":
        return ref.quantize_plane_ref(seed, sids, rids, x, bits=bits)
    if op_analysis.is_abstract(x):
        return _fake_quantize("K1", x, bits)
    lead, n, xf = _build.rows(x, "x", torch.float32)
    m, wire = xf.shape[0], wire_len(n, bits)
    sid = _plane_ids(sids, lead)
    rid = _plane_ids(rids, lead)
    scale = torch.empty((m,), dtype=torch.float32, device=x.device)
    q = torch.empty((m, wire), device=x.device, dtype=_q_dtype(bits))
    _build.launch(
        "quantize_plane", xf.data_ptr(), m, n, bits, seed[0], seed[1],
        _build.id_ptr(sid, m, x.device), _build.id_ptr(rid, m, x.device),
        scale.data_ptr(), q.data_ptr(), wire,
        scratch(m, x.device).data_ptr(),
    )
    quantize_plane.launches += 1
    return op_analysis.kernel_op("K1", (xf,), (q.reshape(lead + (wire,)),
                                               scale.reshape(lead)))


quantize_plane.launches = 0


def _plane_ids(ids, lead):
    """Per-message ids for the kernels: int32 ``[M]`` (None stays None)."""
    if ids is None:
        return None
    try:
        ids = ids.broadcast_to(lead)
    except RuntimeError as e:
        raise ValueError(f"ids of shape {tuple(ids.shape)} do not broadcast "
                         f"to the messages' shape {lead}") from e
    return ids.reshape(-1).to(torch.int32).contiguous()


def quantize_tensor(keys, x, *, bits=8):
    """Quantize every message of ``x [..., n]`` (f32) in one launch, the
    counterpart of the reference's per-message ``quantize_tensor``
    (``quantize/ops.py:86``) batched over the lead dims.  ``keys [..., 2]``
    (``core.jaxrand`` keys, one per message): message m's rounding bits are
    ``jax.random.bits(keys[m], (n_pad,))``, drawn in the kernel.  Returns
    ``(q [..., wire_len], scale [...])``."""
    _check_bits(bits)
    if x.device.type == "cpu":
        return ref.quantize_tensor_ref(keys, x, bits=bits)
    if op_analysis.is_abstract(x):
        return _fake_quantize("K4", x, bits)
    lead, n, xf = _build.rows(x, "x", torch.float32)
    m, wire = xf.shape[0], wire_len(n, bits)
    kd = _key_words(keys, lead, x.device)
    scale = torch.empty((m,), dtype=torch.float32, device=x.device)
    q = torch.empty((m, wire), device=x.device, dtype=_q_dtype(bits))
    _build.launch("quantize_leaf", xf.data_ptr(), m, n, bits, kd.data_ptr(),
                  scale.data_ptr(), q.data_ptr(), wire,
                  scratch(m, x.device).data_ptr())
    quantize_tensor.launches += 1
    return op_analysis.kernel_op("K4", (xf,), (q.reshape(lead + (wire,)),
                                               scale.reshape(lead)))


quantize_tensor.launches = 0


def row_absmax(x):
    """The first pass of K4's shard form: each message's max |x| of ``x
    [..., n]`` (f32) as the uint32 bits of the f32, int32 ``[...]`` (one
    memset and one launch), for an all-reduce with MAX over the ranks
    before ``quantize_shard``."""
    if x.device.type == "cpu":
        return ref.row_absmax_ref(x)
    if op_analysis.is_abstract(x):
        return op_analysis.kernel_op("K4", (x,), torch.empty(
            tuple(x.shape[:-1]), dtype=torch.int32, device=x.device))
    lead, n, xf = _build.rows(x, "x", torch.float32)
    words = torch.empty((xf.shape[0],), dtype=torch.int32, device=x.device)
    _build.launch("leaf_absmax", xf.data_ptr(), xf.shape[0], n,
                  words.data_ptr())
    row_absmax.launches += 1
    return op_analysis.kernel_op("K4", (xf,), words.reshape(lead))


row_absmax.launches = 0


def quantize_shard(keys, x, words, layout, *, bits=8):
    """K4's shard form: the rank's shard ``x [..., n_local]`` (f32) of
    each message's leaf, laid out in the whole leaf as ``layout``
    (``ref.ShardLayout``), quantised as its part of the whole leaf's
    message: at the scales ``max(word, tiny)`` of ``words [...]`` (the
    ranks' ``row_absmax`` all-reduced with MAX), kappa the whole leaf's
    ``jax.random.bits(keys[m], (n_pad,))`` at each element's flat index
    in the whole leaf.  One launch.  Returns ``(q [..., wire_len(n_local)],
    scale [...])``."""
    _check_bits(bits)
    if x.device.type == "cpu":
        return ref.quantize_shard_ref(keys, x, words, layout, bits=bits)
    if op_analysis.is_abstract(x):
        return _fake_quantize("K4", x, bits)
    lead, n, xf = _build.rows(x, "x", torch.float32)
    m, wire = xf.shape[0], wire_len(n, bits)
    kd = _key_words(keys, lead, x.device)
    w = words.reshape(-1).to(torch.int32).contiguous()
    _build.check_tensor("words", w, torch.int32, x.device, (m,))
    desc = _shard_desc(layout)
    scale = torch.empty((m,), dtype=torch.float32, device=x.device)
    q = torch.empty((m, wire), device=x.device, dtype=_q_dtype(bits))
    _build.launch("quantize_leaf_shard", xf.data_ptr(), m, n, bits,
                  kd.data_ptr(), w.data_ptr(), desc, scale.data_ptr(),
                  q.data_ptr(), wire)
    quantize_shard.launches += 1
    return op_analysis.kernel_op("K4", (xf,), (q.reshape(lead + (wire,)),
                                               scale.reshape(lead)))


quantize_shard.launches = 0


def _shard_desc(layout):
    """The shard's description for the C entry, a host int32 array (the
    launcher copies it into the kernel's argument)."""
    import ctypes

    words = layout.words()
    if max(words) >= 2 ** 31:
        raise ValueError(f"a shard description past int32: {words}")
    return (ctypes.c_int32 * len(words))(*words)


def _key_words(keys, lead, device):
    """``[..., 2]`` keys -> contiguous int32 ``[M, 2]`` uint32 bit patterns
    on ``device``, converted where the keys lie.  Host keys bound for a
    CUDA device go through pinned memory in a non-blocking copy, so the
    host does not wait for the stream (a copy from pageable memory
    would)."""
    if tuple(keys.shape) != lead + (2,):
        raise ValueError(f"keys of shape {tuple(keys.shape)} do not match "
                         f"the messages' shape {lead}")
    words = (keys.reshape(-1, 2) & prng.MASK).to(torch.int32).contiguous()
    if words.device.type == "cpu" and torch.device(device).type == "cuda":
        words = words.pin_memory()
    return words.to(device, non_blocking=True)


def row_groups(m: int, n: int, most: int = DQ_MOST_ELEMENTS):
    """Slices of consecutive rows of an ``[m, n]`` call, each fewer than
    ``most`` elements: one slice unless m * n reaches it."""
    if n >= most:
        raise ValueError(f"a row of {n} elements is past the dequantise "
                         f"kernel's {most}")
    per = (most - 1) // n
    return [slice(r0, min(m, r0 + per)) for r0 in range(0, max(m, 1), per)]


def _dequantize(q, scale, n, bits, plane):
    """The dequantise kernel over q's rows (``plane``: the division form
    of ``dequantize_plane``): one launch per row group (``row_groups``).
    Returns ``(out, launches)``."""
    lead, wire, qf = _build.rows(q, "q",
                                 torch.int8 if bits == 8 else torch.uint8)
    if wire != wire_len(n, bits):
        raise ValueError(f"q holds {wire} bytes per message, not "
                         f"{wire_len(n, bits)} for n={n}, bits={bits}")
    m = qf.shape[0]
    sc = scale.reshape(-1)
    _build.check_tensor("scale", sc, torch.float32, q.device, (m,))
    out = torch.empty((m, n), dtype=torch.float32, device=q.device)
    groups = row_groups(m, n)
    for g in groups:
        _build.launch("dequantize_leaf", qf[g].data_ptr(),
                      g.stop - g.start, n, bits, sc[g].data_ptr(),
                      out[g].data_ptr(), wire, plane)
    return out.reshape(lead + (n,)), len(groups)


def dequantize_tensor(q, scale, *, n, bits=8):
    """Inverse of ``quantize_tensor`` in one launch: ``(scale * q) *
    f32(1 / levels)`` per message, as the reference's compiled
    ``dequantize_tensor`` computes it (``quantize/ops.py:104``).
    ``q [..., wire_len]``, ``scale [...]``; returns ``[..., n]`` f32."""
    _check_bits(bits)
    if q.device.type == "cpu":
        return ref.dequantize_tensor_ref(q, scale, n=n, bits=bits)
    if op_analysis.is_abstract(q):
        return _fake_dequantize(q, scale, n)
    out, launches = _dequantize(q, scale, n, bits, 0)
    dequantize_tensor.launches += launches
    return op_analysis.kernel_op("K5", (q, scale), out)


dequantize_tensor.launches = 0


def dequantize_plane(q, scale, *, n, bits=8):
    """Elementwise inverse of ``quantize_plane``: ``(scale * q) / levels``
    as the reference's jnp expression (``quantize/ops.py:71``) computes
    it, subnormal results flushed as XLA flushes them.  On the card one
    launch of K5's kernel in its division form (``csrc/quantize_leaf.cu``),
    where the flush in PyTorch would take four passes over the plane."""
    _check_bits(bits)
    if q.device.type == "cpu":
        return ref.dequantize_plane_ref(q, scale, n=n, bits=bits)
    if op_analysis.is_abstract(q):
        return _fake_dequantize(q, scale, n)
    out, launches = _dequantize(q, scale, n, bits, 1)
    dequantize_plane.launches += launches
    return op_analysis.kernel_op("K5", (q, scale), out)


dequantize_plane.launches = 0
