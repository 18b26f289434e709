"""Threefry-2x32-20 counter PRNG, plain PyTorch (the oracle of the device
code in ``csrc/threefry.cuh``).

The fused compression kernels derive every random decision (stochastic
rounding kappas, RandK index sets) from ``(round seed, sender, receiver,
element)`` with this cipher, so sender and receiver agree on them without
shipping any random stream or index array.  The cipher is plain uint32
arithmetic, so the port must be bit-equal to the JAX package's
``kernels/prng.py``, not merely equal in distribution.

PyTorch has no uint32 arithmetic on the CPU, so uint32 values are carried
in int64 tensors and masked to 32 bits after every add and shift.  Every
function accepts the full uint32 range (Python ints up to 2^32 - 1, or
negative int32 bit patterns, both masked on entry).

``threefry_bits`` is the test entry point of the device cipher: on a CUDA
tensor it launches the ``threefry_bits`` kernel, on a CPU tensor it runs
the plain version below.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# receiver id of a one-to-all message (x broadcasts)
BROADCAST = 0xFFFFFFFF


def u32(x, device=None) -> torch.Tensor:
    """Int, sequence or tensor -> int64 tensor holding the uint32 value."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device or x.device, dtype=torch.int64) & MASK
    return torch.as_tensor(x, dtype=torch.int64, device=device) & MASK


def _rotl(x, r: int):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, c0, c1):
    """One Threefry-2x32-20 block: hash counter ``(c0, c1)`` under key
    ``(k0, k1)``.  Inputs are broadcastable int64 tensors (or ints) holding
    uint32 values; returns two int64 tensors of the broadcast shape.

    Host inputs (the round's key derivation: a few hundred words) take
    numpy's native uint32 arithmetic, which costs a fraction of PyTorch's
    per-op overhead on tiny tensors; device inputs take
    ``threefry2x32_torch``.  Both are the same cipher, bit for bit."""
    dev = next((t.device for t in (k0, k1, c0, c1)
                if isinstance(t, torch.Tensor)), torch.device("cpu"))
    if dev.type == "cpu":
        return _threefry2x32_numpy(k0, k1, c0, c1)
    return threefry2x32_torch(k0, k1, c0, c1)


def _np_u32(x):
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    return (np.asarray(x, dtype=np.int64) & MASK).astype(np.uint32)


def _threefry2x32_numpy(k0, k1, c0, c1):
    k0, k1, x0, x1 = np.broadcast_arrays(*(_np_u32(t) for t in
                                           (k0, k1, c0, c1)))
    shape = k0.shape
    # 1-d copies: numpy warns on uint32 overflow of 0-d scalars only
    k0, k1, x0, x1 = (np.array(t).reshape(-1) for t in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(_PARITY))
    x0 = x0 + k0
    x1 = x1 + k1
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return tuple(torch.from_numpy(t.astype(np.int64).reshape(shape))
                 for t in (x0, x1))


def threefry2x32_torch(k0, k1, c0, c1):
    """``threefry2x32`` in PyTorch int64 ops (any device)."""
    dev = next((t.device for t in (k0, k1, c0, c1)
                if isinstance(t, torch.Tensor)), None)
    k0, k1, x0, x1 = (u32(t, dev) for t in (k0, k1, c0, c1))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def fold(seed, *ids):
    """Absorb integer ids into a seed pair, one cipher block per id; the
    counter's second word carries the fold depth."""
    s0, s1 = seed
    for depth, d in enumerate(ids):
        s0, s1 = threefry2x32(s0, s1, d, depth)
    return s0, s1


def _threefry2x32_int(k0, k1, x0, x1):
    """One cipher block on Python ints (uint32 values)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = (((x1 << r) & MASK) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def fold_int(seed, *ids):
    """``fold`` of one seed pair by scalar ids, in Python ints: the same
    words, at a small fraction of a tensor call's overhead (the fault
    plane folds a few seeds a round on the host)."""
    s0, s1 = (int(w) & MASK for w in seed)
    for depth, d in enumerate(ids):
        s0, s1 = _threefry2x32_int(s0, s1, int(d) & MASK, depth)
    return s0, s1


def message_seed(seed, sender, receiver=None):
    """The per-message seed pair both endpoints derive independently.
    ``receiver=None`` marks a one-to-all broadcast (x-messages)."""
    return fold(seed, sender, BROADCAST if receiver is None else receiver)


def random_bits(seed, ctr, stream=0):
    """uint32 stream (in int64) at counter positions ``ctr``."""
    b0, _ = threefry2x32(seed[0], seed[1], ctr, stream)
    return b0


def uniform01(bits):
    """uint32 bits -> f32 in [0, 1]: round-to-nearest conversion, then an
    exact scaling by 2^-32, as XLA does (bits >= 2^32 - 128 give 1.0)."""
    return bits.to(torch.float32) * (2.0 ** -32)


def derive_offset(seed, n: int):
    """Seeded window offset in [0, n)."""
    b0, _ = threefry2x32(seed[0], seed[1], 0, 1)
    return b0 % n


def derive_stride_slot(seed, n_strides: int):
    """Seeded slot into a static coprime-stride table."""
    _, b1 = threefry2x32(seed[0], seed[1], 0, 1)
    return b1 % n_strides


@functools.lru_cache(maxsize=64)
def coprime_strides(n: int, size: int = 64) -> tuple:
    """Static table of strides coprime to ``n``, spread across [1, n).
    Cached: every RandK stride message asks for its n's table."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    if n == 1:
        return (0,)
    out = []
    step = max(1, n // size)
    for i in range(size):
        c = (1 + i * step) % n
        if c == 0:
            c = 1
        while math.gcd(c, n) != 1:
            c = c + 1 if c + 1 < n else 1
        out.append(c)
    return tuple(out)


def wrap_i32(v):
    """int64 tensor -> the value int32 arithmetic would hold (two's
    complement wrap), still in int64."""
    v = v & MASK
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v)


def affine_indices(seed, n: int, k: int, strides: tuple):
    """The seeded affine index set ``(off + j * stride) % n`` for ``j < k``,
    computed in int32 as the reference does: the product and sum wrap at
    2^31 and the result is floor-modded into [0, n).  Batched: seed words
    of shape ``[...]`` give indices of shape ``[..., k]`` (int64)."""
    s0 = u32(seed[0])
    off = derive_offset((s0, seed[1]), n)
    table = torch.as_tensor(strides, dtype=torch.int64, device=s0.device)
    stride = table[derive_stride_slot((s0, seed[1]), len(strides))]
    j = torch.arange(k, dtype=torch.int64, device=s0.device)
    return wrap_i32(off[..., None] + j * stride[..., None]) % n


def _threefry_bits_ref(seed, sids, rids, ctr, n: int, n_strides: int):
    es = fold(seed, u32(sids), u32(rids))
    bits = random_bits((es[0][:, None], es[1][:, None]), u32(ctr)[None, :])
    return bits, derive_offset(es, n), derive_stride_slot(es, n_strides)


def threefry_bits(seed, sids, rids, ctr, *, n: int, n_strides: int):
    """K0's test entry point: for each message ``b`` with seed
    ``fold(seed, sids[b], rids[b])`` return ``random_bits`` at every
    counter ``ctr[c]`` (``[B, C]``), ``derive_offset(., n)`` and
    ``derive_stride_slot(., n_strides)`` (``[B]`` each), all as int64
    holding uint32.  ``seed`` is a pair of ints; ``sids``/``rids``/``ctr``
    are int32 tensors carrying uint32 bit patterns.  On a CUDA tensor it
    launches the device cipher; on a CPU tensor it runs the plain
    version."""
    if sids.device.type == "cpu":
        return _threefry_bits_ref(seed, sids, rids, ctr, n, n_strides)
    from repro_torch.kernels import _build

    for name, t in (("sids", sids), ("rids", rids), ("ctr", ctr)):
        _build.check_tensor(name, t, torch.int32, sids.device)
    (b,), (c,) = sids.shape, ctr.shape
    if rids.shape != (b,):
        raise ValueError(f"rids shape {tuple(rids.shape)} != ({b},)")
    bits = torch.empty((b, c), dtype=torch.int32, device=sids.device)
    off = torch.empty((b,), dtype=torch.int32, device=sids.device)
    slot = torch.empty((b,), dtype=torch.int32, device=sids.device)
    _build.launch(
        "threefry_bits", seed[0] & MASK, seed[1] & MASK, sids.data_ptr(),
        rids.data_ptr(), ctr.data_ptr(), b, c, n, n_strides,
        bits.data_ptr(), off.data_ptr(), slot.data_ptr(),
    )
    threefry_bits.launches += 1
    return tuple(u32(t) for t in (bits, off, slot))


threefry_bits.launches = 0
