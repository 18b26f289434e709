"""Bit-exact counterparts of the ``jax.random`` functions the main path
draws from, so that the port follows the reference's random draws.

Mode: the threefry implementation with ``jax_threefry_partitionable =
True`` (the default from jax 0.5 on, and the mode of the reference runs
this port is held to).  In that mode every draw hashes a flat 64-bit
element counter split into two uint32 words; ``split(key, n)[i]`` equals
``fold_in(key, i)``, and 32-bit ``bits`` are the XOR of the two output
words.

A key is an int64 tensor ``[..., 2]`` holding the two uint32 words of
``jax.random.key_data``; every function broadcasts over the leading
dims, so a batch of keys (the vmapped per-agent or per-message keys of
the reference) is one call.  Results lie on the key's device.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.prng import MASK, threefry2x32, u32, wrap_i32


def key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.key(seed)``: a 64-bit seed as its two uint32 words (a
    negative int32 seed is its two's complement in the low word)."""
    seed = int(seed)
    hi = (seed >> 32) & MASK if seed >= 0 else 0
    return torch.tensor([hi, seed & MASK], dtype=torch.int64, device=device)


def key_data(k):
    return k


def key_seed(k):
    """Key -> the ``(u32, u32)`` pair of Python ints the fused kernels
    take as their round seed (``prng.key_seed`` of the reference)."""
    w = k.tolist()
    return int(w[0]), int(w[1])


def _hash(k, c0, c1):
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], c0, c1)
    return torch.stack([y0, y1], dim=-1)


def fold_in(k, data):
    """``jax.random.fold_in``: hash the counter ``(0, data)`` under the
    key.  ``data`` (int or int tensor) broadcasts against the key's lead
    dims."""
    return _hash(k, 0, u32(data, k.device))


def split(k, num: int = 2):
    """``jax.random.split``: ``[..., num, 2]``; key i hashes ``(0, i)``."""
    i = torch.arange(num, dtype=torch.int64, device=k.device)
    return _hash(k[..., None, :], 0, i)


def _counters(shape, device, start=0):
    size = math.prod(shape)
    flat = torch.arange(start, start + size, dtype=torch.int64, device=device)
    return (flat >> 32).reshape(shape), (flat & MASK).reshape(shape)


def bits(k, shape, start: int = 0):
    """``jax.random.bits`` (uint32, in int64): ``[..., *shape]``.  With
    ``start``, the elements at flat positions ``start ..`` of a larger
    draw from the same key (each element's bits depend only on its flat
    counter), so a large draw can be taken in slices."""
    shape = tuple(shape)
    hi, lo = _counters(shape, k.device, start)
    pad = (None,) * len(shape)
    y0, y1 = threefry2x32(k[..., 0][(...,) + pad], k[..., 1][(...,) + pad],
                          hi, lo)
    return y0 ^ y1


def bits_at(k, counters):
    """The elements at the flat positions ``counters`` (an int64 tensor of
    any shape) of a ``jax.random.bits`` draw from ``k`` of a size past
    them: ``[..., *counters.shape]``, each element's bits depending only
    on its counter.  A shard of a larger draw reads its elements' global
    positions."""
    c = torch.as_tensor(counters, dtype=torch.int64, device=k.device)
    pad = (None,) * c.dim()
    y0, y1 = threefry2x32(k[..., 0][(...,) + pad], k[..., 1][(...,) + pad],
                          c >> 32, c & MASK)
    return y0 ^ y1


def uniform(k, shape):
    """``jax.random.uniform`` in f32 on [0, 1): 23 random mantissa bits
    under exponent 0, minus one."""
    return unit(bits(k, shape))


def unit(b):
    """``jax.random.uniform``'s f32 on [0, 1) from its uint32 bits (in
    int64)."""
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return f.clamp_min(0.0)


# XLA's single-precision erf_inv (Giles' approximation): polynomial
# coefficients for w = -log1p(-x^2) below 5 and at or above 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _erf_inv(x):
    """erf^-1 on f32 as XLA computes it (|x| < 1)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.zeros_like(x)
    for a, b in zip(_ERFINV_LT5, _ERFINV_GE5):
        p = torch.where(lt, a, b) + p * w
    return p * x


def normal(k, shape, start: int = 0):
    """``jax.random.normal`` in f32: ``sqrt(2) * erf_inv(u)``, u the
    uniform draw on [nextafter(-1, 0), 1).  The uniform draw is
    bit-exact; XLA's erf_inv polynomial is repeated, but XLA may contract
    its multiply-adds, so values agree to a few ulp.  ``start`` as in
    ``bits``."""
    lo = torch.tensor(-0.99999994, dtype=torch.float32)  # nextafter(-1, 0)
    b = bits(k, shape, start)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    u = torch.maximum(lo, f * (1.0 - lo) + lo)
    return torch.tensor(math.sqrt(2), dtype=torch.float32) * _erf_inv(u)


def randint(k, shape, minval: int, maxval: int):
    """``jax.random.randint`` into int32 (returned as int64 values): two
    32-bit draws combined modulo the span with uint32 wrap-around."""
    if not all(-2 ** 31 <= v < 2 ** 31 for v in (minval, maxval)):
        raise ValueError("randint bounds must lie in the int32 range")
    span = 1 if maxval <= minval else (maxval - minval) & MASK
    ks = split(k, 2)
    higher, lower = bits(ks[..., 0, :], shape), bits(ks[..., 1, :], shape)
    mult = (((2 ** 16 % span) ** 2) & MASK) % span  # uint32 product wraps
    off = (((higher % span) * mult) & MASK) + lower % span
    return wrap_i32(minval + (off & MASK) % span)


def bernoulli(k, p: float, shape):
    """``jax.random.bernoulli``: ``uniform < p`` with p in f32."""
    return uniform(k, shape) < torch.tensor(p, dtype=torch.float32)


def permutation(k, n: int):
    """``jax.random.permutation(key, n)``: stable sorts of ``arange(n)``
    by fresh 32-bit keys, as many rounds as jax's static criterion asks.
    Batched keys give ``[..., n]``."""
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(2 ** 32 - 1))
    x = torch.arange(n, dtype=torch.int64, device=k.device)
    x = x.expand(k.shape[:-1] + (n,))
    for _ in range(rounds):
        ks = split(k, 2)
        k, sub = ks[..., 0, :], ks[..., 1, :]
        order = torch.sort(bits(sub, (n,)), dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x
