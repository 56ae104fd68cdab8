"""Counter-based random numbers: the port's counterpart of ``jax.random``.

Every draw is a pure function of a key and an element index, hashed with
a 32-bit xorshift-multiply finalizer — no ``torch.Generator`` state.  So
a draw can be made again and gives the same bits: a CUDA graph replays
the server's sampling noise exactly, and a remat recompute
(``torch.utils.checkpoint`` restores no explicit generator) rebuilds the
dropout masks of the forward it re-runs.

A key is an int in [0, 2^32) or an int64 tensor of such values (0-d, or
[2] for the server's (stream key, step counter) pair), on the device the
draw is made on.  :func:`fold_in` is the schedule step, the counterpart
of ``jax.random.fold_in`` (and of ``split``: the i-th of n keys is
``fold_in(key, i)``).  The streams are not ``jax.random``'s: code held
against the JAX package draws by law, not bit for bit.
"""
from __future__ import annotations

import math
import zlib

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ELEMENT = 0x3C6EF372      # folded into every element hash


def mix32(h):
    """A 32-bit integer finalizer (xorshift-multiply rounds) on int64
    values in [0, 2^32) — a tensor or a Python int; both multipliers are
    below 2^31, so every product stays inside int64 on any device."""
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & M32
    h = h ^ (h >> 15)
    h = (h * 0x5BD1E995) & M32
    return h ^ (h >> 16)


def seed_key(seed: int) -> int:
    """The 32-bit key of an integer seed (host side)."""
    return zlib.crc32(np.int64(seed).tobytes()) & M32


def fold_in(key, data):
    """The key derived from ``key`` and the 64-bit integer ``data`` (an int
    or an int64 tensor): its low and high words hashed in turn."""
    return mix32(mix32(key ^ (data & M32)) ^ ((data >> 32) & M32))


def bits(key, shape, device, offset: int = 0):
    """32 random bits (int64 in [0, 2^32)) per element of ``shape``, a pure
    function of ``key`` and the element's flat index.  ``offset`` shifts
    the indices: a block of a larger draw, made on its own (a row shard
    of a table, a chunk of a draw too large to make at once), holds the
    same bits as the whole draw there."""
    n = 1
    for d in shape:
        n *= d
    idx = torch.arange(offset, offset + n, dtype=torch.int64,
                       device=device).reshape(shape)
    return mix32(mix32(idx ^ key) ^ _ELEMENT)


def uniform(key, shape, device, offset: int = 0):
    """float32 uniforms in (0, 1) on 2^23 levels (each bin's midpoint,
    ``(k + 0.5) / 2^23``: float32 holds every one exactly, so u lies in
    [2^-24, 1 - 2^-24] and never rounds to 0 or 1)."""
    return ((bits(key, shape, device, offset) >> 9).to(torch.float32) + 0.5) \
        * (1.0 / (1 << 23))


def normal(key, shape, device, offset: int = 0):
    """float32 standard normals of ``shape`` under ``key``: the
    counterpart of ``jax.random.normal``, by the inverse CDF
    ``sqrt(2) * erfinv(2u - 1)`` of :func:`uniform` — one draw an
    element, so a remat recompute or a graph replay draws the same
    values again (the bits are the same on every device; ``erfinv`` may
    differ by an ulp between them).  |z| stays below 5.3: ``2u - 1`` is
    exact and at most 1 - 2^-23 in magnitude."""
    u = uniform(key, shape, device, offset)
    return math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)


def gumbel(key, shape, device):
    """Standard Gumbel noise of ``shape`` under ``key`` — an int64 tensor
    [2] (stream key, counter): the server's sampling noise."""
    u = uniform(fold_in(key[0], key[1]), shape, device)
    return -torch.log(-torch.log(u))


def bernoulli(key, p: float, shape, device):
    """A bool mask of ``shape``, each element True with probability ``p``
    (to 2^-24): the counterpart of ``jax.random.bernoulli``."""
    return (bits(key, shape, device) >> 8) < int(round(p * (1 << 24)))
