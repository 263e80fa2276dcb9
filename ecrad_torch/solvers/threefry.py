"""Threefry-2x32 counter-based random numbers, bit-compatible with
``jax.random`` under ``jax_threefry_partitionable=True``.

The McICA generator of the JAX package draws its per-column sample as
``jax.random.key(seed)`` -> ``split(key, 4)`` -> ``uniform(k_i, shape)``
(``ecrad_tpu/solvers/cloud_generator.py`` draw).  The port must draw the
same numbers, or no flux comparison with the reference means anything.
This module computes exactly what those calls compute (jax/_src/prng.py
threefry_seed, _threefry_split_foldlike,
_threefry_random_bits_partitionable; jax/_src/random.py _uniform), in
plain torch on int64 tensors masked to 32 bits, batched over a leading
column axis of per-column seeds.
"""

from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds).  All arguments are int64
    tensors holding uint32 values; keys broadcast against counts."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def seed_keys(seeds):
    """``jax.random.key`` of uint32 seeds: key = (seed >> 32, seed), so
    the high word is 0.  seeds (ncol,) integer tensor -> (k1, k2) each
    (ncol,) int64."""
    s = seeds.to(torch.int64) & _MASK
    return torch.zeros_like(s), s


def split(key, num):
    """``jax.random.split(key, num)`` for a batch of keys: returns a
    list of ``num`` (k1, k2) pairs, each (ncol,)."""
    k1, k2 = key
    out = []
    for i in range(num):
        lo = torch.full_like(k1, i)
        b1, b2 = threefry2x32(k1, k2, torch.zeros_like(k1), lo)
        out.append((b1, b2))
    return out


def _bits(key, shape):
    """Raw (bits1, bits2) for a batch of keys: (ncol,) + shape each."""
    k1, k2 = key
    n = math.prod(shape)
    counts = torch.arange(n, dtype=torch.int64, device=k1.device)
    counts = counts.reshape(shape)
    expand = (slice(None),) + (None,) * len(shape)
    kk1, kk2 = k1[expand], k2[expand]
    # counts < 2**32 here, so the high count word is 0
    return threefry2x32(kk1, kk2, torch.zeros_like(counts), counts)


def uniform(key, shape, dtype):
    """``jax.random.uniform(key, shape, dtype)`` on [0, 1) for a batch
    of keys: returns (ncol,) + shape in ``dtype`` (float32 or float64).

    float32 takes the top 23 bits of bits1 ^ bits2; float64 the top 52
    bits of (bits1 << 32) | bits2.  The mantissa m gives m * 2**-nmant
    exactly, which equals jax's bitcast(1.0 | m) - 1.0."""
    b1, b2 = _bits(key, tuple(shape))
    if dtype == torch.float32:
        m = (b1 ^ b2) >> 9
        return (m.to(torch.float64) * 2.0 ** -23).to(torch.float32)
    if dtype == torch.float64:
        m = (b1 << 20) | (b2 >> 12)
        return m.to(torch.float64) * 2.0 ** -52
    raise TypeError(f"uniform supports float32/float64, got {dtype}")
