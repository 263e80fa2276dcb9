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


def seed_words(seeds):
    """The uint32 seeds of ``seed_keys`` as an int32 tensor of the same
    bits (what a kernel reads as uint32)."""
    s = seeds.to(torch.int64) & _MASK
    return torch.where(s >= 2**31, s - 2**32, s).to(torch.int32)


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


def uniform_at(key, counter, dtype):
    """``jax.random.uniform(key, shape, dtype)`` at one flat counter per
    element: the Threefry-2x32 hash of (0, counter) under the key, whose
    words (b1, b2) give the mantissa of a number in [1, 2), minus 1
    (exact), as jax does.  float32 takes the top 23 bits of b1 ^ b2;
    float64 the top 52 bits of (b1 << 32) | b2.  key (k1, k2) and counter
    are int64 tensors of uint32 values that broadcast together (counter <
    2**32, so the high counter word is 0); this is the formula the
    generator kernel of ecrad_torch/csrc/generator_scan.cu computes per
    element."""
    k1, k2 = key
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(counter), counter)
    if dtype == torch.float32:
        bits = ((b1 ^ b2) >> 9) | 0x3F800000
        return bits.to(torch.int32).view(torch.float32) - 1.0
    if dtype == torch.float64:
        bits = ((((b1 >> 12) | 0x3FF00000) << 32)
                | ((b1 << 20) & _MASK) | (b2 >> 12))
        return bits.view(torch.float64) - 1.0
    raise TypeError(f"uniform supports float32/float64, got {dtype}")


def uniform(key, shape, dtype):
    """``jax.random.uniform(key, shape, dtype)`` on [0, 1) for a batch
    of keys (ncol,): returns (ncol,) + shape in ``dtype`` (float32 or
    float64), uniform_at over the row-major counters of shape."""
    k1, k2 = key
    counts = torch.arange(math.prod(shape), dtype=torch.int64,
                          device=k1.device).reshape(shape)
    expand = (slice(None),) + (None,) * len(shape)
    return uniform_at((k1[expand], k2[expand]), counts, dtype)
