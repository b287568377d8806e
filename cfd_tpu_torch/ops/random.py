"""The JAX package's seeded uniform noise, reproduced in numpy.

``jax.random.uniform(jax.random.PRNGKey(seed), shape, float32, lo, hi)``
with the threefry2x32 generator in its partitionable mode (the JAX default
since 0.5): the key is ``(seed >> 32, seed & 0xffffffff)``, element k of the
flat output hashes the counter pair (k >> 32, k & 0xffffffff) with
Threefry-2x32 (20 rounds), and its 32 random bits are the two output words
XORed. The float is ``((bits >> 9) | 0x3f800000)`` viewed as float32, minus
1, times (hi - lo), plus lo, then ``max(lo, .)``. The same seed then gives
the same initial field in both packages (cases.rayleigh_benard's
perturbation), bit for bit.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: tuple[int, int], x0: np.ndarray, x1: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds of the counter words (x0, x1) under
    ``key`` (two uint32 words)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = x0.astype(np.uint32) + ks[0]
    x1 = x1.astype(np.uint32) + ks[1]
    for block in range(5):
        for r in _ROTATIONS[block % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(block + 1) % 3]
        x1 = x1 + ks[(block + 2) % 3] + np.uint32(block + 1)
    return x0, x1


def uniform(seed: int, shape: tuple[int, ...], minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """float32 array of ``shape``, equal bit for bit to
    ``jax.random.uniform(jax.random.PRNGKey(seed), shape, jnp.float32,
    minval, maxval)``."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    n = int(np.prod(shape, dtype=np.int64))
    k = np.arange(n, dtype=np.uint64)
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32((seed >> 32, seed & 0xFFFFFFFF),
                              (k >> np.uint64(32)).astype(np.uint32),
                              (k & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    bits = b0 ^ b1
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    floats = floats - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    out = floats * (hi - lo) + lo
    return np.maximum(lo, out).reshape(shape)
